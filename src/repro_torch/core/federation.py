"""Federation bookkeeping: group/device sampling and weighted aggregation.

Eq. (1) (local aggregation over the sampled device subset A_m), eq. (2)
(global weighted aggregation over groups) and the A_m / mini-batch
agreement of Algorithm 1 line 13, the secure-aggregation ring of
``repro/core/federation.py`` (pairwise int32 masks drawn with numpy, bit for
bit the reference's, and eq. (1) over masked fixed-point uplinks), and the
fault-tolerant layer's screening statistics and robust eq. (1).

Group sharding: the reference tags every [M, ...] tensor with the logical
"group" axis, so under a mesh eq. (2) lowers to a cross-group collective.
The port shards the group axis by hand, in SPMD style: under
``group_axis(axis)`` each process holds its own [M/n, ...] slice of the
groups as plain tensors, and every function here that reads across groups
(eq. (2), the broadcasts, the A_m draws, the group means of the losses)
works on the local slice and meets the other processes through
``torch.distributed`` collectives over the mesh's horizontal dimensions.
Outside it (a single device, or a mesh whose horizontal size does not
divide M) nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.config import FederationConfig
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class GroupAxis(NamedTuple):
    """The group axis M split over ``size`` processes: this one holds the
    groups [rank · M/size, (rank + 1) · M/size), and ``group`` is the
    process group over the mesh's horizontal dimensions."""

    group: object
    rank: int
    size: int


_GROUP_AXIS: Optional[GroupAxis] = None


@contextlib.contextmanager
def group_axis(axis: Optional[GroupAxis]):
    """Run the federation's cross-group functions over ``axis`` (None: the
    single-process layout)."""
    global _GROUP_AXIS
    prev = _GROUP_AXIS
    _GROUP_AXIS = axis
    try:
        yield
    finally:
        _GROUP_AXIS = prev


def mesh_group_axis(mesh, num_groups: int, rules=None) -> Optional[GroupAxis]:
    """The ``GroupAxis`` that puts M = ``num_groups`` groups on ``mesh``'s
    horizontal dimensions (the logical "group" rule, ``group_sharding``);
    None when they hold one process or do not divide M."""
    from repro_torch.common.sharding import group_sharding, mesh_axes

    entry = group_sharding((num_groups,), mesh, rules)[0]
    if entry is None:
        return None
    names = entry if isinstance(entry, tuple) else (entry,)
    size = int(np.prod([mesh_axes(mesh)[n] for n in names]))
    if size <= 1:
        return None
    sub = mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()
    return GroupAxis(sub.get_group(), sub.get_local_rank(), size)


def active_group_axis() -> Optional[GroupAxis]:
    """The ``GroupAxis`` the federation's functions run over (None outside
    ``group_axis``)."""
    return _GROUP_AXIS


def local_rows(x: torch.Tensor, M: Optional[int] = None) -> torch.Tensor:
    """This process's rows of a tensor whose leading axis is the whole M
    (all of them outside ``group_axis``).

    With ``M`` given, a tensor that already holds this process's M/n rows
    (a state a group-sharded run returned) is returned as it is, and any
    other leading size raises."""
    if _GROUP_AXIS is None:
        return x
    size = _GROUP_AXIS.size
    if M is not None and x.shape[0] != M:
        if x.shape[0] != M // size:
            raise ValueError(f"a leading axis of {x.shape[0]} is neither M = {M} "
                             f"nor M/n = {M // size}")
        return x
    m = x.shape[0] // size
    return x[_GROUP_AXIS.rank * m:(_GROUP_AXIS.rank + 1) * m]


def local_group_count(M: int) -> int:
    return M if _GROUP_AXIS is None else M // _GROUP_AXIS.size


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the processes of the group axis (``x`` itself
    outside it)."""
    if _GROUP_AXIS is None:
        return x
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x, group=_GROUP_AXIS.group)
    return x


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of every element of a group-leading tensor ([M, ...], local
    rows under ``group_axis``) over all M groups."""
    if _GROUP_AXIS is None:
        return torch.mean(x)
    return group_sum(torch.sum(x)) / (x.numel() * _GROUP_AXIS.size)


def local_aggregate(theta2_active, mask: Optional[torch.Tensor] = None):
    """Eq. (1): θ2_m = mean over the sampled devices. [M, A, ...] -> [M, ...].

    ``mask`` ([M, A], 1 = real cohort member, 0 = padding slot) restricts the
    mean to the round's actual participants; a group with an empty cohort
    falls back to the plain mean.
    """
    if mask is None:
        return tree_map(lambda x: torch.mean(x, dim=1), theta2_active)
    w = mask.float()
    cnt = torch.sum(w, dim=1)  # [M]
    safe = torch.clamp_min(cnt, 1.0)

    def agg(x):
        tail = (1,) * (x.dim() - 2)
        wb = w.reshape(w.shape + tail).to(x.dtype)
        masked = torch.sum(x * wb, dim=1) / safe.reshape((-1,) + tail).to(x.dtype)
        plain = torch.mean(x, dim=1)
        keep = (cnt > 0).reshape((-1,) + tail)
        return torch.where(keep, masked, plain)

    return tree_map(agg, theta2_active)


# ---------------------------------------------------------------------------
# Secure aggregation (pairwise-mask simulation, Bonawitz-style)
# ---------------------------------------------------------------------------

# Reserved RNG stream index for pairwise masks: default_rng([seed, 4, r, m, i, j]).
# Streams 0 (registry), 1 (cohort), 2 (typical tails), 3 (faults) are taken.
SECURE_AGG_STREAM = 4
# Fixed-point fractional bits of the ℤ_{2^32} ring encoding. Exact-sum
# requirement: |Σ_i x_i| · 2^FRAC_BITS < 2^31 per coordinate. The encoding
# itself needs every uplink entry within ±2^15. Out of range, a float -> int32
# cast differs between XLA (saturates), torch on the CPU (INT_MIN) and CUDA;
# ``_ring_encode`` saturates explicitly so the port's CPU and card agree, but
# no result may depend on it: beyond ±2^15 the aggregate is not the mean.
SECURE_AGG_FRAC_BITS = 16
_RING = 1 << 32


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 and read as two's-complement int32."""
    v = v & (_RING - 1)
    return torch.where(v >= _RING // 2, v - _RING, v).to(torch.int32)


def secure_agg_masks(template, seed: int, round_idx: int, alive=None):
    """Pairwise antisymmetric int32 uplink masks for one round (host-side).

    ``template`` is the [M, A, ...] uplink tree (θ2); the result has the
    same structure in int32, on the template's device. For each group m and
    alive pair i < j, a mask ``p`` is drawn from
    ``np.random.default_rng([seed, 4, round_idx, m, i, j])``; slot i carries
    +p and slot j carries -p, so the ring sum over the alive slots cancels
    exactly. ``alive`` [M, A] marks the surviving slots; dead slots get (and
    owe) no masks. Bit-identical to the reference's masks.

    Under ``group_axis`` the template (and ``alive``) hold this process's
    M/n groups, and their masks are drawn under their global index m: the
    meshless masks' rows, at 1/n of the host's draws.
    """
    leaves, treedef = tree_flatten(template)
    M, A = leaves[0].shape[:2]
    first = 0 if _GROUP_AXIS is None else _GROUP_AXIS.rank * M
    if alive is None:
        alive_np = np.ones((M, A), bool)
    else:
        alive_np = np.asarray(torch.as_tensor(alive).cpu()) > 0
    nets = [np.zeros(tuple(leaf.shape), np.int64) for leaf in leaves]
    for m in range(M):
        for i in range(A):
            for j in range(i + 1, A):
                if not (alive_np[m, i] and alive_np[m, j]):
                    continue
                rng = np.random.default_rng(
                    [seed, SECURE_AGG_STREAM, round_idx, first + m, i, j])
                for li, leaf in enumerate(leaves):
                    p = rng.integers(-(2**31), 2**31, size=tuple(leaf.shape[2:]), dtype=np.int64)
                    nets[li][m, i] += p
                    nets[li][m, j] -= p
    device = leaves[0].device
    masks = [torch.from_numpy((n & 0xFFFFFFFF).astype(np.uint32).view(np.int32)).to(device)
             for n in nets]
    return tree_unflatten(treedef, masks)


def _ring_encode(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """Fixed point: round(x · 2^frac_bits) half to even, as int32 (|x| < 2^15).

    Scaling by a power of two is exact in fp32 and fp64 alike, so rounding
    in fp64 gives the reference's integers; the clamp makes an out-of-range
    entry saturate on every device instead of taking the cast's own value.
    """
    scaled = torch.round(x.float().double() * (2.0 ** frac_bits))
    return torch.clamp(scaled, -(2.0 ** 31), 2.0 ** 31 - 1).to(torch.int32)


def secure_mask_uplink(theta2_active, masks, frac_bits: int = SECURE_AGG_FRAC_BITS):
    """Worker-side masking: fixed-point encode the uplink and add the pairwise
    mask in the ring ℤ_{2^32} (int64 add, then reduced and read as int32)."""
    return tree_map(lambda x, m: _wrap_int32(_ring_encode(x, frac_bits).long() + m.long()),
                    theta2_active, masks)


def secure_local_aggregate(masked_uplink, like, mask: Optional[torch.Tensor] = None,
                           frac_bits: int = SECURE_AGG_FRAC_BITS):
    """Eq. (1) over ring-masked uplinks: [M, A, ...] int32 -> [M, ...] float.

    The server sums the masked integers along the device axis in int64,
    reduces mod 2^32 (exact, so the antisymmetric masks cancel to the bit),
    and only then decodes to float and divides by the participant count.
    ``like`` supplies the output dtype per leaf; ``mask`` [M, A] restricts
    the sum to the round's real slots (a group with none returns zeros).
    """
    leaves, treedef = tree_flatten(masked_uplink)
    like_leaves = tree_leaves(like)
    M, A = leaves[0].shape[:2]
    device = leaves[0].device
    if mask is None:
        w = torch.ones((M, A), dtype=torch.int64, device=device)
    else:
        w = (mask > 0).to(torch.int64)
    cnt = torch.sum(w, dim=1)  # [M]
    safe = torch.clamp_min(cnt, 1).float()
    out = []
    for x, ref in zip(leaves, like_leaves):
        tail = (1,) * (x.dim() - 2)
        ring_sum = _wrap_int32(torch.sum(x.long() * w.reshape(w.shape + tail), dim=1))
        dec = ring_sum.float() / torch.full_like(safe, 2.0 ** frac_bits).reshape((-1,) + tail)
        mean = dec / safe.reshape((-1,) + tail)
        keep = (cnt > 0).reshape((-1,) + tail)
        out.append(torch.where(keep, mean, torch.zeros((), device=device)).to(ref.dtype))
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Screening statistics and robust aggregation (fault-tolerant layer)
# ---------------------------------------------------------------------------


def worker_sqnorm(tree, lead: int):
    """Σ_leaves ‖·‖² per worker: [M, ...] -> [M] (lead=1) or
    [M, A, ...] -> [M, A] (lead=2). NaN/Inf anywhere in a worker's slice
    poisons its entry, so ``isfinite(worker_sqnorm(g))`` is the one-reduction
    finite-value screen."""
    per = [torch.sum((x * x).float(), dim=tuple(range(lead, x.dim())))
           for x in tree_leaves(tree)]
    return sum(per)


def masked_median_values(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Median of the ``w > 0`` entries along dim 1: [M, A] -> [M].

    Excluded slots sort to the end behind a dtype-max sentinel (NaN sorts
    after it, as in ``jnp.sort``); a row with no selected entry returns the
    sentinel (callers guard on their own count).
    """
    big = torch.finfo(v.dtype).max
    s = torch.sort(torch.where(w > 0, v, big), dim=1).values
    cnt = torch.sum((w > 0).to(torch.int32), dim=1)
    lo = torch.clamp_min((cnt - 1) // 2, 0)
    hi = torch.clamp_min(cnt // 2, 0)
    take = lambda i: torch.gather(s, 1, i[:, None].long())[:, 0]
    med = 0.5 * (take(lo) + take(hi))
    return torch.where(cnt > 0, med, big)


def _robust_center(x: torch.Tensor, w: torch.Tensor, method: str, trim_frac: float):
    """Robust masked center along the device axis: [M, A, ...] -> [M, ...].

    ``w`` [M, A] selects the contributing slots. "mean" is the masked mean;
    "median"/"trimmed" sort each coordinate with excluded slots pushed to the
    end behind a dtype-max sentinel and read the order statistics. Rows with
    zero contributing slots return sentinel-valued garbage: callers select
    those rows away (see ``robust_local_aggregate``).
    """
    cnt = torch.sum(w, dim=1)  # [M]
    safe = torch.clamp_min(cnt, 1.0)
    tail = (1,) * (x.dim() - 2)
    wb = w.reshape(w.shape + tail).to(x.dtype)
    if method == "mean":
        return (torch.sum(torch.where(wb > 0, x, 0.0), dim=1)
                / safe.reshape((-1,) + tail).to(x.dtype))
    big = torch.finfo(x.dtype).max
    s = torch.sort(torch.where(wb > 0, x, big), dim=1).values
    if method == "median":
        cnt_i = cnt.to(torch.int32)
        index = lambda i: i.long().reshape((-1, 1) + tail).expand((x.shape[0], 1) + x.shape[2:])
        take = lambda i: torch.gather(s, 1, index(i))[:, 0]
        lo = torch.clamp_min((cnt_i - 1) // 2, 0)
        hi = torch.clamp_min(cnt_i // 2, 0)
        return 0.5 * (take(lo) + take(hi))
    if method != "trimmed":
        raise ValueError(f"unknown robust method {method!r}")
    t = torch.minimum(torch.floor(trim_frac * cnt), torch.floor((cnt - 1.0) / 2.0))
    t = torch.clamp_min(t, 0.0)  # cnt = 0 rows: keep the window empty-but-sane
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device).reshape((1, -1) + tail)
    keep = ((pos >= t.reshape((-1, 1) + tail))
            & (pos < (cnt - t).reshape((-1, 1) + tail))).to(x.dtype)
    denom = torch.clamp_min(cnt - 2.0 * t, 1.0).reshape((-1,) + tail).to(x.dtype)
    return torch.sum(s * keep, dim=1) / denom


def robust_local_aggregate(theta2_active, pmask: torch.Tensor, trust: torch.Tensor,
                           method: str = "median", trim_frac: float = 0.1, agg_masks=None):
    """Eq. (1) under screening: [M, A, ...] -> [M, ...].

    ``pmask`` marks the round's real cohort slots, ``trust`` (same shape,
    1.0 = screening accepted every update this slot applied) the surviving
    ones. Per group:

      * screening passed (no real slot flagged) -> the exact
        ``local_aggregate(x, pmask)`` result, selected through
        ``torch.where``: the fault-free path is the masked mean bit for bit;
      * flagged, with survivors -> the robust center over the surviving
        slots (masked mean / coordinate-wise median / trimmed mean);
      * flagged, no survivors -> the masked-mean fallback (the group is
        poisoned either way; its weight is zeroed upstream).

    ``agg_masks`` routes the clean-path mean through the secure-aggregation
    ring. The robust center is computed every call and selected by
    ``torch.where``, where the reference's ``lax.cond`` skips it on clean
    rounds: a branch on ``use_robust`` would copy it to the host (a device
    sync) every exchange.
    """
    w = pmask * trust
    flagged = torch.sum(pmask * (1.0 - trust), dim=1)  # [M] flagged real slots
    cnt = torch.sum(w, dim=1)
    use_robust = (flagged > 0) & (cnt > 0)
    if agg_masks is not None:
        plain = secure_local_aggregate(
            secure_mask_uplink(theta2_active, agg_masks), theta2_active, pmask)
    else:
        plain = local_aggregate(theta2_active, pmask)

    def sel(x_full, x_plain):
        rob = _robust_center(x_full, w, method, trim_frac)
        keep = use_robust.reshape((-1,) + (1,) * (x_plain.dim() - 1))
        return torch.where(keep, rob, x_plain)

    return tree_map(sel, theta2_active, plain)


def global_aggregate(theta, group_weights: torch.Tensor):
    """Eq. (2): weighted mean over groups. [M, ...] -> [...]. Under
    ``group_axis`` the [M] weights are whole and the leaves local: each
    process sums its groups' share and the shares are all-reduced."""
    w = local_rows(group_weights / torch.sum(group_weights))

    def agg(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return group_sum(torch.sum(x * wb, dim=0))

    return tree_map(agg, theta)


def broadcast_to_groups(theta, M: int):
    """Send the global model back to every group. [...] -> [M, ...] (this
    process's M/n under ``group_axis``).

    Materialized (not an expanded view), so each group's copy can be
    updated on its own."""
    M = local_group_count(M)
    return tree_map(lambda x: x.unsqueeze(0).expand((M,) + x.shape).clone(), theta)


def broadcast_to_devices(theta2_group, A: int):
    """Line 15: every sampled device restarts from the aggregated θ2_m."""
    return tree_map(
        lambda x: x.unsqueeze(1).expand((x.shape[0], A) + x.shape[1:]).clone(), theta2_group)


def sample_participants(generator: torch.Generator, fed: FederationConfig,
                        device="cpu") -> torch.Tensor:
    """A_m + ξ_m: per-group device subset (== its samples). [M, A] indices.

    Drawn from ``generator`` (a CPU generator) one group at a time, then
    moved to ``device``. Under ``group_axis`` every process draws all M
    and keeps its own rows, so the draws stay those of one process."""
    M, K, A = fed.num_groups, fed.devices_per_group, fed.sampled_devices
    idx = torch.stack([torch.randperm(K, generator=generator)[:A] for _ in range(M)])
    return local_rows(idx).to(device)


def _fill_value(dtype: torch.dtype):
    """What ``jnp.take`` reads past the end: NaN for floats, the least value
    for signed integers, the largest for unsigned ones, True for bools."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if dtype.is_signed else info.max


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """data: {x1,x2,y,valid} with leading [M, K]; idx: [M, A] -> [M, A, ...].

    As the reference's ``jnp.take``, an index at or past K reads the fill
    value of the leaf's type (``_fill_value``). That happens when a group's
    data holds fewer devices than ``devices_per_group``, among which the
    participants are drawn."""
    idx = idx.long()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    out = {}
    for k, v in data.items():
        K = v.shape[1]
        got = v[rows, idx.clamp(max=K - 1)]
        inside = (idx < K).reshape(idx.shape + (1,) * (got.dim() - 2))
        out[k] = torch.where(inside, got, torch.tensor(_fill_value(v.dtype), dtype=v.dtype,
                                                       device=v.device))
    return out
