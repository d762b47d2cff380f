"""Hybrid Stochastic Gradient Descent — the paper's Algorithm 1.

Training runs the reference's 3-level loop, eagerly:

  for R global rounds                             (t mod P == 0 events)
    ├─ local agg (eq 1) + global agg (eq 2) + broadcasts (Alg. 1 lines 3–9)
    └─ for Λ = P/Q local intervals                (t mod Q == 0 events)
         ├─ local aggregation (eq 1, lines 10–12)
         ├─ A_m/ξ_m agreement + intermediate-result EXCHANGE (lines 13–21):
         │    ζ1 = h1(θ1; X1ξ), ζ2 = h2(θ2; X2ξ), stale θ0 snapshot
         │    (optionally top-k/quantize compressed — C-HSGD)
         └─ for Q SGD steps (lines 22–26):
              hospital: (θ0,θ1) step with FRESH ζ1, STALE ζ2   (eqs 5–6)
              devices:  θ2_n step with STALE θ0, STALE ζ1      (eq 7)

Only the sampled devices A_m are materialized ([M, A, ...]): unsampled
devices are reset to θ2_m at every local aggregation anyway (line 15).
Per-group and per-device gradients are ``torch.func.vmap`` over
``torch.func.grad``, as the reference vmaps ``jax.grad``.

``HSGDRunner.round_fn`` builds one round per (P, Q, k, b) bucket, as the
reference compiles one executor per bucket; the adaptive controller and the
privacy path (DP noise in the exchange, secure-aggregation masks on eq. (1))
drive it round by round. ``cohort_round_fn`` and ``fault_round_fn`` do the
same for the population runtime's sampled cohorts (one executor per device-
slot bucket A), the latter with seeded faults and the screening defense.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.executors import built
from repro_torch.common.pytree import tree_dot, tree_leaves, tree_map, tree_norm, tree_sub
from repro_torch.core import federation as F
from repro_torch.core.compression import compress_message_sort
from repro_torch.kernels.compress import compress_pytree
from repro_torch.models.split_model import HybridModel
from repro_torch.optim import halving_schedule


class HSGDState(NamedTuple):
    theta0: Any  # [M, ...] combined models
    theta1: Any  # [M, ...] hospital towers
    theta2: Any  # [M, A, ...] sampled-device towers
    stale: Dict[str, Any]  # {"theta0": [M,...], "z1": [M,A,...], "z2": [M,A,...]}
    batch: Dict[str, torch.Tensor]  # gathered ξ_m: x1,x2,y,valid [M,A,...]
    generator: torch.Generator  # CPU generator for the A_m draws
    step: int


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def _placeholder_ctx(model: HybridModel, theta1, theta2, data, M: int, A: int):
    """Placeholder (batch, z1, z2) shaped for A device slots per group.

    Every run exchanges before its first SGD step, so the placeholders are
    overwritten unread; the ζ shapes come from a forward on the meta device
    (no FLOPs), as the reference uses ``eval_shape``.
    """
    device = data["x1"].device
    batch = F.gather_batch(data, torch.zeros((M, A), dtype=torch.long, device=device))
    meta = lambda t: t.to("meta")
    z1 = _h1_groups(model, tree_map(meta, theta1), meta(batch["x1"]))
    z2 = _h2_groups(model, tree_map(meta, F.local_aggregate(theta2)), meta(batch["x2"]))
    zeros = lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device)
    return batch, zeros(z1), zeros(z2)


def init_state(generator: torch.Generator, model: HybridModel, fed: FederationConfig,
               data, params=None, dtype=torch.float32) -> HSGDState:
    """All groups start from the same global model (Alg. 1 line 1).

    ``params`` (a {theta0, theta1, theta2} dict) replaces the draw from
    ``generator``, e.g. to start from the reference's initial model;
    ``generator`` then drives only the A_m sampling.
    """
    device = data["x1"].device
    if params is None:
        params = model.init(generator, dtype, device)
    M, A = fed.num_groups, fed.sampled_devices
    theta0 = F.broadcast_to_groups(params["theta0"], M)
    theta1 = F.broadcast_to_groups(params["theta1"], M)
    theta2 = F.broadcast_to_devices(F.broadcast_to_groups(params["theta2"], M), A)
    batch, z1, z2 = _placeholder_ctx(model, theta1, theta2, data, M, A)
    stale = {"theta0": tree_map(torch.clone, theta0), "z1": z1, "z2": z2}
    return HSGDState(theta0, theta1, theta2, stale, batch, generator, 0)


def resize_cohort(state: HSGDState, model: HybridModel, data, A_new: int) -> HSGDState:
    """Re-bucket the device-slot axis A between rounds ([M, A, ...] -> [M, A_new, ...]).

    Valid only at a round boundary, where every cohort round has already
    checked its device towers back in (θ2 slots uniform: the round ends with
    θ2 ← broadcast(masked eq. (1))), so collapsing the slot axis by eq. (1)
    and re-broadcasting is exact. The stale/batch placeholders are re-shaped
    as ``init_state`` shapes them; the next round's first exchange overwrites
    them unread.
    """
    M, A = tree_leaves(state.theta2)[0].shape[:2]
    if A == A_new:
        return state
    theta2 = F.broadcast_to_devices(F.local_aggregate(state.theta2), A_new)
    batch, z1, z2 = _placeholder_ctx(model, state.theta1, theta2, data, M, A_new)
    stale = {"theta0": state.stale["theta0"], "z1": z1, "z2": z2}
    return state._replace(theta2=theta2, stale=stale, batch=batch)


# ---------------------------------------------------------------------------
# Forward helpers (vmapped over groups / devices)
# ---------------------------------------------------------------------------


def _h1_groups(model, theta1, x1):
    """[M,...]θ1 × [M,A,...]x1 -> ζ1 [M,A,...]."""
    return vmap(model.h1)(theta1, x1)


def _h2_groups(model, theta2_group, x2):
    """[M,...]θ2_m × [M,A,...]x2 -> ζ2 [M,A,...] (device outputs from θ2_m)."""
    return vmap(model.h2)(theta2_group, x2)


# ---------------------------------------------------------------------------
# The three gradient rules (eqs. (5)–(7))
# ---------------------------------------------------------------------------


def _hospital_loss(model, theta0_m, theta1_m, batch_m, stale_z2_m):
    """Group-level loss with fresh ζ1(θ1), stale ζ2 — drives eqs. (5)(6)."""
    z1 = model.h1(theta1_m, batch_m["x1"])
    return model.loss(theta0_m, z1, stale_z2_m.detach(), batch_m["y"])


def _device_loss(model, theta2_n, x2_n, y_n, stale_theta0_m, stale_z1_n):
    """Per-device loss with stale θ0, stale ζ1, fresh ζ2(θ2_n) — eq. (7)."""
    z2 = model.h2(theta2_n, x2_n[None])
    return model.loss(
        tree_map(torch.Tensor.detach, stale_theta0_m),
        stale_z1_n[None].detach(),
        z2,
        y_n[None],
    )


def _local_grads(model: HybridModel, state: HSGDState):
    """Per-worker gradients of lines 22–26: (losses [M], g0 [M,...], g1 [M,...],
    g2 [M,A,...])."""
    h_grads = vmap(grad_and_value(partial(_hospital_loss, model), argnums=(0, 1)))
    (g0, g1), losses = h_grads(state.theta0, state.theta1, state.batch, state.stale["z2"])
    per_device = vmap(grad(partial(_device_loss, model)), in_dims=(0, 0, 0, None, 0))
    g2 = vmap(per_device)(  # over groups
        state.theta2, state.batch["x2"], state.batch["y"], state.stale["theta0"], state.stale["z1"]
    )
    return losses, g0, g1, g2


def _apply_sgd(state: HSGDState, lr: float, g0, g1, g2) -> HSGDState:
    upd = lambda p, g: p - lr * g.to(p.dtype)
    return state._replace(
        theta0=tree_map(upd, state.theta0, g0),
        theta1=tree_map(upd, state.theta1, g1),
        theta2=tree_map(upd, state.theta2, g2),
        step=state.step + 1,
    )


def local_sgd_step(model: HybridModel, state: HSGDState, lr: float) -> Tuple[HSGDState, torch.Tensor]:
    """One iteration of lines 22–26 for every group and sampled device."""
    losses, g0, g1, g2 = _local_grads(model, state)
    return _apply_sgd(state, lr, g0, g1, g2), F.group_mean(losses)


def _worker_dev2(g, gbar, lead: int):
    """Σ_leaves ||g_worker − ḡ||² per worker: [M, ...]→[M] (lead=1) or
    [M, A, ...]→[M, A] (lead=2)."""
    per = tree_map(
        lambda x, m: torch.sum((x - m.reshape((1,) * lead + tuple(m.shape))) ** 2,
                               dim=tuple(range(lead, x.dim()))), g, gbar)
    return sum(tree_leaves(per))


def local_sgd_step_stats(
    model: HybridModel, state: HSGDState, lr: float, group_weights
) -> Tuple[HSGDState, torch.Tensor, Dict[str, Any]]:
    """``local_sgd_step`` + the §VI-B online probe statistics, reusing the
    step's own gradients (no extra forward/backward passes):

      gbar    — the global-gradient proxy ∇F(θ̃): weighted group mean of
                (g0, g1) and of the device means of g2 (eqs. (1)/(2) applied
                to gradients instead of parameters);
      gnorm2  — ‖gbar‖² (strategy 3's ‖∇F‖² input);
      delta2  — mean squared deviation of per-worker gradients around gbar
                (Assumption 2's δ² estimator).
    """
    losses, g0, g1, g2 = _local_grads(model, state)
    gbar = {
        "theta0": F.global_aggregate(g0, group_weights),
        "theta1": F.global_aggregate(g1, group_weights),
        "theta2": F.global_aggregate(F.local_aggregate(g2), group_weights),
    }
    gnorm2 = tree_dot(gbar, gbar)
    delta2 = (
        F.group_mean(_worker_dev2(g0, gbar["theta0"], 1) + _worker_dev2(g1, gbar["theta1"], 1))
        + F.group_mean(_worker_dev2(g2, gbar["theta2"], 2))
    )
    new_state = _apply_sgd(state, lr, g0, g1, g2)
    return new_state, F.group_mean(losses), {"gbar": gbar, "gnorm2": gnorm2, "delta2": delta2}


# ---------------------------------------------------------------------------
# Fault injection + screening (the fault-tolerant step)
# ---------------------------------------------------------------------------


def _select_fault(x: torch.Tensor, fault: torch.Tensor, op) -> torch.Tensor:
    """``op(x, f)`` where the per-worker fault term f (broadcast from its
    leading axes) is nonzero, else x itself. Selected with ``torch.where``,
    never computed as a blanket ``x + 0``: adding 0.0 turns -0.0 into +0.0,
    and a clean worker must come out bit for bit. NaN terms select the
    faulty branch (NaN != 0)."""
    f = fault.reshape(tuple(fault.shape) + (1,) * (x.dim() - fault.dim())).to(x.dtype)
    return torch.where(f != 0, op(x, f), x)


def _inject_grads(g2, grad_fault: torch.Tensor):
    """Add the per-device fault term where nonzero: [M, A] -> every g2 leaf.

    The reference puts the injection behind a ``lax.cond`` on any nonzero
    term; here it is always the select, which returns g2's values on clean
    rounds without a host sync."""
    return tree_map(lambda g: _select_fault(g, grad_fault, torch.add), g2)


def local_sgd_step_guarded(
    model: HybridModel,
    state: HSGDState,
    lr: float,
    pmask: torch.Tensor,
    grad_fault: Optional[torch.Tensor] = None,
    screen: bool = False,
    zmax: float = 8.0,
) -> Tuple[HSGDState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``local_sgd_step`` with optional fault injection and screening.

    Screening is ``torch.where`` masking (no host syncs), and with every mask
    all-ones the applied update is bit-identical to the unguarded step. Per
    step it zeroes:

      * device updates whose g2 is non-finite, or whose gradient sq-norm
        exceeds ``zmax² ×`` the group's masked median device sq-norm
        (floored by the fleet-wide median: a per-group cut alone falsely
        flags the one device that still has signal once its peers converge);
      * group (θ0, θ1) updates whose hospital gradient is non-finite, or,
        with ≥ 3 groups, an outlier against the cross-group median norm.

    Returns (state, loss, dev_ok [M, A], grp_ok [M]); the reported loss
    averages only unflagged groups when any group is flagged.
    """
    losses, g0, g1, g2 = _local_grads(model, state)
    if grad_fault is not None:
        g2 = _inject_grads(g2, grad_fault)
    M = pmask.shape[0]
    if not screen:
        dev_ok = torch.ones(pmask.shape, dtype=torch.float32, device=pmask.device)
        grp_ok = torch.ones((M,), dtype=torch.float32, device=pmask.device)
        return _apply_sgd(state, lr, g0, g1, g2), torch.mean(losses), dev_ok, grp_ok

    dn2 = F.worker_sqnorm(g2, lead=2)  # [M, A]
    finite_d = torch.isfinite(dn2)
    real = pmask * finite_d
    med = F.masked_median_values(dn2, real)  # [M]
    fleet = F.masked_median_values(dn2.reshape(1, -1), real.reshape(1, -1))[0]
    cut = (zmax * zmax) * torch.clamp_min(torch.maximum(med, fleet), 1e-30)
    dev_ok = (finite_d & (dn2 <= cut[:, None])).float()

    hn2 = F.worker_sqnorm(g0, lead=1) + F.worker_sqnorm(g1, lead=1)  # [M]
    grp_fin = torch.isfinite(hn2)
    if M >= 3:  # the cross-group outlier cut needs a meaningful median
        gmed = F.masked_median_values(hn2[None, :], grp_fin[None, :].float())[0]
        gcut = (zmax * zmax) * torch.clamp_min(torch.maximum(gmed, fleet), 1e-30)
        grp_fin = grp_fin & (hn2 <= gcut)
    grp_ok = grp_fin.float()

    def masked(g, ok):
        return torch.where(ok.reshape(tuple(ok.shape) + (1,) * (g.dim() - ok.dim())) > 0, g, 0.0)

    g0 = tree_map(lambda g: masked(g, grp_ok), g0)
    g1 = tree_map(lambda g: masked(g, grp_ok), g1)
    g2 = tree_map(lambda g: masked(g, dev_ok), g2)

    n_ok = torch.sum(grp_ok)
    # where, not a multiply: a flagged group's NaN loss must not poison the sum
    loss_ok = torch.sum(torch.where(grp_ok > 0, losses, 0.0)) / torch.clamp_min(n_ok, 1.0)
    loss = torch.where(n_ok == M, torch.mean(losses), loss_ok)
    return _apply_sgd(state, lr, g0, g1, g2), loss, dev_ok, grp_ok


# ---------------------------------------------------------------------------
# Exchange + aggregations
# ---------------------------------------------------------------------------


def exchange(
    model: HybridModel,
    state: HSGDState,
    data,
    fed: FederationConfig,
    compression_k: float = 0.0,
    quant_levels: int = 0,
    fused: bool = True,
    idx: Optional[torch.Tensor] = None,
    pmask: Optional[torch.Tensor] = None,
    trust: Optional[torch.Tensor] = None,
    msg_fault: Optional[torch.Tensor] = None,
    screen: bool = False,
    dp_clip=None,
    dp_sigma=None,
    dp_noise: Optional[torch.Tensor] = None,
    dp_generator: Optional[torch.Generator] = None,
    agg_masks=None,
) -> HSGDState:
    """Local aggregation (eq 1) + A_m/ξ_m agreement + ζ/θ0 exchange.

    With compression on, the whole exchange message (θ0 snapshot tree + ζ1
    + ζ2) is compressed in ONE fused top-k+quantize row-matrix call: the
    CUDA kernel on the card, its plain version on the CPU. ``fused=False``
    takes the pre-fusion path instead, leaf by leaf: ``torch.topk``'s exact
    top-k, then a separate quantize (``compress_message_sort``), kept as the
    baseline the fused kernel is measured against. It has no DP stage and
    raises when ``dp_clip`` is given.

    ``idx`` ([M, A] data-row indices) pins the participants instead of
    drawing them from the state's generator. The cohort path (see
    ``core/population.py``) passes the round's cohort as ``idx`` (padded to
    the bucket size by repeating real members) with ``pmask`` ([M, A], 0 on
    padding slots), which eq. (1) excludes.

    The fault-tolerant path adds three legs, all ``torch.where`` selections
    so the clean case is the plain path bit for bit: ``trust`` ([M, A], 1.0 =
    the slot's updates passed screening) switches eq. (1) to
    ``robust_local_aggregate`` per ``fed.robust_agg``; ``msg_fault`` ([M],
    0 = clean) multiplies the group's compressed ζ2 uplink (bit-flip
    corruption); ``screen`` zeroes non-finite ζ2 entries at the receiver.

    Privacy legs: ``dp_clip`` (with ``dp_sigma``) runs the message through
    the fused per-row clip + Gaussian-noise stage, with the noise rows drawn
    from ``dp_generator`` or handed in as ``dp_noise``; ``agg_masks`` (a
    round's int32 tree from ``F.secure_agg_masks``) routes eq. (1) through
    the secure-aggregation ring, where the masks cancel exactly. Under a
    group axis the DP noise is the whole message's, and each process keeps
    its groups' rows (``compress_pytree(shard=)``).
    """
    device = data["x1"].device
    dp = dp_clip is not None
    if dp and not fused:
        raise ValueError("DP is fused into the batched compression kernel; the legacy "
                         "sort path does not support dp_clip/dp_sigma")
    if trust is not None and pmask is not None:  # eq (1) under screening
        theta2_group = F.robust_local_aggregate(
            state.theta2, pmask, trust, method=fed.robust_agg, trim_frac=fed.trim_frac,
            agg_masks=agg_masks)
    elif agg_masks is not None:  # eq (1) over masked uplinks
        theta2_group = F.secure_local_aggregate(
            F.secure_mask_uplink(state.theta2, agg_masks), state.theta2, pmask)
    else:
        theta2_group = F.local_aggregate(state.theta2, pmask)  # eq (1)
    A = fed.sampled_devices if idx is None else idx.shape[1]
    theta2 = F.broadcast_to_devices(theta2_group, A)  # line 15

    if idx is None:
        idx = F.sample_participants(state.generator, fed)  # line 13
    batch = F.gather_batch(data, idx.to(device))

    z1 = _h1_groups(model, state.theta1, batch["x1"])
    z2 = _h2_groups(model, theta2_group, batch["x2"])
    stale_theta0 = state.theta0

    if compression_k or quant_levels or dp:
        msg = {"theta0": stale_theta0, "z1": z1, "z2": z2}
        if not fused:
            msg = tree_map(lambda x: compress_message_sort(x, compression_k or 1.0, quant_levels),
                           msg)
        else:
            dp_kw = {}
            if dp:
                if dp_noise is None and dp_generator is None:
                    raise ValueError("the DP exchange needs dp_noise or a dp_generator")
                axis = F.active_group_axis()
                dp_kw = dict(dp_clip=dp_clip, dp_sigma=dp_sigma, dp_noise=dp_noise,
                             dp_generator=dp_generator,
                             shard=None if axis is None else (axis.rank, axis.size))
            msg = compress_pytree(msg, compression_k or 1.0, quant_levels, **dp_kw)
        stale_theta0, z1, z2 = msg["theta0"], msg["z1"], msg["z2"]

    if msg_fault is not None:  # corruption hits the compressed uplink payload
        z2 = tree_map(lambda x: _select_fault(x, msg_fault, torch.mul), z2)
    if screen:  # receiver-side screen: drop (zero) non-finite ζ2 entries.
        # Only the device uplink needs it: the fault model corrupts ζ2 in
        # flight, while θ0/ζ1 come from hospital state that the per-step
        # group screen keeps finite.
        z2 = tree_map(lambda x: torch.where(torch.isfinite(x), x, 0.0), z2)

    stale = {"theta0": stale_theta0, "z1": z1, "z2": z2}
    return state._replace(theta2=theta2, stale=stale, batch=batch)


def global_aggregation(state: HSGDState, fed: FederationConfig, group_weights) -> HSGDState:
    """Eq. (2) + broadcasts (Alg. 1 lines 3–9).

    The device-slot count is read off the state, so the cohort path, whose
    slot axis is the current bucket size, reuses this unchanged. Slots are
    uniform at round boundaries (check-in), so the unmasked eq. (1) here is
    exact."""
    M = fed.num_groups
    A = tree_leaves(state.theta2)[0].shape[1]
    theta2_group = F.local_aggregate(state.theta2)
    g0 = F.global_aggregate(state.theta0, group_weights)
    g1 = F.global_aggregate(state.theta1, group_weights)
    g2 = F.global_aggregate(theta2_group, group_weights)
    return state._replace(
        theta0=F.broadcast_to_groups(g0, M),
        theta1=F.broadcast_to_groups(g1, M),
        theta2=F.broadcast_to_devices(F.broadcast_to_groups(g2, M), A),
    )


def global_model(state: HSGDState, group_weights, mesh=None) -> Dict[str, Any]:
    """The observable global model θ̃ (eq. (2)).

    With the ``mesh`` a group-sharded run took, eq. (2)'s weighted sum is
    all-reduced over its group axis, so every process returns the same
    global model; the state may hold all M groups or this process's M/n (a
    sharded run's returned state)."""
    M = len(group_weights)
    with F.group_axis(None if mesh is None else F.mesh_group_axis(mesh, M)):
        return {
            "theta0": F.global_aggregate(_group_rows(state.theta0, M), group_weights),
            "theta1": F.global_aggregate(_group_rows(state.theta1, M), group_weights),
            "theta2": F.global_aggregate(F.local_aggregate(_group_rows(state.theta2, M)),
                                         group_weights),
        }


def _group_rows(tree, M: int):
    """This process's groups of every [M, ...] leaf (``F.local_rows``)."""
    return tree_map(lambda x: F.local_rows(x, M), tree)


# ---------------------------------------------------------------------------
# Training run
# ---------------------------------------------------------------------------


def _global_grad_zeros(state: HSGDState):
    """Zero template shaped like the global-gradient proxy (one model copy)."""
    return {
        "theta0": tree_map(lambda x: torch.zeros_like(x[0]), state.theta0),
        "theta1": tree_map(lambda x: torch.zeros_like(x[0]), state.theta1),
        "theta2": tree_map(lambda x: torch.zeros_like(x[0, 0]), state.theta2),
    }


def state_shardings(state: HSGDState, mesh, rules=None) -> HSGDState:
    """Per-leaf specs of an HSGDState on ``mesh``: the leading group axis M
    rides the mesh's horizontal ("data"/"pod") axes via the logical "group"
    rule; the generator and step stay replicated (None). Non-divisible
    leaves fall back to replication, so a trivial mesh degrades to the
    single-device layout."""
    from repro_torch.common.sharding import group_sharding

    grouped = lambda tree: tree_map(lambda x: group_sharding(tuple(x.shape), mesh, rules), tree)
    return HSGDState(grouped(state.theta0), grouped(state.theta1), grouped(state.theta2),
                     grouped(state.stale), grouped(state.batch), None, None)


def place_on_mesh(state: HSGDState, data, group_weights, mesh):
    """(state, data, weights, axis) for ``mesh``: with a ``GroupAxis`` (a
    mesh whose horizontal dimensions hold more than one process and divide
    M), every [M, ...] leaf of the state and the data is cut to this
    process's groups, and the [M] weights stay whole; otherwise all are
    returned as they are, with axis None. A leaf that already holds this
    process's M/n groups (a state a sharded run returned) stays as it is,
    as ``jax.device_put`` leaves an array already placed."""
    M = len(group_weights)
    axis = None if mesh is None else F.mesh_group_axis(mesh, M)
    if axis is None:
        return state, data, group_weights, None
    with F.group_axis(axis):
        rows = lambda tree: _group_rows(tree, M)
        state = state._replace(theta0=rows(state.theta0), theta1=rows(state.theta1),
                               theta2=rows(state.theta2), stale=rows(state.stale),
                               batch=rows(state.batch))
        data = rows(data)
    return state, data, group_weights, axis


# Second word of the DP noise seed (``SeedSequence([seed, DP_NOISE_STREAM])``),
# so the noise generator never shares a stream with the A_m generator.
DP_NOISE_STREAM = 5


def dp_noise_generator(seed: int, device) -> torch.Generator:
    """The generator a private run draws its DP noise rows from: on
    ``device`` (the data's), seeded from the run's ``seed`` through
    ``SeedSequence([seed, DP_NOISE_STREAM])``, apart from the A_m stream."""
    word = np.random.SeedSequence([seed, DP_NOISE_STREAM]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


@dataclass(frozen=True)
class HSGDRunner:
    """HSGD trainer for a (model, federation, train) configuration.

    ``run`` executes whole fixed-interval runs. ``round_fn`` hands out one
    round per (P, Q, k, b, collect[, dp, secure_agg]) bucket, cached in
    ``_round_cache`` as the reference caches its compiled executors (the
    cache's size is what the launcher reports as ``executors_compiled``);
    the adaptive controller and ``run_private`` drive rounds through it.
    """

    model: HybridModel
    fed: FederationConfig
    train: TrainConfig
    do_global_agg: bool = True  # False reproduces TDCD's missing phase
    fused_compression: bool = True  # False keeps the pre-fusion sort path
    # bucket key -> round executor
    _round_cache: Dict = field(default_factory=dict, compare=False, repr=False)

    def run(self, state: HSGDState, data, group_weights, rounds: int,
            participants: Optional[torch.Tensor] = None, mesh=None):
        """Execute ``rounds`` global rounds; returns (state, per-step losses).

        Each round: global aggregation, then Λ × (exchange, Q SGD steps),
        through the (P, Q, k, b) bucket's executor (``round_fn``), built once
        a runner. ``participants`` ([rounds·Λ, M, A]) pins every exchange's
        A_m, as ``exchange(idx=)`` does. The caller's ``state`` is consumed — this
        may update it in place, as the reference donates it — so rebind the
        returned state. Losses stay on the state's device, one per step.

        A ``mesh`` (a ``DeviceMesh``, one process per card) whose horizontal
        dimensions divide M shards the group axis over them
        (``place_on_mesh``): each process runs its M/n groups, the
        cross-group reductions of eq. (2) and the loss means are collectives,
        and the returned state holds this process's groups: a second
        ``run(mesh=)`` takes it as it is, and ``global_model(state, w, mesh)``
        reads the global model from it. The losses are every process's. Any
        other mesh leaves the run as it is.
        """
        fed, train = self.fed, self.train
        if participants is not None and participants.shape[0] != rounds * fed.lam:
            raise ValueError(f"participants holds {participants.shape[0]} draws; "
                             f"{rounds} rounds need rounds·Λ = {rounds * fed.lam}")
        state, data, group_weights, axis = place_on_mesh(state, data, group_weights, mesh)
        lr_fn = halving_schedule(train.learning_rate, train.lr_halve_every)
        fn = self.round_fn(fed.local_interval * fed.lam, fed.local_interval, collect_stats=False)
        losses = []
        with F.group_axis(axis):
            if participants is not None:
                participants = torch.stack([F.local_rows(p) for p in participants])
            for r in range(rounds):
                part = (None if participants is None
                        else participants[r * fed.lam:(r + 1) * fed.lam])
                state, loss = fn(state, data, group_weights, lr_fn, participants=part)
                losses.append(loss)
        out = torch.cat(losses) if losses else torch.zeros(0, device=data["x1"].device)
        return state, out

    def _round_impl(self, state: HSGDState, data, group_weights, lr: Callable[[int], float],
                    Q: int, lam: int, compression_k: float, quant_levels: int,
                    collect: bool, participants=None, dp_clip=None, dp_sigma=None,
                    dp_noise=None, dp_generator=None, agg_masks=None, pmask=None):
        """One global round: global aggregation, then Λ × (exchange, Q steps).

        With ``collect`` every step also returns the §VI-B probe stats; ρ
        secants pair consecutive steps *within* an interval only (same batch
        ⇒ a clean Lipschitz quotient), so Q = 1 rounds yield no ρ samples.
        ``pmask`` ([M, A]) marks a cohort round's real device slots.
        """
        fed, model = self.fed, self.model
        if self.do_global_agg:
            state = global_aggregation(state, fed, group_weights)
        stats = {k: [] for k in ("loss", "gnorm2", "delta2", "rho", "rho_ok")}
        for i in range(lam):
            state = exchange(
                model, state, data, fed, compression_k, quant_levels, self.fused_compression,
                idx=None if participants is None else participants[i],
                dp_clip=dp_clip, dp_sigma=dp_sigma,
                dp_noise=None if dp_noise is None else dp_noise[i],
                dp_generator=dp_generator, agg_masks=agg_masks, pmask=pmask)
            if not collect:
                for _ in range(Q):
                    state, loss = local_sgd_step(model, state, lr(state.step))
                    stats["loss"].append(loss)
                continue
            prev_g, prev_ok = _global_grad_zeros(state), False
            for _ in range(Q):
                lr_t = lr(state.step)
                state, loss, aux = local_sgd_step_stats(model, state, lr_t, group_weights)
                if prev_ok:
                    diff = tree_norm(tree_sub(aux["gbar"], prev_g))
                    rho = diff / torch.clamp_min(lr_t * tree_norm(prev_g), 1e-12)
                else:
                    rho = torch.zeros((), device=loss.device)
                stats["loss"].append(loss)
                stats["gnorm2"].append(aux["gnorm2"])
                stats["delta2"].append(aux["delta2"])
                stats["rho"].append(rho)
                stats["rho_ok"].append(torch.full((), 1.0 if prev_ok else 0.0,
                                                  device=loss.device))
                prev_g, prev_ok = aux["gbar"], True
        if not collect:
            return state, torch.stack(stats["loss"])
        return state, {k: torch.stack(v) for k, v in stats.items()}

    def _cached(self, key, name: str, build: Callable[[], Callable]) -> Callable:
        """The executor of bucket ``key``, built by ``build`` on a miss and
        reported as ``name`` on the executor log. The sort path's buckets
        carry one more word, so the two paths never share an executor."""
        if not self.fused_compression:
            key = key + ("sort",)
        fn = self._round_cache.get(key)
        if fn is None:
            fn = self._round_cache[key] = build()
            built(name, key)
        return fn

    def _bucket(self, P: int, Q: int, compression_k: Optional[float],
                quant_levels: Optional[int], cohort_size: int = 1) -> Tuple[float, int]:
        """Check a round's (P, Q[, cohort size]) and resolve its (k, b),
        ``None`` taking the training config's."""
        if P < 1 or Q < 1 or P % Q:
            raise ValueError(f"P={P} must be a positive multiple of Q={Q}")
        if cohort_size < 1:
            raise ValueError(f"cohort_size={cohort_size} must be >= 1")
        k = self.train.compression_k if compression_k is None else compression_k
        b = self.train.quantization_bits if quant_levels is None else quant_levels
        return k, b

    def round_fn(self, P: int, Q: int, compression_k: Optional[float] = None,
                 quant_levels: Optional[int] = None, collect_stats: bool = True,
                 dp: bool = False, secure_agg: bool = False):
        """The single-round executor of a (P, Q, compression) bucket.

        fn(state, data, group_weights, lr, dp_clip=None, dp_sigma=None,
        agg_masks=None, participants=None, dp_noise=None, dp_generator=None)
        -> (state, stats) with stats a dict of [P] per-step tensors
        (loss/gnorm2/delta2/rho/rho_ok) when ``collect_stats``, else (state,
        losses [P]). ``lr`` is η for the whole round (rounded to fp32 as the
        reference's traced scalar is) or a step -> η schedule. Consumes
        ``state`` like ``run``.

        ``dp``/``secure_agg`` extend the cache key by one bit each, as in the
        reference; clip, σ and the masks are per-call operands, so a new σ
        (the controller's DP governor) or re-keyed masks reuse the entry.
        With ``dp`` the call takes ``dp_clip``, ``dp_sigma`` and either a
        ``dp_generator`` or ``dp_noise`` (one matrix per exchange); with
        ``secure_agg`` it takes ``agg_masks``. ``participants`` ([Λ, M, A])
        pins the round's draws.
        """
        k, b = self._bucket(P, Q, compression_k, quant_levels)
        key = (P, Q, k, b, collect_stats)
        if dp or secure_agg:
            key = key + (dp, secure_agg)
        lam = P // Q

        def build():

            def hsgd_round(state, data, group_weights, lr, dp_clip=None, dp_sigma=None,
                           agg_masks=None, participants=None, dp_noise=None, dp_generator=None):
                if dp and dp_clip is None:
                    raise ValueError("a dp round needs dp_clip and dp_sigma")
                if secure_agg and agg_masks is None:
                    raise ValueError("a secure_agg round needs agg_masks")
                if participants is not None and len(participants) != lam:
                    raise ValueError(f"participants holds {len(participants)} draws; "
                                     f"a round needs Λ = {lam}")
                return self._round_impl(
                    state, data, group_weights, _lr_of(lr), Q, lam, k, b, collect_stats,
                    participants=participants,
                    dp_clip=dp_clip if dp else None, dp_sigma=dp_sigma if dp else None,
                    dp_noise=dp_noise if dp else None,
                    dp_generator=dp_generator if dp else None,
                    agg_masks=agg_masks if secure_agg else None)

            return hsgd_round

        return self._cached(key, "hsgd_private_round" if dp or secure_agg else "hsgd_round",
                            build)

    def cohort_round_fn(self, P: int, Q: int, cohort_size: int,
                        compression_k: Optional[float] = None,
                        quant_levels: Optional[int] = None,
                        collect_stats: bool = True):
        """The round executor over a sampled cohort of device slots.

        fn(state, data, group_weights, lr, participants, pmask) -> (state,
        stats|losses). ``participants`` [M, cohort_size] are the round's data
        rows (padded to the power-of-two bucket by repeating real members),
        ``pmask`` [M, cohort_size] is 1 on real slots; both, and the [M]
        ``group_weights``, may be numpy arrays (the population scheduler's)
        or tensors. The state's device axis must already equal
        ``cohort_size`` (see ``resize_cohort``).

        The round ends with a check-in, θ2 ← broadcast(masked eq. (1)), so
        device slots leave the round uniform: padding slots never leak into
        the next round and re-bucketing between rounds stays exact.

        Cached per (P, Q, cohort_size, k, b, collect) bucket, the reference's
        key: a population run whose cohort sizes vary builds one executor per
        bucket.
        """
        k, b = self._bucket(P, Q, compression_k, quant_levels, cohort_size)
        key = (P, Q, cohort_size, k, b, collect_stats)
        lam = P // Q

        def build():
            def hsgd_cohort_round(state, data, group_weights, lr, participants, pmask):
                idx, pmask, w = _cohort_operands(data, participants, pmask, group_weights)
                state, out = self._round_impl(
                    state, data, w, _lr_of(lr), Q, lam, k, b, collect_stats,
                    participants=[idx] * lam, pmask=pmask)
                theta2_group = F.local_aggregate(state.theta2, pmask)
                state = state._replace(theta2=F.broadcast_to_devices(theta2_group, cohort_size))
                return state, out

            return hsgd_cohort_round

        return self._cached(key, "hsgd_cohort_round", build)

    def _guarded_round_impl(self, state, data, group_weights, lr: Callable[[int], float],
                            Q: int, lam: int, k: float, b: int, idx, pmask,
                            grad_fault, msg_fault, screen: bool):
        """Cohort round with fault injection and (optionally) the defense:
        per-step screening masks, receiver-side message screening, and the
        ``fed.robust_agg`` aggregation over surviving slots. With all fault
        terms zero and screening on, every mask stays all-ones and the
        parameters (and losses) are bit-identical to the cohort round's."""
        fed, model = self.fed, self.model
        if self.do_global_agg:
            state = global_aggregation(state, fed, group_weights)
        trust = torch.ones_like(pmask)
        losses = []
        for _ in range(lam):
            state = exchange(model, state, data, fed, k, b, self.fused_compression,
                             idx=idx, pmask=pmask,
                             trust=trust if screen else None, msg_fault=msg_fault,
                             screen=screen)
            for _ in range(Q):
                state, loss, dev_ok, _ = local_sgd_step_guarded(
                    model, state, lr(state.step), pmask, grad_fault=grad_fault,
                    screen=screen, zmax=fed.screen_zmax)
                # sticky within the round: a flagged device stays out of every
                # later aggregation (x1.0 is the identity on clean rounds)
                trust = trust * dev_ok
                losses.append(loss)
        # check-in: device slots leave the round uniform (robust under screen)
        if screen:
            theta2_group = F.robust_local_aggregate(
                state.theta2, pmask, trust, method=fed.robust_agg, trim_frac=fed.trim_frac)
        else:
            theta2_group = F.local_aggregate(state.theta2, pmask)
        state = state._replace(theta2=F.broadcast_to_devices(theta2_group, pmask.shape[1]))
        flagged = torch.sum(pmask * (1.0 - trust))
        return state, torch.stack(losses), flagged

    def fault_round_fn(self, P: int, Q: int, cohort_size: int,
                       compression_k: Optional[float] = None,
                       quant_levels: Optional[int] = None,
                       robust: bool = True):
        """The fault-injectable round executor (the resilient runtime's).

        fn(state, data, group_weights, lr, participants, pmask, grad_fault,
        msg_fault) -> (state, losses [P], flagged). ``grad_fault`` [M, A] and
        ``msg_fault`` [M] are per-call operands (0 = clean), so re-drawing
        faults each round reuses the executor. ``robust=True`` folds the
        defense in (screening masks + ``fed.robust_agg`` aggregation);
        ``robust=False`` is the naive stack: the same injection, no defense.
        ``flagged`` (a 0-d tensor) counts real slot-updates the screen
        rejected (always 0 on the naive path).

        Cached per (P, Q, cohort_size, k, b, "robust"|"faulty") beside the
        plain executors, the reference's keys.
        """
        k, b = self._bucket(P, Q, compression_k, quant_levels, cohort_size)
        key = (P, Q, cohort_size, k, b, "robust" if robust else "faulty")
        lam = P // Q

        def build():
            def hsgd_fault_round(state, data, group_weights, lr, participants, pmask,
                                 grad_fault, msg_fault):
                idx, pmask, w = _cohort_operands(data, participants, pmask, group_weights)
                dev = data["x1"].device
                return self._guarded_round_impl(
                    state, data, w, _lr_of(lr), Q, lam, k, b, idx, pmask,
                    torch.as_tensor(grad_fault, dtype=torch.float32, device=dev),
                    torch.as_tensor(msg_fault, dtype=torch.float32, device=dev), screen=robust)

            return hsgd_fault_round

        return self._cached(key, "hsgd_robust_round" if robust else "hsgd_faulty_round", build)

    def run_private(self, state: HSGDState, data, group_weights, rounds: int,
                    seed: int = 0, dp_clip: float = 0.0, dp_sigma: float = 0.0,
                    secure_agg: bool = False,
                    participants: Optional[torch.Tensor] = None,
                    dp_noise: Optional[Sequence[torch.Tensor]] = None):
        """Fixed-interval run with the privacy legs on.

        A round loop over one ``round_fn`` bucket: the secure-aggregation
        masks are drawn on the host (numpy, stream 4) and re-keyed every
        round; DP noise rows come from ``dp_noise_generator(seed)`` on the
        data's device. η follows the halving schedule sampled at each round's
        first step, once per round, as the reference's traced scalar does.
        ``participants`` ([rounds·Λ, M, A]) and ``dp_noise`` (one matrix per
        exchange) replace the draws, e.g. with the reference's.

        Returns (state, per-step losses [rounds * P]).
        """
        dp = dp_clip > 0.0
        if dp_sigma > 0.0 and not dp:
            raise ValueError("dp_sigma > 0 requires a positive dp_clip")
        fed = self.fed
        Q, lam = fed.local_interval, fed.lam
        P = Q * lam
        for name, draws in (("participants", participants), ("dp_noise", dp_noise)):
            if draws is not None and len(draws) != rounds * lam:
                raise ValueError(f"{name} holds {len(draws)} draws; {rounds} rounds "
                                 f"need rounds·Λ = {rounds * lam}")
        fn = self.round_fn(P, Q, collect_stats=False, dp=dp, secure_agg=secure_agg)
        lr_fn = halving_schedule(self.train.learning_rate, self.train.lr_halve_every)
        device = data["x1"].device
        kwargs: Dict[str, Any] = {}
        if dp:
            kwargs["dp_clip"] = torch.tensor(dp_clip, dtype=torch.float32, device=device)
            kwargs["dp_sigma"] = torch.tensor(dp_sigma, dtype=torch.float32, device=device)
            if dp_noise is None:
                kwargs["dp_generator"] = dp_noise_generator(seed, device)
        losses, step = [], 0
        for r in range(rounds):
            part = slice(r * lam, (r + 1) * lam)
            if secure_agg:
                kwargs["agg_masks"] = F.secure_agg_masks(state.theta2, seed, r)
            state, loss = fn(state, data, group_weights, lr_fn(step),
                             participants=None if participants is None else participants[part],
                             dp_noise=None if dp_noise is None else dp_noise[part], **kwargs)
            losses.append(loss)
            step += P
        out = torch.cat(losses) if losses else torch.zeros(0, device=device)
        return state, out


def _lr_of(lr) -> Callable[[int], float]:
    """A step -> η schedule: ``lr`` itself if callable, else η for the whole
    round, rounded to fp32 as the reference's traced scalar is."""
    if callable(lr):
        return lr
    eta = float(np.float32(lr))
    return lambda step: eta


def _cohort_operands(data, participants, pmask, group_weights):
    """A cohort round's (idx, pmask, weights) as tensors on the data's
    device: the scheduler hands numpy arrays."""
    dev = data["x1"].device
    return (torch.as_tensor(participants, device=dev).long(),
            torch.as_tensor(pmask, dtype=torch.float32, device=dev),
            torch.as_tensor(group_weights, dtype=torch.float32, device=dev))


def make_group_weights(data) -> torch.Tensor:
    """K_m weights from the per-group valid-sample counts."""
    return torch.sum(data["valid"].float(), dim=1)


# checkpoint restores return a real HSGDState, not an anonymous namedtuple
from repro_torch.checkpoint.ckpt import register_state_class as _register_state_class  # noqa: E402

_register_state_class(HSGDState)
