"""Message compression for the C-HSGD / C-TDCD baselines (paper §VII-A1).

Top-k sparsification keeps the k largest-magnitude entries of each message
row; b-level quantization snaps the survivors to a uniform grid. The paper
compresses forward *messages*, not gradients, so nothing here needs a
backward.

``compress_rows_ref`` is the plain PyTorch version of the fused kernel in
``kernels/compress.py`` and the path every CPU tensor takes. It runs the op
sequence of ``repro/core/compression.py::compress_rows_ref`` one eager op at
a time, which fixes its rounding: IEEE division, no fused multiply-add in
the dequantize, round-half-to-even. The CUDA kernel reproduces exactly that
sequence, so on the card the two agree bit for bit.

Top-k is a fixed 16-step bisection on the magnitude threshold against the
row max (``count >= k`` keeps ≥ k survivors: the exact top-k support, plus
ties). The legacy sort path (``topk_sparsify_sort``, ``compress_message_sort``)
is the pre-fusion baseline: ``torch.topk`` and a separate quantize.

The optional DP stage (``dp_noise`` given) clips each row to L2 norm
``dp_clip`` and adds ``dp_sigma * dp_clip * dp_noise`` before the top-k, as
``repro/core/compression.py::compress_rows_ref`` does. The row's ‖x‖² is
summed in one fixed order, ``warp_order_sqnorm``, that the CUDA kernel
reproduces with one warp per row; any other order (``torch.sum`` on CUDA
adds in its own) would break bit-identity with the kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

N_REFINE = 16  # threshold tight to max|x| / 2^16
WARP = 32  # lanes of the warp that owns one row in the CUDA kernel


def warp_order_sqnorm(sq: torch.Tensor) -> torch.Tensor:
    """Row sums of ``sq`` [rows, n] (invalid columns already 0) -> [rows, 1],
    added in the CUDA kernel's order.

    Lane ``l`` of the kernel's warp adds columns l, l+32, l+64, ... in
    increasing order; the 32 lane sums are then combined by an xor
    butterfly with offsets 16, 8, 4, 2, 1. Here: pad to a multiple of 32
    columns, add the ``n/32`` slices of 32 in order, then halve (first half
    plus second half) down to one column. Every add is a rounded fp32 add,
    in the same sequence, so CPU, CUDA eager and the kernel agree bit for bit.
    """
    rows, n = sq.shape
    pad = (-n) % WARP
    if pad:
        sq = torch.nn.functional.pad(sq, (0, pad))
    sq = sq.reshape(rows, -1, WARP)
    s = sq[:, 0]
    for j in range(1, sq.shape[1]):
        s = s + sq[:, j]
    width = WARP // 2
    while width:
        s = s[:, :width] + s[:, width:2 * width]
        width //= 2
    return s


def dp_scalar(name: str, v, device) -> torch.Tensor:
    """A DP scalar (clip or σ: a float or a one-element tensor) as a [1, 1]
    fp32 tensor on ``device``; one already there is used without a copy."""
    if v is None:
        raise ValueError(f"the DP stage needs {name} with dp_noise")
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.numel() != 1:
        raise ValueError(f"{name} must hold one value, got {t.numel()}")
    return t.reshape(1, 1)


def compress_rows_ref(
    x: torch.Tensor,
    k: Union[int, torch.Tensor],
    levels: int = 0,
    row_len: Optional[torch.Tensor] = None,
    dp_clip=None,
    dp_sigma=None,
    dp_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused top-k sparsify + b-level quantize over the last axis of ``x``.

    x: [rows, n]. k: scalar or [rows]/[rows,1] per-row keep count (k >= n is
    a per-row no-op). levels <= 1 disables quantization. row_len: optional
    [rows]/[rows,1] valid length for ragged rows — entries at column >=
    row_len are excluded from thresholds/extrema and zeroed in the output.

    DP stage (``dp_noise`` [rows, n] standard normals given): each row is
    scaled by ``min(1, C / max(‖x‖₂, 1e-12))`` and ``(σ·C)·noise`` is added
    before the top-k, with C = ``dp_clip`` and σ = ``dp_sigma`` (floats or
    one-element tensors). With σ = 0 and a large finite C the output equals
    the non-DP output bit for bit.
    """
    if not isinstance(k, int):
        k = torch.as_tensor(k, device=x.device).to(torch.int32).reshape(-1, 1)
    xf = x.float()
    if row_len is None:
        valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    else:
        row_len = torch.as_tensor(row_len, device=x.device).to(torch.int32).reshape(-1, 1)
        valid = torch.arange(x.shape[1], dtype=torch.int32, device=x.device) < row_len
    zero = xf.new_zeros(())
    if dp_noise is not None:
        # C and σ as tensors: CUDA divides by a host scalar through its
        # reciprocal, and the kernel divides in IEEE
        clip = dp_scalar("dp_clip", dp_clip, x.device)
        sigma = dp_scalar("dp_sigma", dp_sigma, x.device)
        nrm2 = warp_order_sqnorm(torch.where(valid, xf * xf, zero))
        # clamp_min / minimum keep NaN, as jnp.maximum / jnp.minimum do
        coef = torch.minimum(torch.ones_like(nrm2),
                             clip / torch.clamp_min(torch.sqrt(nrm2), 1e-12))
        xf = xf * coef + (sigma * clip) * dp_noise.float()
    mag = torch.where(valid, xf.abs(), zero)
    hi = mag.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(N_REFINE):
        # invariant: count(lo) >= k > count(hi); converge on the largest
        # threshold still keeping >= k survivors (count >= k, NOT > k)
        mid = 0.5 * (lo + hi)
        count = ((mag >= mid) & valid).to(torch.int32).sum(dim=-1, keepdim=True)
        ok = count >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    kept = (mag >= lo) & valid  # >= k survivors (exactly k up to ties)
    y = torch.where(kept, xf, zero)
    if levels and levels > 1:
        # grid over the SURVIVORS' value range; pruned entries re-zeroed
        qlo = torch.where(kept, y, math.inf).amin(dim=-1, keepdim=True)
        qhi = torch.where(kept, y, -math.inf).amax(dim=-1, keepdim=True)
        span = torch.clamp_min(qhi - qlo, 1e-12)
        # divide by a tensor, not a Python number: CUDA turns division by a
        # host scalar into multiplication by its reciprocal
        scale = span / torch.full_like(span, levels - 1)
        y = torch.where(kept, torch.round((y - qlo) / scale) * scale + qlo, zero)
    return torch.where(valid, y, zero).to(x.dtype)


def topk_sparsify(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Keep ~round(k_frac * n) largest-|x| entries of each row; zero the rest.

    Operates on the last axis (>= k survivors, exact top-k support kept).
    k_frac >= 1 is a no-op.
    """
    if k_frac >= 1.0:
        return x
    n = x.shape[-1]
    k = max(1, int(round(k_frac * n)))
    return compress_rows_ref(x.reshape(-1, n), k, levels=0).reshape(x.shape)


def topk_exact_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k along the last axis by a sort: ``torch.topk`` on |x|,
    threshold at the k-th largest magnitude, keep every entry ``>=`` it (so
    ties at the threshold all survive). The exact-support target of the
    kernel's threshold refinement (``kernels/ref.py``)."""
    mag = x.abs()
    thresh = torch.topk(mag, k, dim=-1).values[..., -1:]
    return torch.where(mag >= thresh, x, torch.zeros((), dtype=x.dtype, device=x.device))


def topk_sparsify_sort(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """The pre-fusion baseline: exact top-k of ``max(1, round(k_frac * n))``
    entries a row by a sort (``topk_exact_ref``). k_frac >= 1 is a no-op."""
    if k_frac >= 1.0:
        return x
    n = x.shape[-1]
    return topk_exact_ref(x, max(1, int(round(k_frac * n))))


def quantize(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Uniform b-level quantize/dequantize per row (last axis), on a grid
    anchored at zero, so already-sparsified rows stay sparse."""
    if levels <= 1:
        return x
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    scale = span / torch.full_like(span, levels - 1)
    return (torch.round(x / scale) * scale).to(x.dtype)


def compress_message(x: torch.Tensor, k_frac: float, levels: int = 0) -> torch.Tensor:
    """Compress one message tensor (any rank >= 1) along its last axis, as a
    single [rows, n] call through the kernel router."""
    if not (0.0 < k_frac < 1.0) and not (levels and levels > 1):
        return x
    from repro_torch.kernels.compress import compress_rows  # lazy: avoids import cycle

    n = x.shape[-1]
    k = n if not (0.0 < k_frac < 1.0) else max(1, int(round(k_frac * n)))
    return compress_rows(x.reshape(-1, n), k, levels).reshape(x.shape)


def compress_message_sort(x: torch.Tensor, k_frac: float, levels: int = 0) -> torch.Tensor:
    """The pre-fusion path, two library calls and no kernel of the port:
    the sort's top-k (``topk_sparsify_sort``), then a separate ``quantize``.
    Kept as the baseline the fused kernel is measured against."""
    y = topk_sparsify_sort(x, k_frac) if 0.0 < k_frac < 1.0 else x
    if levels and levels > 1:
        y = quantize(y, levels)
    return y


# (k_frac, levels) rungs ordered loosest -> tightest wire size; rung 0 is the
# uncompressed message (the adaptive controller's ladder).
COMPRESSION_LADDER = (
    (0.0, 0),     # uncompressed
    (0.5, 128),   # top-50% + b=128 quantization
    (0.25, 128),  # the paper's C-HSGD operating point (§VII-A1)
    (0.1, 128),
    (0.05, 64),
)

# σ multipliers the privacy governor walks UP (never down within a run) when
# the projected ε would bust the (ε, δ) budget. σ reaches the kernel as a
# device tensor, so a new rung never changes the launch.
DP_SIGMA_LADDER = (1.0, 2.0, 4.0, 8.0)


def compressed_bytes(n_elements: int, k_frac: float, levels: int, dense_bytes_per_el: int = 4) -> float:
    """Wire size of a compressed message.

    top-k: k values + k indices (32-bit); quantization: log2(b) bits/value.
    Matches the paper's 'compression ratio log2(b)/32' accounting.
    """
    k = n_elements if not (0.0 < k_frac < 1.0) else max(1, int(round(k_frac * n_elements)))
    bits_per_val = dense_bytes_per_el * 8
    if levels and levels > 1:
        bits_per_val = max(1, math.ceil(math.log2(levels)))
    value_bytes = k * bits_per_val / 8.0
    index_bytes = 0.0 if k == n_elements else k * 4.0
    return value_bytes + index_bytes
