"""Int8 row-quantization for decode caches (``repro/models/quant.py``).

Symmetric per-row int8: one f32 scale per cache row, codes = round(x /
scale) with scale = amax(|row|) / 127. ``torch.round`` rounds half to even,
as ``jnp.round`` does. Both divisions are by tensors, so the card divides
as the CPU does (CUDA turns a division by a host scalar into a reciprocal
multiply).
"""
from __future__ import annotations

import torch

QMAX = 127.0
# floor on the per-row scale: rows of exact zeros (virgin cache) quantize to
# zero codes / zero scale and dequantize back to exact zeros
SCALE_EPS = 1e-30


def is_int8(x) -> bool:
    """True for the int8 dtype and int8 tensors (cache-leaf dispatch)."""
    return getattr(x, "dtype", x) == torch.int8


def quantize_rows(x):
    """[..., D] -> (codes int8 [..., D], scale f32 [...]) per-row symmetric."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = amax / torch.full_like(amax, QMAX)
    codes = torch.round(xf / torch.clamp_min(scale, SCALE_EPS)[..., None])
    return codes.to(torch.int8), scale


def dequantize_rows(codes, scale, dtype=torch.float32):
    """(codes int8 [..., D], scale f32 [...]) -> values [..., D]."""
    return (codes.float() * scale[..., None]).to(dtype)
