"""C-HSGD's message compression in plain PyTorch: top-k sparsification and
b-level quantization of every row of a message leaf (paper §VII-A1).

A row is a leaf's trailing axis. The row keeps the entries whose magnitude
is at least a threshold found by a fixed 16-step bisection between 0 and
the row's largest magnitude, converging on the largest threshold that keeps
k = max(1, round(k_frac * n)) entries or more (the top-k, and any entry
tied with it within max|x| / 2^16). With ``levels`` > 1 the survivors are
snapped to a uniform grid of ``levels`` points over their own range and
every other entry is 0.

Rows are independent, so a leaf is compressed in blocks of rows and the
whole message leaf by leaf.
"""
from __future__ import annotations

import math

import torch

BISECTION_STEPS = 16
BLOCK_ELEMENTS = 1 << 26  # rows are compressed in blocks of about this many floats


def keep_count(k_frac: float, n: int) -> int:
    return max(1, int(round(k_frac * n))) if 0.0 < k_frac < 1.0 else n


def compress_rows(x: torch.Tensor, k: int, levels: int) -> torch.Tensor:
    """x [rows, n] fp32 -> the compressed rows."""
    mag = x.abs()
    hi = mag.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        ok = (mag >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    kept = mag >= lo
    zero = x.new_zeros(())
    y = torch.where(kept, x, zero)
    if levels > 1:
        qlo = torch.where(kept, x, math.inf).amin(dim=-1, keepdim=True)
        qhi = torch.where(kept, x, -math.inf).amax(dim=-1, keepdim=True)
        span = torch.clamp_min(qhi - qlo, 1e-12)
        step = span / torch.full_like(span, levels - 1)
        y = torch.where(kept, torch.round((y - qlo) / step) * step + qlo, zero)
    return y


def compress_leaf(x: torch.Tensor, k_frac: float, levels: int) -> torch.Tensor:
    """A message leaf compressed row by row (rows of its trailing axis)."""
    n = int(x.shape[-1]) if x.dim() else 1
    rows = x.reshape(-1, n)
    k = keep_count(k_frac, n)
    block = max(1, BLOCK_ELEMENTS // n)
    out = torch.empty_like(rows)
    for i in range(0, rows.shape[0], block):
        out[i:i + block] = compress_rows(rows[i:i + block], k, levels)
    return out.reshape(x.shape)
