"""Public wrappers over the kernels for tensors of any rank.

They route by device: the plain version on the CPU, the CUDA kernel on the
card. ``fused_compress`` is ``core/compression.py::compress_message``
(top-k + b-level quantize along the last axis); ``flash_attention`` takes
``[B, S, H, D]`` and folds the heads into rows for
``kernels/flash_attention.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.compression import compress_message as fused_compress
from repro_torch.kernels.flash_attention import flash_attention as _flash_rows


def topk_sparsify(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Row-wise top-k sparsification of a message tensor (any rank >= 1)."""
    return fused_compress(x, k_frac, levels=0)


def flash_attention(q, k, v, scale=None, window: int = 0):
    """q, k, v: [B, S, H, D] (KV heads already repeated to H). Causal.

    ``window`` is a runtime int (≤ 0 = full causal): the kernel takes it as
    an argument, so a per-layer window never rebuilds it.
    """
    B, S, H, D = q.shape
    qf = q.transpose(1, 2).reshape(B * H, S, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * H, S, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * H, S, D).contiguous()
    out = _flash_rows(qf, kf, vf, scale=scale, window=window)
    return out.reshape(B, H, S, D).transpose(1, 2)
