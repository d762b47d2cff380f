"""Public wrappers over the kernels for tensors of any rank.

They route by device: the plain version on the CPU, the CUDA kernel on the
card. ``fused_compress`` is ``core/compression.py::compress_message``
(top-k + b-level quantize along the last axis); ``flash_attention`` takes
``[B, S, H, D]`` and folds the heads into rows for
``kernels/flash_attention.py``; ``ssm_scan`` takes ``[B, T, ...]`` and folds
the trailing dims into channels for ``kernels/ssm_scan.py``'s autograd route
``SSMScan`` (the forward and backward kernels on the card);
``mamba1_discretize`` builds a Mamba-1 chunk's a = exp(dt·A) and
b = (dt·x)·B through ``kernels/mamba1_discretize.py`` (its autograd route
``Mamba1Discretize`` on the card, the plain chain otherwise).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.compression import compress_message as fused_compress
from repro_torch.kernels.flash_attention import flash_attention as _flash_rows
from repro_torch.kernels.mamba1_discretize import mamba1_discretize  # noqa: F401
from repro_torch.kernels.ssm_scan import ssm_scan as _scan_channels


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


def ssm_scan(a, b, h0):
    """Linear recurrence for [B, T, ...] a/b with state [B, ...]: any trailing
    dims are folded into channels."""
    B, T = a.shape[:2]
    trail = tuple(a.shape[2:])
    C = math.prod(trail)
    hs, h_last = _scan_channels(a.reshape(B, T, C).contiguous(),
                                b.reshape(B, T, C).contiguous(), h0.reshape(B, C).contiguous())
    return hs.reshape((B, T) + trail), h_last.reshape((B,) + trail)
