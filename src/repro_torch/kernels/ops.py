"""Public wrappers over the kernels for tensors of any rank.

They route by device through ``compress_rows``: the plain version on the
CPU, the CUDA kernel on the card. ``fused_compress`` is
``core/compression.py::compress_message`` (top-k + b-level quantize along
the last axis).
"""
from __future__ import annotations

import torch

from repro_torch.core.compression import compress_message as fused_compress


def topk_sparsify(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Row-wise top-k sparsification of a message tensor (any rank >= 1)."""
    return fused_compress(x, k_frac, levels=0)
