"""The plain versions of the port's kernels, from one import site.

The port's copy of ``repro/kernels/ref.py``: each kernel's plain version
lives beside its kernel (the fused compression in ``core/compression.py``,
flash attention and the scan in their kernel modules) and is re-exported
here, so kernel tests name one module for every target. ``topk_exact_ref``
is the exact top-k by a sort, the target of the property test that the
compress kernel with ``levels=0`` keeps a superset of the exact support.
"""
from __future__ import annotations

import torch

from repro_torch.core.compression import compress_rows_ref, topk_exact_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["compress_rows_ref", "flash_attention_ref", "ssm_scan_bwd_ref", "ssm_scan_ref",
           "topk_exact_ref", "topk_sparsify_ref"]


def topk_sparsify_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Threshold-refinement top-k: the fused compression with quantization
    off (``topk_sparsify_cuda``'s plain version)."""
    return compress_rows_ref(x, k, levels=0)
