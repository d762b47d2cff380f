"""Row-wise top-k magnitude sparsification — the fused compression kernel
of ``kernels/compress.py`` with quantization off."""
from __future__ import annotations

import functools

from repro_torch.kernels.compress import fused_compress

# x: [rows, n] fp32 on the card, k -> sparsified x (>= k survivors per row).
topk_sparsify_cuda = functools.partial(fused_compress, levels=0)
