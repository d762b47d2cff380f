"""Causal flash attention with a runtime sliding window on the card.

``flash_attention_cuda`` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu``, the port of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``
(``_flash_kernel``), counted under ``launch_counts["flash_attention"]``.
It takes q, k, v ``[BH, S, D]`` (KV heads already repeated to the query
heads), fp32 or bf16, contiguous, D in {32, 64, 128, 256}, and returns the
attention output in q's dtype. The window is a runtime ``int``: ≤ 0 is full
causal attention.

``flash_attention_ref`` is the plain version (the port's copy of
``repro/kernels/ref.py::flash_attention_ref``): dense fp32 scores, the
causal and window mask, softmax, then ``@ v``. ``flash_attention`` routes
by the tensors' device alone: the plain version for CPU tensors, the kernel
for CUDA tensors, with no fallback.

Kernel against plain version on the card: within 2e-5 + 2e-5·|plain| in
fp32 and 2e-2 in bf16, the JAX package's own tolerances for its kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.build import load

NEG_INF = -2.0e38
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, window: int = 0) -> torch.Tensor:
    """Naive attention: q, k, v [BH, S, D], causal (+ optional sliding window)."""
    BH, S, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    pos = torch.arange(S, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > (pos[:, None] - window)
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _check(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda runs on CUDA tensors, got {name} on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, got {name} of {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"flash_attention_cuda takes a contiguous [BH, S, D] {name}, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.shape != like.shape or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on {x.device} does not match "
                         f"q {tuple(like.shape)} {like.dtype} on {like.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None, window: int = 0) -> torch.Tensor:
    """The CUDA kernel: q, k, v [BH, S, D] on the card -> [BH, S, D] in q's dtype."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q)
    BH, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head_dim in {HEAD_DIMS}, got {D}")
    if BH > 65535:
        raise ValueError(f"flash_attention_cuda takes at most 65535 rows of heads, got {BH}")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    lib = load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      BH, S, D, scale, int(window), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.cuda_error_string(err).decode()}")
    launch_counts["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, window: int = 0) -> torch.Tensor:
    """Router: the plain version for a CPU tensor, the kernel otherwise."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, window)
    return flash_attention_cuda(q, k, v, scale, window)
