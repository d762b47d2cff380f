"""The linear recurrence h_t = a_t ⊙ h_{t−1} + b_t on the card.

``ssm_scan_cuda`` launches the hand-written CUDA kernel in
``csrc/ssm_scan.cu``, the port of the TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan_pallas`` (``_scan_kernel``), counted
under ``launch_counts["ssm_scan"]``. It takes a, b ``[B, T, C]`` (fp32 or
bf16, the same type) and h0 ``[B, C]`` (fp32 or bf16), all contiguous on
one card, and returns every state ``[B, T, C]`` in a's type and the last
``[B, C]`` in h0's type; the arithmetic is fp32.

``ssm_scan_ref`` is the plain version (the port's copy of
``repro/kernels/ref.py::ssm_scan_ref``): a loop over t of a multiply, then
an add, on fp32 tensors. ``ssm_scan`` routes by the tensors' device alone:
the plain version for CPU tensors, the kernel for CUDA tensors, with no
fallback.

Kernel against plain version on the card: bit-identical (the kernel rounds
the product and then the sum, as the two eager ops do).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.build import load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential linear recurrence h_t = a_t*h_{t-1} + b_t; a, b [B, T, C]."""
    h = h0.float()
    hs = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs[:, t] = h
    return hs, h.to(h0.dtype)


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_cuda runs on CUDA tensors, got {name} on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan_cuda takes float32 or bfloat16, got {name} of {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"ssm_scan_cuda takes a contiguous {name} of shape {tuple(shape)}, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, a on {device}")


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: (hs [B, T, C] in a's type, h_last [B, C] in h0's type)."""
    if a.dim() != 3:
        raise ValueError(f"ssm_scan_cuda takes a of rank 3 [B, T, C], got {tuple(a.shape)}")
    B, T, C = a.shape
    _check("a", a, (B, T, C), a.device)
    _check("b", b, (B, T, C), a.device)
    _check("h0", h0, (B, C), a.device)
    if b.dtype != a.dtype:
        raise TypeError(f"ssm_scan_cuda takes a and b of one type, got {a.dtype} and {b.dtype}")
    if B > 65535 or max(T, C) >= 2 ** 31:
        raise ValueError(f"ssm_scan_cuda takes B <= 65535 and T, C < 2^31, got {(B, T, C)}")
    hs = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if B == 0 or C == 0:
        return hs, h_last
    lib = load("ssm_scan")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ssm_scan_fwd(a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
                               h_last.data_ptr(), B, T, C, _DTYPES[a.dtype], _DTYPES[h0.dtype],
                               stream)
    if err:
        raise RuntimeError(f"ssm_scan_fwd launch failed: {lib.cuda_error_string(err).decode()}")
    launch_counts["ssm_scan"] += 1
    return hs, h_last


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: the plain version for a CPU tensor, the kernel otherwise."""
    if a.device.type == "cpu":
        return ssm_scan_ref(a, b, h0)
    return ssm_scan_cuda(a, b, h0)
