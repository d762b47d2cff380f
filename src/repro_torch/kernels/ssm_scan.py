"""The linear recurrence h_t = a_t ⊙ h_{t−1} + b_t on the card, and its gradient.

``ssm_scan_cuda`` launches the hand-written CUDA kernel in
``csrc/ssm_scan.cu``, the port of the TPU kernel
``repro/kernels/ssm_scan.py::ssm_scan_pallas`` (``_scan_kernel``), counted
under ``launch_counts["ssm_scan"]``. It takes a, b ``[B, T, C]`` (fp32 or
bf16, the same type) and h0 ``[B, C]`` (fp32 or bf16), all contiguous on
one card, and returns every state ``[B, T, C]`` in a's type and the last
``[B, C]`` in h0's type; the arithmetic is fp32. Its outputs carry no
gradient, so under grad mode it refuses inputs that require one: the
autograd route is ``SSMScan``.

``ssm_scan_bwd_cuda`` launches the backward kernel of the same source,
counted under ``launch_counts["ssm_scan_bwd"]``. The reference has no
backward kernel: it differentiates its ``lax.scan`` twin of the kernel
(``repro/models/ssm.py::_chunk_recurrence``) with ``jax.grad``. With g the
gradient of the loss with respect to h_t, counting t from 0 to T−1:

  g_{T−1} = ∂hs_{T−1} + ∂h_last,   g_t = ∂hs_t + a_{t+1}·g_{t+1},
  ∂a_t = g_t·h_{t−1} (h_{−1} = h0),   ∂b_t = g_t,   ∂h0 = a_0·g_0.

It takes fp32 only, the training path's type.

``ssm_scan_ref`` and ``ssm_scan_bwd_ref`` are the plain versions (the first
the port's copy of ``repro/kernels/ref.py::ssm_scan_ref``): loops over t of
a multiply, then an add, on fp32 tensors. ``ssm_scan`` is ``SSMScan``'s
autograd route; forward and backward route by the tensors' device alone:
the plain versions for CPU tensors, the kernels for CUDA tensors, with no
fallback. Meta tensors (shapes only: the FLOP count and the dry run) take
``ssm_scan_meta``/``ssm_scan_bwd_meta``, the plain versions' outputs and
operations in bulk.

Kernels against plain versions on the card: bit-identical (each kernel
rounds every product and every sum apart, as the eager ops do).
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


def ssm_scan_meta(a: torch.Tensor, b: torch.Tensor,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's outputs for meta tensors (a shape, no data):
    every state from one multiply and one add an element, the operations the
    plain version does, in bulk, so a FLOP count or a dry run over meta
    tensors sees them without T steps of dispatch."""
    hs = (a.float() * b.float() + b.float()).to(a.dtype)
    return hs, (hs[:, -1].float() + h0.float()).to(h0.dtype)


def ssm_scan_bwd_meta(a: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor, d_hs: torch.Tensor,
                      d_last: torch.Tensor):
    """The plain backward's outputs for meta tensors, from its three
    operations an element (g = ∂hs + a·g, ∂a = g·h) in bulk."""
    g = a * d_hs + d_hs
    return g * hs, g, (a[:, 0] * g[:, 0] + d_last).to(h0.dtype)


def ssm_scan_bwd_ref(a: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor, d_hs: torch.Tensor,
                     d_last: torch.Tensor):
    """The scan's gradient, walking t from T-1 down to 0 (fp32):
    (∂a [B, T, C], ∂b [B, T, C], ∂h0 [B, C])."""
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    carry = d_last  # the gradient h_t receives from h_{t+1} (and h_last)
    for t in range(a.shape[1] - 1, -1, -1):
        g = d_hs[:, t] + carry
        da[:, t] = g * (hs[:, t - 1] if t else h0)
        db[:, t] = g
        carry = a[:, t] * g
    return da, db, carry


def _check(fn: str, name: str, x: torch.Tensor, shape, device, dtypes=_DTYPES) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, got {name} on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{fn} takes {' or '.join(map(str, dtypes))}, got {name} of {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{fn} takes a contiguous {name} of shape {tuple(shape)}, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, a on {device}")


def _check_rank(fn: str, a: torch.Tensor) -> None:
    if a.dim() != 3:
        raise ValueError(f"{fn} takes a of rank 3 [B, T, C], got {tuple(a.shape)}")
    B, T, C = a.shape
    if B > 65535 or max(T, C) >= 2 ** 31:
        raise ValueError(f"{fn} takes B <= 65535 and T, C < 2^31, got {(B, T, C)}")


def _raise_on(lib, fn: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn} launch failed: {lib.cuda_error_string(err).decode()}")


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: (hs [B, T, C] in a's type, h_last [B, C] in h0's type)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        raise RuntimeError("ssm_scan_cuda's outputs carry no gradient: take the autograd "
                           "route, kernels.ssm_scan.SSMScan (ssm_scan, ops.ssm_scan)")
    _check_rank("ssm_scan_cuda", a)
    B, T, C = a.shape
    _check("ssm_scan_cuda", "a", a, (B, T, C), a.device)
    _check("ssm_scan_cuda", "b", b, (B, T, C), a.device)
    _check("ssm_scan_cuda", "h0", h0, (B, C), a.device)
    if b.dtype != a.dtype:
        raise TypeError(f"ssm_scan_cuda takes a and b of one type, got {a.dtype} and {b.dtype}")
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
    _raise_on(lib, "ssm_scan_fwd", err)
    launch_counts["ssm_scan"] += 1
    return hs, h_last


def ssm_scan_bwd_cuda(a: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor, d_hs: torch.Tensor,
                      d_last: torch.Tensor):
    """The backward kernel, fp32: (∂a [B, T, C], ∂b [B, T, C], ∂h0 [B, C])."""
    _check_rank("ssm_scan_bwd_cuda", a)
    B, T, C = a.shape
    f32 = {torch.float32: 0}
    for name, x, shape in (("a", a, (B, T, C)), ("h0", h0, (B, C)), ("hs", hs, (B, T, C)),
                           ("d_hs", d_hs, (B, T, C)), ("d_last", d_last, (B, C))):
        _check("ssm_scan_bwd_cuda", name, x, shape, a.device, f32)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    d_h0 = torch.empty_like(h0)
    if B == 0 or C == 0:
        return da, db, d_h0
    lib = load("ssm_scan")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ssm_scan_bwd(a.data_ptr(), h0.data_ptr(), hs.data_ptr(), d_hs.data_ptr(),
                               d_last.data_ptr(), da.data_ptr(), db.data_ptr(), d_h0.data_ptr(),
                               B, T, C, stream)
    _raise_on(lib, "ssm_scan_bwd", err)
    launch_counts["ssm_scan_bwd"] += 1
    return da, db, d_h0


class SSMScan(torch.autograd.Function):
    """The scan with its gradient: the plain versions on the CPU, the forward
    and backward kernels on the card. The backward takes fp32 only."""

    @staticmethod
    def forward(ctx, a, b, h0):
        if any(ctx.needs_input_grad) and any(x.dtype != torch.float32 for x in (a, b, h0)):
            raise TypeError(f"the scan's backward takes float32 only, got a {a.dtype}, "
                            f"b {b.dtype}, h0 {h0.dtype} that require grad")
        fwd = {"cpu": ssm_scan_ref, "meta": ssm_scan_meta}.get(a.device.type, ssm_scan_cuda)
        hs, h_last = fwd(a, b, h0)
        ctx.save_for_backward(a, h0, hs)
        ctx.set_materialize_grads(True)  # a missing output gradient is zeros
        return hs, h_last

    @staticmethod
    def backward(ctx, d_hs, d_last):
        a, h0, hs = ctx.saved_tensors
        bwd = {"cpu": ssm_scan_bwd_ref, "meta": ssm_scan_bwd_meta}.get(a.device.type,
                                                                      ssm_scan_bwd_cuda)
        da, db, d_h0 = bwd(a, h0, hs, d_hs.contiguous(), d_last.contiguous())
        need = ctx.needs_input_grad
        return (da if need[0] else None, db if need[1] else None, d_h0 if need[2] else None)


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan through ``SSMScan``: the plain version for a CPU tensor, the
    kernel otherwise, differentiable either way."""
    return SSMScan.apply(a, b, h0)
