"""Mamba-1's discretization of one chunk, a = exp(dt·A) and b = (dt·x)·B,
on the card, and its gradient.

``mamba1_discretize_cuda`` launches ``csrc/mamba1_discretize.cu``'s forward
kernel, counted under ``launch_counts["mamba1_discretize"]``: from dt, x
``[B, K, d]``, B ``[B, K, N]`` (fp32, any strides) and A ``[d, N]`` it
writes a and b ``[B, K, d, N]`` once. ``mamba1_discretize_bwd_cuda``
launches the backward kernel (``launch_counts["mamba1_discretize_bwd"]``)
and the kernel that adds its per-block partial sums
(``launch_counts["mamba1_discretize_sum"]``): from ∂a and ∂b it gives

  ∂dt = Σₙ (∂a·a)·A + (Σₙ ∂b·B)·x,   ∂x = (Σₙ ∂b·B)·dt,
  ∂B = Σ_d ∂b·(dt·x),                 ∂A = Σ_{b,k} (∂a·a)·dt,

recomputing a from dt and A. No TPU kernel is replaced: the reference
builds a and b in ``jax.numpy`` (``repro/models/ssm.py::mamba1_forward``)
and differentiates them with ``jax.grad``.

``mamba1_discretize_ref`` is the plain version, the eager chain the layer
ran before the kernels, op for op; autograd differentiates it.
``mamba1_discretize`` routes: a CUDA tensor takes the autograd route
``Mamba1Discretize`` (both kernels), a CPU or meta tensor the plain chain,
so CPU numbers and the FLOP count over meta tensors are the chain's.

Kernels against the chain on the card: a and b bit-identical (each product
rounded apart, the same ``expf``); the gradients differ only in the order
of their sums.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.common.spans import span
from repro_torch.kernels import launch_counts
from repro_torch.kernels.build import load

SPAN = "mamba1.discretize"
_THREADS = 256
_MAX_SHARED = 48 * 1024


def mamba1_discretize_ref(dt, x, Bm, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """a = exp(dt·A) and b = (dt·x)·B [B, K, d, N] from dt, x [B, K, d],
    B [B, K, N], A [d, N]: the eager chain."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    return a, b


def _layout(n: int, *big: torch.Tensor) -> Tuple[int, int]:
    """(V, log2 G): V floats a thread, the widest of 4, 2, 1 that divides N
    and keeps the large tensors' accesses aligned; G = N / V lanes a row,
    rounded up to a power of two, at most 32."""
    vec = next(v for v in (4, 2, 1)
               if n % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in big))
    lanes = -(-n // vec)
    g_log2 = (lanes - 1).bit_length()
    if g_log2 > 5:
        raise ValueError(f"the discretize kernels take N up to 32 lanes of {vec} floats, got N {n}")
    return vec, g_log2


def _bwd_steps(n: int) -> int:
    """Time steps a backward block walks: 16 (on an H100 at the training
    chunk [2, 256, 8192, 16], 0.232 ms against 0.235 at 8 and 0.241 at 32),
    fewer where the block's [8, steps, N] floats of shared memory would pass
    48 KB."""
    return max(1, min(16, _MAX_SHARED // (4 * (_THREADS // 32) * n)))


def _strides(dt, x, Bm):
    return (ctypes.c_longlong * 9)(*dt.stride(), *x.stride(), *Bm.stride())


def _check(fn: str, dt, x, Bm, A) -> Tuple[int, int, int, int]:
    tensors = {"dt": dt, "x": x, "B": Bm, "A": A}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dt.device:
            raise ValueError(f"{fn} runs on CUDA tensors on one card, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn} takes float32, got {name} of {t.dtype}")
    if dt.dim() != 3 or tuple(x.shape) != tuple(dt.shape):
        raise ValueError(f"{fn} takes dt, x of one shape [B, K, d], got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}")
    B, K, d = dt.shape
    N = A.shape[-1]
    if tuple(Bm.shape) != (B, K, N) or tuple(A.shape) != (d, N) or not A.is_contiguous():
        raise ValueError(f"{fn} takes B [{B}, {K}, N] and a contiguous A [{d}, N], got "
                         f"{tuple(Bm.shape)}, {tuple(A.shape)} strides {A.stride()}")
    if not 0 < B <= 65535 or K >= 2 ** 31 or B * K * d * N >= 2 ** 62:
        raise ValueError(f"{fn} takes 0 < B <= 65535, got {(B, K, d, N)}")
    return B, K, d, N


def _raise_on(lib, fn: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn} launch failed: {lib.cuda_error_string(err).decode()}")


def mamba1_discretize_cuda(dt, x, Bm, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (a, b) [B, K, d, N], contiguous."""
    B, K, d, N = _check("mamba1_discretize_cuda", dt, x, Bm, A)
    a = torch.empty((B, K, d, N), dtype=torch.float32, device=dt.device)
    b = torch.empty_like(a)
    if K == 0 or d == 0 or N == 0:
        return a, b
    vec, g_log2 = _layout(N, a, b)
    lib = load("mamba1_discretize")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.mamba1_discretize_fwd(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), A.data_ptr(),
                                        a.data_ptr(), b.data_ptr(), B, K, d, N, vec, g_log2,
                                        _strides(dt, x, Bm), stream)
    _raise_on(lib, "mamba1_discretize_fwd", err)
    launch_counts["mamba1_discretize"] += 1
    return a, b


def mamba1_discretize_bwd_cuda(d_a, d_b, dt, x, Bm, A):
    """The backward kernel and the sums of its partials: (∂dt, ∂x [B, K, d],
    ∂B [B, K, N], ∂A [d, N]), contiguous."""
    B, K, d, N = _check("mamba1_discretize_bwd_cuda", dt, x, Bm, A)
    for name, g in (("d_a", d_a), ("d_b", d_b)):
        if (g.device != dt.device or g.dtype != torch.float32 or tuple(g.shape) != (B, K, d, N)
                or not g.is_contiguous()):
            raise ValueError(f"mamba1_discretize_bwd_cuda takes a contiguous float32 {name} "
                             f"[{B}, {K}, {d}, {N}] on {dt.device}, got {g.dtype} "
                             f"{tuple(g.shape)} strides {g.stride()} on {g.device}")
    d_dt = torch.empty((B, K, d), dtype=torch.float32, device=dt.device)
    d_x = torch.empty_like(d_dt)
    d_B = torch.empty((B, K, N), dtype=torch.float32, device=dt.device)
    d_A = torch.empty((d, N), dtype=torch.float32, device=dt.device)
    if K == 0 or d == 0 or N == 0:
        return d_dt, d_x, d_B.zero_(), d_A.zero_()
    vec, g_log2 = _layout(N, d_a, d_b)
    steps = _bwd_steps(N)
    tiles = -(-d // (_THREADS >> g_log2))
    part_a = torch.empty((B * -(-K // steps), d, N), dtype=torch.float32, device=dt.device)
    part_b = torch.empty((tiles, B, K, N), dtype=torch.float32, device=dt.device)
    lib = load("mamba1_discretize")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.mamba1_discretize_bwd(d_a.data_ptr(), d_b.data_ptr(), dt.data_ptr(),
                                        x.data_ptr(), Bm.data_ptr(), A.data_ptr(),
                                        d_dt.data_ptr(), d_x.data_ptr(), d_A.data_ptr(),
                                        d_B.data_ptr(), part_a.data_ptr(), part_b.data_ptr(),
                                        B, K, d, N, vec, g_log2, steps,
                                        _strides(dt, x, Bm), stream)
    _raise_on(lib, "mamba1_discretize_bwd", err)
    launch_counts["mamba1_discretize_bwd"] += 1
    launch_counts["mamba1_discretize_sum"] += 1
    return d_dt, d_x, d_B, d_A


class Mamba1Discretize(torch.autograd.Function):
    """a, b from dt, x, B, A with their gradient, both kernels on the card.
    Saves the small inputs alone: the backward recomputes a."""

    @staticmethod
    def forward(ctx, dt, x, Bm, A):
        a, b = mamba1_discretize_cuda(dt, x, Bm, A)
        ctx.save_for_backward(dt, x, Bm, A)
        return a, b

    @staticmethod
    def backward(ctx, d_a, d_b):
        with span(SPAN):
            grads = mamba1_discretize_bwd_cuda(d_a.contiguous(), d_b.contiguous(),
                                               *ctx.saved_tensors)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def mamba1_discretize(dt, x, Bm, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [B, K, d, N]: the kernels for CUDA tensors, the plain chain for
    CPU and meta tensors; differentiable either way."""
    if dt.device.type == "cuda":
        return Mamba1Discretize.apply(dt, x, Bm, A)
    return mamba1_discretize_ref(dt, x, Bm, A)
