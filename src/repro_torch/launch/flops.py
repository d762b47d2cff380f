"""Analytic FLOP counting of a program run on meta tensors
(``repro/launch/flops.py``).

The reference walks a jaxpr and scales every ``scan`` body by its static
length, because XLA's cost analysis counts a nested loop's body once. The
port's loops are Python loops: running the program under a
``TorchDispatchMode`` sees every iteration's ops, so no trip-count scaling
is needed, and on meta tensors no arithmetic is done.

The rules are the reference's:
  * a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...) costs
    2·B·M·N·K;
  * a convolution costs 2·|out|·prod(kernel[:-1]) (the kernel without its
    output-channel axis: I/groups · kH · kW);
  * an op of the reference's ``ELEMENTWISE`` set (add, mul, exp, tanh,
    select, clamp, ...) costs 1 per output element;
  * an op of its ``REDUCTIONS`` set (sums, maxima, cumulative sums,
    argmax, ...) costs 1 per input element.

Ops the reference's tracer decomposes (softmax, log-softmax, SiLU, GELU,
logsumexp, mean, ...) are charged as that decomposition is. The count is
GLOBAL: divide by the number of cards for a per-device term.
"""
from __future__ import annotations

from math import prod
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# aten ops of the reference's ELEMENTWISE set (and the fused ones it sees
# decomposed) -> operations an output element
_ATEN_ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1, "minimum": 1,
    "exp": 1, "exp2": 1, "log": 1, "tanh": 1, "sigmoid": 1, "rsqrt": 1, "sqrt": 1,
    "pow": 1, "neg": 1, "abs": 1, "sign": 1, "floor": 1, "cos": 1, "sin": 1,
    "erf": 1, "expm1": 1, "log1p": 1, "where": 1, "clamp": 1, "clamp_min": 1,
    "clamp_max": 1, "nextafter": 1, "reciprocal": 1, "square": 1, "masked_fill": 1,
    "softplus": 4,  # log1p(exp(x)) behind a select on the threshold
    "silu": 2,  # x · logistic(x)
    "gelu": 8,  # the tanh approximation: x, x³, tanh, 1 +, ·, ·
    "_softmax": 3,  # (x - max), exp, / sum
    "_log_softmax": 3,  # (x - max), exp ... log, subtract
    "lerp": 3,
}
# aten ops of the reference's REDUCTIONS set -> operations an input element
_ATEN_REDUCTIONS = {
    "sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1, "prod": 1,
    "cumsum": 1, "cumprod": 1, "argmax": 1, "argmin": 1,
    "logsumexp": 2,  # max, then sum of exp
    "_softmax": 2, "_log_softmax": 2,  # max, sum
}
_MEAN_DIVIDES = {"mean"}  # reduce_sum + a div over the output

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm"}
_CONVS = {"convolution", "_convolution"}


class FlopCount(NamedTuple):
    matmul: int  # matmuls and convolutions
    total: int  # plus the elementwise and reduction terms


def _numel(x) -> int:
    return int(prod(x.shape)) if isinstance(x, torch.Tensor) else 1


def _matmul_flops(name, args) -> int:
    if name in ("mm", "addmm", "_scaled_mm"):
        a, b = (args[1], args[2]) if name == "addmm" else (args[0], args[1])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[1], args[2]) if name in ("baddbmm", "addbmm") else (args[0], args[1])
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(args, out) -> int:
    w = args[1]
    return 2 * _numel(out) * int(prod(w.shape[1:]))


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of the ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.matmul = 0
        self.other = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__.rstrip("_")
        if name in _MATMULS:
            self.matmul += _matmul_flops(name, args)
            if name in ("addmm", "baddbmm", "addbmm"):
                self.other += _numel(out)  # the bias add
        elif name in _CONVS:
            self.matmul += _conv_flops(args, out)
        else:
            first = out[0] if isinstance(out, (tuple, list)) else out
            if name in ("max", "min") and func._overloadname == "other":
                name = "maximum"  # the binary form is elementwise
            if name in _ATEN_ELEMENTWISE:
                self.other += _ATEN_ELEMENTWISE[name] * _numel(first)
            if name in _ATEN_REDUCTIONS and args and isinstance(args[0], torch.Tensor):
                self.other += _ATEN_REDUCTIONS[name] * _numel(args[0])
                if name in _MEAN_DIVIDES:
                    self.other += _numel(first)
        return out

    @property
    def count(self) -> FlopCount:
        return FlopCount(self.matmul, self.matmul + self.other)


def traced_flops(fn, *example_args) -> FlopCount:
    """Global analytic FLOPs of ``fn`` on ``example_args`` (trees of
    tensors, meta tensors for a full-width program): (matmul and
    convolution term, total)."""
    with FlopCounter() as counter:
        fn(*example_args)
    return counter.count
