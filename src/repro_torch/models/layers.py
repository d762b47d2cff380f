"""Core layer primitives + the Spec param-declaration system.

Every layer declares its parameters once as a nested dict of ``Spec``s
(shape, logical axes, initializer); ``init_params`` turns that into a dict
of tensors. Apply functions are plain functions over the params dict.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros (ones | embed: LLM layers, not ported yet)
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def init_params(specs, generator: torch.Generator, dtype=torch.float32, device="cpu"):
    """Initialize a tree of Specs into tensors on ``device``.

    Draws come from ``generator`` (a CPU generator, so the values do not
    depend on the device) in sorted-key leaf order, as the reference splits
    its key per leaf.
    """
    leaves, treedef = tree_flatten(specs)
    out = []
    for spec in leaves:
        if spec.init == "zeros":
            arr = torch.zeros(spec.shape, dtype=torch.float32)
        elif spec.init == "normal":  # truncated-normal fan-in scaled (lecun)
            s = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
            arr = torch.nn.init.trunc_normal_(
                torch.empty(spec.shape), 0.0, 1.0, -2.0, 2.0, generator=generator) * s
        else:  # "ones"/"embed" belong to the LLM layers, a later slice
            raise ValueError(f"init {spec.init!r} is not ported yet")
        out.append(arr.to(device=device, dtype=dtype))
    return tree_unflatten(treedef, out)


def dense(params, x):
    """``...d, df -> ...f``."""
    return torch.matmul(x, params["w"].to(x.dtype))


def dense_specs(d_in: int, d_out: int, axes: Tuple[Optional[str], Optional[str]], scale=None):
    return {"w": Spec((d_in, d_out), axes, "normal", scale)}
