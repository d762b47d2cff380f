"""Core layer primitives + the Spec param-declaration system.

Every layer declares its parameters once as a nested dict of ``Spec``s
(shape, logical axes, initializer); ``init_params`` turns that into a dict
of tensors. Apply functions are plain functions over the params dict.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.pytree import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def init_params(specs, generator: torch.Generator, dtype=torch.float32, device="cpu"):
    """Initialize a tree of Specs into tensors on ``device``.

    Draws come from ``generator`` in sorted-key leaf order, as the reference
    splits its key per leaf, and are made on the generator's device: a CPU
    generator gives the same values whatever ``device`` is, a CUDA one
    draws a full-width model on the card without holding it on the host.
    """
    leaves, treedef = tree_flatten(specs)
    gdev = generator.device
    out = []
    for spec in leaves:
        if spec.init == "zeros":
            arr = torch.zeros(spec.shape, dtype=torch.float32, device=gdev)
        elif spec.init == "ones":
            arr = torch.ones(spec.shape, dtype=torch.float32, device=gdev)
        elif spec.init == "embed":
            s = spec.scale if spec.scale is not None else 1.0
            arr = torch.randn(spec.shape, generator=generator, device=gdev).mul_(s)
        elif spec.init == "normal":  # truncated-normal fan-in scaled (lecun)
            s = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
            arr = torch.nn.init.trunc_normal_(torch.empty(spec.shape, device=gdev), 0.0, 1.0,
                                              -2.0, 2.0, generator=generator).mul_(s)
        else:
            raise ValueError(f"unknown init {spec.init!r}")
        out.append(arr.to(device=device, dtype=dtype))
    return tree_unflatten(treedef, out)


def abstract_params(specs, dtype=torch.float32):
    """The tree of Specs as meta tensors of ``dtype`` (the reference's
    ``ShapeDtypeStruct``s)."""
    leaves, treedef = tree_flatten(specs)
    return tree_unflatten(treedef, [torch.empty(s.shape, dtype=dtype, device="meta")
                                    for s in leaves])


def axes_tree(specs):
    """The tree of Specs' logical axes."""
    leaves, treedef = tree_flatten(specs)
    return tree_unflatten(treedef, [s.axes for s in leaves])


def dense(params, x):
    """``...d, df -> ...f``."""
    return torch.matmul(x, params["w"].to(x.dtype))


def dense_specs(d_in: int, d_out: int, axes: Tuple[Optional[str], Optional[str]], scale=None):
    return {"w": Spec((d_in, d_out), axes, "normal", scale)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> Dict[str, Spec]:
    return {"scale": Spec((d,), ("embed",), "ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def layernorm_specs(d: int) -> Dict[str, Spec]:
    return {"scale": Spec((d,), ("embed",), "ones"), "bias": Spec((d,), ("embed",), "zeros")}


def layernorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def norm_specs(kind: str, d: int):
    return rmsnorm_specs(d) if kind == "rmsnorm" else layernorm_specs(d)


def apply_norm(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_specs(vocab: int, d: int):
    return {"table": Spec((vocab, d), ("vocab", None), "embed", 0.02)}


def embed(params, ids):
    return params["table"][ids]


def unembed(params, x):
    """Tied-embedding readout: ``...d, vd -> ...v``."""
    return torch.matmul(x, params["table"].to(x.dtype).t())


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def squared_relu(x):
    r = F.relu(x)
    return r * r


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": gelu,
    "silu": F.silu,
    "relu": F.relu,
    "squared_relu": squared_relu,
}


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_frequencies(head_dim: int, theta: float, device: str):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    return freqs.to(device)


def rope_frequencies(head_dim: int, theta: float, device=None):
    """[head_dim / 2] fp32 inverse frequencies, computed on the CPU once per
    (head_dim, theta, device): building them on the card at every call would
    copy ``theta`` from the host and so stall the stream at every layer."""
    return _rope_frequencies(int(head_dim), float(theta), str(torch.device(device or "cpu")))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_slots(sections: Tuple[int, ...], device: str):
    return torch.cat([torch.full((n,), i, dtype=torch.long)
                      for i, n in enumerate(sections)]).to(device)


def apply_mrope(x, positions_3d, sections: Tuple[int, ...], theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE.

    positions_3d: [..., S, 3] (temporal, height, width position ids).
    sections: split of the head_dim/2 frequency slots over the 3 kinds of
    id. Each slot's id is picked by indexing (the slot -> kind table is
    built on the CPU once per (sections, device)), never by a product with
    a one-hot: a TF32 matmul on the card would round ids past 2048.
    """
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # [D/2]
    slots = _mrope_slots(tuple(int(n) for n in sections), str(x.device))
    angles = positions_3d[..., slots].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def text_positions_3d(positions):
    """Text-only M-RoPE: the same id on all 3 channels."""
    return torch.stack([positions, positions, positions], dim=-1)
