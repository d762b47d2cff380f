"""Weights drawn from the run's seed, on the run's device, in the layout of
the cell's reference module's ``param_layout``.

The draw is cut into units: one layer's slice of a leaf under a ``layers``
stack, else the whole leaf. Each unit has a generator of its own, seeded
from (seed, unit index), so any unit can be drawn again alone, which is how
a run reads the change of a leaf without keeping the initial weights. Every
pod starts from the same draw.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from hsgd_bench.reference.round import leaves


def unit_seed(seed: int, index: int, stream: int = 0) -> int:
    """A generator seed for unit ``index`` of ``stream``, from any whole ``seed``."""
    entropy = [int(seed) % 2 ** 64, stream, index]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return int((int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))


def units(layout) -> Iterator[Tuple[Tuple[str, ...], Tuple, object]]:
    """(leaf path, leaf spec, index along the leaf's first axis or None)."""
    for path, spec in leaves(layout):
        if "layers" in path:
            for i in range(spec[0][0]):
                yield path, spec, i
        else:
            yield path, spec, None


def fill(out: torch.Tensor, kind: str, std: float, seed: int) -> torch.Tensor:
    if kind == "zeros":
        return out.zero_()
    if kind == "ones":
        return out.fill_(1.0)
    gen = torch.Generator(device=out.device).manual_seed(seed)
    if kind == "normal":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    elif kind == "embed":
        out.normal_(generator=gen)
    else:
        raise ValueError(f"unknown initializer {kind!r}")
    return out.mul_(std)


def initial_units(layout, seed: int, device) -> Iterator[Tuple[Tuple[str, ...], object,
                                                              torch.Tensor]]:
    """Each unit's initial values, drawn one unit at a time."""
    for n, (path, spec, i) in enumerate(units(layout)):
        shape = spec[0] if i is None else spec[0][1:]
        out = torch.empty(shape, dtype=torch.float32, device=device)
        yield path, i, fill(out, spec[1], spec[2], unit_seed(seed, n))


def draw(layout, seed: int, pods: int, device) -> Dict:
    """The layout's tensors with a leading [pods] axis, every pod the same."""
    tree: Dict = {}
    for path, spec in leaves(layout):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty((pods,) + spec[0], dtype=torch.float32, device=device)
    for n, (path, spec, i) in enumerate(units(layout)):
        x = get(tree, path)[0]
        fill(x if i is None else x[i], spec[1], spec[2], unit_seed(seed, n))
    for path, _ in leaves(layout):
        x = get(tree, path)
        x[1:].copy_(x[:1].expand_as(x[1:]))
    return tree


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def change_norms(tree, layout, seed: int) -> Dict[Tuple[int, Tuple[str, ...]], float]:
    """{(pod, leaf path): ‖θ - θ_init‖₂} of a [pods]-stacked tree, the
    initial weights drawn again unit by unit."""
    sq: Dict = {}
    for path, i, init in initial_units(layout, seed, get(tree, next(leaves(layout))[0]).device):
        x = get(tree, path)
        for g in range(x.shape[0]):
            cur = x[g] if i is None else x[g, i]
            part = torch.linalg.vector_norm((cur - init).double()) ** 2
            sq[(g, path)] = sq.get((g, path), 0.0) + part
    return {key: float(torch.sqrt(v)) for key, v in sq.items()}
