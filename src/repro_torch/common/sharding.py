"""Sharding helpers: logical-axis rules -> per-dimension specs -> DTensor
placements on a ``DeviceMesh`` (``repro/common/sharding.py``).

Every parameter and activation is tagged with logical axis names; a rule
table maps logical names to mesh axes. Changing the sharding scheme means
swapping the rule table, not touching model code.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension split
over several mesh axes, major first, as a JAX ``PartitionSpec`` entry).
``placements`` turns it into DTensor placements: ``Shard(d)`` on each
mesh dimension that splits tensor dimension d, ``Replicate()`` elsewhere.

``constrain`` and ``use_weight`` are ``redistribute`` calls on a DTensor,
to the layout the reference would constrain to. The port has no ambient
mesh: a DTensor carries its own, so both are the identity on a plain
tensor, and the reference's ``mesh_context`` has no counterpart here.

A mesh argument is a ``DeviceMesh`` or a ``{name: size}`` dict (which
needs no process group: the tests and the dry run's spec checks use it).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch

# Default logical->physical rules for the production mesh.
# "data" carries the horizontal (group) partition of the paper;
# "model" carries the vertical partition + tensor parallelism;
# "pod" is the second horizontal tier (multi-pod).
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "group": ("pod", "data"),
    # FSDP: parameter d_model dims shard over "data"; activations tag "batch"
    # first so the duplicate-axis filter keeps activations data-sharded on
    # batch while parameters ZeRO-shard on embed. NOT sharded over "pod":
    # each pod holds its own HSGD local model replica.
    "embed": ("data",),
    "seq": None,
    "cache_seq": ("model",),  # decode KV caches shard their length over model
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "vocab": ("model",),
    "experts": ("model",),
    "expert_tokens": ("data",),
    "expert_mlp": None,
    "ssm_inner": ("model",),
    "ssm_state": None,
    "conv": None,
    "device_slot": None,  # tier-1 devices stay local
    "pod_group": ("pod",),  # per-pod HSGD local-model replicas (leading G dim)
    "pod_batch": ("pod", "data"),  # inference batch scale-out across pods
    "stack": None,  # stacked layer dimension
}

# Fully-replicated-model variant (pure data parallel) for small models.
DP_ONLY_RULES: Dict[str, Optional[Tuple[str, ...]]] = {k: None for k in DEFAULT_RULES}
DP_ONLY_RULES["batch"] = ("pod", "data", "model")
DP_ONLY_RULES["group"] = ("pod", "data", "model")

Spec = Tuple[object, ...]  # per dimension: None | axis name | tuple of names


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def map_structure(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples are
    nodes), with the matching parts of ``rest``: a leaf of ``tree`` takes
    whatever sits at its place in each of them (an axes tuple whole)."""
    if isinstance(tree, dict):
        return {k: map_structure(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(map_structure(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def structure_leaves(tree):
    """The leaves of ``tree`` (dicts, lists and tuples are nodes), dict keys
    in sorted order as ``jax.tree_util`` flattens them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in structure_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [x for v in tree for x in structure_leaves(v)]
    return [tree]


def axes_leaves(axes_tree):
    """The axes tuples of a logical-axes tree, in ``structure_leaves``'
    order."""
    if is_axes(axes_tree) or axes_tree is None:
        return [axes_tree]
    if isinstance(axes_tree, dict):
        return [a for k in sorted(axes_tree) for a in axes_leaves(axes_tree[k])]
    return [a for v in axes_tree for a in axes_leaves(v)]


def map_axes(fn, axes_tree):
    """``fn`` over every axes tuple of a logical-axes tree."""
    if is_axes(axes_tree) or axes_tree is None:
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v) for k, v in axes_tree.items()}
    return type(axes_tree)(map_axes(fn, v) for v in axes_tree)


def logical_to_spec(axes: Sequence[Optional[str]], rules=None, mesh=None) -> Spec:
    """Map a tuple of logical axis names to a per-dimension spec via the
    rules: mesh axes absent from ``mesh`` are dropped from an entry, and a
    mesh axis already used by an earlier dimension is dropped too."""
    rules = rules or DEFAULT_RULES
    names = set(mesh_axes(mesh)) if mesh is not None else None
    spec = []
    used = set()
    for ax in axes:
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            spec.append(None)
            continue
        if names is not None:
            phys = tuple(p for p in phys if p in names)
        phys = tuple(p for p in phys if p not in used)
        used.update(phys)
        if not phys:
            spec.append(None)
        elif len(phys) == 1:
            spec.append(phys[0])
        else:
            spec.append(phys)
    return tuple(spec)


def divisible_spec(shape, spec: Spec, mesh) -> Spec:
    """Drop mesh axes from a spec wherever the dim is not divisible by them
    (or smaller than their product); pads the spec to ``len(shape)``."""
    sizes = mesh_axes(mesh)
    new = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            new.append(None)
            continue
        size = 1
        for a in entry if isinstance(entry, tuple) else (entry,):
            size *= sizes[a]
        new.append(entry if dim % size == 0 and dim >= size else None)
    return tuple(new)


def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): one per
    mesh dimension, ``Shard(d)`` where the mesh axis splits tensor dim d.
    A dimension split over several mesh axes must name them in the mesh's
    order (major first), the only order DTensor's ``Shard`` expresses."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [order.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {order}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def named_placements(shape, axes, mesh, rules=None):
    """Placements of a tensor of ``shape`` tagged ``axes`` (None = replicated):
    ``logical_to_spec`` then ``divisible_spec``, as the reference's
    ``build_shardings`` and ``shard_tree`` place a leaf."""
    if axes is None:
        return placements((), mesh)
    return placements(divisible_spec(shape, logical_to_spec(axes, rules, mesh), mesh), mesh)


def shard_tree(tree_axes, mesh, rules=None):
    """Map a tree of logical-axis tuples to a tree of specs on ``mesh``
    (the reference returns ``NamedSharding``s; ``placements`` turns a spec
    into a DTensor's)."""
    return map_axes(lambda axes: logical_to_spec(axes, rules, mesh), tree_axes)


def group_sharding(shape, mesh, rules=None) -> Spec:
    """Spec putting a leading group axis M on the mesh's horizontal axes
    (logical "group" rule), everything else replicated. Falls back to full
    replication when M does not divide the mesh axes (trivial-mesh path)."""
    axes = ("group",) + (None,) * (max(len(shape), 1) - 1)
    spec = logical_to_spec(axes[: len(shape)], rules, mesh)
    return divisible_spec(shape, spec, mesh)


def _entries(shape, axes, mesh, rules, drop=()):
    """The reference's ``constrain``/``use_weight`` spec: absent axes and
    ``drop`` filtered per entry, size-1 or non-divisible dims left alone."""
    sizes = mesh_axes(mesh)
    entries = []
    used = set()
    for dim, ax in zip(shape, axes):
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            entries.append(None)
            continue
        phys = tuple(p for p in phys if p not in drop and p in sizes and p not in used)
        size = 1
        for p in phys:
            size *= sizes[p]
        if not phys or size == 1 or dim % size != 0:
            entries.append(None)
            continue
        used.update(phys)
        entries.append(phys if len(phys) > 1 else phys[0])
    return tuple(entries)


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def constrain(x, axes, rules=None, force: bool = False):
    """Redistribute a DTensor to the layout of its logical ``axes`` (the
    reference's ``with_sharding_constraint``). Mesh- and shape-aware: absent
    mesh axes are filtered per entry, non-divisible dims are replicated, and
    a rank mismatch is a no-op. The identity on a plain tensor. ``force``
    redistributes even to the layout ``x`` has, so that the gradient takes
    that layout too (``redistribute``'s backward).

    The redistributed shard is made contiguous: an all-to-all that a process
    group runs as an all-gather and a chunk (gloo's, the dry run's fake
    group) leaves each shard a strided view of a padded buffer, which a
    later matmul's flattening view cannot read (whisper-medium's MLP down
    projection at published widths)."""
    if not is_dtensor(x) or len(axes) != x.dim():
        return x
    spec = _entries(x.shape, axes, x.device_mesh, rules or DEFAULT_RULES)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want and not force:
        return x
    y = x.redistribute(x.device_mesh, want)
    local = y.to_local()
    if local.is_contiguous():
        return y
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), y.device_mesh, y.placements,
                              shape=y.shape, stride=y.stride())


def shard_count(x, dim: int) -> int:
    """The number of ranks dimension ``dim`` of a DTensor is split over (1
    for a plain tensor)."""
    if not is_dtensor(x):
        return 1
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if p.is_shard(dim % x.dim()):
            n *= size
    return n


def leading_slices(x):
    """The slices along ``x``'s leading axis that this process computes.

    A plain tensor (or a DTensor whose leading axis is replicated) gives all
    of them, ``x[0], x[1], ...``. A DTensor whose leading axis is sharded
    gives the slices of its local shard, each a DTensor on the rest of the
    mesh: the SPMD form of the reference's ``vmap`` over a mesh-sharded
    axis (the pod-stacked programs), where each rank runs its own pods."""
    if not is_dtensor(x) or not any(p.is_shard(0) for p in x.placements):
        return [x[i] for i in range(x.shape[0])]
    from torch.distributed.tensor import DTensor, Shard

    mesh, pl = x.device_mesh, x.placements
    rest = [i for i, p in enumerate(pl) if not p.is_shard(0)]
    sub = mesh[tuple(mesh.mesh_dim_names[i] for i in rest)]
    sub_pl = tuple(Shard(pl[i].dim - 1) if pl[i].is_shard() else pl[i] for i in rest)
    shape = tuple(x.shape[1:])
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    local = x.to_local()
    return [DTensor.from_local(local[j], sub, sub_pl, run_check=False, shape=shape, stride=stride)
            for j in range(local.shape[0])]


_WEIGHT_MODE = "gather"


@contextlib.contextmanager
def weight_mode(mode: str):
    """'gather' (train/prefill: ZeRO-3 gather-at-use) or 'fsdp' (decode:
    activations are tiny, so weights stay sharded where they are)."""
    global _WEIGHT_MODE
    prev = _WEIGHT_MODE
    _WEIGHT_MODE = mode
    try:
        yield
    finally:
        _WEIGHT_MODE = prev


def use_weight(w, axes, rules=None):
    """ZeRO-3 weight use: parameters are STORED FSDP-sharded over "data"
    (their 'embed'-like dims); at their use site they are redistributed to
    the gathered layout ("data" dropped, tensor-parallel axes kept), one
    weight all-gather instead of re-sharding activations. Under
    ``weight_mode("fsdp")`` the weight stays as it is; the identity on a
    plain tensor."""
    if _WEIGHT_MODE == "fsdp" or not is_dtensor(w):
        return w
    spec = _entries(w.shape, axes, w.device_mesh, rules or DEFAULT_RULES, drop=("data",))
    want = placements(spec, w.device_mesh)
    return w if tuple(w.placements) == want else w.redistribute(w.device_mesh, want)
