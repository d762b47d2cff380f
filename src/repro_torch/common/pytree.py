"""Nested-dict tensor trees: the port's stand-in for JAX pytrees.

Parameter trees are plain dicts of dicts of tensors. Leaves are visited in
sorted-key order, the order ``jax.tree_util`` flattens a dict in, so a
flattened message lines up row for row with the reference's.
"""
from __future__ import annotations

import torch


def tree_flatten(tree):
    """(leaves in sorted-key order, treedef) of a nested dict."""
    if isinstance(tree, dict):
        leaves, treedef = [], {}
        for k in sorted(tree):
            sub, treedef[k] = tree_flatten(tree[k])
            leaves.extend(sub)
        return leaves, treedef
    return [tree], None


def _build(treedef, it):
    return next(it) if treedef is None else {k: _build(v, it) for k, v in treedef.items()}


def tree_unflatten(treedef, leaves):
    """The nested dict of ``treedef`` with ``leaves`` in sorted-key order.

    A module-level helper takes the iterator as an argument: a nested
    closure over itself would form a reference cycle holding ``leaves``,
    which only the cyclic garbage collector frees."""
    return _build(treedef, iter(leaves))


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_sub(a, b):
    return tree_map(torch.subtract, a, b)


def tree_size(tree) -> int:
    """Total number of scalar elements of a tree of tensors."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors (meta tensors count by shape)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_dot(a, b):
    """Inner product of two trees, summed in fp32."""
    return sum(torch.sum(x.float() * y.float())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_norm(tree):
    return torch.sqrt(tree_dot(tree, tree))


def flatten_dict(d: dict, prefix: str = "", sep: str = "/") -> dict:
    """Nested dict -> {"a/b/c": leaf}, the reference's checkpoint key names."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: dict, sep: str = "/") -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out
