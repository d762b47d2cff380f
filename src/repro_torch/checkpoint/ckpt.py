"""Dependency-free checkpointing: flattened tree -> .npz + manifest, in the
reference's on-disk format (``repro/checkpoint/ckpt.py``).

The format is the reference's: the manifest's keys, ``/``-joined leaf names,
tuples and lists flattened to ``__seq{i}`` keys, a step-stamped ``.npz`` of
the arrays and a structure descriptor from which ``load_checkpoint``
rebuilds the Python containers (dict, list, tuple, registered NamedTuple).
A checkpoint of a parameter dict written by either package loads in the
other.

Two descriptor kinds are this package's own, for what its states hold where
the reference's hold arrays: ``generator`` (a ``torch.Generator``, stored as
its ``get_state()`` bytes and rebuilt on load, so the draws after a restore
are the draws an uninterrupted run makes) and ``int`` (a Python int such as
``HSGDState.step``, restored as an int). Tensors are saved through
``.detach().cpu().numpy()`` and loaded onto the ``device`` the caller names.
"""
from __future__ import annotations

import io
import json
import os
from collections import namedtuple
from typing import Any, Dict, Tuple, Type

import numpy as np
import torch

from repro_torch.common.io import atomic_write_json
from repro_torch.common.pytree import flatten_dict, unflatten_dict

# name -> class for NamedTuple restoration (filled by the state owners:
# core/hsgd.py registers HSGDState, core/baselines.py JFLState)
_STATE_CLASSES: Dict[str, Type] = {}


def register_state_class(cls: Type) -> Type:
    """Register a NamedTuple class for checkpoint restoration (idempotent;
    usable as a decorator)."""
    _STATE_CLASSES[cls.__name__] = cls
    return cls


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _structure_of(tree) -> Dict[str, Any]:
    """JSON-able descriptor of the container skeleton (leaves are opaque)."""
    if isinstance(tree, dict):
        keys = list(tree.keys())
        return {"kind": "dict", "keys": keys,
                "children": [_structure_of(tree[k]) for k in keys]}
    if _is_namedtuple(tree):
        return {"kind": "namedtuple", "class": type(tree).__name__,
                "fields": list(tree._fields),
                "children": [_structure_of(v) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {"kind": type(tree).__name__,
                "children": [_structure_of(v) for v in tree]}
    if isinstance(tree, torch.Generator):
        return {"kind": "generator", "device": str(tree.device)}
    if _is_int(tree):
        return {"kind": "int"}
    return {"kind": "leaf"}


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _generator(state: np.ndarray, recorded: str, device) -> torch.Generator:
    """A generator in ``state``: on the CPU if it was saved from one, else on
    the run's ``device`` (a card generator resumes on the run's card)."""
    gdev = torch.device(recorded)
    if gdev.type != "cpu":
        gdev = torch.device(device)
    gen = torch.Generator(device=gdev)
    gen.set_state(torch.from_numpy(np.array(state, np.uint8)))
    return gen


def _rebuild(nested, desc, device):
    """Reapply a structure descriptor to ``unflatten_dict``'s nested dicts."""
    kind = desc["kind"]
    if kind == "leaf":
        return torch.from_numpy(np.array(nested)).to(device)
    if kind == "int":
        return int(nested)
    if kind == "generator":
        return _generator(nested, desc["device"], device)
    if kind == "dict":
        return {k: _rebuild(nested[str(k)], d, device)
                for k, d in zip(desc["keys"], desc["children"])}
    items = [_rebuild(nested[f"__seq{i}"], d, device) for i, d in enumerate(desc["children"])]
    if kind == "list":
        return items
    if kind == "tuple":
        return tuple(items)
    cls = _STATE_CLASSES.get(desc["class"])
    if cls is None:  # unregistered: a faithful stand-in with the same fields
        cls = namedtuple(desc["class"], desc["fields"])
    return cls(*items)


def save_checkpoint(path: str, params: Any, step: int = 0, extra: Dict | None = None):
    """Atomically commit a checkpoint to directory ``path``.

    A preemption mid-save must leave the previous checkpoint loadable, so the
    save never touches a file the current manifest references: arrays go to a
    fresh step-stamped ``.npz`` (via a temp file + ``os.replace``), and the
    manifest — whose replacement is the single atomic commit point — is
    written last through ``atomic_write_json``. Only after the commit are
    array files from superseded checkpoints pruned (best-effort).
    """
    os.makedirs(path, exist_ok=True)
    leaves = flatten_dict(_to_nested_dict(params))
    arrays = {k: _to_array(v) for k, v in leaves.items()}
    arrays_file = f"arrays-{int(step):012d}.npz"
    buf = io.BytesIO()
    np.savez(buf, **arrays)  # a file object defeats savez's ".npz" renaming
    tmp = os.path.join(path, arrays_file + f".tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, arrays_file))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    manifest = {
        "step": int(step),
        "keys": sorted(arrays),
        "extra": extra or {},
        "arrays_file": arrays_file,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "structure": _structure_of(params),
    }
    atomic_write_json(os.path.join(path, "manifest.json"), manifest)
    for name in os.listdir(path):  # prune superseded/orphaned array files
        if name.startswith("arrays") and name != arrays_file:
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


def load_checkpoint(path: str, device="cpu") -> Tuple[Any, int, Dict]:
    """(tree, step, extra) of the checkpoint in directory ``path``, every
    tensor on ``device``. The manifest must name its arrays file and its
    structure, as both packages' ``save_checkpoint`` record them."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, manifest["arrays_file"])) as z:
        flat = {k: z[k] for k in manifest["keys"]}
    params = _rebuild(unflatten_dict(flat), manifest["structure"], device)
    return params, manifest["step"], manifest.get("extra", {})


def _to_nested_dict(tree):
    """Turn tuples/lists into indexed dicts for stable flattening."""
    if isinstance(tree, dict):
        return {str(k): _to_nested_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {f"__seq{i}": _to_nested_dict(v) for i, v in enumerate(tree)}
    return tree
