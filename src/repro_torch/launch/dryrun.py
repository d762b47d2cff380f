"""Multi-pod dry run (``repro/launch/dryrun.py``): run every (architecture ×
input shape × mesh) program on meta DTensors over a fake process group, and
derive its roofline terms from counts.

For training shapes three programs run (train_step / exchange /
global_agg), whose costs combine as the paper's C(P, Q):
    per-step = train_step + (1/Q)·exchange + (1/P)·global_agg.
Inference shapes run a single serve_step.

Nothing happens at import. ``run_one`` (or ``main``) starts a fake process
group of the mesh's size (``torch.testing``'s ``FakeStore``, backend
"fake": every collective returns at once with the right shape), places each
program's parameters and inputs as meta DTensors by ``build_shardings``,
and runs the program. It reports, per program:

  * traced FLOPs (``launch/flops.py``), global and per device (global ÷
    cards, as the reference charges SPMD-redundant work);
  * collective bytes per device by kind: the result shapes of the
    functional collectives DTensor dispatches (the reference parses the same
    result-shape proxy out of its HLO);
  * argument and output bytes per device, from the local shards;
  * roofline terms at H100 data-sheet constants: 989 TFLOP/s dense bf16,
    67 TFLOP/s fp32, 3.35 TB/s HBM3, and 50 GB/s a card for collectives
    (NDR InfiniBand, 400 Gb/s: a 16-wide axis spans nodes).

Every number is derived from counts and those constants, not measured.
``memory_s`` charges the argument and output bytes once (XLA's "bytes
accessed", which the reference reads, has no counterpart here).

On a mesh with a "pod" axis, the training programs run on the whole mesh
(their [G] pod axis sharded over "pod", each process computing its own
pods, and ``global_agg``'s mean over pods a cross-pod collective); a
serve_step's pods share nothing (weights are replicated over "pod", the
batch split across it), so one pod's replica runs on the (data, model)
rest of the mesh. Plain tensors a program makes (positions, masks, RoPE
tables) are treated as replicated (``implicit_replication``). An op DTensor cannot shard is an
error, never swallowed: ``main`` records it and exits 1.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
import traceback
from math import prod
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.config import INPUT_SHAPES, InputShape, get_config
from repro_torch.common.io import atomic_write_json
from repro_torch.common.sharding import map_structure, structure_leaves
from repro_torch.launch.flops import traced_flops
from repro_torch.launch.mesh import mesh_spec
from repro_torch.launch.steps import LONG_CTX_OK, build_programs, build_shardings

# H100 SXM5 data-sheet constants (per card)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16, fp32
HBM_BW = 3.35e12  # bytes/s
NET_BW = 50e9  # bytes/s a card: NDR InfiniBand, 400 Gb/s

# functional collectives -> the reference's HLO collective kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


class CollectiveBytes(TorchDispatchMode):
    """Per-device bytes of the functional collectives dispatched while it is
    active, by kind (result shapes). DTensor ops are passed on
    (``NotImplemented``), so the collectives DTensor lowers them to are seen."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace == "_c10d_functional":
            outs = out if isinstance(out, (list, tuple)) else [out]
            self.bytes[kind] = self.bytes.get(kind, 0) + sum(_nbytes(o) for o in outs)
        return out


def _nbytes(x) -> int:
    return int(prod(x.shape)) * x.element_size() if isinstance(x, torch.Tensor) else 0


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (DTensor or plain)."""
    return sum(_nbytes(x.to_local() if hasattr(x, "to_local") else x)
               for x in structure_leaves(tree))


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0),
    torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_dtensor(x, placements, mesh, replica_dim=None):
    """``x`` as a meta DTensor on ``mesh`` with ``placements``. With
    ``replica_dim`` (the index of the "pod" mesh dimension), the DTensor of
    one pod's replica instead: on the rest of the mesh, a pod-sharded
    dimension cut to that pod's part."""
    from torch.distributed.tensor import DTensor

    shape = list(x.shape)
    if replica_dim is not None:
        if placements[replica_dim].is_shard():
            shape[placements[replica_dim].dim] //= mesh.shape[replica_dim]
        rest = [i for i in range(mesh.ndim) if i != replica_dim]
        mesh = mesh[tuple(mesh.mesh_dim_names[i] for i in rest)]
        placements = tuple(placements[i] for i in rest)
    local = list(shape)
    for dim_size, p in zip(mesh.shape, placements):
        if p.is_shard():
            local[p.dim] //= dim_size
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=x.dtype, device="meta"), mesh,
                              placements, run_check=False, shape=tuple(shape), stride=stride)


def _fresh(tree):
    return map_structure(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def analyze_program(fn, args, axes, mesh, dtype, pod_replica: bool = False) -> Dict:
    """Run ``fn`` on meta DTensors placed by ``build_shardings`` and on
    global meta tensors; the per-program terms.

    ``pod_replica``: the program's pods are independent replicas (a serve
    step on a mesh with a "pod" axis: weights replicated over pods, the
    batch split across them), so one pod's replica runs on the rest of the
    mesh; its per-device terms are every device's. The FLOPs stay the whole
    program's, divided by every card."""
    from torch.distributed.tensor.experimental import implicit_replication

    n_chips = int(prod(mesh.shape))
    flops = traced_flops(fn, *(_fresh(a) for a in args))
    rd = list(mesh.mesh_dim_names).index("pod") if pod_replica else None
    dargs = tuple(map_structure(lambda x, p: _meta_dtensor(x, p, mesh, rd), a,
                                build_shardings(a, ax, mesh)) for a, ax in zip(args, axes))
    arg_bytes = _local_bytes(dargs)
    with CollectiveBytes() as coll, implicit_replication():
        out = fn(*dargs)
    out_bytes = _local_bytes(out)
    coll_total = sum(coll.bytes.values())
    per_dev = flops.total / n_chips
    return {
        "traced_flops": flops.total,
        "traced_matmul_flops": flops.matmul,
        "traced_flops_per_device": per_dev,
        "collectives": dict(coll.bytes),
        "collective_bytes_per_device": coll_total,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "compute_s": per_dev / PEAK_FLOPS[dtype],
        "memory_s": (arg_bytes + out_bytes) / HBM_BW,
        "collective_s": coll_total / NET_BW,
    }


def _skip_reason(cfg, arch: str, shape: InputShape):
    if shape.name == "long_500k" and arch not in LONG_CTX_OK:
        return "full attention is quadratic at 500k"
    if shape.kind == "decode" and cfg.is_encoder_decoder and shape.name == "long_500k":
        return "enc-dec 500k decode N/A"
    return None


def run_one(arch: str, shape_name, multi_pod: bool = False, mesh=None, verbose: bool = True,
            smoke: bool = False) -> Dict:
    """The dry run of one (arch, shape, mesh). ``mesh`` is a ``DeviceMesh``
    (its process group up), the shape of a (pod,) data, model mesh to run
    on a fake process group of its size, or None for the production mesh.
    ``shape_name`` names an ``INPUT_SHAPES`` entry or is an ``InputShape``;
    ``smoke`` takes the arch's smoke widths."""
    cfg = get_config(arch, smoke=smoke)
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    reason = _skip_reason(cfg, arch, shape)
    if reason is not None:
        return {"arch": arch, "shape": shape.name, "status": "skipped", "reason": reason}
    if mesh is None or isinstance(mesh, tuple):
        from repro_torch.launch.mesh import make_debug_mesh

        dims = mesh_spec(multi_pod=multi_pod)[0] if mesh is None else mesh
        with fake_world(int(prod(dims))):
            dev_mesh = make_debug_mesh(dims[-2], dims[-1], multi_pod=len(dims) == 3,
                                       device_type="cpu")
            return run_one(arch, shape, multi_pod, dev_mesh, verbose, smoke)
    n_chips = int(prod(mesh.shape))
    result = {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "n_chips": n_chips, "status": "ok", "programs": {},
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    progs = build_programs(cfg, shape, multi_pod=multi_pod)
    for name, (fn, args, axes) in progs.entries.items():
        t0 = time.time()
        stats = analyze_program(fn, args, axes, mesh, dtype,
                                pod_replica=name == "serve_step" and "pod" in mesh.mesh_dim_names)
        stats["trace_s"] = round(time.time() - t0, 1)
        result["programs"][name] = stats
        if verbose:
            print(f"  {name:12s} flops/dev={stats['traced_flops_per_device']:.3e} "
                  f"args/dev={stats['argument_bytes']:.3e} "
                  f"coll/dev={stats['collective_bytes_per_device']:.3e} "
                  f"({stats['trace_s']}s)", flush=True)
    return result


def roofline_summary(result: Dict, P: int = 8, Q: int = 4) -> Dict:
    """Combine program terms with the paper's 1/P, 1/Q amortization."""
    if result.get("status") != "ok":
        return {}
    progs = result["programs"]
    keys = ("compute_s", "memory_s", "collective_s")
    if "train_step" in progs:
        terms = {k: progs["train_step"][k] + progs["exchange"][k] / Q
                 + progs["global_agg"][k] / P for k in keys}
    else:
        terms = {k: progs["serve_step"][k] for k in keys}
    out = dict(terms)
    out["dominant"] = max(terms, key=terms.get).replace("_s", "")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED
    from repro_torch.launch.mesh import make_production_mesh

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for mp in meshes:
        tag = "multipod" if mp else "pod"
        with fake_world(int(prod(mesh_spec(multi_pod=mp)[0]))):
            mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
            for arch in archs:
                for shape in shapes:
                    key = f"{arch}__{shape}__{tag}"
                    path = os.path.join(args.out, key + ".json")
                    if os.path.exists(path):
                        print(f"[skip cached] {key}")
                        continue
                    print(f"[dry-run] {key}", flush=True)
                    try:
                        res = run_one(arch, shape, multi_pod=mp, mesh=mesh)
                        res["roofline"] = roofline_summary(res)
                    except Exception as e:  # noqa: BLE001 — recorded, and the run exits 1
                        traceback.print_exc()
                        res = {"arch": arch, "shape": shape, "multi_pod": mp,
                               "status": "error", "error": f"{type(e).__name__}: {e}"[-2000:]}
                        failures.append(key)
                    atomic_write_json(path, res)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
