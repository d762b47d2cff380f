"""Production meshes (``repro/launch/mesh.py``), as torch ``DeviceMesh``es.

Single pod: (data=16, model=16) = 256 cards.
Multi-pod:  (pod=2, data=16, model=16) = 512 cards.

In the HSGD mapping: "pod" carries the hospital-patient groups (tier-3
horizontal, aggregated every P steps), "data" carries batch/FSDP within a
group (tier-1, the intra-group device aggregation), and "model" carries the
vertical partition + tensor parallelism (tier-2, the ζ exchange every Q
steps).

Defined as functions, never module-level constants: importing this module
touches no process group. ``init_device_mesh`` needs one of the mesh's size
to be up (``torch.distributed.init_process_group``); the dry run starts a
fake one (``launch/dryrun.py``), a real run one rank per card.
"""
from __future__ import annotations

def mesh_spec(*, multi_pod: bool = False, n_data: int = 16, n_model: int = 16):
    """(shape, axis names) of a (pod,) data, model mesh."""
    if multi_pod:
        return (2, n_data, n_model), ("pod", "data", "model")
    return (n_data, n_model), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_spec(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, multi_pod: bool = False,
                    device_type: str = "cuda"):
    """Small mesh for CI-sized dry runs and tests (a process group of its
    size must be up)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_spec(multi_pod=multi_pod, n_data=n_data, n_model=n_model)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)
