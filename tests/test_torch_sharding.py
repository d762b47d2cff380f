"""The port's logical-axis sharding (``repro_torch/common/sharding.py``)
against the reference's ``repro/common/sharding.py``.

Specs: for every leaf of every ASSIGNED arch's ``model_specs`` and
``llm_hybrid`` specs, and for every input-axes tree of every program of
every input shape (both ``multi_pod`` settings), the port's
``logical_to_spec`` + ``divisible_spec`` on a ``{name: size}`` mesh equals
the reference's on a ``jax.sharding.AbstractMesh`` (no devices needed), on
(16, 16), (2, 16, 16), (2, 2) and (2, 2, 2) meshes. The rule tables are
equal. Placements, ``constrain`` and ``use_weight`` run on a one-process
gloo mesh (FileStore under ``tmp_path``): a plain tensor passes through
both as is.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.common import sharding as JSH
from repro.common.config import INPUT_SHAPES as J_SHAPES
from repro.common.config import get_config as jget
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.common import sharding as SH
from repro_torch.common.config import INPUT_SHAPES, get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import ASSIGNED
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T

MESHES = {
    (16, 16): ("data", "model"),
    (2, 16, 16): ("pod", "data", "model"),
    (2, 2): ("data", "model"),
    (2, 2, 2): ("pod", "data", "model"),
}


def _jax_spec(spec):
    """A PartitionSpec as the port's tuple (one entry a dimension)."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """(shape, axes) of every param leaf and program input of ``arch``, from
    the port (the reference's shapes and axes equal them: ``test_torch_
    programs.py``)."""
    cfg = get_config(arch)
    out = []
    for specs in (T.model_specs(cfg), S.make_hybrid(cfg).specs()):
        out += [(s.shape, s.axes) for s in tree_leaves(specs)]
    for shape in INPUT_SHAPES.values():
        for mp in (False, True):
            for _, args, axes in S.build_programs(cfg, shape, multi_pod=mp).entries.values():
                out += list(zip([tuple(x.shape) for x in SH.structure_leaves(args)],
                                SH.axes_leaves(axes)))
    return out


def test_rule_tables_equal_the_reference():
    assert SH.DEFAULT_RULES == JSH.DEFAULT_RULES
    assert SH.DP_ONLY_RULES == JSH.DP_ONLY_RULES
    assert ASSIGNED == J_ASSIGNED


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_the_reference(arch):
    leaves = _leaves(arch)
    assert len(leaves) > 50
    for dims, names in MESHES.items():
        jmesh = AbstractMesh(dims, names)
        mesh = dict(zip(names, dims))
        for rules in (None, SH.DP_ONLY_RULES):
            jrules = None if rules is None else JSH.DP_ONLY_RULES
            for shape, axes in leaves:
                if axes is None:
                    continue
                want = JSH.divisible_spec(shape, JSH.logical_to_spec(axes, jrules, jmesh), jmesh)
                got = SH.divisible_spec(shape, SH.logical_to_spec(axes, rules, mesh), mesh)
                assert got == _jax_spec(want), (arch, dims, shape, axes)
                jg = JSH.group_sharding(shape, jmesh, jrules).spec
                assert SH.group_sharding(shape, mesh, rules) == _jax_spec(jg), (shape, dims)


def test_spec_leaves_cover_the_reference_specs():
    """The leaf lists the spec test walks are the reference's, leaf for leaf."""
    cfg = jget("gemma3-1b")
    ref = [s.shape for s in jax.tree_util.tree_leaves(
        JT.model_specs(cfg), is_leaf=JL.is_spec)]
    port = [s.shape for s in tree_leaves(T.model_specs(get_config("gemma3-1b")))]
    assert port == ref
    jprog = JS.build_programs(cfg, J_SHAPES["decode_32k"])
    jaxes = jax.tree_util.tree_leaves(
        jprog.entries["serve_step"][2], is_leaf=lambda a: isinstance(a, tuple) and all(
            isinstance(x, (str, type(None))) for x in a))
    pprog = S.build_programs(get_config("gemma3-1b"), INPUT_SHAPES["decode_32k"])
    assert SH.axes_leaves(pprog.entries["serve_step"][2]) == [tuple(a) for a in jaxes]


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_placements_constrain_and_use_weight(one_rank_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh = one_rank_mesh
    assert SH.placements((("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert SH.placements((None, "model"), mesh) == (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        SH.placements((("model", "data"),), mesh)  # minor-major is not a DTensor order
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert SH.constrain(x, ("batch", "seq", "embed")) is x
    assert SH.use_weight(x, ("embed", "heads", None)) is x
    d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    # size-1 mesh axes are never constrained to (the reference's rule)
    assert SH.constrain(d, ("batch", "seq", "embed")) is d
    with SH.weight_mode("fsdp"):
        assert SH.use_weight(d, ("embed", "heads", None)) is d
    assert isinstance(SH.use_weight(d, ("embed", "heads", None)), DTensor)
    # the spec entries the reference would constrain to, on a wider mesh
    assert SH._entries((8, 6, 4), ("batch", "seq", "embed"), {"data": 2, "model": 2},
                       SH.DEFAULT_RULES) == ("data", None, None)
    assert SH._entries((8, 6, 4), ("embed", "heads", None), {"data": 2, "model": 3},
                       SH.DEFAULT_RULES, drop=("data",)) == (None, "model", None)
