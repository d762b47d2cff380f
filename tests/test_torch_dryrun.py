"""The dry run (``repro_torch/launch/dryrun.py``) on fake process groups.

Each ``run_one`` starts a fake process group in this process and tears it
down after the run. It completes for one smoke arch of each family
(dense, ssm, hybrid, audio, MoE, MLA) on fake (2, 2) and (2, 2, 2) meshes,
and the pod-stacked training programs on the (2, 2, 2) one; gemma3-1b
train_4k at published widths on the fake production (16, 16) mesh
completes, and each program's per-device argument bytes equal what the
reference's specs give on an abstract (16, 16) mesh. long_500k skips where
the reference's does. whisper-medium's encoder at published widths
completes on a fake (4, 16) mesh, the smallest on which its MLP down
projection met a strided all-to-all shard.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.common import sharding as JSH
from repro.common.config import INPUT_SHAPES as J_SHAPES
from repro.common.config import get_config as jget
from repro.launch import steps as JS
from repro_torch.common.config import InputShape
from repro_torch.launch.dryrun import roofline_summary, run_one


def _jax_axes(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda a: isinstance(a, tuple) and all(
        isinstance(x, (str, type(None))) for x in a))


_SMALL = {"train": InputShape("train_4k", 32, 8, "train"),
          "prefill": InputShape("prefill_32k", 32, 4, "prefill"),
          "decode": InputShape("decode_32k", 64, 4, "decode")}


@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch,kind", [("gemma3-1b", "decode"), ("falcon-mamba-7b", "decode"),
                                       ("zamba2-2.7b", "prefill"), ("whisper-medium", "prefill"),
                                       ("grok-1-314b", "decode"), ("deepseek-v3-671b", "prefill")])
def test_dry_run_completes_at_smoke_widths(arch, kind, mesh):
    """One smoke arch of each family (dense, ssm, hybrid, audio, MoE, MLA)
    on a fake (2, 2) and (2, 2, 2) mesh."""
    res = run_one(arch, _SMALL[kind], multi_pod=len(mesh) == 3, mesh=mesh, verbose=False,
                  smoke=True)
    assert res["status"] == "ok" and res["n_chips"] == int(np.prod(mesh))
    for stats in res["programs"].values():
        assert stats["traced_flops"] > 0 and stats["argument_bytes"] > 0
    assert roofline_summary(res)["dominant"] in ("compute", "memory", "collective")


def test_dry_run_pod_programs():
    """The training programs on a (2, 2, 2) mesh: the [G] pod axis on "pod",
    each process stepping its own pod, and global_agg's mean over pods a
    cross-pod collective."""
    res = run_one("gemma3-1b", _SMALL["train"], multi_pod=True, mesh=(2, 2, 2), verbose=False,
                  smoke=True)
    progs = res["programs"]
    assert set(progs) == {"train_step", "exchange", "global_agg"}
    assert progs["global_agg"]["collective_bytes_per_device"] > 0
    assert progs["train_step"]["collectives"]["all-gather"] > 0


def _reference_arg_bytes(arch, shape_name):
    """Per-device argument bytes of each program by the reference's specs
    on an abstract (16, 16) mesh."""
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    out = {}
    for name, (_, sds, axes) in JS.build_programs(jget(arch), J_SHAPES[shape_name]).entries.items():
        total = 0
        for s, a in zip(jax.tree_util.tree_leaves(sds), _jax_axes(axes)):
            spec = JSH.divisible_spec(s.shape, JSH.logical_to_spec(a, None, jmesh), jmesh)
            local = list(s.shape)
            for d, entry in enumerate(tuple(spec)):
                for ax in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
                    local[d] //= jmesh.shape[ax]
            total += int(np.prod(local)) * s.dtype.itemsize
        out[name] = total
    return out


def test_dry_run_on_the_production_mesh():
    """gemma3-1b train_4k at published widths on the fake (16, 16) mesh: the
    per-device argument bytes are the reference's specs' bytes."""
    res = run_one("gemma3-1b", "train_4k", verbose=False)
    assert res["status"] == "ok" and res["n_chips"] == 256
    want = _reference_arg_bytes("gemma3-1b", "train_4k")
    assert {k: v["argument_bytes"] for k, v in res["programs"].items()} == want
    assert run_one("stablelm-1.6b", "long_500k", verbose=False)["status"] == "skipped"
    assert run_one("whisper-medium", "long_500k", verbose=False)["status"] == "skipped"


def test_dry_run_whisper_encoder_at_published_widths():
    """whisper-medium at published widths, 32 requests, on a fake (4, 16)
    mesh: the encoder's MLP hidden [32, 1500, 4096] is redistributed to
    (data, None, model) through the fake group's all-gather and chunk,
    which leaves each shard a strided view of a padded buffer; the down
    projection's flattening view raised there until ``constrain`` made the
    shard contiguous. A 64-token decoder prompt keeps the case short (the
    (16, 16) ``prefill_32k`` cell raised at the same line)."""
    res = run_one("whisper-medium", InputShape("prefill_32k", 64, 32, "prefill"), mesh=(4, 16),
                  verbose=False)
    assert res["status"] == "ok" and res["n_chips"] == 64
    assert res["programs"]["serve_step"]["traced_flops"] > 0
