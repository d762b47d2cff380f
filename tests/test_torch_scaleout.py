"""Scale-out of the port on the CPU: the group-sharded HSGD run over gloo
ranks and a DTensor-sharded LLM train step (the dry run is
``test_torch_dryrun.py``).

Group-sharded HSGD (the counterpart of the reference's
``test_hsgd.py::test_group_sharded_run_matrix``, which it does not run): 2
and 4 gloo ranks, each its own process meeting the others through a
``FileStore`` under ``tmp_path`` (no port, so parallel test workers never
collide), run ``HSGDRunner.run(mesh=)`` on a (n, 1) [data, model] mesh for
the four (compression × global aggregation) cases. Every rank's per-step
losses equal the reference's single-device run within rtol 1e-5, atol 1e-6
(its participants replayed), and every rank holds M/n = 4/n groups. The
adaptive controller's ``run(mesh=)`` (8 steps, no probe) gives the same
plans and, within the same tolerance, the same losses as its meshless run
on each rank.

A sharded run's returned state (the counterpart of the reference's global
arrays): two chained ``run(rounds=1, mesh=)`` calls give the reference's
``rounds=2`` losses within the same tolerance, and ``global_model(state,
w, mesh)`` of the returned state is the meshless chain's global model
within 1e-5 of each leaf's largest |value| (eq. (2)'s all-reduce sums in
another order, and two rounds of training carry that). The
private legs on the mesh: the adaptive controller with DP (C = 1, σ = 1)
and with secure aggregation, on the reference's draws (participants and
whole-message DP noise, injected), gives the reference's plans and losses
within the adaptive tests' rtol 1e-4, and its own meshless run's within
rtol 1e-5, atol 1e-6.

Sharded LLM step: gemma3-1b smoke's ``train_step`` from ``build_programs``
on a (2, 2) [data, model] gloo mesh, its inputs DTensors placed by
``build_shardings``, against the same step on one process: loss within
rtol 1e-5 and every updated parameter within atol 1e-6 (fp32; the sharded
matmuls and all-reduces sum in another order).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FederationConfig as JaxFed
from repro.common.config import TrainConfig as JaxTrain
from repro.core import federation as JF
from repro.core import hsgd as JH
from repro.data.partition import hybrid_partition
from repro.data.synthetic import ORGANAMNIST, make_dataset
from repro.models.split_model import cnn_hybrid as jax_cnn_hybrid
from repro_torch.common.pytree import flatten_dict

SRC = Path(__file__).resolve().parents[1] / "src"
FED = dict(num_groups=4, devices_per_group=8, alpha=0.5, local_interval=2, global_interval=4)
ROUNDS = 2
PRIVATE_STEPS = 4
PRIVATE_TRAIN = dict(learning_rate=0.01, compression_k=0.25, quantization_bits=128)
PRIVATE = {"dp": dict(dp_clip=1.0, dp_sigma=1.0, privacy_budget=12.0),
           "secure": dict(secure_agg=True)}
CASES = [{"name": f"{c}-{a}", "agg": a,
          "train": dict(learning_rate=0.02, compression_k=0.25 if c else 0.0,
                        quantization_bits=128 if c else 0)}
         for c in (False, True) for a in (False, True)]

_HSGD_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
torch.set_num_threads(1)
store, rank, n, inp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import flatten_dict, tree_leaves, unflatten_dict
from repro_torch.core import hsgd as H
from repro_torch.data.partition import hybrid_partition
from repro_torch.data.synthetic import ORGANAMNIST, make_dataset
from repro_torch.models.split_model import cnn_hybrid
cfg = json.load(open(inp + ".json"))
arrs = np.load(inp + ".npz")
fed = FederationConfig(**cfg["fed"])
X, y = make_dataset(ORGANAMNIST, fed.num_groups * fed.devices_per_group, seed=0)
raw = hybrid_partition(ORGANAMNIST, X, y, fed, seed=0).stacked()
data = {k: torch.as_tensor(v) for k, v in raw.items()}
model = cnn_hybrid(h_rows=11)
params = model.params_from_numpy(unflatten_dict({k: arrs[k] for k in arrs.files if k != "parts" and ":" not in k}), "cpu")
mesh = init_device_mesh("cpu", (n, 1), mesh_dim_names=("data", "model"))
res = {}
for case in cfg["cases"]:
    runner = H.HSGDRunner(model, fed, TrainConfig(**case["train"]), do_global_agg=case["agg"])
    state = H.init_state(torch.Generator(), model, fed, data, params=params)
    state, losses = runner.run(state, data, H.make_group_weights(data), cfg["rounds"],
                               participants=torch.as_tensor(arrs["parts"]), mesh=mesh)
    res[case["name"]] = {"losses": losses.tolist(),
                         "groups": sorted({int(x.shape[0]) for x in tree_leaves(state.theta0)})}
# a sharded run's returned state, chained into a second run and read by
# global_model; the meshless chain beside it
case = cfg["cases"][-1]
w, parts, gms = H.make_group_weights(data), torch.as_tensor(arrs["parts"]), {}
for tag, m in (("plain", None), ("mesh", mesh)):
    runner = H.HSGDRunner(model, fed, TrainConfig(**case["train"]), do_global_agg=case["agg"])
    state, chained = H.init_state(torch.Generator(), model, fed, data, params=params), []
    for r in range(cfg["rounds"]):
        state, losses = runner.run(state, data, w, 1,
                                   participants=parts[r * fed.lam:(r + 1) * fed.lam], mesh=m)
        chained += losses.tolist()
    for k, v in flatten_dict(H.global_model(state, w, m)).items():
        gms[tag + ":" + k] = v.numpy()
    res["chained-" + tag] = {"losses": chained,
                             "groups": sorted({int(x.shape[0]) for x in tree_leaves(state.theta0)})}
np.savez(out + "." + str(rank) + ".npz", **gms)
# the adaptive controller: with the mesh and without, from one start
from repro_torch.core.controller import AdaptiveConfig, AdaptiveHSGDRunner
train = TrainConfig(learning_rate=0.02, compression_k=0.25, quantization_bits=128)
for tag, m in (("adaptive-plain", None), ("adaptive-mesh", mesh)):
    runner = AdaptiveHSGDRunner(model, fed, train, AdaptiveConfig(total_steps=8, init_probe=False))
    state = H.init_state(torch.Generator().manual_seed(3), model, fed, data, params=params)
    r = runner.run(state, data, H.make_group_weights(data), mesh=m)
    res[tag] = {"losses": np.asarray(r.losses).tolist(), "P": [h["P"] for h in r.history],
                "groups": sorted({int(x.shape[0]) for x in tree_leaves(r.state.theta0)})}
# the private legs: DP, then secure aggregation, each with the mesh and without
from repro_torch.core.controller import ladder_from
for leg, kw in cfg["private"].items():
    draws = {k[len(leg) + 1:]: torch.as_tensor(arrs[k]) for k in arrs.files if k.startswith(leg + ":")}
    noise = [draws["noise"][i] for i in range(len(draws["noise"]))] if "noise" in draws else None
    acfg = AdaptiveConfig(total_steps=cfg["private_steps"], init_probe=False, max_interval=1,
                          ladder=ladder_from(0.25, 128), **kw)
    for tag, m in (("plain", None), ("mesh", mesh)):
        runner = AdaptiveHSGDRunner(model, fed, TrainConfig(**cfg["private_train"]), acfg)
        state = H.init_state(torch.Generator(), model, fed, data, params=params)
        r = runner.run(state, data, H.make_group_weights(data), participants=draws["parts"],
                       dp_noise=noise, mesh=m)
        res[leg + "-" + tag] = {
            "losses": np.asarray(r.losses).tolist(),
            "plans": [[h[k] for k in ("P", "Q", "rung", "dp_rung")] for h in r.history],
            "groups": sorted({int(x.shape[0]) for x in tree_leaves(r.state.theta0)})}
json.dump(res, open(out + "." + str(rank) + ".json", "w"))
dist.destroy_process_group()
"""


def _spawn(code: str, n: int, tmp_path: Path, inp: str, timeout: int = 240):
    """Run ``code`` as ``n`` ranks (one process each) meeting at a FileStore
    in ``tmp_path``; each rank's JSON result."""
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, store, str(r), str(n), inp, out],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(n)]
    errs = [p.communicate(timeout=timeout)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [json.load(open(f"{out}.{r}.json")) for r in range(n)]


def _message_shape(jfed, jdata, jmodel, state):
    """The whole exchange message's row matrix (θ0 snapshot, ζ1, ζ2 of all
    M groups) as the port stacks it: the DP noise's shape."""
    leaves = jax.tree_util.tree_leaves({"theta0": state.stale["theta0"],
                                        "z1": state.stale["z1"], "z2": state.stale["z2"]})
    widths = [x.shape[-1] for x in leaves]
    return (sum(x.size // w for x, w in zip(leaves, widths)), max(widths))


def _private_reference(jfed, jdata, jmodel, init):
    """The reference's adaptive runs with each private leg, and the draws
    they made (participants at every exchange; with DP, the noise)."""
    from repro.core import controller as JC

    out = {}
    for leg, kw in PRIVATE.items():
        cfg = JC.AdaptiveConfig(total_steps=PRIVATE_STEPS, init_probe=False, max_interval=1,
                                ladder=JC.ladder_from(0.25, 128), **kw)
        state = init(jax.random.PRNGKey(0), jdata)
        shape = _message_shape(jfed, jdata, jmodel, state)
        res = JC.AdaptiveHSGDRunner(jmodel, jfed, JaxTrain(**PRIVATE_TRAIN), cfg).run(
            state, jdata, JH.make_group_weights(jdata))
        _, k = jax.random.split(jax.random.PRNGKey(0))
        parts, noise = [], []
        for _ in range(len(res.history)):  # one exchange a round (Λ = 1)
            if leg == "dp":
                k, ks, kdp = jax.random.split(k, 3)
                noise.append(np.asarray(jax.random.normal(kdp, shape, jnp.float32)))
            else:
                k, ks = jax.random.split(k)
            parts.append(np.asarray(JF.sample_participants(ks, jfed)))
        draws = {f"{leg}:parts": np.stack(parts)}
        if noise:
            draws[f"{leg}:noise"] = np.stack(noise)
        out[leg] = (np.asarray(res.losses),
                    [[h[k] for k in ("P", "Q", "rung", "dp_rung")] for h in res.history], draws)
    return out


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's single-device per-step losses for the four cases,
    its initial model and its participants."""
    jfed = JaxFed(**FED)
    X, y = make_dataset(ORGANAMNIST, jfed.num_groups * jfed.devices_per_group, seed=0)
    jdata = {k: jnp.asarray(v) for k, v in
             hybrid_partition(ORGANAMNIST, X, y, jfed, seed=0).stacked().items()}
    jmodel = jax_cnn_hybrid(h_rows=11)
    init = jax.jit(lambda key, d: JH.init_state(key, jmodel, jfed, d))
    w = JH.make_group_weights(jdata)
    losses = {}
    for case in CASES:
        runner = JH.HSGDRunner(jmodel, jfed, JaxTrain(**case["train"]),
                               do_global_agg=case["agg"])
        _, l = runner.run(init(jax.random.PRNGKey(0), jdata), jdata, w, rounds=ROUNDS)
        losses[case["name"]] = np.asarray(l)
    state = init(jax.random.PRNGKey(0), jdata)
    one = lambda x, lead: np.asarray(x[(0,) * lead])
    params = {"theta0": jax.tree.map(lambda x: one(x, 1), state.theta0),
              "theta1": jax.tree.map(lambda x: one(x, 1), state.theta1),
              "theta2": jax.tree.map(lambda x: one(x, 2), state.theta2)}
    _, k = jax.random.split(jax.random.PRNGKey(0))
    parts = []
    for _ in range(ROUNDS * jfed.lam):
        k, ks = jax.random.split(k)
        parts.append(np.asarray(JF.sample_participants(ks, jfed)))
    return losses, params, np.stack(parts), _private_reference(
        jfed, jdata, jmodel, init)


@pytest.mark.parametrize("n", [2, 4])
def test_group_sharded_hsgd_matches_reference(n, reference_runs, tmp_path):
    losses, params, parts, private = reference_runs
    inp = str(tmp_path / "inp")
    draws = {k: v for leg in private.values() for k, v in leg[2].items()}
    np.savez(inp + ".npz", parts=parts, **flatten_dict(params), **draws)
    json.dump({"fed": FED, "rounds": ROUNDS, "cases": CASES, "private": PRIVATE,
               "private_train": PRIVATE_TRAIN, "private_steps": PRIVATE_STEPS},
              open(inp + ".json", "w"))
    ranks = _spawn(_HSGD_WORKER, n, tmp_path, inp)
    last = CASES[-1]["name"]
    for r, res in enumerate(ranks):  # a sharded run's state, chained and read back
        assert res["chained-mesh"]["groups"] == [FED["num_groups"] // n]
        for tag in ("plain", "mesh"):
            np.testing.assert_allclose(res["chained-" + tag]["losses"], losses[last], rtol=1e-5,
                                       atol=1e-6, err_msg=tag)
        gms = np.load(str(tmp_path / "out") + f".{r}.npz")
        names = [k[len("plain:"):] for k in gms.files if k.startswith("plain:")]
        assert names and len(gms.files) == 2 * len(names)
        for k in names:  # the all-reduced eq. (2) sums in another order: 1e-5 of the leaf's scale
            want = gms["plain:" + k]
            assert np.abs(gms["mesh:" + k] - want).max() <= 1e-5 * np.abs(want).max(), k
    for leg, (jl, jplans, _) in private.items():  # the private legs on the mesh
        for res in ranks:
            plain, meshed = res[leg + "-plain"], res[leg + "-mesh"]
            assert meshed["groups"] == [FED["num_groups"] // n]
            assert meshed["plans"] == plain["plans"] == jplans
            np.testing.assert_allclose(plain["losses"], jl, rtol=1e-4, err_msg=leg)
            np.testing.assert_allclose(meshed["losses"], plain["losses"], rtol=1e-5, atol=1e-6,
                                       err_msg=leg)
    for case in CASES:
        for res in ranks:
            got = res[case["name"]]
            assert got["groups"] == [FED["num_groups"] // n]  # genuinely sharded
            np.testing.assert_allclose(np.asarray(got["losses"]), losses[case["name"]],
                                       rtol=1e-5, atol=1e-6, err_msg=case["name"])
    for res in ranks:  # the adaptive controller's run(mesh=) against its own meshless run
        plain, meshed = res["adaptive-plain"], res["adaptive-mesh"]
        assert meshed["groups"] == [FED["num_groups"] // n] and plain["groups"] == [4]
        assert meshed["P"] == plain["P"]
        np.testing.assert_allclose(meshed["losses"], plain["losses"], rtol=1e-5, atol=1e-6)


_LLM_WORKER = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
torch.set_num_threads(1)
store, rank, n, inp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
from repro_torch.common.config import InputShape, get_config
from repro_torch.common.pytree import tree_map
from repro_torch.common.sharding import map_structure, structure_leaves
from repro_torch.launch import steps as S
cfg = get_config("gemma3-1b", smoke=True).replace(dtype="float32")
progs = S.build_programs(cfg, InputShape("train", 32, 4, "train"))
step, (p_sds, s_sds, b_sds), axes = progs.entries["train_step"]
model = S.make_hybrid(cfg)
params = model.init(torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
batch = map_structure(lambda x: torch.randint(0, cfg.vocab_size, x.shape, generator=g,
                                              dtype=torch.int32), b_sds)
stale = progs.entries["exchange"][0](params, batch)
ref_params, ref_loss = step(tree_map(torch.clone, params), stale, batch)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
args = (params, stale, batch)
dargs = tuple(map_structure(lambda x, p: distribute_tensor(x, mesh, p), a,
                            S.build_shardings(a, ax, mesh)) for a, ax in zip(args, axes))
sharded = sum(any(p.is_shard() for p in x.placements) for x in structure_leaves(dargs))
with implicit_replication():
    new, loss = step(*dargs)
loss = loss.full_tensor()
diff = max(float((x.full_tensor() - y).abs().max())
           for x, y in zip(structure_leaves(new), structure_leaves(ref_params)))
if rank == 0:
    json.dump({"loss": float(loss), "ref_loss": float(ref_loss), "param_diff": diff,
               "sharded_leaves": sharded}, open(out + ".0.json", "w"))
else:
    json.dump({}, open(out + "." + str(rank) + ".json", "w"))
dist.destroy_process_group()
"""


def test_sharded_llm_train_step_matches_one_process(tmp_path):
    res = _spawn(_LLM_WORKER, 4, tmp_path, str(tmp_path / "unused"))[0]
    assert res["sharded_leaves"] > 20  # FSDP/tensor-parallel layout, not replicated
    np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-5)
    assert res["param_diff"] <= 1e-6
