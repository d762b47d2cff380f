"""The port's checkpoint against the JAX package's, and the launcher's
``--checkpoint``.

Round trips are bit for bit (``torch.equal``), the generators included: the
draws after a restore are the draws the saved generator makes next. A
parameter checkpoint written by either package loads in the other to the
same arrays, with the same manifest. The fixed path's saved global model
evaluates to the metrics the run printed. The quickstart twin is held to
the reference's ``auc_roc > 0.6`` on the CPU.
"""
import json
import os
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.core import metrics as JMET
from repro.launch import train as JT
from repro_torch.checkpoint import ckpt as CK
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core import baselines as B
from repro_torch.core import hsgd as H
from repro_torch.core import metrics as MET
from repro_torch.data.synthetic import DATASETS, flatten_for_tower, make_dataset, vertical_split
from repro_torch.launch import train as T
from test_torch_population import _jax_init, both_data, reference_params, setup

TINY = ["--device", "cpu", "--groups", "2", "--devices", "16", "--samples", "128",
        "--rounds", "2"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tensors(state):
    """Every tensor of a state (a NamedTuple of tensor dicts, a generator
    and a step)."""
    return [t for v in state if isinstance(v, dict) for t in tree_leaves(v)]


def _hsgd_state_after_a_round():
    _, tfed, raw, _, tmodel = setup()
    _, tdata = both_data(raw)
    runner = H.HSGDRunner(tmodel, tfed, H.TrainConfig(learning_rate=0.05, compression_k=0.25,
                                                      quantization_bits=128))
    state = H.init_state(torch.Generator().manual_seed(5), tmodel, tfed, tdata)
    state, _ = runner.run(state, tdata, H.make_group_weights(tdata), 1)  # draws from it
    return runner, state, tdata


def test_hsgd_state_round_trips_bit_for_bit_with_its_generator(tmp_path):
    runner, state, data = _hsgd_state_after_a_round()
    d = str(tmp_path / "ck")
    CK.save_checkpoint(d, state, step=state.step, extra={"tag": "one"})
    back, step, extra = CK.load_checkpoint(d)
    assert type(back) is H.HSGDState and step == state.step and extra == {"tag": "one"}
    assert isinstance(back.step, int) and back.step == state.step
    assert back.generator is not state.generator
    assert torch.equal(back.generator.get_state(), state.generator.get_state())
    a, b = _tensors(state), _tensors(back)
    assert len(a) == len(b) >= 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the next round draws the same participants and trains to the same bits
    w = H.make_group_weights(data)
    s1, l1 = runner.run(state, data, w, 1)
    s2, l2 = runner.run(back, data, w, 1)
    assert torch.equal(l1, l2)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(s1), _tensors(s2)))


def test_jfl_state_round_trips_bit_for_bit_with_its_generator(tmp_path):
    _, tfed, raw, _, tmodel = setup()
    _, tdata = both_data(raw)
    runner = B.JFLRunner(tmodel, tfed, H.TrainConfig(learning_rate=0.05))
    w = H.make_group_weights(tdata)
    state, _ = runner.run(runner.init(torch.Generator().manual_seed(3)), tdata, w, 1)
    d = str(tmp_path / "ck")
    CK.save_checkpoint(d, state, step=state.step)
    back, step, _ = CK.load_checkpoint(d)
    assert type(back) is B.JFLState and back.step == step == state.step
    for x, y in zip(tree_leaves(state.params), tree_leaves(back.params)):
        assert torch.equal(x, y)
    s1, l1 = runner.run(state, tdata, w, 1)
    s2, l2 = runner.run(back, tdata, w, 1)
    assert torch.equal(l1, l2)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(s1.params), tree_leaves(s2.params)))


def test_containers_device_and_unregistered_classes(tmp_path):
    Pt = namedtuple("UnregisteredPoint", "x y")
    tree = {"a": [torch.arange(3.0), (torch.ones(2, dtype=torch.int32), 7)],
            "b": Pt(torch.zeros(()), {"c": np.float64(2.5)}),
            "g": torch.Generator().manual_seed(1)}
    d = str(tmp_path / "ck")
    CK.save_checkpoint(d, tree, step=3)
    back, step, _ = CK.load_checkpoint(d, device="meta")
    assert step == 3 and isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    assert back["a"][1][1] == 7 and isinstance(back["a"][1][1], int)
    assert type(back["b"]).__name__ == "UnregisteredPoint" and back["b"]._fields == ("x", "y")
    assert all(t.device.type == "meta" for t in (back["a"][0], back["a"][1][0], back["b"].x))
    assert back["b"].y["c"].dtype == torch.float64
    assert back["g"].device.type == "cpu"
    assert torch.equal(torch.randn(4, generator=back["g"]),
                       torch.randn(4, generator=torch.Generator().manual_seed(1)))


def test_torn_save_leaves_previous_checkpoint_loadable(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    CK.save_checkpoint(d, {"w": torch.arange(4.0)}, step=1, extra={"tag": "one"})

    def torn(path, doc, **kw):  # die between the arrays write and the commit
        raise RuntimeError("preempted mid-save")

    monkeypatch.setattr(CK, "atomic_write_json", torn)
    with pytest.raises(RuntimeError):
        CK.save_checkpoint(d, {"w": torch.arange(4.0) * 7}, step=2, extra={"tag": "two"})
    monkeypatch.undo()
    payload, step, extra = CK.load_checkpoint(d)  # the previous checkpoint still commits
    assert step == 1 and extra["tag"] == "one"
    assert torch.equal(payload["w"], torch.arange(4.0))
    # ...and the next successful save prunes the orphaned arrays file
    CK.save_checkpoint(d, {"w": torch.arange(4.0) * 9}, step=3, extra={"tag": "3"})
    payload, step, _ = CK.load_checkpoint(d)
    assert step == 3 and torch.equal(payload["w"], torch.arange(4.0) * 9)
    assert sorted(os.listdir(d)) == ["arrays-000000000003.npz", "manifest.json"]


def test_params_checkpoints_load_across_packages(tmp_path):
    jfed, _, raw, _, _ = setup()
    jdata, _ = both_data(raw)
    params = reference_params(jfed, jdata, 0)
    nested = {"model": params, "seq": [params["theta0"]["fc2_b"], (np.arange(3),)]}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    JCK.save_checkpoint(ref_dir, nested, step=4, extra={"k": 1})
    tparams = tree_map(lambda a: torch.from_numpy(np.array(a)), params)  # the same key order
    CK.save_checkpoint(port_dir, {"model": tparams, "seq": [tparams["theta0"]["fc2_b"],
                                                            (torch.arange(3),)]},
                       step=4, extra={"k": 1})
    manifests = [json.load(open(os.path.join(d, "manifest.json"))) for d in (ref_dir, port_dir)]
    assert manifests[0] == manifests[1]
    got, step, extra = CK.load_checkpoint(ref_dir)
    assert step == 4 and extra == {"k": 1}
    for x, y in zip(tree_leaves(got["model"]), jax.tree_util.tree_leaves(params)):
        assert isinstance(x, torch.Tensor) and np.array_equal(x.numpy(), np.asarray(y))
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)
    back, _, _ = JCK.load_checkpoint(port_dir)
    for x, y in zip(jax.tree_util.tree_leaves(back["model"]), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.asarray(y).dtype


def test_fixed_path_checkpoint_evaluates_to_the_printed_metrics(tmp_path, capsys):
    d = str(tmp_path / "gm")
    m, losses = T.run_ehealth(T.parse_args(TINY + ["--algorithm", "c-hsgd", "--checkpoint", d]))
    out = capsys.readouterr().out
    assert f"checkpoint -> {d}" in out
    gm, step, extra = CK.load_checkpoint(d)
    assert step == m["steps"] == len(losses)
    assert extra["metrics"] == json.loads(json.dumps(m))
    spec = DATASETS["organamnist"]
    X, y = make_dataset(spec, 128, seed=0)
    X1, X2 = vertical_split(spec, X)
    x1, x2 = flatten_for_tower(spec, X1), flatten_for_tower(spec, X2)
    model = T.make_paper_model("paper-cnn", "organamnist")
    again = MET.evaluate_global(model, gm, x1, x2, y)
    assert again == {k: m[k] for k in again}
    # the reference reads the same file and evaluates its own model to the same numbers
    jgm, _, _ = JCK.load_checkpoint(d)
    ref = JMET.evaluate_global(JT.make_paper_model("paper-cnn", "organamnist"), jgm, x1, x2, y)
    for k in ("loss", "auc_roc"):
        np.testing.assert_allclose(ref[k], again[k], rtol=1e-4)


def test_population_checkpoint_holds_the_final_state(tmp_path, capsys):
    d = str(tmp_path / "pop")
    args = T.parse_args(TINY + ["--population", "sync", "--pop-devices", "8", "--cohort", "2",
                                "--checkpoint", d])
    out, res = T.run_population_cli(args)
    back, step, extra = CK.load_checkpoint(d)
    assert type(back) is H.HSGDState and step == out["steps"]
    assert extra == {"sim_seconds": out["sim_seconds"]}
    assert all(torch.equal(x, y) for x, y in zip(_tensors(res["state"]), _tensors(back)))
    assert "checkpoint ->" in capsys.readouterr().out


def test_quickstart_twin_learns_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    metrics = quickstart.main(["--device", "cpu"])
    assert metrics["auc_roc"] > 0.6
    assert "quickstart OK" in capsys.readouterr().out


def test_example_twins_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.examples import adaptive_ehealth_lstm, quickstart

    for mod in (quickstart, adaptive_ehealth_lstm):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])


def test_reference_state_checkpoint_layout_matches(tmp_path):
    """A port HSGDState and a reference HSGDState of the same run write the
    same leaf names for every tensor (the generator and step aside)."""
    jfed, tfed, raw, jmodel, tmodel = setup()
    jdata, tdata = both_data(raw)
    jstate = _jax_init(jfed)(jax.random.PRNGKey(0), jdata)
    tstate = H.init_state(torch.Generator(), tmodel, tfed, tdata,
                          params=tmodel.params_from_numpy(reference_params(jfed, jdata, 0), "cpu"))
    JCK.save_checkpoint(str(tmp_path / "ref"), jstate)
    CK.save_checkpoint(str(tmp_path / "port"), tstate)
    keys = [set(json.load(open(str(tmp_path / d / "manifest.json")))["keys"])
            for d in ("ref", "port")]
    assert keys[0] - {"__seq5", "__seq6"} == keys[1] - {"__seq5", "__seq6"}
    back, _, _ = CK.load_checkpoint(str(tmp_path / "port"))
    jback, _, _ = JCK.load_checkpoint(str(tmp_path / "ref"))
    for x, y in zip(tree_leaves(tree_map(lambda t: t, back.theta2)),
                    jax.tree_util.tree_leaves(jback.theta2)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
