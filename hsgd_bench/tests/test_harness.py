"""The harness on the CPU: the benchmark file, discovery by file name, the
result line's shape, the counts by hand, the trace arithmetic and the
modules a run loads."""
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hsgd_bench import check, counts, spec, trace
from hsgd_bench import weights as W
from hsgd_bench.reference import model as RM
from hsgd_bench.tests.conftest import CELLS, smoke_cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["hsgd_bench"] and bench["command"][1].startswith("hsgd_bench/")
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {"train_samples_per_s", "peak_device_gib", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
    assert cells == 1 and bench["workloads"][0]["name"] == "falcon-mamba-7b-16L.seq256"
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]


@pytest.mark.parametrize("metric", [m["name"] for m in spec.benchmark()["per_layer"]])
def test_metric_files_state_their_entry(metric):
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[metric]
    mod = spec.metric_module(metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    assert entry["moves"] == "train_samples_per_s"
    empty = {"device": [], "host": [], "busy_us": 0.0, "window_us": 1.0}
    assert mod.read({"traced": empty, "rounds": 1, "steps": 4,
                     "exchanges": 2, "window_rounds": 0, "window_s": 1.0, "peaks": None,
                     "round_flops": 1.0, "exchange_bytes": 1.0, "round_scan_bytes": 1.0}) is None


def test_a_new_cell_is_new_files(tmp_path, cpu_run):
    """A configuration, a traffic mix, a per-layer metric and a cell added as
    files and entries, with no file of the harness edited, run."""
    shutil.copytree(HERE, tmp_path / "hsgd_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    cfg = json.loads((HERE / "configs" / "falcon-mamba-7b-16L.json").read_text())
    cfg["name"] = "falcon-mamba-7b-8L"
    cfg["model"]["num_layers"] = 8
    (tmp_path / "hsgd_bench/configs/falcon-mamba-7b-8L.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "seq256.json").read_text())
    mix["name"] = "seq32"
    mix["seq"] = 32
    (tmp_path / "hsgd_bench/traffic/seq32.json").write_text(json.dumps(mix))
    (tmp_path / "hsgd_bench/limits/falcon-mamba-7b-8L.seq32.json").write_text(
        (HERE / "limits" / "falcon-mamba-7b-16L.seq256.json").read_text())
    (tmp_path / "hsgd_bench/metrics/rounds_traced.py").write_text(
        'LAYER = "round loop: launch/steps.py LLMRoundRunner"\nUNIT = "count"\n'
        'MOVES = "train_samples_per_s"\n\n\ndef read(ctx):\n    return float(ctx["rounds"])\n')
    bench["configs"].append({**bench["configs"][0], "name": "falcon-mamba-7b-8L",
                             "file": "hsgd_bench/configs/falcon-mamba-7b-8L.json"})
    bench["workloads"].append({"name": "falcon-mamba-7b-8L.seq32", "config": "falcon-mamba-7b-8L",
                               "traffic": "seq32", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "rounds_traced", "unit": "count", "better": "higher",
                               "source": "program_counter",
                               "layer": "round loop: launch/steps.py LLMRoundRunner",
                               "moves": "train_samples_per_s",
                               "workloads": ["falcon-mamba-7b-8L.seq32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("falcon-mamba-7b-8L.seq32", spec.benchmark(tmp_path), tmp_path)
    assert cell["config"]["model"]["num_layers"] == 8 and cell["traffic"]["seq"] == 32
    assert "rounds_traced" in [m["name"] for m in cell["per_layer"]]
    cell["config"]["model"] = smoke_cell(CELLS[0])["config"]["model"]
    cell["traffic"] = {**cell["traffic"], "seq": 8, "pool_rounds": 1}
    out = cpu_run(cell, trace=True)
    assert out["correct"] and out["metrics"]["rounds_traced"]["value"] == 1.0


def _named_reference(root: Path, module: str, source) -> str:
    """A copy of the harness under ``root`` with a configuration that names
    ``reference/<module>.py`` (written from ``source`` unless None) and a cell
    of it, added as files and entries only; returns the cell's name."""
    shutil.copytree(HERE, root / "hsgd_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    cfg = json.loads((HERE / "configs" / "falcon-mamba-7b-16L.json").read_text())
    cfg["name"], cfg["reference"] = "falcon-mamba-7b-named", module
    (root / "hsgd_bench/configs/falcon-mamba-7b-named.json").write_text(json.dumps(cfg))
    if source is not None:
        (root / "hsgd_bench/reference" / f"{module}.py").write_text(source)
    cell = "falcon-mamba-7b-named.seq256"
    (root / "hsgd_bench/limits" / f"{cell}.json").write_text(
        (HERE / "limits" / "falcon-mamba-7b-16L.seq256.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "falcon-mamba-7b-named",
                             "file": "hsgd_bench/configs/falcon-mamba-7b-named.json"})
    bench["workloads"].append({"name": cell, "config": "falcon-mamba-7b-named",
                               "traffic": "seq256", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


MODEL_SOURCE = (HERE / "reference" / "model.py").read_text()
# the term times 0, so that its leaf stays in the graph with a zero gradient
NO_D_SKIP = ('y = torch.einsum("btcn,btn->btc", hs, Cm) + p["d_skip"] * xc',
             'y = torch.einsum("btcn,btn->btc", hs, Cm) + 0.0 * p["d_skip"] * xc')


@pytest.mark.parametrize("module, fault", [("model_twin", False), ("model_no_d_skip", True)])
def test_a_new_architecture_is_new_files(tmp_path, cpu_run, module, fault):
    """A configuration that names a reference module of its own, added as
    files and entries with no file of the harness edited, is checked against
    that module: a copy of ``model.py`` passes, the copy whose Mamba-1 mixer
    drops the D skip term fails."""
    source = MODEL_SOURCE.replace(*NO_D_SKIP) if fault else MODEL_SOURCE
    assert (source == MODEL_SOURCE) is not fault
    name = _named_reference(tmp_path, module, source)
    cell = smoke_cell(name, root=tmp_path)
    assert cell["reference"].__file__ == str(tmp_path / "hsgd_bench/reference" / f"{module}.py")
    out = cpu_run(cell)
    assert out["correct"] is not fault, out["checks"]


@pytest.mark.parametrize("module, source, says", [
    ("model_absent", None, "no module"),
    ("model_no_loss", MODEL_SOURCE.replace("def loss(", "def _loss("), "lacks loss of the"),
])
def test_a_bad_reference_key_fails_before_the_device(tmp_path, module, source, says):
    """A configuration whose ``reference`` names no module, or a module
    without a function of the contract, stops ``spec.load_cell``, and so a
    run before it looks for the card."""
    name = _named_reference(tmp_path, module, source)
    with pytest.raises(SystemExit, match="configuration key 'reference'") as err:
        spec.load_cell(name, spec.benchmark(tmp_path), tmp_path)
    assert says in str(err.value) and module in str(err.value)
    out = subprocess.run([sys.executable, "hsgd_bench/run.py", "--workload", name, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == "" and says in out.stderr, out.stderr[-2000:]


FALCON_THETA0 = [
    ("theta0/final_norm/scale", ((4096,), "ones", 0.0)),
    ("theta0/head/w", ((4096, 65024), "normal", 0.02)),
    ("theta0/layers/mamba/a_log", ((16, 8192, 16), "zeros", 0.0)),
    ("theta0/layers/mamba/conv_b", ((16, 8192), "zeros", 0.0)),
    ("theta0/layers/mamba/conv_w", ((16, 4, 8192), "normal", 0.5)),
    ("theta0/layers/mamba/d_skip", ((16, 8192), "ones", 0.0)),
    ("theta0/layers/mamba/dt_bias", ((16, 8192), "zeros", 0.0)),
    ("theta0/layers/mamba/w_bcdt", ((16, 8192, 288), "normal", 0.002762135864009951)),
    ("theta0/layers/mamba/w_dt", ((16, 256, 8192), "normal", 0.1)),
    ("theta0/layers/mamba/w_in", ((16, 4096, 16384), "normal", 0.00390625)),
    ("theta0/layers/mamba/w_out", ((16, 8192, 4096), "normal", 0.002762135864009951)),
    ("theta0/layers/norm/scale", ((16, 4096), "ones", 0.0)),
]
FALCON_TOWER = [
    ("embed/table", ((65024, 4096), "embed", 0.02)),
    ("layers/mamba/a_log", ((1, 8192, 16), "zeros", 0.0)),
    ("layers/mamba/conv_b", ((1, 8192), "zeros", 0.0)),
    ("layers/mamba/conv_w", ((1, 4, 8192), "normal", 0.5)),
    ("layers/mamba/d_skip", ((1, 8192), "ones", 0.0)),
    ("layers/mamba/dt_bias", ((1, 8192), "zeros", 0.0)),
    ("layers/mamba/w_bcdt", ((1, 8192, 288), "normal", 0.011048543456039804)),
    ("layers/mamba/w_dt", ((1, 256, 8192), "normal", 0.1)),
    ("layers/mamba/w_in", ((1, 4096, 16384), "normal", 0.015625)),
    ("layers/mamba/w_out", ((1, 8192, 4096), "normal", 0.011048543456039804)),
    ("layers/norm/scale", ((1, 4096), "ones", 0.0)),
    ("norm/scale", ((4096,), "ones", 0.0)),
]


def test_the_falcon_cell_reads_what_it_read():
    """The falcon cell's layout (leaf order, shapes, draws) and the counts its
    per-layer metrics divide by, exactly as the harness gave them before a
    configuration could name its reference."""
    cell = spec.load_cell("falcon-mamba-7b-16L.seq256", spec.benchmark())
    cfg, tr, model = cell["config"], cell["traffic"], cell["reference"]
    assert cell["reference"].__file__ == str(HERE / "reference" / "model.py")
    layout = model.param_layout(cfg["model"], cfg["n_tower"])
    towers = [(f"theta{i}/{path}", leaf) for i in (1, 2) for path, leaf in FALCON_TOWER]
    assert [("/".join(path), leaf) for path, leaf in W.leaves(layout)] == FALCON_THETA0 + towers
    assert counts.round_flops(model, cfg["model"], tr, cfg["n_tower"]) == 82371567157248.0
    assert counts.round_scan_bytes(model, cfg["model"], tr, cfg["n_tower"]) == 571599749120.0
    assert counts.exchange_bytes(cfg["model"], tr, layout) == 31254970368.0


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(cpu_run, traced):
    out = cpu_run(smoke_cell(CELLS[0]), trace=traced)
    assert list(out)[-1] == "checks" and list(out)[:5] == ["correct", "attempted", "failed",
                                                            "metrics", "device"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] % 16 == 0
    assert set(out["checks"]) == {"loss_gap", "update_gap", "change_gap_median"}
    for c in out["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        assert set(out["metrics"]) <= {m["name"] for m in spec.benchmark()["per_layer"]}
    else:
        assert set(out["metrics"]) == {"train_samples_per_s", "peak_device_gib", "setup_s"}
    json.dumps(out, allow_nan=False)


def _norms(gaps):
    """{round: {(pod, leaf): ‖Δ‖}} pairs whose leaves read ``gaps`` (the reference's all 1)."""
    ref = {(0, (str(i),)): 1.0 for i in range(len(gaps))}
    prog = {key: 1.0 + g for key, g in zip(ref, gaps)}
    return {1: ref, 2: ref}, {1: ref, 2: prog}


@pytest.mark.parametrize("gaps, median, worst", [
    ([0.0] * 8, 0.0, 0.0),
    ([0.0] * 7 + [3e-4], 0.0, 3e-4),  # one leaf far out: the median holds, the worst shows it
    ([1e-3] * 5 + [0.0] * 3, 1e-3, 1e-3),  # most leaves off: the median sees it
    ([0.0] * 7 + [math.nan], math.inf, math.inf),  # a leaf that is not finite fails
    ([-1.0] * 8, 1.0, 1.0),  # a state left unchanged reads 1
])
def test_change_gap_is_the_median_leafs(gaps, median, worst):
    ref, prog = _norms(gaps)
    values = check.numbers([[1.0]], [[1.0]], prog, ref, 1)
    assert values["update_gap"] == 0.0
    assert values["change_gap_median"] == pytest.approx(median)
    assert values["change_gap_worst"] == pytest.approx(worst)
    ok, checks = check.verdict(values, {"loss_gap": 0, "update_gap": 0, "change_gap_median": 1e-4})
    assert set(checks) == set(check.NUMBERS) and ok is (median <= 1e-4)


TINY = {"family": "ssm", "num_layers": 2, "d_model": 8, "vocab_size": 10, "ssm_state": 4,
        "ssm_conv": 4, "ssm_expand": 2, "ssm_version": 1, "ssm_headdim": 64}
TINY_TRAFFIC = {"pods": 1, "batch": 1, "seq": 4, "P": 1, "Q": 1}


def test_flops_by_hand():
    # a Mamba-1 token: 2·(8·32 + 16·9 + 1·16 + 16·8) = 1088 weight FLOPs,
    # 2·16·4 = 128 for y = C·h, 512 of them the in-projection's
    tower, body, head = 2 * (1088 + 128), 2 * 4 * (1088 + 128), 2 * 4 * 8 * 10
    hospital = 3 * (tower + body + head) - 512 * 2
    device = (body + head) + (2 * 4 * 1088 + 2 * 2 * 4 * 128 + head) - 512 * 2 + 3 * tower
    assert counts.step_flops(RM, TINY, TINY_TRAFFIC) == hospital + device == 65408
    assert counts.exchange_flops(RM, TINY, TINY_TRAFFIC) == 2 * tower
    assert counts.round_flops(RM, TINY, TINY_TRAFFIC) == 65408 + 2 * tower


def test_forward_flops_are_what_torch_counts():
    """The forward terms against torch's own count of the reference's forward."""
    params = RR_tree(W.draw(RM.param_layout(TINY), 1, 1, "cpu"))
    ids = torch.randint(0, 10, (1, 4))
    with FlopCounterMode(display=False) as fc:
        z = RM.tower(TINY, params["theta1"], ids)
    assert fc.get_total_flops() == 4 * (1088 + 128)
    with FlopCounterMode(display=False) as fc:
        RM.loss(TINY, params["theta0"], z[:, :2], z[:, 2:], ids)
    assert fc.get_total_flops() == 2 * 4 * (1088 + 128) + 2 * 4 * 8 * 10


def RR_tree(params):
    from hsgd_bench.reference.round import tree_map
    return tree_map(lambda x: x[0], params)


def test_bytes_by_hand():
    theta0 = counts.param_count(RM.param_layout(TINY)["theta0"])
    # θ0: 2 layers of (8·32 + 4·16 + 16 + 16·9 + 16 + 16 + 16·4 + 16 + 16·8 + 8), norm, head
    assert theta0 == 2 * (256 + 64 + 16 + 144 + 16 + 16 + 64 + 16 + 128 + 8) + 8 + 80
    assert counts.exchange_bytes(TINY, TINY_TRAFFIC, RM.param_layout(TINY)) == 8 * (theta0 + 32)
    C = 16 * 4
    fwd = lambda T: 4 * (3 * T * C + 2 * C)
    bwd = lambda T: 4 * (5 * T * C + 3 * C)
    step = (fwd(2) + bwd(2)) * 2 + 2 * 2 * (fwd(4) + bwd(4))
    assert counts.round_scan_bytes(RM, TINY, TINY_TRAFFIC) == step + 2 * fwd(2)


def test_trace_arithmetic(tmp_path):
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 30, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void compress_group_kernel<64, 1, false>", "ts": 5,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void gemm", "ts": 12, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "an instant", "ts": 50},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace._read(str(path))
    assert len(got["device"]) == 3 and len(got["host"]) == 2
    assert trace.busy_us([(d["ts"], d["dur"]) for d in got["device"]]) == 32.0
    found = trace.kernels(got, ("compress_group_kernel", "compress_rows_kernel"))
    assert [d["dur"] for d in found] == [10.0]
    assert trace.kernels(got, ("Memcpy",)) == []  # kernels only
    bd = trace.breakdown(got)
    assert bd["idle_gaps"] == [["aten::item", 8e-6]]
    assert bd["device_ops"][0] == ["void gemm", 2e-5]


@pytest.mark.parametrize("name, want", [("NVIDIA H100 80GB HBM3", 67e12),
                                        ("NVIDIA H100 PCIe", None), ("cpu", None)])
def test_peaks_are_the_cards_alone(name, want):
    from hsgd_bench import harness
    got = harness.peaks(name)
    assert (got and got["fp32_flops"]) == want


def test_no_jax_or_reference_package_is_loaded(tmp_path, cpu_run):
    """Runs of the falcon cell and of a cell whose configuration names a
    reference module of its own load nothing of JAX or the JAX package."""
    named = _named_reference(tmp_path, "model_twin", MODEL_SOURCE)
    code = (
        "import sys, time, torch; sys.path[:0] = ['src', '.']\n"
        "from pathlib import Path\n"
        "from hsgd_bench import harness, spec, readings\n"
        "from hsgd_bench.tests.conftest import smoke_cell\n"
        "torch.set_num_threads(2)\n"
        f"for cell in (smoke_cell('falcon-mamba-7b-16L.seq256'),\n"
        f"             smoke_cell({named!r}, root=Path({str(tmp_path)!r}))):\n"
        "    harness.run(cell, 3, 0.01, True, torch.device('cpu'), time.perf_counter(),\n"
        "                log=lambda m: None)\n"
        "print(cell['reference'].__file__)\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith('hsgd_bench.reference')"
        " or m == 'repro_torch'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-3] == str(tmp_path / "hsgd_bench/reference/model_twin.py")
    assert lines[-2] == "[]"
    assert "repro_torch" in lines[-1]  # the program ran; its name is not the reference's


def test_reference_alone_loads_no_port():
    code = ("import sys; sys.path[:0] = ['.']\n"
            "import hsgd_bench.reference.round, hsgd_bench.reference.model\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from hsgd_bench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "hsgd_bench/run.py", "--workload", CELLS[0],
                          "--seed", str(2 ** 32 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def test_token_stream_is_the_seeds():
    from hsgd_bench import tokens
    tr = {"P": 4, "Q": 2, "pods": 2, "batch": 2, "seq": 16, "drift": 17, "p_drift": 0.7}
    a = tokens.rounds(tr, 100, 2 ** 40 + 3, 3, "cpu")
    b = tokens.rounds(tr, 100, 2 ** 40 + 3, 3, "cpu")
    c = tokens.rounds(tr, 100, 2 ** 40 + 4, 3, "cpu")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["y"], c[0]["y"])
    assert a[0]["x1"].shape == (2, 2, 2, 8) and a[0]["y"].shape == (2, 2, 2, 16)
    rows = torch.cat([r["x1"].reshape(-1, 8) for r in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]  # every row differs


def test_weights_are_the_seeds_and_units_redraw():
    layout = RM.param_layout(TINY)
    a, b = W.draw(layout, 2 ** 35, 2, "cpu"), W.draw(layout, 2 ** 35, 2, "cpu")
    for (path, x), (_, y) in zip(W.leaves(a), W.leaves(b)):
        assert torch.equal(x, y) and torch.equal(x[0], x[1]), path
    norms = W.change_norms(a, layout, 2 ** 35)
    assert set(norms.values()) == {0.0}
    W.get(a, ("theta0", "head", "w"))[1, 0, 0] += 3.0
    norms = W.change_norms(a, layout, 2 ** 35)
    assert norms[(1, ("theta0", "head", "w"))] == 3.0 and math.fsum(norms.values()) == 3.0
