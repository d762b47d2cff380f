"""The port's training entry point, device rule and package boundary."""
import json
import math
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro.launch import train as REF
from repro_torch.core.controller import epsilon_of, gaussian_rho
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import train as T
from repro_torch.launch.profile_train import busy_us, device_intervals, port_kernel_times

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
TINY = ["--groups", "2", "--devices", "16", "--samples", "128", "--rounds", "2"]
# The JSON keys ``repro.launch.train.run_ehealth`` prints on its fixed-interval
# path: ``evaluate_global``'s metrics, then the three run keys.
REFERENCE_KEYS = {"loss", "accuracy", "precision", "recall", "f1", "auc_roc",
                  "train_loss_final", "steps", "wall_s"}
# The keys its adaptive and privacy branches add.
ADAPTIVE_KEYS = {"adaptive_rounds", "adaptive_bytes_total", "adaptive_final_PQ"}
PRIVATE_KEYS = {"secure_agg", "executors_compiled"}
DP_KEYS = {"epsilon", "delta"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(argv, capsys):
    metrics, losses = T.run_ehealth(T.parse_args(argv))
    printed = json.loads(capsys.readouterr().out)
    assert printed == metrics
    return metrics, losses


@pytest.mark.parametrize("algorithm", ["hsgd", "c-hsgd"])
def test_run_ehealth_emits_reference_keys(algorithm, capsys):
    m, losses = _run(["--device", "cpu", "--algorithm", algorithm] + TINY, capsys)
    assert set(m) == REFERENCE_KEYS
    assert m["steps"] == len(losses) == 2 * 4
    assert all(map(lambda v: v == v, losses))  # finite, no NaN
    assert 0.0 <= m["accuracy"] <= 1.0 and 0.0 <= m["auc_roc"] <= 1.0


@pytest.mark.parametrize("flags,keys", [
    (["--dp-clip", "1", "--dp-sigma", "1", "--secure-agg"], PRIVATE_KEYS | DP_KEYS),
    (["--secure-agg"], PRIVATE_KEYS),
    (["--dp-clip", "1"], PRIVATE_KEYS),
    (["--adaptive"], ADAPTIVE_KEYS),
    (["--adaptive", "--dp-clip", "1", "--dp-sigma", "1", "--epsilon", "25", "--secure-agg"],
     ADAPTIVE_KEYS | PRIVATE_KEYS | DP_KEYS),
])
def test_private_and_adaptive_emit_reference_keys(flags, keys, capsys):
    """The privacy flags and --adaptive on the CPU: the reference's JSON keys
    (after the adaptive round lines), and the ε of the composed releases."""
    reset_launch_counts()
    metrics, losses = T.run_ehealth(T.parse_args(["--device", "cpu", "--algorithm", "c-hsgd"]
                                                 + TINY + flags))
    out = capsys.readouterr().out
    rounds = [ln for ln in out.splitlines() if ln.startswith("[adaptive] round")]
    assert json.loads(out[out.index("{"):]) == metrics
    assert set(metrics) == REFERENCE_KEYS | keys
    assert torch.isfinite(torch.as_tensor(losses)).all()
    assert not launch_counts  # the CPU takes the plain versions
    if "--adaptive" in flags:
        assert len(rounds) == metrics["adaptive_rounds"] > 0
        assert metrics["steps"] == len(losses) <= 2 * 4
    else:
        assert not rounds and metrics["steps"] == 2 * 4
        assert metrics["executors_compiled"] == 1
        if "epsilon" in keys:
            assert metrics["epsilon"] == epsilon_of(2 * 2 * gaussian_rho(1.0), 1e-5)
    if "epsilon" in keys and "--adaptive" in flags:
        assert metrics["epsilon"] <= 25 and "σ=1 ε=" in rounds[0]


@pytest.mark.parametrize("flags", [["--dp-sigma", "1"], ["--dp-clip", "-1"],
                                   ["--dp-sigma", "-0.5", "--dp-clip", "1"], ["--delta", "0"],
                                   ["--delta", "1.5"], ["--epsilon", "0"]])
def test_privacy_argument_checks_match_reference(flags, capsys):
    with pytest.raises(SystemExit) as ref:
        REF.main(flags)
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as port:
        T.parse_args(["--device", "cpu"] + flags)
    assert port.value.code == ref.value.code == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == ref_err


@pytest.mark.parametrize("flags", [["--algorithm", "jfl", "--dp-clip", "1"],
                                   ["--algorithm", "tdcd", "--secure-agg"],
                                   ["--algorithm", "c-tdcd", "--adaptive"]])
def test_other_algorithms_refuse_the_hsgd_paths(flags):
    with pytest.raises(SystemExit) as ref:
        REF.main(TINY + flags)
    with pytest.raises(SystemExit) as port:
        T.run_ehealth(T.parse_args(["--device", "cpu"] + TINY + flags))
    assert str(port.value) == str(ref.value)
    assert "drive" in str(port.value)


@pytest.mark.parametrize("algorithm", ["jfl", "tdcd", "c-tdcd", "centralized"])
def test_baselines_run_on_cpu(algorithm, capsys):
    m, losses = _run(["--device", "cpu", "--algorithm", algorithm] + TINY, capsys)
    assert set(m) == REFERENCE_KEYS
    assert m["steps"] == len(losses) > 0
    assert torch.isfinite(torch.as_tensor(losses)).all()


def test_lstm_model_runs(capsys):
    m, _ = _run(["--device", "cpu", "--model", "paper-lstm", "--dataset", "mimic3",
                 "--algorithm", "c-hsgd", "--groups", "2", "--devices", "8",
                 "--samples", "64", "--rounds", "1"], capsys)
    assert m["steps"] == 4


def test_esr_lstm_runs_with_fewer_samples_than_devices(capsys):
    """paper-lstm on ESR ([B, 89, 1] towers) with 256 samples over the
    default 10 groups of 64 devices: a group's data holds 25 devices, the
    participants are drawn among all 64, and those past the data read the
    fill values, as in the reference. Both runs exit normally and print the
    same metrics (NaN losses included); only the wall time differs."""
    flags = ["--model", "paper-lstm", "--dataset", "esr", "--algorithm", "hsgd",
             "--samples", "256", "--rounds", "1"]
    REF.main(flags)
    ref = json.loads(capsys.readouterr().out)
    T.run_ehealth(T.parse_args(["--device", "cpu"] + flags))
    port = json.loads(capsys.readouterr().out)
    assert set(port) == set(ref) == REFERENCE_KEYS
    assert port["steps"] == ref["steps"] == 4
    for key in REFERENCE_KEYS - {"wall_s"}:
        assert port[key] == ref[key] or (math.isnan(port[key]) and math.isnan(ref[key])), key
    assert math.isnan(ref["train_loss_final"])


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert T.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        T.run_ehealth(T.parse_args(TINY))


@pytest.mark.parametrize("flag", [["--arch", "paper-lstm"], ["--arch", "paper-cnn"],
                                  ["--arch", "qwen2-vl-72b"], ["--arch", "grok-1-314b", "--smoke"],
                                  ["--population", "sync", "--arch", "qwen2-vl-72b"],
                                  ["--fault-nan", "0.1", "--smoke", "--arch", "deepseek-v3-671b"],
                                  ["--checkpoint", "ckpt", "--arch", "deepseek-v3-671b"]])
def test_unported_flags_refuse(flag):
    """Only the paper models, which are not LLM architectures, are refused
    as --arch values; the VLM and MoE configs parse with the same flags
    (their runs: tests/test_torch_vlm.py, tests/test_torch_moe.py), as the dense --arch
    path runs (tests/test_torch_llm.py), the ssm and hybrid ones too
    (tests/test_torch_ssm_train.py), as do the population, fault and
    checkpoint flags (tests/test_torch_faults.py,
    tests/test_torch_population.py, tests/test_torch_checkpoint.py), and
    whisper-medium (tests/test_torch_audio.py)."""
    llm = next((a for a in ("grok-1-314b", "deepseek-v3-671b", "qwen2-vl-72b") if a in flag),
               None)
    if llm:
        assert T.parse_args(["--device", "cpu"] + flag).arch == llm
        return
    with pytest.raises(SystemExit, match="not an LLM architecture"):
        T.parse_args(["--device", "cpu"] + flag)


@pytest.mark.parametrize("flag", [["--arch", "gemma3-1b"], ["--smoke"],
                                  ["--arch", "gemma3-1b", "--smoke"],
                                  ["--population", "sync", "--arch", "gemma3-1b"],
                                  ["--fault-nan", "0.1", "--smoke"],
                                  ["--checkpoint", "ckpt", "--arch", "stablelm-1.6b"]])
def test_llm_flags_parse(flag):
    """The flags of the LLM path parse, with the reference's defaults."""
    args = T.parse_args(["--device", "cpu"] + flag)
    assert (args.steps, args.batch, args.seq, args.p, args.q, args.pods) == (20, 2, 64, 4, 2, 1)


def test_package_imports_no_jax():
    """Import repro_torch and every submodule in a fresh interpreter: jax,
    the JAX package and the fake process group's module stay out of
    sys.modules, and no process group is started."""
    mods = sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  for p in (SRC / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')"
            " or m == 'torch.testing._internal.distributed.fake_pg')\n"
            "print(len(sys.modules)); assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized(), 'an import started a process group'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 30
    assert {"repro_torch.checkpoint", "repro_torch.checkpoint.ckpt", "repro_torch.common.io",
            "repro_torch.configs.paper_models", "repro_torch.core.faults",
            "repro_torch.core.population", "repro_torch.examples.quickstart",
            "repro_torch.examples.adaptive_ehealth_lstm",
            "repro_torch.examples.train_100m_hsgd", "repro_torch.examples.serve_batched",
            "repro_torch.configs.whisper_medium",
            "repro_torch.configs.gemma3_1b", "repro_torch.configs.stablelm_1_6b",
            "repro_torch.configs.falcon_mamba_7b", "repro_torch.kernels.ssm_scan",
            "repro_torch.models.ssm",
            "repro_torch.kernels.flash_attention", "repro_torch.launch.engine",
            "repro_torch.launch.serve", "repro_torch.launch.steps",
            "repro_torch.models.attention",
            "repro_torch.models.mlp", "repro_torch.models.quant",
            "repro_torch.models.transformer", "repro_torch.common.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.flops",
            "repro_torch.launch.dryrun"} <= set(mods)


def test_no_source_names_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|import repro$|from repro import)",
                         re.M)
    files = list((SRC / "repro_torch").rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_profile_trace_parsing(tmp_path):
    """Device busy time is the union of kernel/copy/memset intervals; host
    ops in the trace are not device time."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},  # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    intervals = device_intervals(str(path))
    assert [i[1] for i in intervals] == ["a", "b", "c"]
    assert busy_us(intervals) == 17.0


def test_profile_port_kernel_times():
    """The port's kernels are counted by their __global__ name, launches and
    device time; a copy of a similar name is not a launch."""
    intervals = [
        ("kernel", "(anonymous namespace)::compress_rows_kernel(float const*, int)", 0.0, 7.5),
        ("kernel", "void at::native::reduce_kernel<128, 4>", 10.0, 3.0),
        ("kernel", "(anonymous namespace)::compress_rows_kernel(float const*, int)", 20.0, 8.0),
        ("gpu_memcpy", "compress_rows_kernel staging", 30.0, 1.0),
    ]
    intervals.append(("kernel", "(anonymous namespace)::compress_rows_dp_kernel(float const*)",
                      40.0, 9.0))
    intervals.append(("kernel", "void (anonymous namespace)::ssm_scan_kernel<float, float>",
                      50.0, 4.0))
    intervals.append(("kernel", "(anonymous namespace)::ssm_scan_bwd_kernel(float const*)",
                      60.0, 5.0))
    assert port_kernel_times(intervals) == {"compress_rows_kernel": {"launches": 2, "us": 15.5},
                                            "compress_rows_dp_kernel": {"launches": 1, "us": 9.0},
                                            "ssm_scan_kernel": {"launches": 1, "us": 4.0},
                                            "ssm_scan_bwd_kernel": {"launches": 1, "us": 5.0}}
    assert port_kernel_times([]) == {name: {"launches": 0, "us": 0} for name in (
        "compress_rows_kernel", "compress_rows_dp_kernel", "ssm_scan_kernel",
        "ssm_scan_bwd_kernel")}
