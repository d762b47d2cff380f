"""The port's spans (``common/spans.py``) on the LLM round executor and the
MoE layer: nothing recorded and nothing entered with no profiler, the
span tree a round forms under one, the same numbers either way, the
ranges in the exported trace, the launches a span counts and the device
time arithmetic (on a fake clock here; on the card in the ``gpu`` test).
Imports no JAX, so the ``gpu`` test can run on the card alone.
"""
import json
import time

import pytest
import torch

from repro_torch.common import spans
from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels import launch_counts
from repro_torch.launch import train as TR
from repro_torch.launch.steps import LLMRoundRunner
from repro_torch.models import layers as L
from repro_torch.models import moe as M

ROUND_SPANS = ("hsgd.round", "hsgd.global_agg", "hsgd.exchange", "hsgd.exchange.towers",
               "hsgd.exchange.compress", "hsgd.step", "hsgd.step.hospital",
               "hsgd.step.device", "hsgd.step.update", "mamba1.discretize")
# each span's parent; the Mamba-1 discretization nests in every phase that runs the model
PARENT = {"hsgd.round": None, "hsgd.global_agg": "hsgd.round", "hsgd.exchange": "hsgd.round",
          "hsgd.exchange.towers": "hsgd.exchange", "hsgd.exchange.compress": "hsgd.exchange",
          "hsgd.step": "hsgd.round", "hsgd.step.hospital": "hsgd.step",
          "hsgd.step.device": "hsgd.step", "hsgd.step.update": "hsgd.step",
          "mamba1.discretize": ("hsgd.exchange.towers", "hsgd.step.hospital",
                                "hsgd.step.device")}


@pytest.fixture(autouse=True)
def no_records():
    spans.clear()
    yield
    spans.clear()


def _round(pods, P, Q, collect=False, device="cpu", seed=3):
    """(fn() -> (params, losses) running one round, the params) of a
    falcon-mamba-7b smoke C-HSGD round runner with ``pods`` pods."""
    args = TR.parse_args(["--device", device, "--arch", "falcon-mamba-7b", "--smoke",
                          "--pods", str(pods), "--batch", "2", "--seq", "16",
                          "--seed", str(seed)])
    _, model, params, batch_fn = TR.build_llm(args, torch.device(device))
    fn = LLMRoundRunner(model, n_pods=pods).round_fn(P, Q, 0.25, 128, collect_stats=collect)
    batches = batch_fn(0, P // Q)
    return (lambda: fn(params, batches, 0.01)), params


def _moe():
    """fn() running a deepseek-v3 smoke MoE layer's forward."""
    cfg = get_config("deepseek-v3-671b", smoke=True)
    params = L.init_params(M.moe_specs(cfg), torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    return lambda: M.moe_forward(params, x, cfg)


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("path", ["round", "moe"])
def test_no_profiler_enters_nothing_and_records_nothing(monkeypatch, path):
    fn = _round(2, 4, 2)[0] if path == "round" else _moe()

    def refuse(*args, **kwargs):
        raise AssertionError("entered while no profiler traces")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    fn()
    assert spans.rounds() == [] and spans.outside() == {}


@pytest.mark.parametrize("pods, P, Q, collect", [(1, 2, 1, False), (2, 4, 2, False),
                                                 (2, 4, 2, True)])
def test_round_span_tree(pods, P, Q, collect):
    fn = _round(pods, P, Q, collect)[0]
    with _cpu_profile():
        fn()
    (entry,) = spans.rounds()
    shards = 2 if collect else 1  # the probe step's worker shards
    # one chunk (seq 16) a Mamba-1 layer: θ0's layers and one tower layer in
    # each hospital and device pass (forward spans alone: the CPU takes the
    # plain chain, whose backward has no span), both towers an exchange a pod
    layers = get_config("falcon-mamba-7b", smoke=True).num_layers + 1
    want = {"hsgd.round": 1, "hsgd.exchange": P // Q, "hsgd.exchange.towers": P // Q,
            "hsgd.exchange.compress": P // Q, "hsgd.step": P * pods,
            "hsgd.step.hospital": P * pods * shards, "hsgd.step.device": P * pods * shards,
            "hsgd.step.update": P * pods,
            "mamba1.discretize": 2 * P * pods * shards * layers + 2 * (P // Q) * pods}
    if pods > 1:
        want["hsgd.global_agg"] = 1
    assert {name: row["count"] for name, row in entry.items()} == want
    assert spans.outside() == {}
    for rec in spans._records:
        allowed = PARENT[rec.name]
        assert (rec.parent.name if rec.parent else None) in (
            allowed if isinstance(allowed, tuple) else (allowed,))
    for row in entry.values():  # CPU tensors: no device time
        assert row["device_ms"] is None and row["self_device_ms"] is None
        assert row["host_ms"] > 0 and row["launches"] == 0
    assert entry["hsgd.round"]["host_ms"] >= sum(
        entry[n]["host_ms"] for n in ("hsgd.exchange", "hsgd.step"))


def test_profiled_round_is_bit_identical():
    def run(profile):
        fn, params = _round(2, 4, 2)
        if profile:
            with _cpu_profile():
                _, losses = fn()
        else:
            _, losses = fn()
        return losses, [x.clone() for x in tree_leaves(params)]

    (l0, p0), (l1, p1) = run(False), run(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert len(spans.rounds()) == 1


@pytest.mark.parametrize("path", ["round", "moe"])
def test_chrome_trace_holds_the_spans(tmp_path, path):
    fn, names = (_round(2, 4, 2)[0], ROUND_SPANS) if path == "round" else (_moe(), M.MOE_RANGES)
    with _cpu_profile() as prof:
        fn()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    found = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(names) <= found
    if path == "moe":
        assert {n: r["count"] for n, r in spans.outside().items()} == dict.fromkeys(names, 1)


def test_span_counts_the_launches_inside_it():
    before = launch_counts.copy()
    try:
        with _cpu_profile():
            with spans.span("outer"):
                launch_counts["fused_compress"] += 2
                with spans.span("inner"):
                    launch_counts["ssm_scan"] += 3
            launch_counts["ssm_scan"] += 5  # outside every span
    finally:
        launch_counts.clear()
        launch_counts.update(before)
    got = spans.outside()
    assert (got["outer"]["launches"], got["inner"]["launches"]) == (5, 3)


class _Clock:
    now = 0.0


class _FakeEvent:
    """A CUDA event on a fake device clock (ms)."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = _Clock.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_self_time_on_a_fake_clock(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _Clock.now = 0.0

    def tick(ms):
        _Clock.now += ms

    with _cpu_profile():
        for _ in range(2):
            with spans.span("hsgd.round"):
                tick(1.0)
                with spans.span("hsgd.exchange"):
                    tick(2.0)
                for _ in range(2):
                    with spans.span("hsgd.step"):
                        tick(0.5)
                        with spans.span("hsgd.step.hospital"):
                            tick(3.0)
                        with spans.span("hsgd.step.update"):
                            tick(1.5)
        with spans.span("moe_dispatch"):
            tick(4.0)
    got = spans.rounds()
    assert len(got) == 2
    for entry in got:
        dev = {n: (r["device_ms"], r["self_device_ms"]) for n, r in entry.items()}
        assert dev == {"hsgd.round": (13.0, 1.0), "hsgd.exchange": (2.0, 2.0),
                       "hsgd.step": (10.0, 1.0), "hsgd.step.hospital": (6.0, 6.0),
                       "hsgd.step.update": (3.0, 3.0)}
    assert spans.outside()["moe_dispatch"]["device_ms"] == 4.0
    total = spans.summed(got)
    assert total["hsgd.step"]["count"] == 4 and total["hsgd.step"]["device_ms"] == 20.0
    assert total["hsgd.round"]["self_device_ms"] == 2.0


@pytest.mark.gpu
def test_round_spans_on_the_card():
    """On the card, in a device-only profiler session: the flag reads true,
    every span has device time, each span's children and self time make up
    its device time, no child outlasts its parent, and the round's device
    time lies within its host time up to the synchronize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn = _round(2, 4, 2, device="cuda")[0]
    fn()
    torch.cuda.synchronize()
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert torch._C._autograd._profiler_enabled()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    (entry,) = spans.rounds()
    assert set(entry) == set(ROUND_SPANS)
    kids = {}
    for rec in spans._records:
        if rec.parent is not None:
            kids[rec.parent.name] = kids.get(rec.parent.name, 0.0) + rec.device_ms()
    for name, row in entry.items():
        assert row["self_device_ms"] + kids.get(name, 0.0) == pytest.approx(row["device_ms"],
                                                                             abs=1e-6)
        assert row["self_device_ms"] >= -1e-2 * row["count"]  # event resolution
    assert 0 < entry["hsgd.round"]["device_ms"] <= host_ms
