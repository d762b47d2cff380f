"""The port's reprolint (``repro_torch.analysis``): the twins of
``tests/test_reprolint.py`` on torch fixtures — one or more bad and good
fixtures a rule, suppressions, the baseline round trip, the port's own
baseline matching ``src/repro_torch`` and ``chip_smoke.py`` — and the
executor guard: budgets over a round cache, and the twin of the reference's
``test_population.py::test_one_executor_per_cohort_bucket``.

The port's guard counts executors BUILT (cache misses reported on the
``repro_torch.executors`` logger); the reference's counts XLA compiles, and
its jit compiles lazily at the first call, so where the reference pins 0
compiles for building alone the port pins one build a bucket.
"""
import dataclasses
import json
import logging
import textwrap

import pytest
import torch

from repro_torch.analysis import RULES, CompileBudgetError, compile_guard, lint_paths, lint_source
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.linter import apply_baseline, fingerprint, load_baseline, write_baseline
from repro_torch.analysis.rules import RESERVED_STREAMS
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.executors import LOGGER
from repro_torch.core import hsgd as H
from repro_torch.core.population import PopulationConfig, run_population
from repro_torch.data.partition import hybrid_partition
from repro_torch.data.synthetic import ORGANAMNIST, make_dataset
from repro_torch.models.split_model import cnn_hybrid


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def findings_for(rule_id, source, path="src/x.py"):
    return [f for f in lint_source(textwrap.dedent(source), path) if f.rule == rule_id]


# ---------------------------------------------------------------------------
# Fixture matrix: for each rule, BAD must fire and GOOD must not
# ---------------------------------------------------------------------------

FIXTURES = {
    "RP1": {
        "bad": """
            import torch
            def train(model, steps):
                for _ in range(steps):
                    fn = torch.compile(model)
                    fn(1.0)
        """,
        "bad2": """
            import torch
            def train(steps):
                while steps:
                    @torch.jit.script
                    def step(x):
                        return x
                    steps -= 1
        """,
        # a CUDA graph captured anew every pass
        "bad3": """
            import torch
            def replay(fn, n):
                for _ in range(n):
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        fn()
                    g.replay()
        """,
        # the kernels' loader per launch
        "bad4": """
            from repro_torch.kernels.build import load
            def launch_all(xs):
                for x in xs:
                    lib = load("compress")
                    lib.compress_rows_f32(x.data_ptr())
        """,
        "good": """
            import torch
            def train(model, steps):
                fn = torch.compile(model)
                for _ in range(steps):
                    fn(1.0)
        """,
        # a def INSIDE a loop whose body builds is fine: the body runs later
        "good2": """
            import torch
            def make_all(models):
                out = {}
                for m in models:
                    def make(mm=m):
                        return torch.compile(mm)
                    out[m] = make
                return out
        """,
        # the build handed to a thread pool is a reference, not a call
        "good3": """
            from concurrent.futures import ThreadPoolExecutor
            from repro_torch.kernels import build
            def build_all(sources):
                with ThreadPoolExecutor(len(sources)) as pool:
                    return list(pool.map(build.build, sources))
        """,
    },
    "RP2": {
        "bad": """
            def train(runner, state, data, w):
                _, losses = runner.run(state, data, w, 2)
                return state.theta0, losses
        """,
        "bad2": """
            def one_round(runner, state, data, w):
                fn = runner.round_fn(4, 2)
                new, stats = fn(state, data, w, 0.05)
                return state, new
        """,
        # a call broken over lines: the rebind comes after the whole statement
        "good": """
            def train(runner, state, data, w, rounds):
                fn = runner.round_fn(4, 2)
                for _ in range(rounds):
                    state, stats = fn(state, data, w, 0.05)
                state, losses = runner.run(
                    state, data, w, 2)
                return state, losses
        """,
        # a one-argument run (a CLI's namespace) consumes nothing
        "good2": """
            def main(loadgen, args):
                report = loadgen.run(args)
                return report, args.rate
        """,
        # a nested function is a scope of its own
        "good3": """
            def outer(runner, state, data, w):
                _, losses = runner.run(state, data, w, 1)
                def inner(state):
                    return state.theta0
                return losses, inner
        """,
    },
    "RP3": {
        "bad": """
            class Runner:
                def build(self, buckets):
                    for P in buckets:
                        def hsgd_round(state):
                            return state * P
                        self._round_cache[P] = hsgd_round
        """,
        "bad2": """
            def build(cache, buckets):
                for b in buckets:
                    cache[b] = lambda x: x * b
        """,
        "good": """
            def build(cache, buckets):
                for b in buckets:
                    def fn(x, b=b):
                        return x * b
                    cache[b] = fn
        """,
        # a closure over values fixed for the bucket
        "good2": """
            class Runner:
                def round_fn(self, P):
                    lam = P // 2
                    def hsgd_round(state):
                        return state * lam
                    fn = self._round_cache[P] = hsgd_round
                    return fn
        """,
    },
    "RP4": {
        "bad": """
            class Runner:
                def round_fn(self):
                    def hsgd_round(state):
                        return state.sum().item()
                    return hsgd_round
        """,
        "bad2": """
            class Engine:
                def step(self):
                    self._decode()
                def _decode(self):
                    toks = self.fn()
                    return toks.cpu()
        """,
        # a one-level helper of an executor
        "bad3": """
            class Runner:
                def round_fn(self):
                    def llm_round(params):
                        return self._impl(params)
                    return llm_round
                def _impl(self, params):
                    return float(params.sum())
        """,
        "bad4": """
            import torch
            class Engine:
                def _decode_fn(self):
                    def serve_decode(params, caches):
                        torch.cuda.synchronize()
                        return caches
                    return serve_decode
        """,
        "good": """
            import numpy as np
            def postprocess(x):
                return np.asarray(x.cpu())  # host code, not an executor
        """,
        "good2": """
            import torch
            class Runner:
                def round_fn(self, prev_ok):
                    def hsgd_round(state):
                        return state * float(2)
                    return hsgd_round
        """,
    },
    "RP5": {
        "bad": """
            import numpy as np
            def make_batch(n):
                return np.random.randn(n)
        """,
        "bad2": """
            import numpy as np
            def make_rng():
                return np.random.default_rng()
        """,
        "good": """
            import numpy as np
            def make_batch(n, seed):
                rng = np.random.default_rng(seed)
                return rng.standard_normal(n)
        """,
    },
    "RP6": {
        "bad": """
            import time
            import torch
            def bench(fn, x):
                t0 = time.perf_counter()
                fn(x)
                return time.perf_counter() - t0
        """,
        "good": """
            import time
            import torch
            def bench(fn, x):
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        """,
        # a host copy of the result waits for the card too
        "good2": """
            import time
            import torch
            def bench(fn, x):
                t0 = time.time()
                y = fn(x).sum().item()
                return time.time() - t0, y
        """,
    },
    "RP7": {
        "bad": """
            def accumulate(x, out=[]):
                out.append(x)
                return out
        """,
        "bad2": """
            import torch
            from dataclasses import dataclass
            @dataclass
            class Config:
                weights: object = torch.zeros(3)
        """,
        "bad3": """
            import torch
            def scale(x, w=torch.ones(3)):
                return x * w
        """,
        "good": """
            from dataclasses import dataclass, field
            import torch
            def accumulate(x, out=None):
                out = [] if out is None else out
                out.append(x)
                return out
            @dataclass
            class Config:
                weights: object = field(default_factory=lambda: torch.zeros(3))
        """,
        # devices and dtypes are immutable
        "good2": """
            import torch
            def place(x, device=torch.device("cpu"), dtype=torch.float32):
                return x.to(device, dtype)
        """,
    },
    "RP8": {
        "bad": """
            from typing import NamedTuple
            class TrainState(NamedTuple):
                step: int
        """,
        "good": """
            from typing import NamedTuple
            from repro_torch.checkpoint.ckpt import register_state_class
            class TrainState(NamedTuple):
                step: int
            register_state_class(TrainState)
        """,
        "good2": """
            from typing import NamedTuple
            class Metrics(NamedTuple):
                loss: float
        """,
    },
    "RP9": {
        "bad": """
            import json
            def dump_results(path, results):
                with open(path, "w") as f:
                    json.dump(results, f, indent=1)
        """,
        "bad2": """
            def write_manifest(payload):
                with open("out/manifest.json", "w") as f:
                    f.write(payload)
        """,
        "good": """
            from repro_torch.common.io import atomic_write_json
            def dump_results(path, results):
                atomic_write_json(path, results)
        """,
        "good2": """
            import json, os
            def dump_results(path, results):
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(results, f)
                os.replace(tmp, path)
        """,
        "good3": """
            def write_log(path, lines):
                with open(path, "w") as f:
                    f.write("\\n".join(lines))
        """,
    },
    "RP10": {
        "bad": """
            import numpy as np
            def draw_faults(seed, r):
                rng = np.random.default_rng([seed, 7, r])
                return rng.integers(0, 10)
        """,
        "bad2": """
            import numpy as np
            def draw(seed, widx):
                rng = np.random.default_rng([seed, widx])
                return rng.integers(0, 10)
        """,
        # a SeedSequence is a structured seed too
        "bad3": """
            import numpy as np
            def noise_seed(seed):
                return np.random.SeedSequence([seed, 9]).generate_state(1)[0]
        """,
        "good": """
            import numpy as np
            def draw_faults(seed, r):
                rng = np.random.default_rng([seed, 3, r])
                return rng.integers(0, 10)
        """,
        "good2": """
            import numpy as np
            DP_NOISE_STREAM = 5
            def noise_seed(seed):
                return np.random.SeedSequence([seed, DP_NOISE_STREAM]).generate_state(1)[0]
        """,
        "good3": """
            import numpy as np
            def noise_seed(seed):
                return np.random.SeedSequence([seed, 5]).generate_state(1)[0]
        """,
    },
}

_CASES = [(rid, kind) for rid, fx in FIXTURES.items() for kind in fx]


def _fixture_path(rule_id):
    return "src/repro_torch/launch/profile_x.py" if rule_id == "RP6" else "src/x.py"


@pytest.mark.parametrize("rule_id,kind", _CASES, ids=[f"{r}-{k}" for r, k in _CASES])
def test_fixture_matrix(rule_id, kind):
    hits = findings_for(rule_id, FIXTURES[rule_id][kind], path=_fixture_path(rule_id))
    if kind.startswith("bad"):
        assert hits, f"{rule_id} missed its {kind} fixture"
        assert all(f.rule == rule_id and f.line > 0 for f in hits)
    else:
        assert not hits, f"{rule_id} false-positive on {kind}: {hits}"


def test_every_rule_has_fixtures_and_registry_entry():
    assert set(FIXTURES) == set(RULES)
    assert len(RULES) == 10
    for rid, r in RULES.items():
        assert r.id == rid and r.title and r.doc
    assert RESERVED_STREAMS[5] and H.DP_NOISE_STREAM == 5  # the port's DP noise stream


# ---------------------------------------------------------------------------
# Path scoping
# ---------------------------------------------------------------------------


def test_rp5_exempts_data_fixtures():
    src = "import numpy as np\nx = np.random.randn(3)\n"
    assert findings_for("RP5", src, path="src/repro_torch/data/synthetic.py") == []
    assert findings_for("RP5", src, path="src/repro_torch/core/hsgd.py")


@pytest.mark.parametrize("path,applies", [
    ("src/repro_torch/launch/timing.py", True), ("src/repro_torch/launch/profile_train.py", True),
    ("src/repro_torch/examples/quickstart.py", True), ("chip_smoke.py", True),
    ("src/repro_torch/core/hsgd.py", False), ("src/repro_torch/launch/train.py", False)])
def test_rp6_applies_where_the_port_times(path, applies):
    src = FIXTURES["RP6"]["bad"]
    assert bool(findings_for("RP6", src, path=path)) == applies
    no_torch = textwrap.dedent(src).replace("import torch\n", "")
    assert [f for f in lint_source(no_torch, path) if f.rule == "RP6"] == []


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


def test_line_suppression():
    src = ("import numpy as np\n"
           "x = np.random.randn(3)  # reprolint: disable=RP5\n"
           "y = np.random.randn(3)\n")
    assert [f.line for f in lint_source(src, "src/x.py") if f.rule == "RP5"] == [3]


def test_line_suppression_all_rules_and_multi():
    src = ("import numpy as np\n"
           "x = np.random.randn(3)  # reprolint: disable\n"
           "y = np.random.randn(3)  # reprolint: disable=RP1,RP5\n")
    assert [f for f in lint_source(src, "src/x.py") if f.rule == "RP5"] == []


def test_file_suppression():
    src = ("# reprolint: disable-file=RP5\n"
           "import numpy as np\n"
           "x = np.random.randn(3)\n"
           "y = np.random.randn(3)\n")
    assert [f for f in lint_source(src, "src/x.py") if f.rule == "RP5"] == []


def test_syntax_error_is_a_finding_not_a_crash():
    hits = lint_source("def broken(:\n", "src/x.py")
    assert len(hits) == 1 and hits[0].rule == "SYNTAX"


# ---------------------------------------------------------------------------
# Baseline round-trip and the CLI
# ---------------------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    src = "import numpy as np\nx = np.random.randn(3)\n"
    f = tmp_path / "src" / "mod.py"
    f.parent.mkdir()
    f.write_text(src)
    findings = lint_paths([str(tmp_path / "src")])
    assert [x.rule for x in findings] == ["RP5"]

    bl_path = tmp_path / "baseline.json"
    write_baseline(str(bl_path), findings)
    assert not list(tmp_path.glob("baseline.json.tmp*"))  # staged, then replaced
    baseline = load_baseline(str(bl_path))
    assert set(baseline) == {fingerprint(findings[0])}
    new, stale = apply_baseline(findings, baseline)
    assert new == [] and stale == []
    # fingerprints survive line drift: same source, different line
    drifted = lint_source("# a new comment line\n" + src, findings[0].path)
    assert apply_baseline(drifted, baseline) == ([], [])
    # fixing the violation makes the baseline entry stale
    new, stale = apply_baseline([], baseline)
    assert new == [] and len(stale) == 1
    assert json.loads(bl_path.read_text())["findings"][0]["rule"] == "RP5"

    # the CLI: new findings fail; baselined ones pass; stale ones fail --check
    assert lint_main([str(tmp_path / "src"), "--no-baseline"]) == 1
    assert lint_main([str(tmp_path / "src"), "--check", "--baseline", str(bl_path)]) == 0
    f.write_text("x = 1\n")
    assert lint_main([str(tmp_path / "src"), "--baseline", str(bl_path)]) == 0
    assert lint_main([str(tmp_path / "src"), "--check", "--baseline", str(bl_path)]) == 1


def test_port_baseline_matches_tree():
    """``reprolint_torch_baseline.json`` covers the port and its chip script
    exactly: no new findings, no stale entries, at most 10 (the serving
    engine's documented once-a-block host syncs)."""
    findings = lint_paths(["src/repro_torch", "chip_smoke.py"])
    baseline = load_baseline("reprolint_torch_baseline.json")
    assert len(baseline) <= 10
    new, stale = apply_baseline(findings, baseline)
    assert new == [], f"non-baselined findings: {new}"
    assert stale == [], f"stale baseline entries: {stale}"
    assert {e["rule"] for e in baseline.values()} <= {"RP4"}


# ---------------------------------------------------------------------------
# compile_guard: executors built, by name
# ---------------------------------------------------------------------------


def _mini(M=2, K=8, q=2, p=4):
    fed = FederationConfig(num_groups=M, devices_per_group=K, alpha=0.5,
                           local_interval=q, global_interval=p)
    X, y = make_dataset(ORGANAMNIST, M * K, seed=0)
    data = {k: torch.as_tensor(v)
            for k, v in hybrid_partition(ORGANAMNIST, X, y, fed, seed=0).stacked().items()}
    return cnn_hybrid(h_rows=11), fed, data


def test_compile_guard_counts_and_budgets():
    model, fed, _ = _mini()
    runner = H.HSGDRunner(model, fed, TrainConfig(learning_rate=0.05))
    level, propagate = LOGGER.level, LOGGER.propagate
    with compile_guard(track=r"hsgd_") as g:
        runner.round_fn(4, 2)
        runner.round_fn(4, 2)  # a cache hit: nothing built
        runner.round_fn(4, 4)
        runner.round_fn(4, 2, dp=True)
    assert g.total == 3 and g.count(r"hsgd_round") == 2
    assert g.by_name == {"hsgd_round": 2, "hsgd_private_round": 1}
    assert (LOGGER.level, LOGGER.propagate) == (level, propagate)  # restored after the region

    with compile_guard(exact=0):  # every bucket revisited: nothing built
        runner.round_fn(4, 2)
        runner.round_fn(4, 2, dp=True)
    with pytest.raises(CompileBudgetError):
        with compile_guard(track=r"hsgd_round", exact=2):
            runner.round_fn(8, 2)  # one build, budget says 2
    with pytest.raises(CompileBudgetError):
        with compile_guard(track=r"hsgd_", max_compiles=1):
            runner.round_fn(8, 4)
            runner.round_fn(8, 8)
    # dict budgets pin counts by name; the sort path builds executors of its own
    sort = dataclasses.replace(runner, fused_compression=False)
    with compile_guard(track=r"hsgd_", exact={r"hsgd_round": 1, r"hsgd_cohort_round": 1}):
        sort.round_fn(4, 2)
        sort.cohort_round_fn(2, 1, 4)
    assert not LOGGER.handlers


def test_compile_guard_nests():
    model, fed, _ = _mini()
    runner = H.HSGDRunner(model, fed, TrainConfig(learning_rate=0.05))
    with compile_guard(track=r"hsgd_") as outer:
        with compile_guard(track=r"hsgd_", exact=1) as inner:
            runner.round_fn(2, 1)
        runner.cohort_round_fn(2, 1, 4)
    assert inner.total == 1 and outer.total == 2
    assert not LOGGER.handlers and LOGGER.getEffectiveLevel() > logging.DEBUG


def test_one_executor_per_cohort_bucket():
    """The twin of the reference's test: revisiting a bucket never builds a
    new executor, and a population run builds exactly one per cohort bucket
    it visits, however the rounds revisit them."""
    model, fed, data = _mini(M=3, K=16, q=1, p=2)
    train = TrainConfig(learning_rate=0.05)
    runner = H.HSGDRunner(model, fed, train)
    with compile_guard(track=r"hsgd_cohort_round", exact=3):
        for A in (2, 4, 8, 4, 2, 8, 8, 2):
            runner.cohort_round_fn(2, 1, A, collect_stats=False)
    assert len(runner._round_cache) == 3
    pop = PopulationConfig(seed=2, devices_per_group=16, target_cohort=6,
                           duty_min=0.25, duty_max=0.9, period=7.0)
    with compile_guard(track=r"hsgd_cohort_round") as g:
        res = run_population(model, fed, train, data, pop, rounds=10)
    buckets = {h["bucket"] for h in res["history"]}
    assert g.total == len(buckets), g.by_name
    assert len(res["runner"]._round_cache) == len(buckets)
