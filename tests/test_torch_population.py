"""The port's population runtime against the JAX package's.

Host code (registry traces, cohorts, cohort durations, the scheduler's
records and ledger, the planner's time model) must match exactly: it is the
reference's numpy on the same seeds. Runs start from the reference's initial
model (``HybridModel.init`` under ``PRNGKey(pop.seed)``, as its runners draw
it) and must give the same per-step losses within rtol 1e-4 and the same
executor counts. The paper-model configs, the config helpers,
``smoothed_losses`` and ``steps_to_target`` are held here too.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JC
from repro.configs import paper_models as _jax_paper_models  # noqa: F401  (registers them)
from repro.common.config import FederationConfig as JaxFed
from repro.common.config import TrainConfig as JaxTrain
from repro.core import controller as JCtl
from repro.core import hsgd as JH
from repro.core import metrics as JMET
from repro.core import population as JP
from repro.data.partition import hybrid_partition
from repro.data.synthetic import ORGANAMNIST, make_dataset
from repro.models.split_model import cnn_hybrid as jax_cnn_hybrid
from repro_torch.common import config as TC
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import controller as TCtl
from repro_torch.core import federation as F
from repro_torch.core import hsgd as H
from repro_torch.core import metrics as MET
from repro_torch.core import population as P
from repro_torch.models.split_model import cnn_hybrid

M, K = 3, 16
POP = dict(seed=7, devices_per_group=16, target_cohort=4, period=100.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def setup(robust_agg="median", q=1, p=2):
    """(JAX fed, port fed, stacked numpy data, JAX model, port model): paper-cnn
    on OrganAMNIST, 3 groups of 16 devices."""
    kw = dict(num_groups=M, devices_per_group=K, alpha=0.5, local_interval=q,
              global_interval=p, robust_agg=robust_agg)
    jfed, tfed = JaxFed(**kw), FederationConfig(**kw)
    X, y = make_dataset(ORGANAMNIST, M * K, seed=0)
    raw = hybrid_partition(ORGANAMNIST, X, y, jfed, seed=0).stacked()
    return jfed, tfed, raw, jax_cnn_hybrid(h_rows=11), cnn_hybrid(h_rows=11)


def both_data(raw):
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.as_tensor(v) for k, v in raw.items()})


@functools.lru_cache(maxsize=None)
def _jax_init(jfed):
    jmodel = setup()[3]  # every setup holds the same paper-cnn
    return jax.jit(lambda key, d: JH.init_state(key, jmodel, jfed, d))


def reference_params(jfed, jdata, seed):
    """The initial model the reference's population runners draw
    (``init_state(PRNGKey(seed))``), as numpy."""
    js = _jax_init(jfed)(jax.random.PRNGKey(seed), jdata)
    one = lambda x, lead: np.asarray(x[(0,) * lead])
    return {"theta0": jax.tree.map(lambda x: one(x, 1), js.theta0),
            "theta1": jax.tree.map(lambda x: one(x, 1), js.theta1),
            "theta2": jax.tree.map(lambda x: one(x, 2), js.theta2)}


def port_params(tmodel, params):
    return tmodel.params_from_numpy(params, "cpu")


# A keyword argument that differs between the packages: (reference's, port's).
Pair = collections.namedtuple("Pair", "ref port")


def run_both(runner_name, rounds, pop_kw=POP, train_kw=None, setup_kw=None, **kw):
    """One population runner of each package on the same data and initial
    model: (reference result, port result). A ``Pair`` keyword hands each
    package its own value."""
    jfed, tfed, raw, jmodel, tmodel = setup(**(setup_kw or {}))
    jdata, tdata = both_data(raw)
    train_kw = train_kw or dict(learning_rate=0.05)
    jpop, tpop = JP.PopulationConfig(**pop_kw), P.PopulationConfig(**pop_kw)
    params = port_params(tmodel, reference_params(jfed, jdata, jpop.seed))
    jkw = {k: v.ref if isinstance(v, Pair) else v for k, v in kw.items()}
    tkw = {k: v.port if isinstance(v, Pair) else v for k, v in kw.items()}
    ref = getattr(JP, runner_name)(jmodel, jfed, JaxTrain(**train_kw), jdata, jpop,
                                   *([rounds] if rounds is not None else []), **jkw)
    got = getattr(P, runner_name)(tmodel, tfed, TrainConfig(**train_kw), tdata, tpop,
                                  *([rounds] if rounds is not None else []), params=params, **tkw)
    return ref, got


# ---------------------------------------------------------------------------
# Host code: exact equality
# ---------------------------------------------------------------------------


def _np_data():
    return {k: np.asarray(v) for k, v in setup()[2].items()}


@pytest.mark.parametrize("cfg", [
    POP,
    dict(seed=3, devices_per_group=16, target_cohort=5, period=100.0),
    dict(seed=5, devices_per_group=12, target_cohort=6, duty_min=0.3, duty_max=0.6, period=50.0),
    dict(seed=2, devices_per_group=40, target_cohort=8, period=7.0),
])
def test_registry_traces_and_cohorts_equal_reference(cfg):
    data = _np_data()
    ref = JP.DeviceRegistry(data, JP.PopulationConfig(**cfg))
    got = P.DeviceRegistry({k: torch.as_tensor(v) for k, v in data.items()},
                           P.PopulationConfig(**cfg))
    for name in ("lat_mult", "comp_mult", "duty", "phase", "data_row"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        assert getattr(got, name).dtype == getattr(ref, name).dtype
    now = 0.0
    for r in range(6):
        np.testing.assert_array_equal(got.available(now), ref.available(now))
        cg, cr = got.sample_cohort(r, now), ref.sample_cohort(r, now)
        for a, b in zip(cg, cr):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        now += 13.7
    for a, b in zip(got.typical_tails(0.8), ref.typical_tails(0.8)):
        np.testing.assert_array_equal(a, b)


def test_cohort_durations_and_time_model_equal_reference():
    jfed, tfed, raw, jmodel, tmodel = setup()
    jdata, tdata = both_data(raw)
    data = _np_data()
    ref_reg = JP.DeviceRegistry(data, JP.PopulationConfig(**POP))
    reg = P.DeviceRegistry(data, P.PopulationConfig(**POP))
    jstate = _jax_init(jfed)(jax.random.PRNGKey(0), jdata)
    tstate = H.init_state(torch.Generator(), tmodel, tfed, tdata,
                          params=port_params(tmodel, reference_params(jfed, jdata, 0)))
    jsizes, tsizes = JCtl.hsgd_sizes_of(jstate, jfed), TCtl.hsgd_sizes_of(tstate, tfed)
    for k, b in ((0.0, 0), (0.25, 128), (0.05, 64)):
        assert vars(tsizes(k, b)) == vars(jsizes(k, b))
    for r in range(4):
        cohort = reg.sample_cohort(r, 31.0 * r)
        for P_, Q_ in ((2, 1), (4, 2), (8, 8)):
            np.testing.assert_array_equal(
                P.cohort_durations(cohort, tsizes(0.25, 128), P_, Q_, 0.05),
                JP.cohort_durations(cohort, jsizes(0.25, 128), P_, Q_, 0.05))
    ladder = JCtl.AdaptiveConfig().ladder
    assert TCtl.AdaptiveConfig().ladder == ladder
    for mode in ("sync", "semi_async"):
        got = P.make_time_of(tsizes, ladder, reg, 0.05, mode=mode)
        want = JP.make_time_of(jsizes, ladder, ref_reg, 0.05, mode=mode)
        for P_ in (1, 2, 8, 32):
            for rung in range(len(ladder)):
                assert got(P_, rung) == want(P_, rung)


@pytest.mark.parametrize("mode,cfg", [
    ("semi_async", dict(deadline_quantile=0.5, staleness_damping=0.5, max_staleness=2)),
    ("sync", {}),
    ("semi_async", dict(min_quorum=0.9, max_retries=2, backoff_factor=2.0)),
])
def test_scheduler_records_and_ledger_equal_reference(mode, cfg):
    data = _np_data()
    kw = dict(seed=1, devices_per_group=8, target_cohort=3, **cfg)
    ref = JP.PopulationScheduler(JP.DeviceRegistry(data, JP.PopulationConfig(**kw)),
                                 np.arange(1.0, M + 1), mode=mode)
    got = P.PopulationScheduler(P.DeviceRegistry(data, P.PopulationConfig(**kw)),
                                np.arange(1.0, M + 1), mode=mode)
    rng = np.random.default_rng(0)
    for r in range(8):
        cg, cr = got.next_cohort(), ref.next_cohort()
        for a, b in zip(cg, cr):
            np.testing.assert_array_equal(a, b)
        if r == 5:  # one round with every group absent
            cg = cg._replace(counts=np.zeros(M, np.int64))
            cr = cr._replace(counts=np.zeros(M, np.int64))
        dur = rng.uniform(1.0, 60.0, M)
        (wg, recg), (wr, recr) = got.settle(cg, dur), ref.settle(cr, dur)
        np.testing.assert_array_equal(wg, wr)
        assert recg == recr
        assert got.state_dict() == ref.state_dict()
    clone = P.PopulationScheduler(got.registry, np.arange(1.0, M + 1), mode=mode)
    clone.load_state_dict(ref.state_dict())
    assert clone.state_dict() == got.state_dict()
    np.testing.assert_array_equal(clone.staleness, ref.staleness)


def test_config_validation_matches_reference():
    for kw in (dict(max_retries=-1), dict(backoff_factor=1.0), dict(min_quorum=1.2),
               dict(deadline_quantile=0.0), dict(target_cohort=0)):
        with pytest.raises(ValueError) as want:
            JP.PopulationConfig(**kw)
        with pytest.raises(ValueError) as got:
            P.PopulationConfig(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mode must be"):
        P.PopulationScheduler(P.DeviceRegistry(_np_data(), P.PopulationConfig()), np.ones(M),
                              mode="async")


# ---------------------------------------------------------------------------
# Cohort state plumbing and the executor cache
# ---------------------------------------------------------------------------


def test_resize_cohort_exact_when_slots_uniform():
    jfed, tfed, raw, jmodel, tmodel = setup()
    jdata, tdata = both_data(raw)
    params = reference_params(jfed, jdata, 0)
    state = H.init_state(torch.Generator(), tmodel, tfed, tdata,
                         params=port_params(tmodel, params))
    jstate = _jax_init(jfed)(jax.random.PRNGKey(0), jdata)
    before = F.local_aggregate(state.theta2)
    for A_new in (2, 8, 4, 4):
        state = H.resize_cohort(state, tmodel, tdata, A_new)
        jstate = JH.resize_cohort(jstate, jmodel, jdata, A_new)
        assert all(x.shape[1] == A_new for x in tree_leaves(state.theta2))
        assert state.batch["x1"].shape[:2] == (M, A_new)
        assert state.stale["z1"].shape == tuple(jstate.stale["z1"].shape)
        assert state.stale["z2"].shape == tuple(jstate.stale["z2"].shape)
        for a, b in zip(tree_leaves(before), tree_leaves(F.local_aggregate(state.theta2))):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)
        for a, b in zip(tree_leaves(state.theta2), jax.tree_util.tree_leaves(jstate.theta2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert H.resize_cohort(state, tmodel, tdata, 4) is state


def test_cohort_executor_cache_keys_equal_reference():
    jfed, tfed, raw, jmodel, tmodel = setup()
    jr = JH.HSGDRunner(jmodel, jfed, JaxTrain(learning_rate=0.05, compression_k=0.25,
                                              quantization_bits=128))
    tr = H.HSGDRunner(tmodel, tfed, TrainConfig(learning_rate=0.05, compression_k=0.25,
                                                quantization_bits=128))
    for A in (2, 4, 8, 4, 2, 8, 8, 2):
        for r in (jr, tr):
            r.cohort_round_fn(2, 1, A, collect_stats=False)
            r.cohort_round_fn(4, 2, A, 0.1, 16)
            r.fault_round_fn(2, 1, A, robust=A != 4)
    assert set(tr._round_cache) == set(jr._round_cache)
    assert len(tr._round_cache) == 3 + 3 + 3
    for bad in ((3, 2, 4), (2, 1, 0)):
        for fn in (tr.cohort_round_fn, tr.fault_round_fn):
            with pytest.raises(ValueError):
                fn(*bad)


# ---------------------------------------------------------------------------
# Runs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,compressed", [("sync", False), ("sync", True),
                                             ("semi_async", True)])
def test_run_population_matches_reference(mode, compressed):
    """Losses within rtol 1e-4; uncompressed, the final global model within
    fp32 tolerance too (compressed, ulp-level differences move top-k picks,
    so only the losses are held)."""
    train_kw = dict(learning_rate=0.05)
    if compressed:
        train_kw.update(compression_k=0.25, quantization_bits=128)
    ref, got = run_both("run_population", 3, mode=mode, train_kw=train_kw)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    np.testing.assert_array_equal(got["times"], ref["times"])
    assert got["history"] == ref["history"]
    assert got["staleness_hist"] == ref["staleness_hist"]
    assert got["sim_seconds"] == ref["sim_seconds"]
    assert len(got["runner"]._round_cache) == len(ref["runner"]._round_cache)
    assert set(got["runner"]._round_cache) == set(ref["runner"]._round_cache)
    if not compressed:
        for a, b in zip(tree_leaves(H.global_model(got["state"], torch.ones(M))),
                        jax.tree_util.tree_leaves(JH.global_model(ref["state"], jnp.ones(M)))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_run_population_adaptive_matches_reference():
    cfg = dict(total_steps=10, max_interval=4, eta_max=0.05, init_probe=False,
               time_budget=60.0)
    ref, got = run_both("run_population_adaptive", None,
                        cfg=Pair(JCtl.AdaptiveConfig(**cfg), TCtl.AdaptiveConfig(**cfg)))
    plans = lambda res: [(h["P"], h["Q"], h["rung"]) for h in res["history"]]
    assert plans(got) == plans(ref)
    assert len(set(plans(got))) > 1  # the governor moved
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    np.testing.assert_array_equal(got["times"], ref["times"])
    assert got["sim_seconds"] == ref["sim_seconds"]
    assert len(got["runner"]._round_cache) == len(ref["runner"]._round_cache)
    for hg, hr in zip(got["history"], ref["history"]):
        assert hg["seconds_total"] == hr["seconds_total"]
        assert hg["bytes_total"] == hr["bytes_total"]


# ---------------------------------------------------------------------------
# The rest of the paper's main path: configs, config helpers, loss curves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["paper-cnn", "paper-lstm"])
def test_paper_model_configs_match_reference(name):
    for smoke in (False, True):
        got, want = TC.get_config(name, smoke), JC.get_config(name, smoke)
        assert got == TC.ModelConfig(**{k: getattr(want, k) for k in
                                        want.__dataclass_fields__})
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    assert name in TC.list_configs()


def test_config_helpers_match_reference():
    assert {k: tuple(vars(v).values()) for k, v in TC.INPUT_SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JC.INPUT_SHAPES.items()}
    moe = dict(name="m", family="moe", num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
               d_ff=128, vocab_size=100, num_experts=8, experts_per_token=2,
               num_shared_experts=1, moe_d_ff=32)
    assert TC.ModelConfig(**moe).active_param_count() == JC.ModelConfig(**moe).active_param_count()
    items = ["a=1", "b=x=y", "c="]
    assert TC.parse_kv_list(items) == JC.parse_kv_list(items) == {"a": "1", "b": "x=y", "c": ""}
    assert TC.parse_kv_list(None) == {}
    with pytest.raises(ValueError, match="key=value"):
        TC.parse_kv_list(["nokey"])


def test_loss_curve_helpers_match_reference():
    rng = np.random.default_rng(0)
    losses = np.cumsum(-np.abs(rng.normal(0.05, 0.02, 50))) + 3.0
    for window in (1, 4, 7, 100):
        np.testing.assert_array_equal(MET.smoothed_losses(losses, window),
                                      JMET.smoothed_losses(losses, window))
        for target in (2.5, 1.0, -10.0):
            assert MET.steps_to_target(losses, target, window) == \
                JMET.steps_to_target(losses, target, window)
    assert MET.steps_to_target(losses, -10.0) is None
    assert MET.smoothed_losses([]).shape == (0,)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "adaptive"])
def test_population_cli_reports_the_reference_keys(mode, capsys):
    """The same report keys in the same order; the host-side fields (the
    schedule does not depend on the model) equal the reference's. The two
    CLIs draw different initial models, so the losses differ."""
    from repro.launch import train as JT
    from repro_torch.launch import train as T

    argv = ["--population", mode, "--samples", "48", "--groups", "3", "--devices", "8",
            "--rounds", "2", "--p", "2", "--q", "1", "--pop-devices", "8", "--cohort", "3",
            "--compression-k", "0.25", "--quantization", "128"]
    ref = JT.main(argv)
    out = T.main(["--device", "cpu"] + argv)
    assert list(out) == list(ref)
    assert np.isfinite(out["loss_last"])
    keys = ("mode", "trace_seed")
    if mode == "sync":
        keys += ("steps", "sim_seconds", "staleness_hist", "executors_compiled")
    assert {k: out[k] for k in keys} == {k: ref[k] for k in keys}
    assert '"executors_compiled"' in capsys.readouterr().out


def test_population_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train as T

    with pytest.raises(RuntimeError, match="cuda"):
        T.main(["--population", "sync", "--samples", "48", "--groups", "2", "--devices", "8"])
