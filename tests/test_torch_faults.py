"""The port's fault-tolerant runtime against the JAX package's.

Exact: fault plans' validation, injector draws and traces (NaN at the same
places; a trace written by either package replays in the other), the
screen's per-device and per-group masks, flagged counts and the fault log.
Within fp32 tolerance: the robust aggregates (rtol 1e-6) and run losses
(rtol 1e-4, NaN at the same steps). Bit for bit, in the port alone: a
fault-free screened run against the plain cohort run, and a resumed run
against an uninterrupted one.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JaxTrain
from repro.core import faults as JFT
from repro.core import federation as JF
from repro.core import hsgd as JH
from repro.core import population as JP
from repro.launch import train as JT
from repro_torch.common.config import TrainConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import faults as FT
from repro_torch.core import federation as F
from repro_torch.core import hsgd as H
from repro_torch.core import population as P
from repro_torch.launch import train as T
from test_torch_population import (POP, M, Pair, _jax_init, both_data, port_params,
                                   reference_params, run_both, setup)

PLAN = dict(seed=11, dropout_rate=0.15, nan_rate=0.12, outlier_rate=0.08,
            msg_corrupt_rate=0.2)
PLANS = Pair(JFT.FaultPlan(**PLAN), FT.FaultPlan(**PLAN))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_faults_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # NaN == NaN
        assert np.asarray(a).dtype == np.asarray(b).dtype


def state_tensors(state):
    """Every tensor of an HSGDState, in a fixed order."""
    return (tree_leaves(state.theta0) + tree_leaves(state.theta1) + tree_leaves(state.theta2)
            + tree_leaves(state.stale) + tree_leaves(state.batch))


# ---------------------------------------------------------------------------
# Fault plans, injector draws and traces: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(dropout_rate=1.5), dict(nan_rate=-0.1),
                                dict(latency_spike_mult=0.5), dict(preempt_round=-3)])
def test_fault_plan_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JFT.FaultPlan(**kw)
    with pytest.raises(ValueError) as got:
        FT.FaultPlan(**kw)
    assert str(got.value) == str(want.value)
    assert FT.FaultPlan().empty and not FT.FaultPlan(**PLAN).empty
    assert not FT.FaultPlan(preempt_round=0).empty


@pytest.mark.parametrize("plan", [
    PLAN,
    dict(seed=3, dropout_rate=0.3, msg_loss_rate=0.4, msg_dup_rate=0.3,
         latency_spike_rate=0.5, latency_spike_mult=4.0, preempt_round=2),
])
def test_injector_draws_equal_reference(plan):
    ref, got = JFT.FaultInjector(JFT.FaultPlan(**plan)), FT.FaultInjector(FT.FaultPlan(**plan))
    pmask = np.ones((3, 8), np.float32)
    pmask[1, 5:] = 0.0  # padding slots take no faults
    for r in range(8):
        shape = (3, 8) if r % 2 else (3, 4)
        mask = pmask if r % 2 else None
        fg, fr = got.faults(r, *shape, mask), ref.faults(r, *shape, mask)
        assert_faults_equal(fg, fr)
        assert fg.preempt == fr.preempt and fg.any_device_fault == fr.any_device_fault
    assert got.trace == ref.trace


def test_traces_replay_across_packages(tmp_path):
    ref, got = JFT.FaultInjector(PLANS.ref), FT.FaultInjector(PLANS.port)
    drawn = [ref.faults(r, 3, 8) for r in range(5)]
    for r in range(5):
        got.faults(r, 3, 8)
    ref_path, port_path = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref.save_trace(ref_path)
    got.save_trace(port_path)
    assert open(ref_path).read() == open(port_path).read()
    for replay in (FT.FaultInjector.from_trace(ref_path), JFT.FaultInjector.from_trace(port_path)):
        assert vars(replay.plan) == vars(PLANS.ref)
        for r, rf in enumerate(drawn):
            assert_faults_equal(replay.faults(r, 3, 8), rf)
        # bucket-shape mismatch: crops/pads onto the asked-for shape
        np.testing.assert_array_equal(replay.faults(0, 2, 4).drop, drawn[0].drop[:2, :4])
        assert not replay.faults(99, 3, 8).any_device_fault


# ---------------------------------------------------------------------------
# Screening statistics and robust aggregation
# ---------------------------------------------------------------------------


def test_sort_gather_and_floor_division_follow_jax():
    """The primitives the medians rest on: NaN sorts after +inf and after
    the dtype-max sentinel (as jnp.sort), gather reads as take_along_axis,
    and (cnt - 1) // 2 floors on integer tensors."""
    big = np.finfo(np.float32).max
    v = np.array([[np.nan, big, 1.0, np.inf, -np.inf, -0.0, 0.0, big],
                  [3.0, np.nan, np.nan, -1.0, big, 2.0, np.inf, -np.inf]], np.float32)
    np.testing.assert_array_equal(torch.sort(torch.from_numpy(v), dim=1).values.numpy(),
                                  np.asarray(jnp.sort(jnp.asarray(v), axis=1)))
    idx = np.array([[0, 7], [3, 1]], np.int64)
    np.testing.assert_array_equal(
        torch.gather(torch.from_numpy(v), 1, torch.from_numpy(idx)).numpy(),
        np.asarray(jnp.take_along_axis(jnp.asarray(v), jnp.asarray(idx), axis=1)))
    cnt = np.array([0, 1, 2, 3, 8], np.int32)
    np.testing.assert_array_equal(((torch.from_numpy(cnt) - 1) // 2).numpy(),
                                  np.asarray((jnp.asarray(cnt) - 1) // 2))


def _robust_inputs(seed=0):
    """θ2-like slots [4, 6, 3, 2] with NaN, padding slots, an empty group and
    flagged slots: (x, pmask, trust)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 6, 3, 2)).astype(np.float32)
    x[0, 5] = 1e8                       # a poisoned slot, flagged below
    x[2, 1, 0, 0] = np.nan              # NaN in a flagged slot
    x[3, 0, 1, 1] = np.nan              # NaN in a padding slot
    pmask = np.ones((4, 6), np.float32)
    pmask[1, 4:] = 0.0                  # padding
    pmask[3, :] = 0.0                   # empty group
    trust = np.ones((4, 6), np.float32)
    trust[0, 5] = trust[2, 1] = trust[2, 3] = 0.0
    return x, pmask, trust


@pytest.mark.parametrize("method", ["mean", "median", "trimmed"])
def test_robust_statistics_match_reference(method):
    x, pmask, trust = _robust_inputs()
    w = pmask * trust
    got = F._robust_center(torch.from_numpy(x), torch.from_numpy(w), method, 0.2).numpy()
    want = np.asarray(JF._robust_center(jnp.asarray(x), jnp.asarray(w), method, 0.2))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    v = x[:, :, 0, 0]
    np.testing.assert_allclose(
        F.masked_median_values(torch.from_numpy(v), torch.from_numpy(w)).numpy(),
        np.asarray(JF.masked_median_values(jnp.asarray(v), jnp.asarray(w))), rtol=1e-6)
    tree = {"w": x, "b": x[:, :, 0]}
    got = F.robust_local_aggregate({k: torch.from_numpy(v) for k, v in tree.items()},
                                   torch.from_numpy(pmask), torch.from_numpy(trust),
                                   method=method, trim_frac=0.2)
    want = JF.robust_local_aggregate({k: jnp.asarray(v) for k, v in tree.items()},
                                     jnp.asarray(pmask), jnp.asarray(trust),
                                     method=method, trim_frac=0.2)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   equal_nan=True)
    assert np.isfinite(got["w"][0].numpy()).all()  # the poisoned slot is out
    sq = {k: torch.from_numpy(v) for k, v in tree.items()}
    np.testing.assert_allclose(
        F.worker_sqnorm(sq, lead=2).numpy(),
        np.asarray(JF.worker_sqnorm({k: jnp.asarray(v) for k, v in tree.items()}, lead=2)),
        rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("method", ["mean", "median", "trimmed"])
def test_all_trusted_robust_aggregate_is_the_masked_mean(method):
    x, pmask, _ = _robust_inputs(1)
    x = np.nan_to_num(x, nan=0.0)
    x[0, 2, 0, 0] = -0.0
    tree = {"w": torch.from_numpy(x), "b": torch.from_numpy(x[:, :, 0])}
    pm, trust = torch.from_numpy(pmask), torch.ones((4, 6))
    got = F.robust_local_aggregate(tree, pm, trust, method=method, trim_frac=0.2)
    plain = F.local_aggregate(tree, pm)
    assert all(torch.equal(got[k], plain[k]) for k in tree)
    masks = F.secure_agg_masks(tree, 3, 0)
    got = F.robust_local_aggregate(tree, pm, trust, method=method, agg_masks=masks)
    ring = F.secure_local_aggregate(F.secure_mask_uplink(tree, masks), tree, pm)
    assert all(torch.equal(got[k], ring[k]) for k in tree)


@functools.lru_cache(maxsize=None)
def _jax_exchange(jfed):
    jmodel = setup()[3]
    return jax.jit(lambda st, d, i, pm: JH.exchange(jmodel, st, d, jfed, idx=i, pmask=pm))


@functools.lru_cache(maxsize=None)
def _jax_guarded_step(screen: bool):
    jmodel = setup()[3]
    return jax.jit(lambda st, pm, f: JH.local_sgd_step_guarded(jmodel, st, 0.05, pm, f,
                                                               screen=screen))


def _guarded_states(grad_fault, poison_group=None, exchanged=True):
    """The reference's and the port's states on one cohort (after one
    exchange, unless ``exchanged`` is False), from the same initial model."""
    jfed, tfed, raw, jmodel, tmodel = setup()
    jdata, tdata = both_data(raw)
    reg = JP.DeviceRegistry(raw, JP.PopulationConfig(seed=3, devices_per_group=16,
                                                     target_cohort=4, period=100.0))
    cohort = reg.sample_cohort(0, 0.0)
    A = int(cohort.pmask.shape[1])
    jstate = JH.resize_cohort(_jax_init(jfed)(jax.random.PRNGKey(0), jdata), jmodel, jdata, A)
    tstate = H.resize_cohort(H.init_state(torch.Generator(), tmodel, tfed, tdata, params=port_params(
        tmodel, reference_params(jfed, jdata, 0))), tmodel, tdata, A)
    if exchanged:
        jstate = _jax_exchange(jfed)(jstate, jdata, jnp.asarray(cohort.idx),
                                     jnp.asarray(cohort.pmask))
        tstate = H.exchange(tmodel, tstate, tdata, tfed, idx=torch.from_numpy(cohort.idx),
                            pmask=torch.from_numpy(cohort.pmask))
    if poison_group is not None:  # a NaN hospital tower: its group's step is flagged
        k = sorted(tstate.theta1)[0]
        leaf = sorted(tstate.theta1[k])[0]
        tstate.theta1[k][leaf][poison_group] = float("nan")
        jstate = jstate._replace(theta1={**jstate.theta1, k: {
            **jstate.theta1[k], leaf: jstate.theta1[k][leaf].at[poison_group].set(jnp.nan)}})
    gf = np.zeros((M, A), np.float32)
    for (m, a), v in grad_fault.items():
        gf[m, a] = v
    return jfed, tfed, jmodel, tmodel, jstate, tstate, cohort, gf


@pytest.mark.parametrize("faults,poison,screen", [
    ({(0, 0): np.nan, (1, 1): 1e4}, None, True),
    ({(0, 0): np.nan, (1, 1): 1e4}, None, False),
    ({(2, 0): 1e4}, 2, True),
    ({(2, 0): 1e4}, 2, False),
    ({}, None, True),
])
def test_guarded_step_matches_reference(faults, poison, screen):
    jfed, tfed, jmodel, tmodel, jstate, tstate, cohort, gf = _guarded_states(faults, poison)
    jnew, jloss, jdev, jgrp = _jax_guarded_step(screen)(jstate, jnp.asarray(cohort.pmask),
                                                        jnp.asarray(gf))
    tnew, tloss, tdev, tgrp = H.local_sgd_step_guarded(
        tmodel, tstate, 0.05, torch.from_numpy(cohort.pmask), torch.from_numpy(gf),
        screen=screen)
    np.testing.assert_array_equal(tdev.numpy(), np.asarray(jdev))
    np.testing.assert_array_equal(tgrp.numpy(), np.asarray(jgrp))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, equal_nan=True)
    if screen and (faults or poison is not None):
        assert tdev.min() == 0 or tgrp.min() == 0  # the screen flagged something
    # an unscreened NaN tower's own update is NaN in both, but where depends
    # on each framework's max-pool gradient at NaN: hold the other groups
    keep = [m for m in range(M) if screen or m != poison]
    for a, b in zip(tree_leaves(tnew.theta2) + tree_leaves(tnew.theta0),
                    jax.tree_util.tree_leaves(jnew.theta2) + jax.tree_util.tree_leaves(jnew.theta0)):
        np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep], rtol=1e-4, atol=1e-6,
                                   equal_nan=True)


def test_clean_guarded_step_is_the_plain_step_bit_for_bit():
    _, tfed, _, tmodel, _, tstate, cohort, gf = _guarded_states({})
    plain, ploss = H.local_sgd_step(tmodel, tstate, 0.05)
    guarded, gloss, dev_ok, grp_ok = H.local_sgd_step_guarded(
        tmodel, tstate, 0.05, torch.from_numpy(cohort.pmask), torch.from_numpy(gf), screen=True)
    assert bool(dev_ok.all()) and bool(grp_ok.all())
    assert torch.equal(gloss, ploss)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(guarded), state_tensors(plain)))


# ---------------------------------------------------------------------------
# Round executors and runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robust", [True, False])
def test_fault_round_matches_reference(robust):
    jfed, tfed, jmodel, tmodel, jstate, tstate, cohort, gf = _guarded_states(
        {(0, 0): np.nan, (1, 1): 1e4}, exchanged=False)
    A = gf.shape[1]
    msg = np.zeros(M, np.float32)
    msg[2] = np.nan  # a corrupted compressed uplink
    w = np.ones(M, np.float32) / M
    jdata, tdata = both_data(setup()[2])
    jr = JH.HSGDRunner(jmodel, jfed, JaxTrain(learning_rate=0.05))
    tr = H.HSGDRunner(tmodel, tfed, TrainConfig(learning_rate=0.05))
    jstate, jl, jflag = jr.fault_round_fn(2, 1, A, robust=robust)(
        jstate, jdata, w, 0.05, cohort.idx, cohort.pmask, gf, msg)
    tstate, tl, tflag = tr.fault_round_fn(2, 1, A, robust=robust)(
        tstate, tdata, w, 0.05, cohort.idx, cohort.pmask, gf, msg)
    assert float(tflag) == float(jflag)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, equal_nan=True)
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(tstate.theta2))
    assert finite == robust  # NaN propagates through the naive stack only
    if robust:
        assert float(tflag) > 0


def test_fault_free_screened_run_equals_the_plain_cohort_run():
    """Empty plan + armed screen: the same executors' count per bucket, and
    parameters, losses and clocks bit for bit the plain cohort run's."""
    jfed, tfed, raw, jmodel, tmodel = setup()
    _, tdata = both_data(raw)
    params = port_params(tmodel, reference_params(jfed, both_data(raw)[0], POP["seed"]))
    train = TrainConfig(learning_rate=0.05, compression_k=0.25, quantization_bits=128)
    pop = P.PopulationConfig(**POP)
    plain = P.run_population(tmodel, tfed, train, tdata, pop, 4, params=params)
    screened = P.run_population_resilient(tmodel, tfed, train, tdata, pop, 4, faults=None,
                                          robust=True, monitor=False, params=params)
    np.testing.assert_array_equal(screened["losses"], plain["losses"])
    np.testing.assert_array_equal(screened["times"], plain["times"])
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(screened["state"]),
                                                 state_tensors(plain["state"])))
    assert screened["state"].step == plain["state"].step
    assert sum(r["flagged_updates"] for r in screened["fault_log"]) == 0.0
    buckets = {h["bucket"] for h in plain["history"]}
    assert len(plain["runner"]._round_cache) == len(screened["runner"]._round_cache) == len(buckets)


FAULT_LOG_KEYS = ("round", "dropped", "grad_faulted", "msg_faulted", "lost", "dup",
                  "latency_spikes", "flagged_updates", "retries")


@pytest.mark.parametrize("robust", [True, False])
def test_resilient_run_matches_reference(robust):
    ref, got = run_both("run_population_resilient", 4, faults=PLANS, robust=robust,
                        monitor=False)
    assert [{k: r[k] for k in FAULT_LOG_KEYS} for r in got["fault_log"]] == \
        [{k: r[k] for k in FAULT_LOG_KEYS} for r in ref["fault_log"]]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4, equal_nan=True)
    assert got["recovered"] == ref["recovered"] == robust
    assert got["history"] == ref["history"]
    assert got["sim_seconds"] == ref["sim_seconds"]
    assert len(got["runner"]._round_cache) == len(ref["runner"]._round_cache)
    if robust:
        assert sum(r["flagged_updates"] for r in got["fault_log"]) > 0


def test_preemption_and_bit_identical_resume(tmp_path):
    plan = Pair(dataclasses.replace(PLANS.ref, preempt_round=3),
                dataclasses.replace(PLANS.port, preempt_round=3))
    dirs = Pair(str(tmp_path / "ref"), str(tmp_path / "port"))
    with pytest.raises(JP.CoordinatorPreempted) as want:
        run_both("run_population_resilient", 5, faults=plan, monitor=False, ckpt_dir=dirs,
                 ckpt_every=1)
    jfed, tfed, raw, jmodel, tmodel = setup()
    _, tdata = both_data(raw)
    params = port_params(tmodel, reference_params(jfed, both_data(raw)[0], POP["seed"]))
    kw = dict(robust=True, monitor=False, params=params)
    train, pop = TrainConfig(learning_rate=0.05), P.PopulationConfig(**POP)
    with pytest.raises(P.CoordinatorPreempted) as got:
        P.run_population_resilient(tmodel, tfed, train, tdata, pop, 5, faults=plan.port,
                                   ckpt_dir=dirs.port, ckpt_every=1, **kw)
    assert got.value.round_idx == want.value.round_idx == 3
    assert got.value.ckpt_dir == dirs.port
    resumed = P.run_population_resilient(tmodel, tfed, train, tdata, pop, 5, faults=plan.port,
                                         ckpt_dir=dirs.port, ckpt_every=1, resume=True, **kw)
    whole = P.run_population_resilient(tmodel, tfed, train, tdata, pop, 5, faults=PLANS.port,
                                       **kw)
    np.testing.assert_array_equal(resumed["losses"], whole["losses"])
    np.testing.assert_array_equal(resumed["times"], whole["times"])
    assert resumed["sim_seconds"] == whole["sim_seconds"]
    assert resumed["staleness_hist"] == whole["staleness_hist"]
    assert resumed["history"] == whole["history"]
    assert resumed["state"].step == whole["state"].step
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(resumed["state"]),
                                                 state_tensors(whole["state"])))
    assert resumed["recovered"]
    with pytest.raises(FileNotFoundError):
        P.run_population_resilient(tmodel, tfed, train, tdata, pop, 2, params=params,
                                   ckpt_dir=str(tmp_path / "none"), resume=True)


def test_divergence_monitor_matches_reference(tmp_path):
    """A pathologically tight spike threshold: once a checkpoint exists every
    round trips the monitor, so both packages roll back max_rollbacks times
    with a compounding η shrink, then accept progress."""
    ref, got = run_both("run_population_resilient", 4, faults=None, robust=True, monitor=True,
                        ckpt_dir=Pair(str(tmp_path / "ref"), str(tmp_path / "port")),
                        ckpt_every=1, divergence_factor=1e-9, eta_shrink=0.25, max_rollbacks=3)
    assert got["rollbacks"] == ref["rollbacks"] == 3
    assert got["lr_scale"] == ref["lr_scale"] == 0.25 ** 3
    assert [r.get("rolled_back", False) for r in got["fault_log"]] == \
        [r.get("rolled_back", False) for r in ref["fault_log"]]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    assert got["recovered"] and np.isfinite(got["losses"]).all()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--fault-nan", "1.5"],
    ["--fault-dropout", "-0.1"],
    ["--max-retries", "-1"],
    ["--backoff-factor", "1.0"],
    ["--min-quorum", "1.5"],
    ["--trim-frac", "0.6"],
    ["--preempt-round", "-3"],
    ["--ckpt-every", "-1"],
    ["--ckpt-every", "2"],          # checkpoint cadence without --checkpoint
    ["--resume"],                   # resume without --checkpoint
    ["--population", "sync", "--algorithm", "c-hsgd"],
    ["--population", "sync", "--secure-agg"],
    ["--population", "adaptive", "--fault-nan", "0.1"],
])
def test_cli_rejects_bad_flags_before_any_work(argv, monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("the CLI started work before rejecting its flags")

    monkeypatch.setattr(T, "setup_ehealth", no_work)
    with pytest.raises(SystemExit):
        T.main(["--device", "cpu"] + argv)


def test_cli_fault_run_end_to_end_with_trace(tmp_path, capsys):
    argv = ["--algorithm", "hsgd", "--population", "semi_async",
            "--dataset", "organamnist", "--samples", "48", "--groups", "2",
            "--devices", "8", "--rounds", "2", "--p", "2", "--q", "1",
            "--pop-devices", "8", "--cohort", "2", "--seed", "0",
            "--fault-nan", "0.2", "--fault-dropout", "0.1", "--robust-agg", "median"]
    ref = JT.main(argv + ["--fault-trace", str(tmp_path / "ref.json")])
    out = T.main(["--device", "cpu"] + argv + ["--fault-trace", str(tmp_path / "port.json")])
    assert out["recovered"] and math.isfinite(out["loss_last"])
    assert list(out) == list(ref)  # the reference's report keys, in its order
    for key in ("mode", "trace_seed", "steps", "sim_seconds", "devices_dropped",
                "grad_faults", "msg_faults", "round_retries", "executors_compiled"):
        assert out[key] == ref[key], key
    for path in ("ref.json", "port.json"):  # either trace replays in either package
        for cls in (FT.FaultInjector, JFT.FaultInjector):
            replay = cls.from_trace(str(tmp_path / path))
            assert replay.plan.nan_rate == pytest.approx(0.2) and len(replay.trace) == 2
    assert "fault trace ->" in capsys.readouterr().out
