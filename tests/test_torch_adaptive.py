"""The port's §VI adaptive loop against the JAX package's.

* ``comm_model`` and the ``adaptive`` formulas are host-side float math and
  must equal the reference's exactly.
* ``plan_round`` and ``ControllerCore`` must give the reference's
  ``RoundPlan`` and history records, field for field, on the same probes
  and stats (the cases of ``tests/test_adaptive_controller.py`` and
  ``tests/test_privacy.py``).
* Anything that runs the model (the ρ/δ probe, the step statistics, whole
  adaptive runs) holds to rtol 1e-4: fp32 model math summed in other
  orders. Runs replay the reference's draws — per exchange ``k, ks =
  split(k)`` (``k, ks, kdp = split(k, 3)`` with DP), the probe's batches
  and perturbations as ``adaptive.py`` draws them — and inject them.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FederationConfig as JaxFed
from repro.common.config import TrainConfig as JaxTrain
from repro.core import adaptive as JA
from repro.core import comm_model as JCM
from repro.core import controller as JC
from repro.core import hsgd as JH
from repro_torch.common import buckets
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.core import adaptive as TA
from repro_torch.core import comm_model as TCM
from repro_torch.core import controller as TCT
from repro_torch.core import hsgd as H
from test_torch_hsgd import FED, SEED, _jax_draws, _setup
from test_torch_privacy import _states, jax_private_draws, message_shape


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params():
    """The reference's initial model (numpy) and the port's copy of it."""
    jmodel, tmodel = _setup()[3:]
    jp = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(SEED)))
    return jp, tmodel.params_from_numpy(jp, "cpu")


# ---------------------------------------------------------------------------
# Pure formulas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,b", [(0.0, 0), (0.25, 128), (0.05, 64), (0.5, 0)])
def test_comm_model_matches_jax(k, b):
    jp, tp = _params()
    js = JCM.message_sizes(jp, 256, 512, 4, k, b, raw_upfront=1e5)
    ts = TCM.message_sizes(tp, 256, 512, 4, k, b, raw_upfront=1e5)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for P, Q in [(1, 1), (4, 2), (8, 8), (12, 3)]:
        jf, tf = JaxFed(global_interval=P, local_interval=Q), FederationConfig(
            global_interval=P, local_interval=Q)
        assert TCM.comm_cost_per_iteration(ts, tf) == JCM.comm_cost_per_iteration(js, jf)
        assert TCM.total_comm_cost(ts, tf, 37) == JCM.total_comm_cost(js, jf, 37)
        assert TCM.per_round_bytes(ts, P, Q, 10) == JCM.per_round_bytes(js, P, Q, 10)
        for tl, jl in ((TCM.WAN, JCM.WAN), (TCM.ICI, JCM.ICI)):
            assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
            assert TCM.round_time(ts, tf, 0.05, tl) == JCM.round_time(js, jf, 0.05, jl)
            assert (TCM.round_time_hetero(ts, tf, 0.05, tl, 2.5, 1.7)
                    == JCM.round_time_hetero(js, jf, 0.05, jl, 2.5, 1.7))
            for up in (True, False):
                assert (TCM.time_to_step(ts, tf, 0.05, 50, tl, up)
                        == JCM.time_to_step(js, jf, 0.05, 50, jl, up))


@pytest.mark.parametrize("F0,rho,delta,eta,P,Q,T,gnorm2", [
    (2.3, 2.0, 0.5, 0.01, 4, 2, 100, 1.0),
    (0.7, 35.0, 3.1, 0.002, 1, 1, 40, 0.03),
    (5.0, 0.3, 0.01, 0.1, 16, 16, 1000, 12.0),
])
def test_adaptive_formulas_match_jax(F0, rho, delta, eta, P, Q, T, gnorm2):
    assert (TA.convergence_bound(F0, 0.1, rho, delta, eta, P, Q, T)
            == JA.convergence_bound(F0, 0.1, rho, delta, eta, P, Q, T))
    assert TA.max_learning_rate(P, rho) == JA.max_learning_rate(P, rho)
    for target in (1.0, 1e3, 1e9):
        assert (TA.strategy1_lambda_lower_bound(F0, 0.0, rho, delta, eta, P, T, target)
                == JA.strategy1_lambda_lower_bound(F0, 0.0, rho, delta, eta, P, T, target))
    assert TA.strategy1_intervals(Q) == JA.strategy1_intervals(Q)
    assert (TA.strategy2_optimal_interval(F0, rho, delta, eta, T)
            == JA.strategy2_optimal_interval(F0, rho, delta, eta, T))
    assert (TA.strategy3_learning_rate(P, Q, rho, delta, gnorm2)
            == JA.strategy3_learning_rate(P, Q, rho, delta, gnorm2))
    probe = {"rho": rho, "delta": delta, "F0": F0, "grad_norm_sq": gnorm2}
    assert (TA.recommend_settings(probe, T, eta, FederationConfig())
            == JA.recommend_settings(probe, T, eta, JaxFed()))
    for n in (1, 2, 3, 7, 8, 33, 1000):
        assert buckets.pow2_floor(n) == 1 << (n.bit_length() - 1)
        assert buckets.pow2_ceil(n) >= n > buckets.pow2_ceil(n) // 2 or n == 1


def test_estimate_rho_delta_matches_jax_on_its_draws():
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jp, tp = _params()
    jdata = {k: jnp.asarray(v) for k, v in raw.items()}
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    key, n_probes, n_perturb, batch = jax.random.PRNGKey(5), 3, 2, 8
    want = JA.estimate_rho_delta(jmodel, jax.tree.map(jnp.asarray, jp), jdata, key,
                                 n_probes=n_probes, n_perturb=n_perturb, batch=batch)
    # the reference's draws, as its jitted probe makes them
    total = int(np.prod(raw["y"].shape[:2]))
    k_noise, k_lip, k_pert = jax.random.split(key, 3)
    choice = lambda k, n: np.array(jax.random.choice(k, total, (n,), replace=False))
    leaves, treedef = tree_flatten(tp)
    perturb = []
    for k in jax.random.split(k_pert, n_perturb):
        ks = jax.random.split(k, len(leaves))
        perturb.append(tree_unflatten(treedef, [
            torch.from_numpy(np.array(jax.random.normal(kk, tuple(p.shape), jnp.float32)))
            for kk, p in zip(ks, leaves)]))
    draws = {"probe_idx": np.stack([choice(k, batch) for k in jax.random.split(k_noise, n_probes)]),
             "lip_idx": choice(k_lip, min(4 * batch, total)), "perturb": perturb}
    got = TA.estimate_rho_delta(tmodel, tp, tdata, draws=draws)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, err_msg=name)
    own = TA.estimate_rho_delta(tmodel, tp, tdata, torch.Generator().manual_seed(1),
                                n_probes=n_probes, n_perturb=n_perturb, batch=batch)
    assert own["rho"] > 0 and own["F0"] > 0 and math.isfinite(own["delta"])


# ---------------------------------------------------------------------------
# Planning and the ledgers
# ---------------------------------------------------------------------------

PROBE = {"rho": 2.0, "delta": 0.5, "F0": 1.0, "grad_norm_sq": 1.0}


def _sizes_const(cm):
    """Constant message sizes (the reference tests' own), in module ``cm``."""
    def sizes_of(k_frac, levels):
        n = 10_000
        comp = cm.compressed_bytes(n, k_frac or 1.0, levels) if (k_frac or levels) else n * 4
        return cm.MessageSizes(theta0=comp, theta1=4e4, theta2=1e4,
                               z1=comp / 10, z2=comp / 10, n_active=4)
    return sizes_of


@pytest.mark.parametrize("case", [
    # the byte governor: an impossible budget ratchets to the tightest rung
    dict(cfg=dict(total_steps=100, byte_budget=1.0)),
    dict(cfg=dict(total_steps=100, byte_budget=math.inf)),
    dict(cfg=dict(total_steps=100, byte_budget=3e7), bytes_spent=1e7, rung=1),
    # the η floor yields to Theorem 1's cap
    dict(cfg=dict(total_steps=1000, max_interval=32, eta_min=1e-3), probe=dict(rho=50.0)),
    # the Theorem-1 guard
    dict(cfg=dict(total_steps=1000, target_bound=1e-6, max_interval=64)),
    dict(cfg=dict(total_steps=1000, target_bound=math.inf, max_interval=64)),
    dict(cfg=dict(total_steps=6, max_interval=64)),
    # the σ ratchet and the refusal
    dict(cfg=dict(total_steps=32, privacy_budget=5.0, dp_clip=1.0, dp_sigma=1.0)),
    dict(cfg=dict(total_steps=64, privacy_budget=1e-3, dp_clip=1.0, dp_sigma=1.0)),
    dict(cfg=dict(total_steps=32, privacy_budget=40.0, dp_clip=1.0, dp_sigma=2.0),
         steps_done=8, dp_rung=1),
    # the wall-clock governor
    dict(cfg=dict(total_steps=64, time_budget=10.0), time=True),
])
def test_plan_round_matches_jax(case):
    probe = dict(PROBE, **case.get("probe", {}))
    fed_kw = dict(num_groups=4)
    cfg_kw = case["cfg"]
    args = (probe, case.get("steps_done", 0), case.get("bytes_spent", 0.0),
            case.get("rung", 0), 0.01)
    jcfg, tcfg = JC.AdaptiveConfig(**cfg_kw), TCT.AdaptiveConfig(**cfg_kw)
    kw = dict(dp_rung=case.get("dp_rung", 0), privacy_spent=case.get("privacy_spent", 0.3))
    if case.get("time"):
        kw["time_of"] = lambda P, rung: 0.5 + 4.0 / P + rung * 0.1
    jp = JC.plan_round(*args, jcfg, JaxFed(**fed_kw), _sizes_const(JCM), **kw)
    tp = TCT.plan_round(*args, tcfg, FederationConfig(**fed_kw), _sizes_const(TCM), **kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_ladders_and_privacy_math_match_jax():
    for k, b in [(0.0, 0), (0.25, 128), (0.5, 0), (0.1, 128), (0.05, 64)]:
        assert TCT.ladder_from(k, b) == JC.ladder_from(k, b)
    assert TCT.COMPRESSION_LADDER == JC.COMPRESSION_LADDER
    assert TCT.DP_SIGMA_LADDER == JC.DP_SIGMA_LADDER
    for sigma in (0.0, 0.3, 1.0, 8.0):
        assert TCT.gaussian_rho(sigma) == JC.gaussian_rho(sigma)
    for rho, delta in [(0.0, 1e-5), (0.5, 1e-5), (20.0, 1e-3), (math.inf, 1e-5)]:
        assert TCT.epsilon_of(rho, delta) == JC.epsilon_of(rho, delta)
    assert TCT.NEUTRAL_PROBE == JC.NEUTRAL_PROBE


def _fake_stats(P, r):
    """Per-step stats that vary with the round, so the probe EMA moves."""
    g = np.random.default_rng(r)
    return {"loss": (0.5 + g.random(P)).astype(np.float32),
            "gnorm2": (1.0 + g.random(P)).astype(np.float32),
            "delta2": (0.25 * g.random(P)).astype(np.float32),
            "rho": (2.0 * g.random(P)).astype(np.float32),
            "rho_ok": (g.random(P) > 0.3).astype(np.float32)}


@pytest.mark.parametrize("cfg_kw", [
    dict(total_steps=32, byte_budget=2e6, max_interval=8),
    dict(total_steps=32, privacy_budget=18.0, dp_clip=1.0, dp_sigma=1.0),
    dict(total_steps=64, privacy_budget=1e-3, dp_clip=1.0, dp_sigma=1.0),
    dict(total_steps=40, time_budget=30.0, target_bound=50.0),
])
def test_controller_core_matches_jax(cfg_kw):
    """Plan, record fake stats, repeat: the same plans, history records and
    ledgers; the state_dict round-trips into a fresh core."""
    fed = dict(local_interval=1, global_interval=2)
    time_of = lambda P, rung: 0.5 + 4.0 / P + rung * 0.1
    jcore = JC.ControllerCore(JC.AdaptiveConfig(**cfg_kw), JaxFed(**fed), _sizes_const(JCM),
                              eta0=0.05, probe=PROBE, time_of=time_of)
    tcore = TCT.ControllerCore(TCT.AdaptiveConfig(**cfg_kw), FederationConfig(**fed),
                               _sizes_const(TCM), eta0=0.05, probe=PROBE, time_of=time_of)
    r = 0
    while not jcore.done:
        jp, jrung = jcore.plan()
        tp, trung = tcore.plan()
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp) and trung == jrung
        assert tcore.privacy_exhausted == jcore.privacy_exhausted
        if jcore.privacy_exhausted:
            break
        assert tcore.record(tp, _fake_stats(tp.P, r)) == jcore.record(jp, _fake_stats(jp.P, r))
        r += 1
    assert tcore.done and tcore.state_dict() == jcore.state_dict()
    assert tcore.epsilon_spent == jcore.epsilon_spent
    clone = TCT.ControllerCore(TCT.AdaptiveConfig(**cfg_kw), FederationConfig(**fed),
                               _sizes_const(TCM), eta0=0.05, time_of=time_of)
    clone.load_state_dict(tcore.state_dict())
    assert clone.state_dict() == tcore.state_dict()
    legacy = {k: v for k, v in tcore.state_dict().items()
              if k not in ("rho_spent", "dp_rung", "privacy_exhausted")}
    clone.load_state_dict(legacy)
    assert clone.rho_spent == 0.0 and clone.dp_rung == 0 and not clone.privacy_exhausted


def test_hsgd_sizes_of_matches_jax():
    jfed, tfed, raw, jmodel, tmodel = _setup()
    _, _, jstate, tstate = _states(jfed, tfed, raw, tmodel)
    js, ts = JC.hsgd_sizes_of(jstate, jfed), TCT.hsgd_sizes_of(tstate, tfed)
    for k, b in TCT.COMPRESSION_LADDER:
        assert dataclasses.asdict(ts(k, b)) == dataclasses.asdict(js(k, b))


# ---------------------------------------------------------------------------
# Round statistics and round_fn
# ---------------------------------------------------------------------------


def test_local_sgd_step_stats_match_jax():
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jdata, tdata, jstate, tstate = _states(jfed, tfed, raw, tmodel)
    idx = _jax_draws(jfed, 1)[0]
    jw, tw = JH.make_group_weights(jdata), H.make_group_weights(tdata)
    jstep = jax.jit(lambda s: JH.local_sgd_step_stats(
        jmodel, JH.exchange(jmodel, s, jdata, jfed, idx=jnp.asarray(idx.numpy())), 0.02, jw))
    _, jloss, jaux = jstep(jstate)
    tstate = H.exchange(tmodel, tstate, tdata, tfed, idx=idx)
    _, tloss, taux = H.local_sgd_step_stats(tmodel, tstate, 0.02, tw)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    for name in ("gnorm2", "delta2"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-4, err_msg=name)


def test_round_fn_stats_match_jax():
    """One collecting round at P=4, Q=2: every per-step stat, the ρ secants
    included, and which steps carry a secant."""
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jdata, tdata, jstate, tstate = _states(jfed, tfed, raw, tmodel)
    jw, tw = JH.make_group_weights(jdata), H.make_group_weights(tdata)
    train = dict(learning_rate=0.02, compression_k=0.25, quantization_bits=128)
    jfn = JH.HSGDRunner(jmodel, jfed, JaxTrain(**train)).round_fn(4, 2)
    _, jstats = jfn(jstate, jdata, jw, 0.02)
    tfn = H.HSGDRunner(tmodel, tfed, TrainConfig(**train)).round_fn(4, 2)
    _, tstats = tfn(tstate, tdata, tw, 0.02, participants=_jax_draws(jfed, 2))
    assert set(tstats) == set(jstats) == {"loss", "gnorm2", "delta2", "rho", "rho_ok"}
    np.testing.assert_array_equal(tstats["rho_ok"].numpy(), [0.0, 1.0, 0.0, 1.0])
    np.testing.assert_array_equal(tstats["rho_ok"].numpy(), np.asarray(jstats["rho_ok"]))
    for name in ("loss", "gnorm2", "delta2", "rho"):
        np.testing.assert_allclose(tstats[name].numpy(), np.asarray(jstats[name]), rtol=1e-4,
                                   err_msg=name)
    assert (tstats["rho"].numpy()[1::2] > 0).all()


def test_round_fn_cache_and_validation():
    _, tfed, raw, _, tmodel = _setup()
    runner = H.HSGDRunner(tmodel, tfed, TrainConfig(learning_rate=0.02))
    f1 = runner.round_fn(4, 2, 0.25, 128)
    assert runner.round_fn(4, 2, 0.25, 128) is f1  # bucket cached
    assert runner.round_fn(4, 4, 0.25, 128) is not f1
    assert runner.round_fn(4, 2, 0.0, 0) is not f1
    assert runner.round_fn(4, 2, 0.25, 128, dp=True) is not f1
    assert runner.round_fn(4, 2, 0.25, 128, dp=True) is runner.round_fn(4, 2, 0.25, 128, dp=True)
    assert len(runner._round_cache) == 4
    for P, Q in ((4, 3), (0, 1), (2, 0)):
        with pytest.raises(ValueError, match="multiple"):
            runner.round_fn(P, Q)
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    state = H.init_state(torch.Generator().manual_seed(0), tmodel, tfed, tdata)
    with pytest.raises(ValueError, match="dp_clip"):
        runner.round_fn(4, 2, dp=True)(state, tdata, H.make_group_weights(tdata), 0.02)


# ---------------------------------------------------------------------------
# Whole adaptive runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("private", [False, True])
def test_adaptive_run_matches_jax(private):
    """init_probe=False, T = 8 steps, on the reference's draws: the same
    (P, Q, rung, dp_rung) per round, losses within rtol 1e-4 and the same ε
    ledger. The private run has DP (C=1, σ=1 under an ε budget that makes
    the σ ladder climb) and secure aggregation."""
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jdata, tdata, jstate, tstate = _states(jfed, tfed, raw, tmodel)
    steps = 8
    cfg_kw = dict(total_steps=steps, init_probe=False, max_interval=4,
                  ladder=TCT.ladder_from(0.25, 128))
    if private:
        cfg_kw.update(dp_clip=1.0, dp_sigma=1.0, privacy_budget=12.0, secure_agg=True)
        parts, noise = jax_private_draws(jfed, steps, message_shape(tstate))
    else:
        parts, noise = _jax_draws(jfed, steps), None
    train = dict(learning_rate=0.01, compression_k=0.25, quantization_bits=128)
    jres = JC.AdaptiveHSGDRunner(jmodel, JaxFed(**FED), JaxTrain(**train),
                                 JC.AdaptiveConfig(**cfg_kw)).run(
        jstate, jdata, JH.make_group_weights(jdata))
    tctl = TCT.AdaptiveHSGDRunner(tmodel, tfed, TrainConfig(**train), TCT.AdaptiveConfig(**cfg_kw))
    tres = tctl.run(tstate, tdata, H.make_group_weights(tdata), participants=parts,
                    dp_noise=noise)
    keys = ("P", "Q", "rung", "dp_rung", "compression_k", "quant_levels", "dp_sigma")
    assert ([{k: h[k] for k in keys} for h in tres.history]
            == [{k: h[k] for k in keys} for h in jres.history])
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    for th, jh in zip(tres.history, jres.history):
        assert th["epsilon_total"] == jh["epsilon_total"]
        assert th["bytes_total"] == jh["bytes_total"]
        np.testing.assert_allclose(th["eta"], jh["eta"], rtol=1e-4)
    assert sum(h["P"] for h in tres.history) == len(tres.losses) <= steps
    assert len(tctl.runner._round_cache) == len({(h["P"], h["Q"], h["rung"])
                                                  for h in tres.history})
    if private:
        assert max(h["dp_rung"] for h in tres.history) > 0  # the σ ladder climbed
