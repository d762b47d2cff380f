"""The port's HSGD trainer against the JAX package's, run for run.

Both start from the same initial model (the JAX ``init_state``'s, converted
through numpy) and see the same participants: the test replays the JAX key
stream — ``k_init, k = split(key)``, then per exchange ``k, ks = split(k)``
and ``sample_participants(ks, fed)`` — and hands the draws to the port's
``HSGDRunner.run(participants=)``.

Tolerances: hsgd per-step losses within rtol 1e-5, atol 1e-6 and the final
global model within atol 1e-5 (fp32, different summation order). c-hsgd
losses within rtol 1e-4: the fp32 differences move the compressed message
by a few ulp.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FederationConfig as JaxFed
from repro.common.config import TrainConfig as JaxTrain
from repro.core import baselines as JB
from repro.core import federation as JF
from repro.core import hsgd as JH
from repro.data.partition import hybrid_partition
from repro.data.synthetic import ESR, ORGANAMNIST, make_dataset
from repro.models.split_model import cnn_hybrid as jax_cnn_hybrid
from repro.models.split_model import lstm_hybrid as jax_lstm_hybrid
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import baselines as B
from repro_torch.core import federation as F
from repro_torch.core import hsgd as H
from repro_torch.kernels.compress import compress_pytree
from repro_torch.models.split_model import cnn_hybrid, lstm_hybrid

FED = dict(num_groups=2, devices_per_group=16, alpha=0.25, local_interval=2, global_interval=4)
SEED = 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _setup(dataset="organamnist"):
    """(JAX fed, port fed, stacked data, JAX model, port model): paper-cnn on
    OrganAMNIST, or for ``dataset="esr"`` the launcher's ESR paper-lstm
    (178x1 series split 89/89 into [K, 89, 1] towers, 5 classes)."""
    jfed, tfed = JaxFed(**FED), FederationConfig(**FED)
    spec = ESR if dataset == "esr" else ORGANAMNIST
    X, y = make_dataset(spec, 128, seed=SEED)
    raw = hybrid_partition(spec, X, y, jfed, seed=SEED).stacked()
    if dataset == "esr":
        kw = dict(n_features=178, hospital_features=89, n_classes=5)
        jmodel, tmodel = jax_lstm_hybrid(**kw), lstm_hybrid(**kw)
    else:
        jmodel, tmodel = jax_cnn_hybrid(h_rows=11), cnn_hybrid(h_rows=11)
    return jfed, tfed, raw, jmodel, tmodel


@functools.lru_cache(maxsize=None)
def _jax_init(jfed, dataset="organamnist"):
    jmodel = _setup(dataset)[3]
    return jax.jit(lambda key, d: JH.init_state(key, jmodel, jfed, d))


def _jax_state(jfed, jdata, dataset="organamnist"):
    """A fresh JAX initial state (its run donates it)."""
    return _jax_init(jfed, dataset)(jax.random.PRNGKey(SEED), jdata)


def _initial_params(jstate):
    """The JAX state's starting model (every group and device slot holds it)."""
    one = lambda x, lead: np.asarray(x[(0,) * lead])
    return {
        "theta0": jax.tree.map(lambda x: one(x, 1), jstate.theta0),
        "theta1": jax.tree.map(lambda x: one(x, 1), jstate.theta1),
        "theta2": jax.tree.map(lambda x: one(x, 2), jstate.theta2),
    }


def _jax_draws(jfed, n):
    """The participants the JAX run draws at its first ``n`` exchanges."""
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    draws = []
    for _ in range(n):
        k, ks = jax.random.split(k)
        draws.append(np.asarray(JF.sample_participants(ks, jfed)))
    return torch.from_numpy(np.stack(draws))


def _run_both(rounds, algorithm="hsgd", dataset="organamnist", **train_kw):
    jfed, tfed, raw, jmodel, tmodel = _setup(dataset)
    jrunner, jfed = JB.make_runner(algorithm, jmodel, jfed, JaxTrain(**train_kw))
    trunner, tfed = B.make_runner(algorithm, tmodel, tfed, TrainConfig(**train_kw))
    if algorithm in ("centralized", "tdcd", "c-tdcd"):
        # one merged group, as both launchers feed TDCD (and the port's,
        # centralized SGD)
        raw = B.merge_groups_for_tdcd(raw)
    jdata = {k: jnp.asarray(v) for k, v in raw.items()}
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    jstate = _jax_state(jfed, jdata, dataset)
    params = tmodel.params_from_numpy(_initial_params(jstate), "cpu")
    tstate = H.init_state(torch.Generator(), tmodel, tfed, tdata, params=params)
    parts = _jax_draws(jfed, rounds * jfed.lam)

    jw, tw = JH.make_group_weights(jdata), H.make_group_weights(tdata)
    jstate, jlosses = jrunner.run(jstate, jdata, jw, rounds=rounds)
    tstate, tlosses = trunner.run(tstate, tdata, tw, rounds, participants=parts)
    return (np.asarray(jlosses), tlosses.numpy(),
            JH.global_model(jstate, jw), H.global_model(tstate, tw))


def test_hsgd_run_matches_jax():
    jl, tl, jgm, tgm = _run_both(3, learning_rate=0.05)
    assert tl.shape == jl.shape == (12,)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[-4:].mean() < tl[:4].mean()
    for t, j in zip(tree_leaves(tgm), jax.tree_util.tree_leaves(jgm)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_c_hsgd_run_matches_jax():
    jl, tl, _, _ = _run_both(2, "c-hsgd", learning_rate=0.05, compression_k=0.25,
                             quantization_bits=128)
    assert tl.shape == jl.shape == (8,)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_centralized_run_matches_jax():
    """Centralized SGD (M=1, α=1, P=Q=1) on the merged groups: the port's
    runner against the reference's on the same merged data. The reference's
    launcher does not merge for this algorithm and its run fails on the
    [M, K] data; the port's launcher merges, as it does for TDCD."""
    jl, tl, jgm, tgm = _run_both(3, "centralized", learning_rate=0.05)
    assert tl.shape == jl.shape == (3,)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for t, j in zip(tree_leaves(tgm), jax.tree_util.tree_leaves(jgm)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("algorithm,train_kw", [
    ("hsgd", {}),
    ("c-hsgd", {"compression_k": 0.25, "quantization_bits": 128}),
])
def test_esr_lstm_runs_match_jax(algorithm, train_kw):
    """paper-lstm on ESR ([K, 89, 1] towers, whose size-1 feature axis the
    input projection broadcasts): 2 rounds from the reference's initial
    model and participants, per-step losses within rtol 1e-4."""
    jl, tl, _, _ = _run_both(2, algorithm, "esr", learning_rate=0.05, **train_kw)
    assert tl.shape == jl.shape == (8,)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("algorithm,train_kw", [
    ("tdcd", {}),
    ("c-tdcd", {"compression_k": 0.25, "quantization_bits": 128}),
    ("hsgd", {"lr_halve_every": 2}),
])
def test_tdcd_and_lr_schedule_runs_match_jax(algorithm, train_kw):
    """3 rounds of TDCD and C-TDCD (one merged group) and of HSGD with the
    step size halved every 2 steps, against the reference from the same
    initial model and participants: losses within rtol 1e-4 (compression,
    as for c-hsgd) or rtol 1e-5, atol 1e-6, and the final global model
    within atol 1e-5 without compression."""
    jl, tl, jgm, tgm = _run_both(3, algorithm, learning_rate=0.05, **train_kw)
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    if algorithm == "c-tdcd":
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        return
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for t, j in zip(tree_leaves(tgm), jax.tree_util.tree_leaves(jgm)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_compressed_exchange_message_matches_jax():
    """One c-hsgd exchange on identical state, message (θ0 snapshot, ζ1, ζ2)
    by message. The port's compression of the JAX's uncompressed message
    meets the compression tolerances against the JAX's compressed one; the
    port's own exchange has the same survivors, and its ζ values carry the
    forward pass's fp32 tolerance on top."""
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jdata = {k: jnp.asarray(v) for k, v in raw.items()}
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    jstate = _jax_state(jfed, jdata)
    params = tmodel.params_from_numpy(_initial_params(jstate), "cpu")
    tstate = H.init_state(torch.Generator(), tmodel, tfed, tdata, params=params)
    idx = _jax_draws(jfed, 1)[0]
    jexchange = jax.jit(lambda s, d, i, k, b: JH.exchange(jmodel, s, d, jfed, k, b, idx=i),
                        static_argnums=(3, 4))
    jplain = jexchange(jstate, jdata, jnp.asarray(idx.numpy()), 0.0, 0)
    jout = jexchange(jstate, jdata, jnp.asarray(idx.numpy()), 0.25, 128)
    tout = H.exchange(tmodel, tstate, tdata, tfed, 0.25, 128, idx=idx)
    recompressed = compress_pytree(
        jax.tree.map(lambda v: torch.tensor(np.asarray(v)), jplain.stale), 0.25, 128)
    for name in ("theta0", "z1", "z2"):
        want = jax.tree_util.tree_leaves(jout.stale[name])
        plain = jax.tree_util.tree_leaves(jplain.stale[name])
        for r, t, j, x in zip(tree_leaves(recompressed[name]), tree_leaves(tout.stale[name]),
                              want, plain):
            j, x = np.asarray(j).reshape(-1, j.shape[-1]), np.asarray(x).reshape(-1, x.shape[-1])
            r, t = r.numpy().reshape(j.shape), t.numpy().reshape(j.shape)
            tol = 4 * 2.0 ** -23 * np.abs(x).max(axis=-1, keepdims=True)
            np.testing.assert_array_equal(r != 0, j != 0)
            assert (np.abs(r - j) <= tol).all(), name
            np.testing.assert_array_equal(t != 0, j != 0)
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=name)
    for k in tdata:
        np.testing.assert_array_equal(tout.batch[k].numpy(), np.asarray(jout.batch[k]))


def test_sampled_participants_valid_and_distinct():
    fed = FederationConfig(**FED)
    idx = F.sample_participants(torch.Generator().manual_seed(3), fed)
    assert tuple(idx.shape) == (fed.num_groups, fed.sampled_devices)
    assert ((idx >= 0) & (idx < fed.devices_per_group)).all()
    for row in idx:
        assert len(set(row.tolist())) == fed.sampled_devices


def test_gather_past_the_group_data_fills_as_the_reference():
    """Participants are drawn among all devices_per_group devices; where a
    group's data holds fewer, the indices past it read jnp.take's fill
    values (NaN features, the least int32 label, True for valid) in both
    packages, and the rest is gathered exactly."""
    _, _, raw, _, _ = _setup()
    K = raw["y"].shape[1]
    idx = np.stack([np.r_[0, K - 1, K, K + 7], np.r_[K + 1, 3, 1, K - 2]]).astype(np.int32)
    want = JF.gather_batch({k: jnp.asarray(v[:2]) for k, v in raw.items()}, jnp.asarray(idx))
    got = F.gather_batch({k: torch.as_tensor(v[:2]) for k, v in raw.items()},
                         torch.from_numpy(idx))
    for k in raw:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert np.isnan(got["x1"].numpy()[0, 2]).all()
    assert int(got["y"][1, 0]) == np.iinfo(np.int32).min


def test_run_rejects_wrong_participant_count():
    _, tfed, raw, _, tmodel = _setup()
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    state = H.init_state(torch.Generator().manual_seed(0), tmodel, tfed, tdata)
    parts = torch.zeros((3, tfed.num_groups, tfed.sampled_devices), dtype=torch.long)
    with pytest.raises(ValueError, match="rounds·Λ"):
        H.HSGDRunner(tmodel, tfed, TrainConfig()).run(
            state, tdata, H.make_group_weights(tdata), 1, participants=parts)


def test_jfl_run_matches_jax():
    """The JFL baseline's own runner (a full model per device-hospital pair)
    against the reference's, from its initial model and per-round draws."""
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jdata = {k: jnp.asarray(v) for k, v in raw.items()}
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    jrunner = JB.JFLRunner(jmodel, jfed, JaxTrain(learning_rate=0.05))
    trunner = B.JFLRunner(tmodel, tfed, TrainConfig(learning_rate=0.05))
    jstate = jax.jit(jrunner.init)(jax.random.PRNGKey(SEED))
    params = tmodel.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x[0, 0]), jstate.params), "cpu")
    tstate = trunner.init(torch.Generator(), "cpu", params=params)
    rounds = 2
    jstate, jlosses = jrunner.run(jstate, jdata, JH.make_group_weights(jdata), rounds)
    tstate, tlosses = trunner.run(tstate, tdata, H.make_group_weights(tdata), rounds,
                                  participants=_jax_draws(jfed, rounds))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-5, atol=1e-6)
