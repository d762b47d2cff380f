"""The port's paper models, data pipeline and configs against the JAX package.

Both packages get the same inputs: the JAX ``HybridModel.init`` parameters
(through ``params_from_numpy``) and numpy data from one seed. The towers'
outputs, the loss and the gradients of θ0, θ1 and θ2 agree within rtol 1e-5,
atol 1e-6: both run fp32, but sum in different orders. The data pipeline and
the config errors must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FederationConfig as JaxFed
from repro.common.config import TrainConfig as JaxTrain
from repro.common.config import apply_overrides as jax_apply_overrides
from repro.common.pytree import tree_dot as jax_tree_dot
from repro.data import partition as jax_partition
from repro.data import synthetic as jax_synthetic
from repro.models import split_model as jax_split
from repro.models.cnn import classification_loss as jax_classification_loss
from repro_torch.common.config import FederationConfig, TrainConfig, apply_overrides
from repro_torch.common.pytree import tree_dot, tree_flatten, tree_leaves, tree_norm, tree_unflatten
from repro_torch.data import partition, synthetic
from repro_torch.models import split_model
from repro_torch.models.cnn import classification_loss

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(kind):
    if kind == "cnn":
        return jax_split.cnn_hybrid(h_rows=11), split_model.cnn_hybrid(h_rows=11)
    if kind == "esr":  # the launcher's ESR model: 178x1 series split 89/89, 5 classes
        kw = dict(n_features=178, hospital_features=89, n_classes=5)
        return jax_split.lstm_hybrid(**kw), split_model.lstm_hybrid(**kw)
    return (jax_split.lstm_hybrid(n_features=76, hospital_features=36),
            split_model.lstm_hybrid(n_features=76, hospital_features=36))


def _inputs(kind, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "cnn":
        x1 = rng.standard_normal((batch, 11 * 28)).astype(np.float32)
        x2 = rng.standard_normal((batch, 17 * 28)).astype(np.float32)
        y = rng.integers(0, 11, batch).astype(np.int32)
    elif kind == "esr":  # [B, 89, 1] towers: the size-1 feature axis meets wx's 89 rows
        x1 = rng.standard_normal((batch, 89, 1)).astype(np.float32)
        x2 = rng.standard_normal((batch, 89, 1)).astype(np.float32)
        y = rng.integers(0, 5, batch).astype(np.int32)
    else:
        x1 = rng.standard_normal((batch, 48, 36)).astype(np.float32)
        x2 = rng.standard_normal((batch, 48, 40)).astype(np.float32)
        y = rng.integers(0, 2, batch).astype(np.int32)
    return x1, x2, y


def _close(port, ref, what):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("kind", ["cnn", "lstm", "esr"])
def test_forward_loss_and_grads_match_jax(kind):
    jm, tm = _models(kind)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tparams = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    x1, x2, y = _inputs(kind)
    jx1, jx2, jy = map(jnp.asarray, (x1, x2, y))
    tx1, tx2, ty = map(torch.from_numpy, (x1, x2, y))

    _close(tm.h1(tparams["theta1"], tx1), jax.jit(jm.h1)(jparams["theta1"], jx1), "h1")
    _close(tm.h2(tparams["theta2"], tx2), jax.jit(jm.h2)(jparams["theta2"], jx2), "h2")
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.full_loss))(jparams, jx1, jx2, jy)
    tgrads, tloss = torch.func.grad_and_value(tm.full_loss)(tparams, tx1, tx2, ty)
    _close(tloss, jloss, "loss")
    jleaves = jax.tree_util.tree_leaves(jgrads)
    tleaves = tree_leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert tuple(t.shape) == j.shape
        _close(t, j, f"grad leaf {i}")


def test_classification_loss_reads_nan_outside_the_classes_as_jax():
    """Labels that count from the end, and the fill label gathered from past
    a group's data, against the reference's take_along_axis: the same loss
    (NaN where a label lies outside [-C, C)) and the same gradient."""
    logits = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    for labels in ([1, 4, 0, 2], [1, -1, -5, 2], [1, np.iinfo(np.int32).min, 3, 0]):
        lab = np.asarray(labels, np.int32)
        want, want_g = jax.value_and_grad(jax_classification_loss)(jnp.asarray(logits),
                                                                   jnp.asarray(lab))
        x = torch.from_numpy(logits).requires_grad_()
        got = classification_loss(x, torch.from_numpy(lab))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, equal_nan=True)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["cnn", "lstm", "esr"])
def test_init_matches_spec_shapes(kind):
    jm, tm = _models(kind)
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tparams = tm.init(torch.Generator().manual_seed(0))
    for t, j, spec in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams),
                          tree_leaves(tm.specs())):
        assert tuple(t.shape) == j.shape == spec.shape
        if spec.init == "zeros":
            assert not t.any()
        else:  # truncated normal at ±2 fan-in-scaled standard deviations
            bound = 2.0 / np.sqrt(np.prod(spec.shape[:-1]) if len(spec.shape) > 1 else spec.shape[0])
            assert t.abs().max() <= bound * (1 + 1e-6) and t.std() > 0


def test_params_from_numpy_checks_shapes():
    _, tm = _models("cnn")
    shapes = jax.eval_shape(_models("cnn")[0].init, jax.random.PRNGKey(0))
    good = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes)
    tm.params_from_numpy(good, "cpu")
    bad = dict(good, theta0=dict(good["theta0"], fc2_b=np.zeros(12, np.float32)))
    with pytest.raises(ValueError, match="does not match spec"):
        tm.params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("name", sorted(synthetic.DATASETS))
def test_synthetic_and_partition_bit_identical(name):
    spec_t, spec_j = synthetic.DATASETS[name], jax_synthetic.DATASETS[name]
    Xt, yt = synthetic.make_dataset(spec_t, 300, seed=3)
    Xj, yj = jax_synthetic.make_dataset(spec_j, 300, seed=3)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    for a, b in zip(synthetic.vertical_split(spec_t, Xt), jax_synthetic.vertical_split(spec_j, Xj)):
        np.testing.assert_array_equal(a, b)
    kw = dict(num_groups=4, devices_per_group=64, alpha=0.25, local_interval=2, global_interval=4)
    st = partition.hybrid_partition(spec_t, Xt, yt, FederationConfig(**kw), seed=3).stacked()
    sj = jax_partition.hybrid_partition(spec_j, Xj, yj, JaxFed(**kw), seed=3).stacked()
    assert st.keys() == sj.keys()
    for k in st:
        assert st[k].dtype == sj[k].dtype
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    bt = partition.sample_minibatch(st, 5, np.random.RandomState(7))
    bj = jax_partition.sample_minibatch(sj, 5, np.random.RandomState(7))
    for k in bt:
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(local_interval=0),
    dict(global_interval=0),
    dict(local_interval=3, global_interval=4),
    dict(robust_agg="mode"),
    dict(trim_frac=0.5),
    dict(screen_zmax=1.0),
])
def test_federation_config_raises_same_errors(kw):
    with pytest.raises(ValueError) as ref:
        JaxFed(**kw)
    with pytest.raises(ValueError) as port:
        FederationConfig(**kw)
    assert str(port.value) == str(ref.value)


def test_configs_match_reference_fields_and_overrides():
    for port_cls, ref_cls in ((FederationConfig, JaxFed), (TrainConfig, JaxTrain)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(ref_cls())
    fed = FederationConfig(num_groups=4, local_interval=2, global_interval=4)
    assert (fed.lam, fed.sampled_devices) == (2, 2)
    over = {"learning_rate": "0.5", "lr_halve_every": "7", "remat": "false"}
    assert (dataclasses.asdict(apply_overrides(TrainConfig(), over))
            == dataclasses.asdict(jax_apply_overrides(JaxTrain(), over)))
    with pytest.raises(KeyError):
        apply_overrides(TrainConfig(), {"nope": "1"})


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(2)
    a = {"b": rng.standard_normal((3, 2)).astype(np.float32),
         "a": {"y": rng.standard_normal(4).astype(np.float32),
               "x": rng.standard_normal((2, 2)).astype(np.float32)}}
    leaves, treedef = tree_flatten(a)
    # dicts flatten in sorted-key order, as jax.tree_util does
    for t, j in zip(leaves, jax.tree_util.tree_leaves(a)):
        np.testing.assert_array_equal(t, j)
    assert tree_unflatten(treedef, leaves) == a
    ta = jax.tree.map(torch.from_numpy, a)
    np.testing.assert_allclose(float(tree_dot(ta, ta)), float(jax_tree_dot(a, a)), rtol=1e-6)
    np.testing.assert_allclose(float(tree_norm(ta)) ** 2, float(jax_tree_dot(a, a)), rtol=1e-5)
