"""The port's legacy sort path against the JAX package's.

The pre-fusion compression path (``topk_sparsify_sort``: ``torch.topk`` on
|x|, keep ``>=`` the k-th magnitude; ``compress_message_sort``: that, then
a separate ``quantize``), the leaf-wise ``exchange(fused=False)`` and
``HSGDRunner(fused_compression=False)``: the baseline the fused compress
kernel is measured against. On the same numpy inputs the survivor mask
equals the reference's exactly and the values agree within 4·2⁻²³ of
their row's largest |x|. The runner tests are the twins of the
reference's ``test_hsgd.py::test_legacy_sort_path_still_converges`` and
``test_privacy.py::test_exchange_legacy_sort_path_rejects_dp``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import compression as TC
from repro_torch.core.controller import AdaptiveHSGDRunner
from repro_torch.core.hsgd import HSGDRunner, exchange, init_state, make_group_weights
from repro_torch.data.partition import hybrid_partition
from repro_torch.data.synthetic import ORGANAMNIST, make_dataset
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.split_model import cnn_hybrid

ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mini(M=2, K=8, A_frac=0.5, q=2, p=4):
    """The reference tests' ``_mini``: paper-cnn over OrganAMNIST."""
    fed = FederationConfig(num_groups=M, devices_per_group=K, alpha=A_frac,
                           local_interval=q, global_interval=p)
    X, y = make_dataset(ORGANAMNIST, M * K, seed=0)
    data = {k: torch.as_tensor(v)
            for k, v in hybrid_partition(ORGANAMNIST, X, y, fed, seed=0).stacked().items()}
    return cnn_hybrid(h_rows=11), fed, data


def _rows(seed, shape, ties=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if ties:  # whole runs of equal magnitudes at and around the threshold
        x[..., ::3] = np.sign(x[..., ::3]) * 0.5
    return x


SHAPES = [((6, 128), False), ((3, 5, 300), False), ((4, 64), True), ((2, 7), False)]


@pytest.mark.parametrize("k_frac", [0.25, 0.1, 1.0])
@pytest.mark.parametrize("shape,ties", SHAPES)
def test_topk_sparsify_sort_matches_jax(shape, ties, k_frac):
    x = _rows(len(shape) * 7 + shape[-1], shape, ties)
    got = TC.topk_sparsify_sort(torch.from_numpy(x), k_frac).numpy()
    want = np.asarray(JC.topk_sparsify_sort(jnp.asarray(x), k_frac))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got, want)  # survivors keep their values


@pytest.mark.parametrize("k_frac,levels", [(0.25, 128), (0.1, 16), (1.0, 128), (0.25, 0)])
@pytest.mark.parametrize("shape,ties", SHAPES)
def test_compress_message_sort_matches_jax(shape, ties, k_frac, levels):
    x = _rows(shape[-1] + levels, shape, ties)
    got = TC.compress_message_sort(torch.from_numpy(x), k_frac, levels).numpy()
    want = np.asarray(JC.compress_message_sort(jnp.asarray(x), k_frac, levels))
    np.testing.assert_array_equal(got != 0, want != 0)
    scale = np.abs(x).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 4 * ULP * scale).all()


def test_sort_path_keeps_the_exact_support():
    """k survivors a row without ties; with ties every entry at the k-th
    magnitude survives; the fused path keeps a superset of the support."""
    x = torch.from_numpy(_rows(3, (8, 200)))
    k = int(round(0.25 * 200))
    kept = TC.topk_sparsify_sort(x, 0.25) != 0
    assert (kept.sum(-1) == k).all()
    assert (kept <= (TC.topk_sparsify(x, 0.25) != 0)).all()
    t = torch.from_numpy(_rows(4, (4, 64), ties=True))
    kt = TC.topk_sparsify_sort(t, 0.25) != 0
    assert (kt.sum(-1) >= 16).all()


def test_legacy_sort_path_still_converges():
    """The pre-fusion sort-based compression path (the baseline) trains: the
    twin of the reference's test, on the CPU's plain path (no kernel)."""
    model, fed, data = _mini(M=2, K=16, q=1, p=2)
    train_c = TrainConfig(learning_rate=0.05, compression_k=0.25, quantization_bits=128)
    runner = HSGDRunner(model, fed, train_c, fused_compression=False)
    state = init_state(torch.Generator().manual_seed(0), model, fed, data)
    w = make_group_weights(data)
    reset_launch_counts()
    state, losses = runner.run(state, data, w, rounds=10)
    assert torch.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert not launch_counts


def test_exchange_legacy_sort_path_rejects_dp():
    """DP is fused into the batched kernel; the pre-fusion leaf-wise path
    refuses rather than silently skip the clip + noise stage."""
    model, fed, data = _mini()
    state = init_state(torch.Generator().manual_seed(0), model, fed, data)
    with pytest.raises(ValueError, match="fused"):
        exchange(model, state, data, fed, compression_k=0.25, quant_levels=128, fused=False,
                 dp_clip=torch.tensor(1.0), dp_sigma=torch.tensor(1.0))


def test_exchange_sort_path_compresses_leaf_by_leaf():
    """``exchange(fused=False)`` sends every message leaf through
    ``compress_message_sort``: the same A_m, ζ and θ0 snapshot as the fused
    exchange before compression, each leaf the sort path's output."""
    model, fed, data = _mini()
    state = init_state(torch.Generator().manual_seed(0), model, fed, data)
    idx = torch.stack([torch.randperm(fed.devices_per_group, generator=torch.Generator()
                                      .manual_seed(m))[:fed.sampled_devices]
                       for m in range(fed.num_groups)])
    plain = exchange(model, state, data, fed, idx=idx)
    sort = exchange(model, state, data, fed, 0.25, 128, fused=False, idx=idx)
    for name in ("z1", "z2"):
        want = TC.compress_message_sort(plain.stale[name], 0.25, 128)
        assert torch.equal(sort.stale[name], want)
    for a, b in zip(tree_leaves(sort.stale["theta0"]), tree_leaves(plain.stale["theta0"])):
        assert torch.equal(a, TC.compress_message_sort(b, 0.25, 128))


def test_sort_and_fused_paths_never_share_an_executor():
    """A runner's bucket key carries the path, so a runner copied with the
    other path (``dataclasses.replace`` shares the cache) builds its own."""
    model, fed, _ = _mini()
    train = TrainConfig(learning_rate=0.05, compression_k=0.25, quantization_bits=128)
    fused = HSGDRunner(model, fed, train)
    sort = dataclasses.replace(fused, fused_compression=False)
    assert sort._round_cache is fused._round_cache
    f, s = fused.round_fn(4, 2), sort.round_fn(4, 2)
    assert f is not s and sort.round_fn(4, 2) is s
    assert sorted(map(len, fused._round_cache)) == [5, 6]
    assert AdaptiveHSGDRunner(model, fed, train, fused_compression=False).runner.fused_compression \
        is False
