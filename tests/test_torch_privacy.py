"""The port's privacy-hardened exchange against the JAX package's.

* DP compression: the port's plain ``compress_rows_ref`` with the DP stage
  against ``fused_compress_pallas(..., interpret=True)`` and the jitted JAX
  oracle, on the same noise rows. Survivor masks are equal; values agree
  within 4·2⁻²³·max|y| of their row, y the clipped and noised row: the
  reference sums ‖x‖² in XLA's order and may contract the noise add into a
  fused multiply-add, the port sums in the CUDA kernel's fixed order and
  rounds every product and sum.
* Secure aggregation: masks, masked uplinks and the ring aggregate are
  integers (or exact decodes of them) and must be equal to the bit.
* ``run_private``: the reference's draws are replayed and injected — per
  exchange ``k, ks, kdp = split(k, 3)``, participants from ``ks`` and the
  noise as ``jax.random.normal(kdp, mat.shape)``. Losses within rtol 1e-4
  (the fp32 model math of ``test_torch_hsgd``, through compression).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JaxTrain
from repro.core import federation as JF
from repro.core import hsgd as JH
from repro.core.compression import compress_rows_ref as jax_compress_rows_ref
from repro.kernels.compress import compress_pytree as jax_compress_pytree
from repro.kernels.compress import fused_compress_pallas
from repro_torch.common.config import TrainConfig
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core import federation as F
from repro_torch.core import hsgd as H
from repro_torch.core.compression import compress_rows_ref, warp_order_sqnorm
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.compress import compress_pytree, fused_compress, stack_rows
from repro_torch.kernels.compress_cases import EDGE_WIDTHS, edge_case_rows, same_values
from test_torch_hsgd import SEED, _initial_params, _jax_state, _setup

_oracle = jax.jit(jax_compress_rows_ref, static_argnames=("levels",))
ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and keeps parallel test
    workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ragged(seed, widths=(64, 300, 129), rows=5, scale=1.0):
    """Rows of several widths padded to the widest, per-row k and length."""
    n_max = max(widths)
    x = np.concatenate([np.pad(scale * _normal(seed + i, (rows, w)), ((0, 0), (0, n_max - w)))
                        for i, w in enumerate(widths)])
    k = np.repeat([max(1, w // 4) for w in widths], rows).astype(np.int32)
    row_len = np.repeat(widths, rows).astype(np.int32)
    return x, k, row_len


def _dp_rows_f64(x, row_len, clip, sigma, noise):
    """The clipped and noised rows in float64 (the tolerance's scale)."""
    valid = np.arange(x.shape[1]) < row_len[:, None]
    xd = np.where(valid, x.astype(np.float64), 0.0)
    nrm = np.sqrt((xd * xd).sum(axis=1, keepdims=True))
    coef = np.minimum(1.0, clip / np.maximum(nrm, 1e-12))
    return np.where(valid, xd * coef + sigma * clip * noise, 0.0)


def _port_dp(x, k, levels, row_len, clip, sigma, noise):
    return compress_rows_ref(torch.from_numpy(x), torch.from_numpy(k), levels,
                             torch.from_numpy(row_len), clip, sigma,
                             torch.from_numpy(noise)).numpy()


@pytest.mark.parametrize("levels", [0, 128])
@pytest.mark.parametrize("clip,sigma", [(1.0, 1.0), (4.0, 0.3), (0.5, 0.0)])
def test_dp_compress_rows_match_jax(levels, clip, sigma):
    """Ragged rows, every row clipped (norms ≫ C for the small clips), the
    noise added: the port against the Pallas kernel and the jitted oracle."""
    x, k, row_len = _ragged(31, scale=2.0)
    noise = _normal(77, x.shape)
    port = _port_dp(x, k, levels, row_len, clip, sigma, noise)
    y = _dp_rows_f64(x, row_len, clip, sigma, noise)
    tol = 4 * ULP * np.abs(y).max(axis=-1, keepdims=True)
    args = (jnp.asarray(x), jnp.asarray(k))
    dp = dict(dp_clip=jnp.float32(clip), dp_sigma=jnp.float32(sigma), dp_noise=jnp.asarray(noise))
    for want in (fused_compress_pallas(*args, levels=levels, row_len=jnp.asarray(row_len),
                                       interpret=True, **dp),
                 _oracle(*args, levels=levels, row_len=jnp.asarray(row_len), **dp)):
        want = np.asarray(want)
        np.testing.assert_array_equal(port != 0, want != 0, err_msg="survivor pattern differs")
        assert (np.abs(port - want) <= tol).all(), np.abs(port - want).max()
    for i, w in enumerate((64, 300, 129)):
        assert not port[i * 5:(i + 1) * 5, w:].any()


@pytest.mark.parametrize("levels", [0, 16, 128])
def test_sigma_zero_large_clip_is_the_plain_pass(levels):
    """σ = 0 with a large finite clip multiplies by exactly 1 and adds 0:
    the DP output equals the non-DP output bit for bit."""
    x, k, row_len = _ragged(5)
    noise = _normal(6, x.shape)
    port = _port_dp(x, k, levels, row_len, 1e30, 0.0, noise)
    plain = compress_rows_ref(torch.from_numpy(x), torch.from_numpy(k), levels,
                              torch.from_numpy(row_len)).numpy()
    np.testing.assert_array_equal(port, plain)


def test_clip_only_rows_are_bounded():
    """σ = 0, k = n, no quantization: the output is the clipped row, whose
    L2 norm is at most C (to fp32 roundoff); short rows pass unchanged."""
    clip = 1.0
    x = _normal(8, (12, 200))
    x[:4] *= 1e-3  # norms below the clip
    out = compress_rows_ref(torch.from_numpy(x), 200, 0, None, clip, 0.0,
                            torch.from_numpy(_normal(9, x.shape))).numpy()
    norms = np.sqrt((out.astype(np.float64) ** 2).sum(axis=1))
    assert (norms <= clip * (1 + 1e-6)).all(), norms.max()
    np.testing.assert_allclose(norms[4:], clip, rtol=1e-6)
    np.testing.assert_array_equal(out[:4], x[:4])


@pytest.mark.parametrize("n", [1, 31, 32, 100, 1000])
def test_fixed_order_sqnorm_matches_float64(n):
    x = _normal(n, (7, n)) * np.float32(3.0)
    got = warp_order_sqnorm(torch.from_numpy(x * x))[:, 0].numpy()
    want = (x.astype(np.float64) ** 2).sum(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_compress_pytree_dp_matches_jax():
    """A message tree through the DP stage: the same noise rows (the JAX
    function's own draw from its key) give the JAX result within tolerance."""
    tree = {"w": 3 * _normal(5, (3, 4, 96)), "b": _normal(6, (3, 17)),
            "c": _normal(7, (2, 5, 8, 130))}
    key = jax.random.PRNGKey(4)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    want = jax.jit(lambda t, c, s: jax_compress_pytree(t, 0.25, 128, dp_clip=c, dp_sigma=s,
                                                       dp_key=key))(
        jtree, jnp.float32(1.0), jnp.float32(0.5))
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    mat, _, len_rows, _ = stack_rows(tree_leaves(ttree), 0.25)
    noise = np.array(jax.random.normal(key, tuple(mat.shape), jnp.float32))
    out = compress_pytree(ttree, 0.25, 128, dp_clip=1.0, dp_sigma=0.5,
                          dp_noise=torch.from_numpy(noise))
    y = _dp_rows_f64(mat.numpy(), len_rows.numpy(), 1.0, 0.5, noise)
    off = 0
    for name in sorted(tree):
        n = tree[name].shape[-1]
        got = out[name].reshape(-1, n).numpy()
        w = np.asarray(want[name]).reshape(-1, n)
        tol = 4 * ULP * np.abs(y[off:off + len(got)]).max(axis=-1, keepdims=True)
        np.testing.assert_array_equal(got != 0, w != 0, err_msg=name)
        assert (np.abs(got - w) <= tol).all(), name
        off += len(got)
    # only DP on: the stage still runs (no early return), keeping every entry
    dp_only = compress_pytree(ttree, 1.0, 0, dp_clip=1e30, dp_sigma=0.0,
                              dp_noise=torch.from_numpy(noise))
    for name in tree:
        assert torch.equal(dp_only[name], ttree[name])
    gen = torch.Generator().manual_seed(0)
    drawn = compress_pytree(ttree, 1.0, 0, dp_clip=1.0, dp_sigma=1.0, dp_generator=gen)
    assert not torch.equal(drawn["w"], ttree["w"])


def _theta2(seed, M=3, A=6):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(M, A, 5).astype(np.float32),
            "b": rng.randn(M, A).astype(np.float32),
            "c": {"k": rng.randn(M, A, 2, 3).astype(np.float32)}}


def _alive(M=3, A=6):
    alive = np.ones((M, A), bool)
    alive[0, 1] = alive[0, 4] = alive[2, 0] = False
    return alive


def _assert_tree_equal(port, ref):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r)
        assert p.dtype == {np.dtype("int32"): torch.int32,
                           np.dtype("float32"): torch.float32}[r.dtype]
        np.testing.assert_array_equal(p.numpy(), r)


@pytest.mark.parametrize("seed,round_idx,alive", [(0, 0, False), (7, 2, False),
                                                  (123, 5, True), (9, 0, True)])
def test_secure_agg_masks_match_jax(seed, round_idx, alive):
    tree = _theta2(seed)
    al = _alive() if alive else None
    port = F.secure_agg_masks(tree_map(torch.from_numpy, tree), seed, round_idx, alive=al)
    ref = JF.secure_agg_masks(jax.tree.map(jnp.asarray, tree), seed, round_idx, alive=al)
    _assert_tree_equal(port, ref)


@pytest.mark.parametrize("masked", [True, False])
def test_secure_uplink_and_aggregate_match_jax(masked):
    tree = _theta2(3)
    pmask = _alive().astype(np.float32)
    ttree, jtree = tree_map(torch.from_numpy, tree), jax.tree.map(jnp.asarray, tree)
    tm = F.secure_agg_masks(ttree, 11, 1, alive=_alive())
    jm = JF.secure_agg_masks(jtree, 11, 1, alive=_alive())
    if not masked:
        tm, jm = tree_map(torch.zeros_like, tm), jax.tree.map(jnp.zeros_like, jm)
    t_up, j_up = F.secure_mask_uplink(ttree, tm), JF.secure_mask_uplink(jtree, jm)
    _assert_tree_equal(t_up, j_up)
    for mask in (None, pmask):
        port = F.secure_local_aggregate(t_up, ttree, None if mask is None else torch.from_numpy(mask))
        ref = JF.secure_local_aggregate(j_up, jtree, None if mask is None else jnp.asarray(mask))
        _assert_tree_equal(port, ref)


def test_ring_encode_rounds_half_to_even_as_jax():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.49999, 1e-5], np.float32) / 2 ** 16
    np.testing.assert_array_equal(F._ring_encode(torch.from_numpy(x), 16).numpy(),
                                  np.asarray(JF._ring_encode(jnp.asarray(x), 16)))


@pytest.mark.parametrize("alive", [False, True])
def test_masks_cancel_in_the_torch_ring(alive):
    """The masked aggregate equals the zero-masked one to the bit (int32 ring
    sums in torch), and the float eq. (1) mean to 2^-15."""
    tree = tree_map(torch.from_numpy, _theta2(21))
    al = _alive() if alive else None
    pmask = None if al is None else torch.from_numpy(al.astype(np.float32))
    masks = F.secure_agg_masks(tree, 4, 3, alive=al)
    got = F.secure_local_aggregate(F.secure_mask_uplink(tree, masks), tree, pmask)
    want = F.secure_local_aggregate(
        F.secure_mask_uplink(tree, tree_map(torch.zeros_like, masks)), tree, pmask)
    for g, w, p in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(F.local_aggregate(tree, pmask))):
        assert torch.equal(g, w)
        assert (g - p).abs().max() <= 2.0 ** -15
    # every slot's payload is hidden: the masked uplink differs from the bare one
    bare = F.secure_mask_uplink(tree, tree_map(torch.zeros_like, masks))
    up = F.secure_mask_uplink(tree, masks)
    live = torch.ones(3, 6, dtype=torch.bool) if al is None else torch.from_numpy(al)
    assert ((up["w"] != bare["w"]).any(dim=-1) == live).all()


# ---------------------------------------------------------------------------
# run_private against the reference
# ---------------------------------------------------------------------------


def _states(jfed, tfed, raw, tmodel):
    jdata = {k: jnp.asarray(v) for k, v in raw.items()}
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    jstate = _jax_state(jfed, jdata)
    params = tmodel.params_from_numpy(_initial_params(jstate), "cpu")
    return jdata, tdata, jstate, H.init_state(torch.Generator(), tmodel, tfed, tdata, params=params)


def message_shape(tstate):
    leaves = tree_leaves({"theta0": tstate.stale["theta0"], "z1": tstate.stale["z1"],
                          "z2": tstate.stale["z2"]})
    return tuple(stack_rows(leaves, 0.25)[0].shape)


def jax_private_draws(jfed, n, mat_shape):
    """The participants and noise the reference draws at its first ``n``
    exchanges on the DP trace."""
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    parts, noise = [], []
    for _ in range(n):
        k, ks, kdp = jax.random.split(k, 3)
        parts.append(np.asarray(JF.sample_participants(ks, jfed)))
        noise.append(torch.from_numpy(np.array(jax.random.normal(kdp, mat_shape, jnp.float32))))
    return torch.from_numpy(np.stack(parts)), noise


def test_run_private_without_legs_is_run():
    _, tfed, raw, _, tmodel = _setup()
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    train = TrainConfig(learning_rate=0.05, compression_k=0.25, quantization_bits=128)
    w = H.make_group_weights(tdata)
    init = lambda: H.init_state(torch.Generator().manual_seed(3), tmodel, tfed, tdata)
    sa, la = H.HSGDRunner(tmodel, tfed, train).run(init(), tdata, w, 2)
    sb, lb = H.HSGDRunner(tmodel, tfed, train).run_private(init(), tdata, w, 2)
    assert torch.equal(la, lb)
    for a, b in zip(tree_leaves(sa.theta0), tree_leaves(sb.theta0)):
        assert torch.equal(a, b)


def test_run_private_dp_secure_agg_matches_jax():
    """c-hsgd with DP (C=1, σ=1) and secure aggregation, 2 rounds, from the
    reference's initial model and on its draws, at the CLI's η = 0.01. Two
    rounds only: the noised θ0 snapshot drives the devices' θ2 up by orders
    of magnitude a round in both packages (~1e3 after round 1, ~1e9 after
    round 2), so later aggregations leave the ring's ±2^15 range."""
    jfed, tfed, raw, jmodel, tmodel = _setup()
    jdata, tdata, jstate, tstate = _states(jfed, tfed, raw, tmodel)
    kw = dict(learning_rate=0.01, compression_k=0.25, quantization_bits=128)
    rounds = 2
    parts, noise = jax_private_draws(jfed, rounds * jfed.lam, message_shape(tstate))
    jrunner = JH.HSGDRunner(jmodel, jfed, JaxTrain(**kw))
    _, jl = jrunner.run_private(jstate, jdata, JH.make_group_weights(jdata), rounds, seed=SEED,
                                dp_clip=1.0, dp_sigma=1.0, secure_agg=True)
    trunner = H.HSGDRunner(tmodel, tfed, TrainConfig(**kw))
    reset_launch_counts()
    _, tl = trunner.run_private(tstate, tdata, H.make_group_weights(tdata), rounds,
                                seed=SEED, dp_clip=1.0, dp_sigma=1.0, secure_agg=True,
                                participants=parts, dp_noise=noise)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    assert len(trunner._round_cache) == 1
    assert not launch_counts  # CPU tensors take the plain version


def test_run_private_draws_its_own_noise():
    _, tfed, raw, _, tmodel = _setup()
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    w = H.make_group_weights(tdata)
    runner = H.HSGDRunner(tmodel, tfed, TrainConfig(learning_rate=0.05))
    init = lambda: H.init_state(torch.Generator().manual_seed(3), tmodel, tfed, tdata)
    _, plain = runner.run_private(init(), tdata, w, 1)
    _, a = runner.run_private(init(), tdata, w, 1, seed=1, dp_clip=1.0, dp_sigma=1.0)
    _, b = runner.run_private(init(), tdata, w, 1, seed=1, dp_clip=1.0, dp_sigma=1.0)
    assert torch.isfinite(a).all() and torch.equal(a, b)  # seeded
    assert not torch.equal(a, plain)  # the noise reaches the trajectory
    assert len(runner._round_cache) == 2  # plain and dp buckets


def test_run_private_sigma_requires_clip():
    _, tfed, raw, _, tmodel = _setup()
    tdata = {k: torch.as_tensor(v) for k, v in raw.items()}
    state = H.init_state(torch.Generator().manual_seed(0), tmodel, tfed, tdata)
    with pytest.raises(ValueError, match="dp_clip"):
        H.HSGDRunner(tmodel, tfed, TrainConfig()).run_private(
            state, tdata, H.make_group_weights(tdata), 1, dp_sigma=1.0)


def test_dp_noise_generator_is_apart_from_the_sampling_stream():
    a = torch.randn(8, generator=H.dp_noise_generator(0, "cpu"))
    b = torch.randn(8, generator=H.dp_noise_generator(0, "cpu"))
    c = torch.randn(8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dp_kernel_refuses_cpu_tensors():
    x = torch.from_numpy(_normal(1, (4, 32)))
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fused_compress(x, 4, 0, None, 1.0, 1.0, x)
    assert not launch_counts


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [0, 128])
def test_dp_kernel_matches_plain(levels):
    """The DP kernel against the plain version on the card: bit-identical,
    ragged rows, NaN rows and the edge-case matrix included, and the σ = 0
    pass equal to the non-DP kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x, k, row_len = (torch.from_numpy(a).to(dev) for a in _ragged(3, rows=300))
    noise = torch.from_numpy(_normal(4, tuple(x.shape))).to(dev)
    reset_launch_counts()
    for clip, sigma in ((1.0, 1.0), (0.5, 0.25)):
        c, s = torch.tensor(clip, device=dev), torch.tensor(sigma, device=dev)
        bad = x.clone()
        bad[::37, 3] = float("nan")
        for inp in (x, bad):
            got = fused_compress(inp, k, levels, row_len, c, s, noise)
            want = compress_rows_ref(inp, k, levels, row_len, c, s, noise)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    assert torch.equal(fused_compress(x, k, levels, row_len, 1e30, 0.0, noise),
                       fused_compress(x, k, levels, row_len))
    assert launch_counts["fused_compress_dp"] == 5
    c, s = torch.tensor(1.0, device=dev), torch.tensor(0.5, device=dev)
    for n in EDGE_WIDTHS:  # every register bucket, the group body and the wide body
        xe, ke, le = (t.to(dev) for t in edge_case_rows(n))
        ne = torch.from_numpy(_normal(n, tuple(xe.shape))).to(dev)
        got = fused_compress(xe, ke, levels, le, c, s, ne)
        want = compress_rows_ref(xe, ke, levels, le, c, s, ne)
        torch.cuda.synchronize()
        assert same_values(got, want), n
