"""The port's MoE family (the router, capacity dispatch and experts; MLA, the
DeepSeek latent attention) against the JAX package's.

Configs: grok-1-314b and deepseek-v3-671b at their smoke widths, and the
reference model tests' ``moe`` (a shared expert, one dense layer first)
and ``mla`` configs (``tests/test_models.py``). Both packages get the same
parameters (the reference's jitted ``init_params``, ``HybridModel.init``
or ``init_llm_params`` output, carried over by ``params_from_numpy``) and
the same numpy inputs. Tolerances:

* ``moe_forward``, ``mla_forward``, ``backbone_forward``, ``lm_loss`` and
  their gradients, cache values: rtol = atol = 1e-5 (fp32 sums taken in
  another order by XLA and by PyTorch);
* router expert ids and capacity ``keep`` masks: exact, except where the
  probabilities at the first rank that differs and the next lie within
  1e-6 (a near-tie an ulp of the logits can flip);
* ``decode_step`` and ``draft_decode_step``: logits within 1e-4 of the
  largest |logit|, position tracks exact; int8 codes equal except one-step
  flips whose unrounded code lies within 1e-3 of a rounding boundary;
* round losses: rtol 1e-4; the CLI's losses equal the port's round
  runner's bit for bit.

The reference cannot run MLA over bf16 caches on the CPU (XLA's CPU dot
takes no bf16 x bf16 = f32), so the caches here are fp32 and int8.
Greedy tokens of the port's engine equal the reference engine's and the
port's ``sequential_generate``; MLA's batched prefill is not bit-identical
to the sequential one in either package, so only tokens are held there.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JaxModelConfig
from repro.common.config import get_config as jax_get_config
from repro.data import synthetic as JSY
from repro.launch import engine as JE
from repro.launch import steps as JST
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.split_model import llm_hybrid as jax_llm_hybrid
from repro_torch.common.config import ModelConfig, get_config, list_configs
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.data import synthetic as SY
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import engine as E
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.split_model import llm_hybrid

TOL = 1e-5
RUN_RTOL = 1e-4
TIE = 1e-6
ARCHS = ["grok-1-314b", "deepseek-v3-671b"]
# the reference model tests' configs (tests/test_models.py)
BASE = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97)
TEST_CONFIGS = {
    "moe": dict(name="moe", family="moe", num_experts=4, experts_per_token=2,
                num_shared_experts=1, moe_d_ff=32, first_dense_layers=1, **BASE),
    "mla": dict(name="mla", family="moe", attention="mla", q_lora_rank=16, kv_lora_rank=16,
                qk_rope_head_dim=8, v_head_dim=8, head_dim=8, num_experts=4,
                experts_per_token=2, moe_d_ff=32, **BASE),
}
NAMES = ARCHS + list(TEST_CONFIGS)
DTYPES = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name):
    if name in TEST_CONFIGS:
        return JaxModelConfig(**TEST_CONFIGS[name]), ModelConfig(**TEST_CONFIGS[name])
    return jax_get_config(name, smoke=True), get_config(name, smoke=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_PARAMS = {}


def _params(name):
    """(reference params, port params) from one reference draw."""
    if name not in _PARAMS:
        jcfg, cfg = _configs(name)
        jp = jax.jit(lambda k: JL.init_params(JT.model_specs(jcfg), k, jnp.float32))(
            jax.random.PRNGKey(0))
        _PARAMS[name] = (jp, T.params_from_numpy(cfg, _np(jp)))
    return _PARAMS[name]


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=msg)


def _close_trees(got, want, rtol=TOL, atol=TOL):
    got_leaves, want_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        np.testing.assert_allclose(g.detach().numpy().astype(np.float64),
                                   np.asarray(w, np.float64), rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


def _logits_close(got, want):
    """Logits within 1e-4 of the largest |logit|."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


def _layer(tree, i=0):
    return tree_map(lambda a: a[i], tree)


def _reference_routing(jp, flat, jcfg, C):
    """The reference ``moe_forward``'s routing lines: (probs, expert ids
    [T, k], keep [T * k])."""
    E, k = jcfg.num_experts, jcfg.experts_per_token
    logits = jnp.einsum("td,de->te", flat, jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray(probs), np.asarray(idx), np.asarray(pos < C)


def _check_ids(got, want, probs):
    """Expert ids equal, except rows whose first differing rank and the
    next hold probabilities within TIE of each other."""
    got, want = np.asarray(got), np.asarray(want)
    for row in np.flatnonzero((got != want).any(axis=-1)):
        rank = int(np.flatnonzero(got[row] != want[row])[0])
        srt = np.sort(np.asarray(probs)[row])[::-1]
        assert srt[rank] - srt[rank + 1] <= TIE, (row, got[row], want[row])


def _capture(log):
    """``quantize_rows`` that logs the unrounded codes before quantizing."""

    def q(x):
        xf = x.float()
        amax = torch.amax(torch.abs(xf), dim=-1)
        scale = amax / torch.full_like(amax, Q.QMAX)
        log.append(xf / torch.clamp_min(scale, Q.SCALE_EPS)[..., None])
        return Q.quantize_rows(x)

    return q


def _check_codes(got, want, unrounded):
    """int8 codes equal except one-step flips whose unrounded code lies
    within 1e-3 of a rounding boundary."""
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    u = np.abs(unrounded.numpy().astype(np.float64))
    gap = np.abs(u - np.floor(u) - 0.5)
    assert (gap[diff > 0] < 1e-3).all()


# ---------------------------------------------------------------------------
# Configs, specs and caches
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    assert set(ARCHS) <= set(list_configs())
    for name in ARCHS:
        for smoke in (False, True):
            got, want = get_config(name, smoke), jax_get_config(name, smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
            assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("name", NAMES)
def test_specs_and_cache_specs_match_reference(name):
    """``model_specs`` (shapes, axes, inits; the dense layers under
    ``dense_layers``) and the stacked f32 and int8 cache specs with their
    logical axes, which the engine reads (``_cache_axis``)."""
    jcfg, cfg = _configs(name)
    got, want = tree_leaves(T.model_specs(cfg)), jax.tree_util.tree_leaves(
        JT.model_specs(jcfg), is_leaf=JL.is_spec)
    assert [(s.shape, s.axes, s.init, s.scale) for s in got] == \
        [(s.shape, s.axes, s.init, s.scale) for s in want]
    assert ("dense_layers" in T.model_specs(cfg)) == bool(cfg.first_dense_layers)
    for dt, jdt in DTYPES.values():
        (tsh, tax), (jsh, jax_) = (T.make_decode_caches(cfg, 3, 16, dt),
                                   JT.make_decode_caches(jcfg, 3, 16, jdt))
        assert list(tsh) == list(jsh) == ["kv"]
        assert [tuple(s.shape) for s in tsh["kv"]] == [s.shape for s in jsh["kv"]]
        assert [str(s.dtype).split(".")[-1] for s in tsh["kv"]] == \
            [str(s.dtype) for s in jsh["kv"]]
        assert tax == jax_


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def _moe_case(case):
    """(reference cfg, port cfg, reference layer params, port layer params,
    x [B, S, D]) of a ``moe_forward`` case. ``drops``: T = 512, E = 4,
    k = 2 with the router biased so that every token picks experts 0 and 1
    (C = 384: 128 of each expert's 512 assignments drop)."""
    if case == "drops":
        jcfg, cfg = _configs("moe")
        jp, tp = _params("moe")
        jl = jax.tree.map(lambda a: np.array(a[0]), jp["layers"]["moe"])
        jl["router"][:] *= 0.01
        jl["router"][0] = [6.0, 5.0, 0.0, 0.0]
        x = np.random.RandomState(3).standard_normal((2, 256, cfg.d_model)).astype(np.float32)
        x[..., 0] = 1.0
        tl = tree_map(lambda a: torch.from_numpy(np.array(a)), jl)
        return jcfg, cfg, jax.tree.map(jnp.asarray, jl), tl, x
    jcfg, cfg = _configs(case)
    jp, tp = _params(case)
    x = np.random.RandomState(4).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            _layer(tp["layers"]["moe"]), x)


@pytest.mark.parametrize("case", NAMES + ["drops"])
def test_moe_forward_matches_reference(case):
    """Output and aux loss within 1e-5; router ids and keep masks equal
    (near-ties aside); the ``drops`` case drops exactly 256 assignments
    (the reference's own capacity) and no kernel launches."""
    jcfg, cfg, jl, tl, x = _moe_case(case)
    B, S, D = x.shape
    T_ = B * S
    C = M._capacity(T_, cfg.num_experts, cfg.experts_per_token)
    assert C == JM._capacity(T_, jcfg.num_experts, jcfg.experts_per_token)
    want, want_aux = jax.jit(lambda p, h: JM.moe_forward(p, h, jcfg))(jl, jnp.asarray(x))
    reset_launch_counts()
    got, got_aux = M.moe_forward(tl, torch.from_numpy(x), cfg)
    assert not launch_counts
    _close(got.numpy(), want)
    _close(float(got_aux), float(want_aux))
    probs, ids, keep = _reference_routing(jl, jnp.asarray(x.reshape(T_, D)), jcfg, C)
    tprobs, _, tids = M.route(tl, torch.from_numpy(x.reshape(T_, D)), cfg)
    _close(tprobs.numpy(), probs)
    _check_ids(tids.numpy(), ids, probs)
    _, tkeep = M.dispatch_positions(tids, cfg.num_experts, C)
    if (tids.numpy() == ids).all():
        np.testing.assert_array_equal(tkeep.numpy(), keep)
    if case == "drops":
        assert C == 384 and (ids == [0, 1]).all()
        assert int((~keep).sum()) == int((~tkeep).sum().item()) == 256


def test_router_top_k_breaks_ties_toward_the_lower_expert():
    """Equal probabilities: the lower expert id first, as jax.lax.top_k."""
    cfg = ModelConfig(**TEST_CONFIGS["moe"])
    params = {"router": torch.zeros((cfg.d_model, cfg.num_experts))}
    params["router"][0] = torch.tensor([1.0, 2.0, 2.0, 2.0])
    flat = torch.ones((3, cfg.d_model))
    _, gate, idx = M.route(params, flat, cfg)
    assert idx.tolist() == [[1, 2]] * 3
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(flat.numpy() @ params["router"].numpy())),
                            2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    torch.testing.assert_close(gate, torch.full((3, 2), 0.5))


def test_moe_gradients_match_reference():
    """``jax.grad`` of a scalar of ``moe_forward`` (output and aux) in the
    dropping case: the parameters' and the input's gradients within 1e-5."""
    jcfg, cfg, jl, tl, x = _moe_case("drops")
    w = np.random.RandomState(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, h):
        out, aux = JM.moe_forward(p, h, jcfg)
        return jnp.sum(out * w) + aux

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jl, jnp.asarray(x))
    tl = tree_map(lambda a: a.clone().requires_grad_(True), tl)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_forward(tl, tx, cfg)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)) + aux,
                              tree_leaves(tl) + [tx])
    for g, v in zip(got, jax.tree_util.tree_leaves(want[0]) + [want[1]]):
        _close(g.numpy(), v, tol=1e-4 * max(1.0, float(np.abs(np.asarray(v)).max())))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["none", "f32", "int8"])
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "mla"])
def test_mla_forward_matches_reference(name, cache):
    """The expanded arm (no cache) on a 20-token block; with a cache the
    absorbed arm: a 12-token block at 0, then a [B] vector step with slot 1
    parked at cache_len (its write dropped). Outputs within 1e-5, caches
    within 1e-5 (int8: codes equal but at rounding boundaries), position
    tracks exact."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = _layer(tp["layers"]["attn"])
    rng = np.random.RandomState(6)
    B, CL = 2, 16
    x = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    if cache == "none":
        pos = np.broadcast_to(np.arange(20, dtype=np.int32), (B, 20))
        want, _ = JA.mla_forward(jattn, jnp.asarray(x), jnp.asarray(pos), jcfg)
        got, new = A.mla_forward(tattn, torch.from_numpy(x), torch.from_numpy(pos.copy()), cfg)
        assert new is None
        _close(got.numpy(), want)
        return
    dt, jdt = DTYPES[cache]
    tshapes, _ = A.make_kv_cache_specs(cfg, B, CL, dt)
    jshapes, _ = JA.make_kv_cache_specs(jcfg, B, CL, jdt)
    tc = tuple(torch.full(s.shape, A.INT32_MAX, dtype=s.dtype) if s.dtype == torch.int32
               else torch.zeros(s.shape, dtype=s.dtype) for s in tshapes)
    jc = tuple(jnp.full(s.shape, np.iinfo(np.int32).max, s.dtype) if s.dtype == jnp.int32
               else jnp.zeros(s.shape, s.dtype) for s in jshapes)
    steps = [(x[:, :12], np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12)), 0),
             (x[:, 12:13], np.array([[12], [CL]], np.int32), np.array([12, CL], np.int32))]
    for xs, pos, idx in steps:
        tidx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(A, "quantize_rows", _capture(log))
            got, tc = A.mla_forward(tattn, torch.from_numpy(xs), torch.from_numpy(pos.copy()), cfg,
                                    kv_cache=tc, cache_index=tidx)
        want, jc = JA.mla_forward(jattn, jnp.asarray(xs), jnp.asarray(pos), jcfg, kv_cache=jc,
                                  cache_index=jnp.asarray(idx))
        _close(got.numpy(), want)
        np.testing.assert_array_equal(tc[-1].numpy(), np.asarray(jc[-1]))
        if cache == "int8":
            n = xs.shape[1]
            cols = slice(0, n) if isinstance(idx, int) else slice(12, 13)
            rows = slice(None) if isinstance(idx, int) else slice(0, 1)
            for leaf, u in ((0, log[0]), (1, log[1])):
                _check_codes(tc[leaf][rows, cols], np.asarray(jc[leaf])[rows, cols], u[rows])
            for g, w in zip(tc[2:4], jc[2:4]):
                _close(g.numpy(), w)
            tc = tuple(torch.from_numpy(np.array(a)) for a in jc)  # restart from the reference's
        else:
            for g, w in zip(tc, jc):
                _close(g.numpy(), w)
    assert (tc[-1][1, 12:] == A.INT32_MAX).all()  # parked slot 1's write was dropped


# ---------------------------------------------------------------------------
# The train path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_backbone_and_lm_loss_match_reference(name):
    """``backbone_forward`` (hidden and aux) on embedded inputs, ``lm_loss``
    and its gradients against ``jax.value_and_grad`` (the port with remat
    on, the reference without: the same arithmetic)."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want_x, want_aux = jax.jit(lambda p, h: JT.backbone_forward(jcfg, p, h, remat=False))(
        jp, jnp.asarray(x))
    got_x, got_aux = T.backbone_forward(cfg, tp, torch.from_numpy(x), remat=True)
    _close(got_x.numpy(), want_x)
    _close(float(got_aux), float(want_aux))
    assert float(got_aux) > 0
    tokens = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(jcfg, p, jb, False)))(jp)
    got_l, got_g = ST._grads(lambda p: T.lm_loss(cfg, p, tb, True), tp)
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g)


# ---------------------------------------------------------------------------
# Decode and the draft
# ---------------------------------------------------------------------------


def _caches(cfg, jcfg, B, CL, cache):
    dt, jdt = DTYPES[cache]
    return T.init_decode_caches(cfg, B, CL, dt), JT.init_decode_caches(jcfg, B, CL, jdt)


def _check_cache_steps(tc, jc, cache, log, n_layers, start, n):
    """After one step: positions exact, f32 values within 1e-5. int8: the
    written columns' codes, layer by layer (``log`` holds the unrounded
    codes of the step's two quantized leaves a layer), equal but at
    rounding boundaries up to the first layer where one flips; the layers
    after it read that code in this same step, so their codes are held
    within one step, and their scales within 1e-5 of the reference's only
    before it. Returns the number of codes that flipped."""
    np.testing.assert_array_equal(tc["kv"][-1].numpy(), np.asarray(jc["kv"][-1]))
    if cache == "f32":
        for g, w in zip(tc["kv"], jc["kv"], strict=True):
            _close(g.numpy(), w)
        return 0
    assert len(log) == 2 * n_layers
    flips = 0
    for layer in range(n_layers):
        for leaf in range(2):
            got = tc["kv"][leaf][layer][:, start:start + n]
            want = np.asarray(jc["kv"][leaf][layer])[:, start:start + n]
            if flips:
                assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1
            else:
                _check_codes(got, want, log[2 * layer + leaf])
                _close(tc["kv"][2 + leaf][layer].numpy(), jc["kv"][2 + leaf][layer])
            flips += int((got.numpy() != want).sum())
    return flips


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("name", ARCHS + ["moe"])
def test_decode_step_matches_reference(name, cache):
    """A fresh-cache prefill block, two single tokens and a [B] vector step
    with slot 1 parked at cache_len: logits within 1e-4 of the largest
    |logit|, caches as ``_check_cache_steps`` says. Under int8 each step
    starts both packages from the reference's caches; where a code of the
    step flipped at a rounding boundary, the later layers read it, and the
    logits are held within one code step's reach, 1e-3 of the largest
    |logit|, as ``tests/test_torch_serve.py`` holds nemotron-4-15b's."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    B, S_len, CL = 2, 12, 16
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, S_len)).astype(np.int32)
    tc, jc = _caches(cfg, jcfg, B, CL, cache)
    steps = ([(slice(0, 9), 0, True), (slice(9, 10), 9, False), (slice(10, 11), 10, False),
              (slice(11, 12), np.array([11, CL], np.int32), False)])
    for sl, idx, fresh in steps:
        if cache == "int8":
            tc = {"kv": tuple(torch.from_numpy(np.array(a)) for a in jc["kv"])}
        vec = isinstance(idx, np.ndarray)
        tidx, jidx = (torch.from_numpy(idx), jnp.asarray(idx)) if vec else (idx, jnp.int32(idx))
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(A, "quantize_rows", _capture(log))
            tl, tc = T.decode_step(cfg, tp, torch.from_numpy(toks[:, sl]), tc, tidx,
                                   fresh_cache=fresh)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, sl]), jc, jidx, fresh_cache=fresh)
        if vec:  # row 0 wrote column 11; parked row 1's write was dropped
            assert (tc["kv"][-1][:, 0, 11] == 11).all()
            assert (tc["kv"][-1][:, 1, 11] == A.INT32_MAX).all()
            np.testing.assert_array_equal(tc["kv"][-1].numpy(), np.asarray(jc["kv"][-1]))
            flips = 0 if cache == "f32" else int(sum(
                (tc["kv"][leaf][:, 0, 11].numpy() != np.asarray(jc["kv"][leaf])[:, 0, 11]).sum()
                for leaf in range(2)))
        else:
            flips = _check_cache_steps(tc, jc, cache, log, cfg.num_layers, idx,
                                       sl.stop - sl.start)
        if flips:
            want = np.asarray(jl, np.float64)
            assert np.abs(tl.numpy() - want).max() <= 1e-3 * np.abs(want).max()
        else:
            _logits_close(tl.numpy(), jl)


@pytest.mark.parametrize("name", NAMES)
def test_draft_decode_step_matches_reference(name):
    """After a prefill, a draft step of every depth in (0, num_layers) at a
    [B] vector index (slot 1 parked): the reference's logits and caches;
    layers at or past the draft depth untouched."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    B, CL = 2, 16
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    for dk in range(1, cfg.num_layers):
        tc, jc = _caches(cfg, jcfg, B, CL, "f32")
        _, tc = T.decode_step(cfg, tp, torch.from_numpy(toks[:, :8]), tc, 0, fresh_cache=True)
        _, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, :8]), jc, 0, fresh_cache=True)
        before = [c.clone() for c in tc["kv"]]
        idx = np.array([8, CL], np.int32)
        tl, tc = T.draft_decode_step(cfg, tp, torch.from_numpy(toks[:, 8:9]), tc,
                                     torch.from_numpy(idx), dk)
        jl, jc = JT.draft_decode_step(jcfg, jp, jnp.asarray(toks[:, 8:9]), jc, jnp.asarray(idx),
                                      dk)
        _logits_close(tl.numpy(), jl)
        for g, w, b in zip(tc["kv"], jc["kv"], before, strict=True):
            _close(g.numpy(), w)
            assert torch.equal(g[dk:], b[dk:])


def test_draft_decode_step_guards():
    jcfg, cfg = _configs("deepseek-v3-671b")
    _, tp = _params("deepseek-v3-671b")
    tc = T.init_decode_caches(cfg, 1, 8, torch.float32)
    tok, idx = torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32)
    assert T.supports_self_speculation(cfg)
    for dk in (0, cfg.num_layers):
        with pytest.raises(ValueError, match="draft_layers"):
            T.draft_decode_step(cfg, tp, tok, tc, idx, dk)


# ---------------------------------------------------------------------------
# The engine and the serve CLI
# ---------------------------------------------------------------------------


def _run_engine(eng, prompts, max_new):
    rids = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
    eng.run()
    by_id = {r.rid: r.tokens for r in eng.done}
    return [by_id[r] for r in rids]


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("name", ARCHS)
def test_engine_tokens_match_reference_and_sequential(name, cache):
    """Three requests of two lengths through 2 slots (the third inserted
    into a freed slot): greedy tokens equal the reference engine's and each
    request's solo ``sequential_generate`` (same cache dtype), executor
    counts equal the reference's, the final decode caches' positions equal;
    no kernel launches on the CPU."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    dt, jdt = DTYPES[cache]
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 8, 4)]
    max_new = [5, 3, 6]
    teng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=dt, decode_block=3)
    jeng = JE.ServeEngine(jcfg, jp, max_batch=2, cache_dtype=jdt, decode_block=3,
                          temperature=0.0)
    reset_launch_counts()
    got = _run_engine(teng, prompts, max_new)
    assert not launch_counts
    assert got == _run_engine(jeng, prompts, max_new)
    assert teng.compile_counts() == jeng.compile_counts()
    for p, n, toks in zip(prompts, max_new, got):
        assert E.sequential_generate(cfg, tp, p[None], n, cache_dtype=dt)[0].tolist() == toks
    np.testing.assert_array_equal(teng._state["caches"]["kv"][-1].numpy(),
                                  np.asarray(jeng._state["caches"]["kv"][-1]))


@pytest.mark.parametrize("name", ARCHS)
def test_speculative_and_prefix_cache_match_plain_and_reference(name):
    """γ = 2 with a 1-layer draft: tokens equal plain decode's and the
    reference's speculative engine's, with its drafted/accepted counts;
    requests sharing an 8-token head hit the prefix store (the reference's
    hit/miss/seeded stats) and reproduce their solo sequential runs, over
    int8 caches for the MLA config (the harvest and the seeding carry its
    [L, B, S] scale leaves)."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    rng = np.random.RandomState(2)
    prompts = list(rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    kw = dict(max_batch=2, decode_block=2)
    plain = _run_engine(E.ServeEngine(cfg, tp, cache_dtype=torch.float32, **kw), prompts, [6, 6])
    teng = E.ServeEngine(cfg, tp, cache_dtype=torch.float32, spec_gamma=2, spec_draft_layers=1,
                         **kw)
    jeng = JE.ServeEngine(jcfg, jp, cache_dtype=jnp.float32, spec_gamma=2, spec_draft_layers=1,
                          temperature=0.0, **kw)
    spec = _run_engine(teng, prompts, [6, 6])
    assert spec == plain == _run_engine(jeng, prompts, [6, 6])
    assert teng._spec_stats == jeng._spec_stats and teng._spec_stats["drafted"] > 0

    head = rng.randint(0, cfg.vocab_size, 8)
    shared = [np.concatenate([head, rng.randint(0, cfg.vocab_size, 4)]).astype(np.int32)
              for _ in range(4)]
    dt, jdt = DTYPES["int8" if cfg.attention == "mla" else "f32"]
    teng = E.ServeEngine(cfg, tp, cache_dtype=dt, prefix_cache=True, **kw)
    jeng = JE.ServeEngine(jcfg, jp, cache_dtype=jdt, prefix_cache=True, temperature=0.0, **kw)
    got = _run_engine(teng, shared, [5] * 4)
    assert got == _run_engine(jeng, shared, [5] * 4)
    assert teng._prefix_stats == jeng._prefix_stats and teng._prefix_stats["hits"] > 0
    for p, toks in zip(shared, got):
        assert E.sequential_generate(cfg, tp, p[None], 5, cache_dtype=dt,
                                     cache_len=32)[0].tolist() == toks


@pytest.mark.parametrize("extra", [[], ["--cache-dtype", "int8"], ["--spec-gamma", "2"],
                                   ["--sequential"]])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, extra, capsys):
    report = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "12",
                         "--gen", "5"] + extra)
    assert report["arch"] == arch and len(report["sample_output"]) == 5
    assert all(0 <= t < get_config(arch, smoke=True).vocab_size
               for t in report["sample_output"])
    if "--spec-gamma" in extra:
        assert report["speculative"]["drafted"] > 0


def test_profile_serve_reads_the_moe_ranges(tmp_path):
    """``annotated_kernels`` gives each ``models/moe.py`` range the kernels
    whose launching call lies inside it (matched by correlation id), and no
    range a kernel launched outside every range."""
    from repro_torch.launch.profile_serve import annotated_kernels

    ev = [{"ph": "X", "cat": "user_annotation", "name": "moe_dispatch", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "moe_experts", "ts": 20, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "ts": 21, "dur": 2}]
    for corr, ts in ((1, 5), (2, 22), (3, 25), (4, 40)):
        ev.append({"ph": "X", "cat": "cuda_runtime" if corr != 3 else "cuda_driver",
                   "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": 100 + ts,
                   "dur": float(corr), "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert annotated_kernels(str(path), M.MOE_RANGES) == {
        "moe_dispatch": (1.0, 1), "moe_experts": (5.0, 2), "moe_combine": (0.0, 0)}


# ---------------------------------------------------------------------------
# The split model, rounds and the train CLI
# ---------------------------------------------------------------------------


def _models(name):
    """(reference model, port model): ``llm_hybrid(n_tower=1, remat=False)``,
    as both CLIs build it (deepseek's towers are dense MLA towers)."""
    jcfg, cfg = _configs(name)
    return (jax_llm_hybrid(jcfg, n_tower=1, remat=False),
            llm_hybrid(cfg, n_tower=1, remat=False))


@pytest.mark.parametrize("name", ["mla"])
def test_exchange_matches_reference(name):
    """The uncompressed exchange (ζ1, ζ2 from the towers, θ0's snapshot)
    and the top-k one (k = 0.25): survivor masks equal, values within 1e-5;
    an MLA config's towers are dense MLA towers."""
    jmodel, tmodel = _models(name)
    assert ("wkv_b" in tmodel.specs1["layers"]["attn"]) == (name == "mla")
    jp = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tp = tmodel.params_from_numpy(_np(jp), "cpu")
    rng = np.random.RandomState(0)
    inp = rng.randint(0, _configs(name)[1].vocab_size, (2, 16))
    b = {"x1": inp[:, :8], "x2": inp[:, 8:], "y": inp}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v.astype(np.int32)) for k, v in b.items()}
    for k_frac in (0.0, 0.25):
        want = jax.jit(JST.make_exchange_step(jmodel, k_frac))(jp, jb)
        got = ST.make_exchange_step(tmodel, k_frac)(tp, tb)
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_array_equal(g != 0, w != 0)
            _close(g, w)


@pytest.mark.parametrize("name, pods", [("grok-1-314b", 1), ("mla", 2)])
def test_round_runner_matches_reference(name, pods):
    """Two fixed-cadence rounds at the CLI's cadence (P = 4, Q = 2, η = 0.01,
    top-k at k = 0.25, b = 0: the LLM rounds are held at top-k only,
    ROADMAP's held divergence; batch 2 of 16 tokens) from the reference's
    initial model: per-step losses within rtol 1e-4, final parameters
    within 1e-3."""
    jmodel, tmodel = _models(name)
    jcfg, cfg = _configs(name)
    jp = jax.jit(lambda k: JST.init_llm_params(k, jmodel, n_pods=pods))(jax.random.PRNGKey(1))
    tp = ST.params_from_numpy(tmodel, _np(jp))
    kw = dict(steps=8, P=4, Q=2, lr=0.01, compression_k=0.25, quant_levels=0)
    jp, want = JST.LLMRoundRunner(jmodel, n_pods=pods).run_fixed(
        jp, JSY.llm_batch_fn(jcfg, 2, 16, n_pods=pods, seed=3), **kw)
    trun = ST.LLMRoundRunner(tmodel, n_pods=pods)
    tp, got = trun.run_fixed(tp, SY.llm_batch_fn(cfg, 2, 16, n_pods=pods, seed=3), **kw)
    assert got.shape == (8,) and np.isfinite(got).all()
    _close(got, want, tol=RUN_RTOL)
    _close_trees(tp, jp, rtol=1e-3, atol=1e-5)
    assert len(trun._round_cache) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_smoke_runs_the_round_runner(arch, capsys):
    """``--arch <arch> --smoke --steps 4 --compression-k 0.25 --quantization
    128 --pods 2`` (one round) on the CPU: the CLI's losses are those of
    ``LLMRoundRunner.run_fixed`` (held against the reference in
    ``test_round_runner_matches_reference``) from the CLI's own model and
    token stream, bit for bit; one executor, no kernel launches."""
    argv = ["--device", "cpu", "--arch", arch, "--smoke", "--steps", "4", "--compression-k",
            "0.25", "--quantization", "128", "--pods", "2"]
    args = TR.parse_args(argv)
    reset_launch_counts()
    got, losses = TR.run_llm(args)
    assert not launch_counts
    assert got["steps"] == 4 and got["executors_compiled"] == 1 and got["pods"] == 2
    _, model, params, batch_fn = TR.build_llm(args, torch.device("cpu"))
    _, want = ST.LLMRoundRunner(model, n_pods=2).run_fixed(
        params, batch_fn, steps=4, P=args.p, Q=args.q, lr=args.lr, compression_k=0.25,
        quant_levels=128)
    np.testing.assert_array_equal(losses, want)
    assert np.isfinite(losses).all() and f'"arch": "{arch}"' in capsys.readouterr().out
