"""The port's hybrid family (zamba2: Mamba-2 SSD heads and one shared
attention block over ring-buffer KV caches) against the JAX package's.

Both packages get the same parameters (the reference's ``init_params``
output, carried over by ``params_from_numpy``) and the same numpy inputs.
``mamba2_forward`` (no state, an f32 state, an int8 state; T = 300 crosses a
256-step chunk) agrees within rtol = atol = 1e-5, as Mamba-1 does in
``tests/test_torch_ssm.py``; ``decode_step`` logits within 1e-4 of the
largest |logit| and the ring caches' position tracks exactly, with f32 and
int8 caches, on zamba2-2.7b's smoke widths and on the reference tests'
``hyb`` config (``tests/test_serve_engine.py``). Greedy tokens of the port's
``ServeEngine`` equal the reference engine's and the port's own
``sequential_generate`` with the prompt inside the window, past the ring's
edge, and with more requests than slots.
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
from repro.launch import engine as JE
from repro.models import layers as JL
from repro.models import quant as JQ
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.common.config import ModelConfig, get_config
from repro_torch.launch import engine as E
from repro_torch.launch import loadgen, serve
from repro_torch.models import attention as A
from repro_torch.models import quant as Q
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

TOL = 1e-5
ARCH = "zamba2-2.7b"
# the reference engine tests' hybrid config (tests/test_serve_engine.py)
HYB = dict(name="hyb", family="hybrid", ssm_state=8, ssm_version=2, ssm_headdim=16,
           hybrid_attn_every=1, sliding_window=16, num_layers=2, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=97)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name, smoke=True):
    if name == "hyb":
        return JaxModelConfig(**HYB), ModelConfig(**HYB)
    return jax_get_config(name, smoke=smoke), get_config(name, smoke=smoke)


_PARAMS = {}


def _params(name):
    """(reference params, port params) from one reference draw."""
    if name not in _PARAMS:
        jcfg, cfg = _configs(name)
        jp = jax.jit(lambda k: JL.init_params(JT.model_specs(jcfg), k, jnp.float32))(
            jax.random.PRNGKey(0))
        _PARAMS[name] = (jp, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp)))
    return _PARAMS[name]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _logits_close(got, want):
    """Logits within 1e-4 of the largest |logit|."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


def _index(idx):
    """(reference index, port index) of a step: a scalar or an int32 [B]."""
    if isinstance(idx, np.ndarray):
        return jnp.asarray(idx), torch.from_numpy(idx)
    return jnp.int32(idx), idx


# ---------------------------------------------------------------------------
# Config and specs
# ---------------------------------------------------------------------------


def test_config_matches_reference():
    for smoke in (False, True):
        jcfg, cfg = _configs(ARCH, smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert get_config(ARCH).param_count() == 2_340_280_320
    assert get_config(ARCH).resolved_head_dim == 80


def _same_spec(got, want):
    assert (tuple(got.shape), got.axes, got.init, got.scale) == (want.shape, want.axes,
                                                                 want.init, want.scale)


@pytest.mark.parametrize("name,smoke", [(ARCH, True), (ARCH, False), ("hyb", True)])
def test_mamba2_specs_match_reference(name, smoke):
    """``mamba_specs`` and ``mamba_state_specs`` (f32 and int8, whose scales
    are (B, conv - 1) and (B, H, P)): shapes, axes, init, scale and types."""
    jcfg, cfg = _configs(name, smoke)
    specs, jspecs = S.mamba_specs(cfg), JS.mamba_specs(jcfg)
    assert list(specs) == list(jspecs)
    for k in specs:
        _same_spec(specs[k], jspecs[k])
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        shapes, axes = S.mamba_state_specs(cfg, 3, dt)
        jshapes, jaxes = JS.mamba_state_specs(jcfg, 3, jdt)
        assert [tuple(s.shape) for s in shapes] == [s.shape for s in jshapes]
        assert [str(s.dtype).split(".")[-1] for s in shapes] == [str(s.dtype) for s in jshapes]
        assert axes == jaxes
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    assert tuple(shapes[3].shape) == (3, H, cfg.ssm_headdim)


@pytest.mark.parametrize("name", [ARCH, "hyb"])
def test_model_specs_and_caches_match_reference(name):
    """The whole tree (the Mamba-2 stack and the ONE shared block), and the
    decode caches: ``"ssm"`` over every layer, ``"kv"`` over the super-blocks
    at ring length min(cache_len, window); zeros and the INT32_MAX sentinel."""
    jcfg, cfg = _configs(name)
    flat = jax.tree_util.tree_flatten_with_path(JT.model_specs(jcfg), is_leaf=JL.is_spec)[0]
    want = {jax.tree_util.keystr(p): s for p, s in flat}
    got = {}

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + f"['{k}']")
            else:
                got[path + f"['{k}']"] = tree[k]

    walk(T.model_specs(cfg), "")
    assert list(got) == list(want)
    for k in got:
        _same_spec(got[k], want[k])
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8),
                    (torch.bfloat16, jnp.bfloat16)):
        for cache_len in (8, 4 * cfg.sliding_window):
            tc = T.init_decode_caches(cfg, 2, cache_len, dt)
            jc = JT.init_decode_caches(jcfg, 2, cache_len, jdt)
            assert sorted(tc) == sorted(jc) == ["kv", "ssm"]
            for group in tc:
                for g, w in zip(tc[group], jc[group], strict=True):
                    assert tuple(g.shape) == w.shape
                    assert str(g.dtype).split(".")[-1] == str(w.dtype)
                    np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
            n_sb = cfg.num_layers // cfg.hybrid_attn_every
            assert tc["kv"][-1].shape == (n_sb, 2, min(cache_len, cfg.sliding_window))


# ---------------------------------------------------------------------------
# Mamba-2 layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state", ["none", "f32", "int8"])
@pytest.mark.parametrize("T_len", [1, 37, 300])
def test_mamba2_forward_matches_reference(state, T_len):
    """Layer 0 of zamba2-2.7b smoke: the output and the new (conv, h) state
    within 1e-5; int8 codes within one step, scales within 1e-5."""
    jcfg, cfg = _configs(ARCH)
    jp, tp = _params(ARCH)
    jl = jax.tree.map(lambda v: v[0], jp["layers"])["mamba"]
    tl = T.layer_params(tp["layers"], 0)["mamba"]
    B, D = 2, cfg.d_model
    d_in, N, P = cfg.ssm_expand * D, cfg.ssm_state, cfg.ssm_headdim
    rng = np.random.default_rng(T_len)
    x = rng.standard_normal((B, T_len, D)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, d_in + 2 * N)).astype(np.float32)
    h = rng.standard_normal((B, d_in // P, P, N)).astype(np.float32)
    if state == "none":
        jst = tst = None
    elif state == "f32":
        jst, tst = (jnp.asarray(conv), jnp.asarray(h)), (torch.from_numpy(conv),
                                                          torch.from_numpy(h))
    else:
        (jcq, jcs), (jhq, jhs) = JQ.quantize_rows(jnp.asarray(conv)), JQ.quantize_rows(
            jnp.asarray(h))
        jst = (jcq, jhq, jcs, jhs)
        tst = tuple(torch.from_numpy(np.array(v)) for v in jst)
    got, gst = S.mamba_forward(tl, torch.from_numpy(x), cfg, tst)
    want, wst = JS.mamba_forward(jl, jnp.asarray(x), jcfg, jst)
    assert tuple(got.shape) == (B, T_len, D)
    _close(got.numpy(), want)
    if state == "none":
        assert gst is None and wst is None
    elif state == "f32":
        for g, w in zip(gst, wst, strict=True):
            assert tuple(g.shape) == w.shape
            _close(g.numpy(), w)
    else:
        assert [g.dtype for g in gst] == [torch.int8, torch.int8, torch.float32, torch.float32]
        for g, w in zip(gst[:2], wst[:2]):  # codes: a last-bit difference may flip a rounding
            assert np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32)).max() <= 1
        for g, w in zip(gst[2:], wst[2:]):
            _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------


def _steps(cfg, toks, CL):
    """A block at 0, a later block filling the ring, single tokens past its
    edge, then a [B] vector step with slot 1 parked at CL (its ring write
    lands at CL mod ring)."""
    W = cfg.sliding_window
    half = W // 2
    return ([(toks[:, :half], 0), (toks[:, half:W], half)]
            + [(toks[:, i:i + 1], i) for i in range(W, W + 3)]
            + [(toks[:, W + 3:W + 4], np.array([W + 3, CL], np.int32))])


def _capture(tag, log):
    """``quantize_rows`` that logs (tag, unrounded codes) before quantizing."""

    def q(x):
        xf = x.float()
        amax = torch.amax(torch.abs(xf), dim=-1)
        scale = amax / torch.full_like(amax, Q.QMAX)
        log.append((tag, xf / torch.clamp_min(scale, Q.SCALE_EPS)[..., None]))
        return Q.quantize_rows(x)

    return q


def _boundary_gap(u):
    """Distance of |u|'s fractional part from the rounding boundary 0.5."""
    u = np.abs(u.numpy().astype(np.float64))
    return np.abs(u - np.floor(u) - 0.5)


def _check_int8_step(cfg, tc, jc, log, idx, S_len):
    """Both packages started this step from the same int8 caches: codes
    equal except flips of one step where the port's unrounded code is
    within 1e-3 of a rounding boundary (the fp32 values of the packages
    differ by ~1e-6); scales within 1e-5; position tracks equal. The ssm
    states are rewritten whole; a ring cache only at this step's columns."""
    ssm_u = [u for tag, u in log if tag == "ssm"]
    kv_u = [u for tag, u in log if tag == "kv"]
    assert len(ssm_u) == 2 * cfg.num_layers
    n_sb = cfg.num_layers // cfg.hybrid_attn_every
    assert len(kv_u) == 2 * n_sb
    ring = tc["kv"][0].shape[2]
    B = tc["kv"][0].shape[1]
    for leaf in range(2):
        got, ref = tc["ssm"][leaf].numpy().astype(np.int32), np.asarray(jc["ssm"][leaf], np.int32)
        diff = np.abs(got - ref)
        assert diff.max() <= 1
        for layer in range(cfg.num_layers):
            gap = _boundary_gap(ssm_u[2 * layer + leaf])
            assert (gap[diff[layer] > 0] < 1e-3).all()
        got, ref = tc["kv"][leaf].numpy().astype(np.int32), np.asarray(jc["kv"][leaf], np.int32)
        diff = np.abs(got - ref)
        assert diff.max() <= 1
        for sb in range(n_sb):
            gap = np.full(got.shape[1:], np.inf)  # a column not written may not differ
            u = _boundary_gap(kv_u[2 * sb + leaf])
            if isinstance(idx, np.ndarray):
                gap[np.arange(B), idx % ring] = u[:, 0]
            else:
                start = idx % ring
                gap[:, start:start + S_len] = u
            assert (gap[diff[sb] > 0] < 1e-3).all()
    for group in ("ssm", "kv"):
        for g, w in zip(tc[group][2:], jc[group][2:]):
            if g.dtype == torch.int32:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                _close(g.numpy(), w)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("name", [ARCH, "hyb"])
def test_decode_step_matches_reference(name, cache):
    """The steps of ``_steps``: logits within 1e-4 of the largest |logit|,
    position tracks exactly equal, f32 states and K/V within 1e-5. With int8
    caches each step starts both packages from the reference's caches, and
    codes may flip only at rounding boundaries."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    int8 = cache == "int8"
    dt, jdt = (torch.int8, jnp.int8) if int8 else (torch.float32, jnp.float32)
    B, CL = 2, 4 * cfg.sliding_window
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size,
                                            (B, cfg.sliding_window + 4)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jdt)
    tc = T.init_decode_caches(cfg, B, CL, dt)
    for t, idx in _steps(cfg, toks, CL):
        jidx, tidx = _index(idx)
        if int8:
            tc = {g: tuple(torch.from_numpy(np.array(x)) for x in jc[g]) for g in jc}
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(S, "quantize_rows", _capture("ssm", log))
            mp.setattr(A, "quantize_rows", _capture("kv", log))
            tl, tc = T.decode_step(cfg, tp, torch.from_numpy(t), tc, tidx)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, jidx)
        _logits_close(tl.numpy(), jl)
        if int8:
            _check_int8_step(cfg, tc, jc, log, idx, t.shape[1])
            continue
        for group in ("ssm", "kv"):
            for g, w in zip(tc[group], jc[group], strict=True):
                if g.dtype == torch.int32:
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                else:
                    _close(g.numpy(), w)
    # the parked slot's write landed at ring column CL mod ring, position CL
    ring = min(CL, cfg.sliding_window)
    assert (tc["kv"][-1][:, 1, CL % ring] == CL).all()


def test_vector_index_takes_single_tokens_only():
    """A [B] vector index with S > 1 raises, as the reference's does (a span
    crossing the ring's edge would be dropped, not wrapped)."""
    jcfg, cfg = _configs(ARCH)
    jp, tp = _params(ARCH)
    toks = np.zeros((2, 2), np.int32)
    idx = np.array([0, 3], np.int32)
    msg = "single-token vector writes only"
    with pytest.raises(ValueError, match=msg):
        T.decode_step(cfg, tp, torch.from_numpy(toks), T.init_decode_caches(cfg, 2, 16),
                      torch.from_numpy(idx))
    with pytest.raises(ValueError, match=msg):
        JT.decode_step(jcfg, jp, jnp.asarray(toks), JT.init_decode_caches(jcfg, 2, 16),
                       jnp.asarray(idx))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _engine_pair(name, prompts, max_new, max_batch, decode_block):
    """The reference's and the port's engines over the same requests (f32
    caches): (tokens, compile counts) of each, and both engines."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    engines = (JE.ServeEngine(jcfg, jp, max_batch=max_batch, cache_dtype=jnp.float32,
                              decode_block=decode_block, temperature=0.0),
               E.ServeEngine(cfg, tp, max_batch=max_batch, cache_dtype=torch.float32,
                             decode_block=decode_block, temperature=0.0))
    out = []
    for eng in engines:
        rids = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
        eng.run()
        by_id = {r.rid: r for r in eng.done}
        out.append(([by_id[r].tokens for r in rids], eng.compile_counts()))
    return out, engines


def _check_engine(name, prompts, max_new, max_batch, decode_block):
    """Tokens equal the reference engine's and each request's solo
    sequential oracle; executor counts equal the reference's compiles."""
    _, tp = _params(name)
    _, cfg = _configs(name)
    ((jt, jcounts), (tt, tcounts)), engines = _engine_pair(name, prompts, max_new, max_batch,
                                                           decode_block)
    assert tt == jt
    assert tcounts == jcounts
    for p, n, got in zip(prompts, max_new, tt):
        assert E.sequential_generate(cfg, tp, p[None], n)[0].tolist() == got
    return tcounts, engines


def test_engine_prompt_inside_the_window():
    """zamba2 smoke, two 16-token prompts (window 32): one prefill block."""
    _, cfg = _configs(ARCH)
    prompts = list(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    counts, _ = _check_engine(ARCH, prompts, [6, 6], 2, 3)
    assert counts["prefill_buckets"] == 1


@pytest.mark.parametrize("name,S_len", [("hyb", 24), (ARCH, 40)])
def test_engine_ring_wrap_matches_reference(name, S_len):
    """A prompt longer than the window (the twin of
    ``test_hybrid_ring_wrap_prefill_matches_sequential``): blocks fill the
    ring, the tail past its edge prefills one token at a time, decode writes
    wrap the ring."""
    _, cfg = _configs(name)
    prompts = list(np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                    (2, S_len)).astype(np.int32))
    counts, _ = _check_engine(name, prompts, [6, 6], 2, 3)
    assert counts["prefill_buckets"] == 2  # the ring-filling block and single tokens


def test_engine_continuous_batching_copies_both_groups():
    """Five requests of mixed lengths through 2 slots: ``serve_insert`` copies
    the "ssm" (stacked over layers) and "kv" (over super-blocks) rows into
    freed slots, and parked slots write ring column cache_len mod ring, as
    the reference's; the final decode caches equal the reference's."""
    _, cfg = _configs(ARCH)
    rng = np.random.RandomState(1)
    W = cfg.sliding_window
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (W + 8, W + 8, 5, 5, W // 2)]
    counts, (jeng, teng) = _check_engine(ARCH, prompts, [3, 6, 4, 5, 7], 2, 3)
    assert counts["insert_buckets"] == counts["insert_compiles"] >= 2
    cache_len = teng._cache_len
    ring = min(cache_len, W)
    tcaches, jcaches = teng._state["caches"], jeng._state["caches"]
    pos = tcaches["kv"][-1]
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jcaches["kv"][-1]))
    assert (pos[:, :, cache_len % ring] == cache_len).any()  # a parked slot's write
    for group in ("ssm", "kv"):
        for g, w in zip(tcaches[group][:-1] if group == "kv" else tcaches[group],
                        jcaches[group]):
            _close(g.numpy(), w)


def test_engine_refuses_speculation_and_skips_the_prefix_cache():
    _, cfg = _configs(ARCH)
    _, tp = _params(ARCH)
    assert not T.supports_self_speculation(cfg)
    with pytest.raises(ValueError, match="recurrent state cannot roll back"):
        E.ServeEngine(cfg, tp, spec_gamma=2)
    eng = E.ServeEngine(cfg, tp, prefix_cache=True)
    assert not eng._prefix_enabled()
    assert eng._attn_ring_len(64) == cfg.sliding_window and eng._attn_ring_len(16) == 16


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--sequential"], ["--cache-dtype", "int8"]])
def test_serve_cli_runs_on_cpu(extra, capsys):
    """zamba2 smoke through the serve CLI: a 40-token prompt fills the
    32-slot ring with one block and prefills 8 single tokens past its
    edge."""
    report = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                         "--prompt-len", "40", "--gen", "6"] + extra)
    assert json.loads(capsys.readouterr().out) == report
    assert report["arch"] == ARCH and len(report["sample_output"]) == 6
    if "--sequential" not in extra:
        assert report["generated_tokens"] == 12
        assert report["compiled_executors"]["prefill_buckets"] == 2


def test_loadgen_cli_runs_on_cpu(capsys):
    """Arrival-driven zamba2 smoke traffic (mixed with a shared prompt head):
    every request finishes; ``--prefix-cache`` stays inert for a recurrent
    state, as the reference's does."""
    rep = loadgen.main(["--device", "cpu", "--arch", ARCH, "--requests", "6", "--rate", "100",
                        "--prompt-len", "40", "--gen", "5", "--max-batch", "2",
                        "--prefix-cache"])
    assert json.loads(capsys.readouterr().out) == rep
    assert rep["requests"] == 6 and rep["generated_tokens"] == 30
    assert rep["engine"]["prefix_cache"] == {"hits": 0, "misses": 0, "seeded_tokens": 0}
