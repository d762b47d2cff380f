"""The port's audio family (whisper: an encoder, a decoder with
cross-attention, and the audio split of the hybrid model) against the JAX
package's, and the twins of the two LLM examples.

Both packages get the same parameters (the reference's ``init_params`` or
``HybridModel.init`` output, carried over by ``params_from_numpy``) and the
same numpy inputs: whisper-medium's smoke widths (``encoder_seq`` 16) and
the reference engine tests' ``audio`` config (``tests/test_serve_engine.py``).
Tolerances:

* ``encode_audio``, ``audio_forward``, ``forward``, ``lm_loss`` and their
  gradients, the cross K/V caches: rtol = atol = 1e-5 (fp32 sums taken in
  another order by XLA and by PyTorch);
* ``decode_step``: logits within 1e-4 of the largest |logit|, caches
  within 1e-5, position tracks exact; int8 codes equal except one-step
  flips whose unrounded code lies within 1e-3 of a rounding boundary;
* compressed exchange messages: survivor masks equal, θ0 within 4 ulp of
  its row's max |x|, ζ within 1e-5 of it;
* round, adaptive and CLI losses: rtol 1e-4.

Greedy tokens of the port's ``ServeEngine`` equal the reference engine's
and the port's ``sequential_generate``. The example twins are held to the
reference examples' printed metrics from the reference's initial model;
the temperature-0.8 draws of ``serve_batched``'s last run differ by design
(``torch.Generator``, not threefry), so only their counts are compared.
"""
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JaxModelConfig
from repro.common.config import get_config as jax_get_config
from repro.core.controller import AdaptiveConfig as JaxAdaptiveConfig
from repro.data import synthetic as JSY
from repro.launch import engine as JE
from repro.launch import serve as JSV
from repro.launch import steps as JST
from repro.launch import train as JTR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.split_model import llm_hybrid as jax_llm_hybrid
from repro_torch.common.config import ModelConfig, get_config
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core.compression import compress_rows_ref
from repro_torch.core.controller import AdaptiveConfig
from repro_torch.data import synthetic as SY
from repro_torch.kernels import compress as K
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import engine as E
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.split_model import llm_hybrid

TOL = 1e-5
RUN_RTOL = 1e-4
ULP = 2.0 ** -23
ARCH = "whisper-medium"
ROOT = Path(__file__).resolve().parent.parent
# the reference engine tests' audio config (tests/test_serve_engine.py)
AUDIO = dict(name="audio", family="audio", is_encoder_decoder=True, encoder_layers=2,
             encoder_seq=8, num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
             vocab_size=97)
NAMES = [ARCH, "audio"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name, smoke=True):
    if name == "audio":
        return JaxModelConfig(**AUDIO), ModelConfig(**AUDIO)
    return jax_get_config(name, smoke=smoke), get_config(name, smoke=smoke)


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


def _frames(cfg, B, seed=1):
    return np.random.RandomState(seed).randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32)


# ---------------------------------------------------------------------------
# Config, specs and caches
# ---------------------------------------------------------------------------


def test_config_matches_reference():
    for smoke in (False, True):
        jcfg, cfg = _configs(ARCH, smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.encoder_seq,
            cfg.vocab_size) == (24, 24, 1024, 1500, 51865)
    assert cfg.source == "arXiv:2212.04356"


@pytest.mark.parametrize("name", NAMES)
def test_model_specs_and_caches_match_reference(name):
    """The whole tree (encoder stack and norm, decoder and cross stacks),
    and the decode caches: ``"kv"`` and ``"cross"`` (4 cross leaves under
    int8, the scales [L, B, Se, KH] fp32), zeros and the INT32_MAX
    sentinel, the batch on axis 1 of every leaf."""
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
        assert (tuple(got[k].shape), got[k].axes, got[k].init, got[k].scale) == (
            want[k].shape, want[k].axes, want[k].init, want[k].scale)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8),
                    (torch.bfloat16, jnp.bfloat16)):
        tc = T.init_decode_caches(cfg, 3, 16, dt)
        jc = JT.init_decode_caches(jcfg, 3, 16, jdt)
        assert list(tc) == ["kv", "cross"] and sorted(jc) == sorted(tc)
        _, axes = T.make_decode_caches(cfg, 3, 16, dt)
        _, jaxes = JT.make_decode_caches(jcfg, 3, 16, jdt)
        assert {k: tuple(v) for k, v in axes.items()} == {k: tuple(v) for k, v in jaxes.items()}
        for group in tc:
            for g, w in zip(tc[group], jc[group], strict=True):
                assert tuple(g.shape) == w.shape
                assert str(g.dtype).split(".")[-1] == str(w.dtype)
                np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
        assert len(tc["cross"]) == (4 if dt == torch.int8 else 2)
        assert tuple(tc["cross"][0].shape) == (cfg.num_layers, 3, cfg.encoder_seq,
                                               cfg.num_kv_heads, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# Encoder, training forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_encoder_and_forward_match_reference(name):
    """``encode_audio``, ``audio_forward`` (with and without remat) and
    ``forward`` (which does not scale the token embedding by sqrt(d), as
    the reference does not) within 1e-5; no kernel launches on the CPU."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    rng = np.random.RandomState(3)
    frames = _frames(cfg, 2)
    toks = rng.randint(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    reset_launch_counts()
    got = T.encode_audio(cfg, tp, torch.from_numpy(frames))
    want = jax.jit(lambda p, f: JT.encode_audio(jcfg, p, f))(jp, jnp.asarray(frames))
    assert tuple(got.shape) == (2, cfg.encoder_seq, cfg.d_model)
    _close(got.numpy(), want)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, h, f: JT.audio_forward(p, h, f, None, jcfg, False))(
        jp, jnp.asarray(x), jnp.asarray(frames))
    for remat in (False, True):
        got = T.audio_forward(tp, torch.from_numpy(x), torch.from_numpy(frames), cfg,
                              remat)
        _close(got.numpy(), want)
    got, aux = T.forward(cfg, tp, torch.from_numpy(toks), extra_embeds=torch.from_numpy(frames))
    want, _ = jax.jit(lambda p, t, f: JT.forward(jcfg, p, t, extra_embeds=f))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    _close(got.numpy(), want)
    assert float(aux) == 0.0
    assert not launch_counts
    with pytest.raises(ValueError):
        T.backbone_forward(cfg, tp, torch.from_numpy(x))


_LOSS = {}


def _loss_case(name):
    """(port batch, the reference's ``lm_loss`` and its gradients) on one
    numpy draw, computed once per config: the reference's remat changes
    what it stores, not what it computes."""
    if name not in _LOSS:
        jcfg, cfg = _configs(name)
        jp, _ = _params(name)
        rng = np.random.RandomState(4)
        frames = _frames(cfg, 2, seed=5)
        toks = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        labels = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "extra_embeds": jnp.asarray(frames)}
        tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
              "extra_embeds": torch.from_numpy(frames)}
        _LOSS[name] = (tb, jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(jcfg, p, jb)))(jp))
    return _LOSS[name]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_and_gradients_match_reference(name, remat):
    _, cfg = _configs(name)
    _, tp = _params(name)
    tb, (want_l, want_g) = _loss_case(name)
    got_l, got_g = ST._grads(lambda p: T.lm_loss(cfg, p, tb, remat), tp)
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g)
    assert float(torch.abs(got_g["enc_layers"]["attn"]["wq"]).max()) > 0


# ---------------------------------------------------------------------------
# Cross-attention caches and decode
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_cross_caches_match_reference(name, cache):
    """``audio_cross_kv`` (one einsum over the stacked weights) and
    ``seed_audio_caches``: the encoder's K/V cast (f32) or quantized a row
    (int8) into the cross leaves, in place; the ``"kv"`` caches untouched."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    frames = _frames(cfg, 3, seed=6)
    enc = T.encode_audio(cfg, tp, torch.from_numpy(frames))
    jenc = JT.encode_audio(jcfg, jp, jnp.asarray(frames))
    for g, w in zip(T.audio_cross_kv(cfg, tp, enc), JT.audio_cross_kv(jcfg, jp, jenc)):
        assert tuple(g.shape) == w.shape == (cfg.num_layers, 3, cfg.encoder_seq,
                                             cfg.num_kv_heads, cfg.resolved_head_dim)
        _close(g.numpy(), w)
    dt, jdt = (torch.int8, jnp.int8) if cache == "int8" else (torch.float32, jnp.float32)
    tc = T.init_decode_caches(cfg, 3, 16, dt)
    leaves = tc["cross"]
    log = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "quantize_rows", _capture(log))
        tc = T.seed_audio_caches(cfg, tp, tc, torch.from_numpy(frames))
    jc = JT.seed_audio_caches(jcfg, jp, JT.init_decode_caches(jcfg, 3, 16, jdt),
                              jnp.asarray(frames))
    assert all(a is b for a, b in zip(tc["cross"], leaves))  # written in place
    for g, w in zip(tc["kv"], jc["kv"]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    if cache == "f32":
        for g, w in zip(tc["cross"], jc["cross"], strict=True):
            _close(g.numpy(), w)
        return
    assert [x.dtype for x in tc["cross"]] == [torch.int8, torch.int8, torch.float32,
                                              torch.float32]
    _check_codes(tc["cross"][0], jc["cross"][0], log[0])
    _check_codes(tc["cross"][1], jc["cross"][1], log[1])
    for g, w in zip(tc["cross"][2:], jc["cross"][2:]):
        _close(g.numpy(), w)


def _decode_steps(S_len, CL):
    """A prefill block at 0 (fresh cache), single tokens, then a [B] vector
    step with slot 1 parked at CL (its write is dropped)."""
    blk = S_len - 4
    return ([(slice(0, blk), 0, True)]
            + [(slice(i, i + 1), i, False) for i in range(blk, S_len - 1)]
            + [(slice(S_len - 1, S_len), np.array([S_len - 1, CL], np.int32), False)])


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name, cache):
    """Seeded caches, a prefill block, single-token steps and a vector step:
    logits within 1e-4 of the largest |logit|, position tracks exact, f32
    K/V within 1e-5; the cross leaves unchanged by decode. With int8 caches
    each step starts both packages from the reference's caches."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    int8 = cache == "int8"
    dt, jdt = (torch.int8, jnp.int8) if int8 else (torch.float32, jnp.float32)
    B, S_len, CL = 2, 12, 16
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, S_len)).astype(np.int32)
    frames = _frames(cfg, B, seed=8)
    jc = JT.seed_audio_caches(jcfg, jp, JT.init_decode_caches(jcfg, B, CL, jdt),
                              jnp.asarray(frames))
    tc = T.seed_audio_caches(cfg, tp, T.init_decode_caches(cfg, B, CL, dt),
                             torch.from_numpy(frames))
    for sl, idx, fresh in _decode_steps(S_len, CL):
        if int8:
            tc = {g: tuple(torch.from_numpy(np.array(x)) for x in jc[g]) for g in jc}
        cross = [x.clone() for x in tc["cross"]]
        jidx, tidx = ((jnp.asarray(idx), torch.from_numpy(idx)) if isinstance(idx, np.ndarray)
                      else (jnp.int32(idx), idx))
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(A, "quantize_rows", _capture(log))
            tl, tc = T.decode_step(cfg, tp, torch.from_numpy(toks[:, sl]), tc, tidx,
                                   fresh_cache=fresh)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, sl]), jc, jidx, fresh_cache=fresh)
        _logits_close(tl.numpy(), jl)
        assert all(torch.equal(a, b) for a, b in zip(cross, tc["cross"]))
        np.testing.assert_array_equal(tc["kv"][-1].numpy(), np.asarray(jc["kv"][-1]))
        if int8:
            assert len(log) == 2 * cfg.num_layers
            start = idx if isinstance(idx, int) else None
            for i in range(2 * cfg.num_layers):
                layer, leaf = divmod(i, 2)
                got = tc["kv"][leaf][layer]
                want = np.asarray(jc["kv"][leaf][layer])
                if start is None:  # the vector step wrote column idx[0] of row 0
                    got, want, u = got[:1, idx[0]:idx[0] + 1], want[:1, idx[0]:idx[0] + 1], \
                        log[i][:1]
                else:
                    n = toks[:, sl].shape[1]
                    got, want, u = got[:, start:start + n], want[:, start:start + n], log[i]
                _check_codes(got, want, u)
            for g, w in zip(tc["kv"][2:4], jc["kv"][2:4]):
                _close(g.numpy(), w)
        else:
            for g, w in zip(tc["kv"], jc["kv"], strict=True):
                _close(g.numpy(), w)
    # the vector step wrote row 0's column S - 1; parked row 1's write was dropped
    assert (tc["kv"][-1][:, 0, S_len - 1] == S_len - 1).all()
    assert (tc["kv"][-1][:, 1, S_len - 1] == A.INT32_MAX).all()


# ---------------------------------------------------------------------------
# Engine and the serve CLI
# ---------------------------------------------------------------------------


def _engine_pair(name, prompts, frames, max_new, max_batch, decode_block,
                 cache=(torch.float32, jnp.float32)):
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    engines = (JE.ServeEngine(jcfg, jp, max_batch=max_batch, cache_dtype=cache[1],
                              decode_block=decode_block, temperature=0.0),
               E.ServeEngine(cfg, tp, max_batch=max_batch, cache_dtype=cache[0],
                             decode_block=decode_block, temperature=0.0))
    out = []
    for eng in engines:
        rids = [eng.submit(p, n, f) for p, f, n in zip(prompts, frames, max_new)]
        eng.run()
        by_id = {r.rid: r for r in eng.done}
        out.append(([by_id[r].tokens for r in rids], eng.compile_counts()))
    return out, engines


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_tokens_match_reference_and_sequential(name, cache):
    """Two requests, each with its own frames, through one prefill group:
    greedy tokens equal the reference engine's and the port's own
    ``sequential_generate`` (same cache dtype), executor counts equal the
    reference's; no flash launch (13-token prompts)."""
    _, cfg = _configs(name)
    _, tp = _params(name)
    rng = np.random.RandomState(0)
    prompts = list(rng.randint(0, cfg.vocab_size, (2, 13)).astype(np.int32))
    frames = list(_frames(cfg, 2, seed=9))
    dts = (torch.int8, jnp.int8) if cache == "int8" else (torch.float32, jnp.float32)
    reset_launch_counts()
    ((jt, jcounts), (tt, tcounts)), _ = _engine_pair(name, prompts, frames, [6, 6], 2, 3, dts)
    assert tt == jt
    assert tcounts == jcounts
    assert not launch_counts
    seq = E.sequential_generate(cfg, tp, np.stack(prompts), 6, extra_embeds=np.stack(frames),
                                cache_dtype=dts[0], cache_len=32)
    assert seq.tolist() == tt


def test_engine_continuous_batching_with_per_request_frames():
    """Five requests of mixed lengths, each with its own frames, through 2
    slots: ``serve_insert`` copies the ``"kv"`` and ``"cross"`` rows (batch
    axis 1) into freed slots. Tokens equal the reference engine's and each
    request's solo ``sequential_generate``; the final decode caches equal
    the reference's."""
    _, cfg = _configs(ARCH)
    _, tp = _params(ARCH)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 9, 5, 5, 7)]
    frames = list(_frames(cfg, 5, seed=10))
    max_new = [3, 6, 4, 5, 7]
    ((jt, jcounts), (tt, tcounts)), (jeng, teng) = _engine_pair(ARCH, prompts, frames, max_new,
                                                                2, 3)
    assert tt == jt
    assert tcounts == jcounts and tcounts["insert_buckets"] >= 2
    for p, f, n, got in zip(prompts, frames, max_new, tt):
        assert E.sequential_generate(cfg, tp, p[None], n, extra_embeds=f[None])[0].tolist() == got
    tcaches, jcaches = teng._state["caches"], jeng._state["caches"]
    for group in ("kv", "cross"):
        for g, w in zip(tcaches[group], jcaches[group], strict=True):
            _close(g.numpy(), w)


def test_engine_refuses_speculation_keeps_the_prefix_cache_inert_and_needs_frames():
    _, cfg = _configs(ARCH)
    _, tp = _params(ARCH)
    assert not T.supports_self_speculation(cfg)
    with pytest.raises(ValueError, match="recurrent state cannot roll back"):
        E.ServeEngine(cfg, tp, spec_gamma=2)
    eng = E.ServeEngine(cfg, tp, prefix_cache=True, cache_dtype=torch.float32)
    assert not eng._prefix_enabled()
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, cfg.vocab_size, 20).astype(np.int32)
    frames = _frames(cfg, 2, seed=11)
    for f in frames:  # the same prompt with other frames: no prefix hit
        eng.submit(prompt, 3, f)
    rep = eng.run()
    assert rep["prefix_cache"] == {"hits": 0, "misses": 0, "seeded_tokens": 0}
    with pytest.raises(ValueError, match="extra_embeds"):
        eng.submit(prompt, 3)


def test_serve_inputs_are_the_reference_draws():
    """``build_inputs``' prompts and frames come from one
    ``RandomState(seed)``, the frames after the prompts, as the
    reference's."""
    jcfg, cfg = _configs(ARCH)
    _, prompts, extra = serve.build_inputs(cfg, 2, 16, seed=3)
    _, jprompts, jextra = JSV.build_inputs(jcfg, 2, 16, seed=3)
    np.testing.assert_array_equal(prompts, jprompts)
    np.testing.assert_array_equal(extra, jextra)
    assert extra.dtype == np.float32 and extra.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert serve.build_inputs(get_config("gemma3-1b", smoke=True), 2, 16)[2] is None


@pytest.mark.parametrize("extra", [[], ["--sequential"], ["--cache-dtype", "int8"]])
def test_serve_cli_runs_on_cpu(extra, capsys):
    report = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                         "--prompt-len", "12", "--gen", "5"] + extra)
    assert json.loads(capsys.readouterr().out) == report
    assert report["arch"] == ARCH and len(report["sample_output"]) == 5
    if "--sequential" not in extra:
        assert report["generated_tokens"] == 10
        assert report["compiled_executors"]["prefill_buckets"] == 2  # 8 + 4 tokens


def test_serve_cli_engine_equals_sequential(capsys):
    """The CLI's engine and ``--sequential`` runs give the same tokens."""
    argv = ["--device", "cpu", "--arch", ARCH, "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--cache-dtype", "f32"]
    _, eng = serve.run(serve.parse_args(argv))
    _, seq = serve.run(serve.parse_args(argv + ["--sequential"]))
    assert eng == seq


# ---------------------------------------------------------------------------
# The audio split of the hybrid model
# ---------------------------------------------------------------------------


def _models(name):
    """(reference model, port model): ``llm_hybrid(n_tower=1, remat=False)``,
    as both CLIs build it."""
    jcfg, cfg = _configs(name)
    return (jax_llm_hybrid(jcfg, n_tower=1, remat=False),
            llm_hybrid(cfg, n_tower=1, remat=False))


_HYBRID = {}


def _hybrid_params(name):
    """The reference's ``llm_hybrid(n_tower=1).init(PRNGKey(0))``, as numpy."""
    if name not in _HYBRID:
        _HYBRID[name] = _np(jax.jit(_models(name)[0].init)(jax.random.PRNGKey(0)))
    return _HYBRID[name]


def _pod_params(name, tmodel, pods):
    """(reference, port) pod-stacked params: the reference's
    ``init_llm_params(PRNGKey(0), n_pods=pods)``."""
    jp = jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * pods), _hybrid_params(name))
    return jp, ST.params_from_numpy(tmodel, _np(jp))


def _capturing(fn, store):
    """``fn`` that also keeps a numpy copy of what it returns (the
    reference's runners donate their params)."""

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.append(_np(out))
        return out

    return wrapped


def _flat_batch(cfg, B=4, S=10, seed=0):
    rng = np.random.RandomState(seed)
    b = {"x1": rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32),
         "x2": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "y": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.slow  # the reference's jit compiles: 10-35 s a case on a CPU
@pytest.mark.parametrize("name", NAMES)
def test_split_towers_loss_and_gradients_match_reference(name):
    """The hospital tower has no embedding and runs over the frames (a
    dense tower, causal with RoPE over them); h1, h2, the loss (ζ2 as the
    decoder's input, ζ1 as the encoder's, the untied head) and its
    gradients; then ``hybrid_grads``."""
    jmodel, tmodel = _models(name)
    jcfg, cfg = _configs(name)
    assert "embed" not in tmodel.specs1 and "embed" in tmodel.specs2
    assert "head" in tmodel.specs0 and "embed" not in tmodel.specs0
    jp = jax.tree.map(jnp.asarray, _hybrid_params(name))
    tp = tmodel.params_from_numpy(_hybrid_params(name), "cpu")
    jb, tb = _flat_batch(cfg)
    z1, z2 = tmodel.h1(tp["theta1"], tb["x1"]), tmodel.h2(tp["theta2"], tb["x2"])
    jz1, jz2 = jmodel.h1(jp["theta1"], jb["x1"]), jmodel.h2(jp["theta2"], jb["x2"])
    assert tuple(z1.shape) == (4, cfg.encoder_seq, cfg.d_model)
    _close(z1.numpy(), jz1)
    _close(z2.numpy(), jz2)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda t: jmodel.loss(t, jz1, jz2, jb["y"])))(jp["theta0"])
    got_l, got_g = ST._grads(lambda t: tmodel.loss(t, z1, z2, tb["y"]), tp["theta0"])
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g)
    jstale = jax.jit(JST.make_exchange_step(jmodel))(jp, jb)
    tstale = ST.make_exchange_step(tmodel)(tp, tb)
    _close_trees(tstale, jstale)
    want_loss, want_g = jax.jit(lambda p, s, b: JST.hybrid_grads(jmodel, p, s, b))(jp, jstale, jb)
    got_loss, got_g = ST.hybrid_grads(tmodel, tp, tstale, tb)
    _close(float(got_loss), float(want_loss))
    _close_trees(got_g, want_g)


def _quant_gap(x, levels):
    """Each entry's distance, in quantization steps, from the rounding
    boundary of its b-level code, for the rows ``x`` after top-k at k = 0.25
    (the port's plain version); inf where the entry is pruned."""
    x = torch.from_numpy(np.array(x, np.float32))
    y = compress_rows_ref(x, max(1, round(0.25 * x.shape[1])), 0)
    kept = y != 0
    qlo = torch.where(kept, y, np.inf).amin(-1, keepdim=True)
    qhi = torch.where(kept, y, -np.inf).amax(-1, keepdim=True)
    u = torch.where(kept, (y - qlo) / (torch.clamp_min(qhi - qlo, 1e-12) / (levels - 1)), 0.0)
    u = u.double().numpy()
    return np.where(kept.numpy(), np.abs(u - np.floor(u) - 0.5), np.inf)


@pytest.mark.parametrize("levels", [0, 128])
def test_exchange_message_matches_reference(levels):
    """k = 0.25 at top-k only and at b = 128, on equal inputs: survivor
    masks equal, θ0 within 4 ulp of its row's max |x|, ζ1 (the frame
    tower's) and ζ2 within 1e-5 of it. At b = 128 an entry may land one
    quantization step apart where its unrounded code lies within 1e-3 of
    a rounding boundary (XLA's fused dequantize; one θ0 entry of this
    message does)."""
    jmodel, tmodel = _models(ARCH)
    jp = jax.tree.map(jnp.asarray, _hybrid_params(ARCH))
    tp = tmodel.params_from_numpy(_hybrid_params(ARCH), "cpu")
    jb, tb = _flat_batch(_configs(ARCH)[1])
    plain = jax.jit(JST.make_exchange_step(jmodel))(jp, jb)
    want = jax.jit(JST.make_exchange_step(jmodel, 0.25, levels))(jp, jb)
    got = ST.make_exchange_step(tmodel, 0.25, levels)(tp, tb)
    for key, rel in (("theta0", 4 * ULP), ("z1", TOL), ("z2", TOL)):
        for g, w, x in zip(tree_leaves(got[key]), jax.tree_util.tree_leaves(want[key]),
                           jax.tree_util.tree_leaves(plain[key])):
            n = w.shape[-1]
            g, w = g.numpy().reshape(-1, n), np.asarray(w).reshape(-1, n)
            x = np.asarray(x).reshape(-1, n)
            np.testing.assert_array_equal(g != 0, w != 0)
            off = np.abs(g - w) > rel * np.abs(x).max(axis=-1, keepdims=True)
            if levels:
                span = np.where(g != 0, g, -np.inf).max(-1, keepdims=True) - np.where(
                    g != 0, g, np.inf).min(-1, keepdims=True)
                step = np.broadcast_to(span / (levels - 1), g.shape)
                assert (np.abs(np.abs(g - w) - step)[off] <= 1e-3 * step[off]).all(), key
                assert (_quant_gap(x, levels)[off] < 1e-3).all(), key
            else:
                assert not off.any(), key


def _message_widths(arch, pods, layers=None):
    """Widths of each row group of ``arch``'s pod-stacked exchange message
    at full width (``ST.message_specs``: meta tensors) at --batch 2
    --seq 64."""
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=layers) if layers else cfg
    params = tree_map(lambda x: torch.empty((pods,) + tuple(x.shape), device="meta"),
                      llm_hybrid(cfg, n_tower=1).specs())
    batch = SY.llm_batch_fn(cfg, 2, 64, n_pods=pods, seed=0)(0, 1)
    leaves = tree_leaves(ST.message_specs(params, batch))
    return [sorted({leaves[i].shape[-1] for i in g}) for g in K.row_groups(leaves)]


def test_row_groups_cap_the_narrow_padding():
    """whisper-medium's message at two pods: padding its 64-wide attention
    rows to 1024 would take 27 GB for 4.9 GB of values, so the narrow
    widths get a group each: 4 launches an exchange. The other LLM
    messages keep their groups (gemma3-1b 4, zamba2-2.7b 7, falcon-mamba-7b
    5 at 16 layers and at its full 64, its 16- and 288-wide rows still
    padded together: fewer floats of padding than of values). On small
    leaves with the floor at 0 the split groups compress each leaf as it
    is compressed alone (torch.equal); padding fewer floats than the
    values never splits."""
    assert _message_widths(ARCH, 2) == [[64], [1024], [4096], [51865]]
    assert _message_widths("gemma3-1b", 2) == [[256], [1152], [6912], [262144]]
    assert len(_message_widths("zamba2-2.7b", 2)) == 7
    for layers in (16, 64):
        assert _message_widths("falcon-mamba-7b", 2, layers=layers)[0] == [16, 288]
        assert len(_message_widths("falcon-mamba-7b", 2, layers=layers)) == 5
    rng = np.random.default_rng(0)
    msg = {k: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for k, sh in (("a", (40, 11)), ("b", (5, 64)), ("c", (2, 3, 64)), ("d", (4, 2000)))}
    leaves = tree_leaves(msg)
    assert [[leaves[i].shape[-1] for i in g] for g in K.row_groups(leaves)] == [[11, 64, 64],
                                                                                [2000]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "NARROW_PAD_BYTES", 0)
        assert [[leaves[i].shape[-1] for i in g] for g in K.row_groups(leaves)] == [
            [11], [64, 64], [2000]]
        few = [leaves[0][:3]] + leaves[1:]  # 3 x 53 floats of padding for 737 of values
        assert [[few[i].shape[-1] for i in g] for g in K.row_groups(few)] == [[11, 64, 64],
                                                                              [2000]]
        got = K.compress_pytree(msg, 0.25, 128)
    for key, leaf in msg.items():
        want = K.compress_pytree({key: leaf}, 0.25, 128)[key]
        assert torch.equal(got[key], want), key


def test_batch_fn_draws_the_reference_frames():
    """``llm_batch_fn``'s audio batches: x1 fp32 [Λ, G, B, Se, d], x2 and y
    int32, each equal bit for bit to the reference's."""
    jcfg, cfg = _configs(ARCH)
    jbf, tbf = JSY.llm_batch_fn(jcfg, 2, 8, n_pods=2, seed=4), SY.llm_batch_fn(cfg, 2, 8,
                                                                              n_pods=2, seed=4)
    for _ in range(2):
        jb, tb = jbf(0, 2), tbf(0, 2)
        assert tb["x1"].dtype == torch.float32 and tb["x2"].dtype == torch.int32
        assert tuple(tb["x1"].shape) == (2, 2, 2, cfg.encoder_seq, cfg.d_model)
        for k in ("x1", "x2", "y"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.slow  # the reference's jit compiles: 10-35 s a case on a CPU
@pytest.mark.parametrize("pods", [1, 2])
def test_round_runner_matches_reference(pods):
    """Two fixed-cadence rounds (P = 4, Q = 2, top-k at k = 0.25) through
    run_fixed: the per-step losses and the final parameters (top-k only:
    at b = 128 the fp32 differences of ζ flip codes by a whole step, as for
    the ssm and hybrid families)."""
    jmodel, tmodel = _models(ARCH)
    jcfg, cfg = _configs(ARCH)
    jp, tp = _pod_params(ARCH, tmodel, pods)
    kw = dict(steps=8, P=4, Q=2, lr=0.05, compression_k=0.25, quant_levels=0)
    jp, want = JST.LLMRoundRunner(jmodel, n_pods=pods).run_fixed(
        jp, JSY.llm_batch_fn(jcfg, 2, 8, n_pods=pods, seed=3), **kw)
    trun = ST.LLMRoundRunner(tmodel, n_pods=pods)
    tp, got = trun.run_fixed(tp, SY.llm_batch_fn(cfg, 2, 8, n_pods=pods, seed=3), **kw)
    assert got.shape == (8,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RUN_RTOL, atol=0)
    _close_trees(tp, jp, rtol=1e-3, atol=1e-5)
    assert len(trun._round_cache) == 1


@pytest.mark.slow  # the reference's jit compiles: 10-35 s a case on a CPU
def test_adaptive_runner_matches_reference():
    """The §VI loop (G = 2, byte budget, seed probe on): the same P, Q and
    rung every round, η within rtol 1e-4, the byte ledger exact (ζ1 is
    B·Se·d floats a pod), the losses within rtol 1e-4."""
    jmodel, tmodel = _models(ARCH)
    jcfg, cfg = _configs(ARCH)
    kw = dict(total_steps=8, byte_budget=1e6, max_interval=4, eta_min=0.01, eta_max=0.05)
    jad = JST.AdaptiveLLMRunner(jmodel, JaxAdaptiveConfig(**kw), n_pods=2, learning_rate=0.05)
    tad = ST.AdaptiveLLMRunner(tmodel, AdaptiveConfig(**kw), n_pods=2, learning_rate=0.05)
    jp, tp = _pod_params(ARCH, tmodel, 2)
    _, want, jhist = jad.run(jp, JSY.llm_batch_fn(jcfg, 2, 8, n_pods=2, seed=0))
    _, got, thist = tad.run(tp, SY.llm_batch_fn(cfg, 2, 8, n_pods=2, seed=0))
    assert len(thist) == len(jhist) > 1
    for t, j in zip(thist, jhist):
        assert (t["P"], t["Q"], t["rung"]) == (j["P"], j["Q"], j["rung"])
        assert t["eta"] == pytest.approx(j["eta"], rel=RUN_RTOL)
        assert t["bytes_total"] == j["bytes_total"]
    np.testing.assert_allclose(got, want, rtol=RUN_RTOL, atol=0)


@pytest.mark.slow  # the reference's jit compiles: 10-35 s a case on a CPU
def test_cli_smoke_matches_reference(monkeypatch):
    """``--arch whisper-medium --smoke --steps 8 --compression-k 0.25
    --quantization 128 --pods 2``: the port's CLI, started from the
    reference CLI's initial model, reports the reference CLI's losses."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "8", "--compression-k", "0.25",
            "--quantization", "128", "--pods", "2"]
    init = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JST, "init_llm_params", _capturing(JST.init_llm_params, init))
        want = JTR.main(argv)
    build = TR.build_llm

    def from_reference(args, device):
        cfg, model, _, batch_fn = build(args, device)
        return cfg, model, ST.params_from_numpy(model, init[0]), batch_fn

    monkeypatch.setattr(TR, "build_llm", from_reference)
    got, losses = TR.run_llm(TR.parse_args(["--device", "cpu"] + argv))
    assert got["steps"] == want["steps"] == 8 and got["executors_compiled"] == 1
    assert np.isfinite(losses).all()
    for key in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[key], want[key], rtol=RUN_RTOL, atol=0, err_msg=key)


# ---------------------------------------------------------------------------
# The example twins
# ---------------------------------------------------------------------------


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NARROW = dict(name="dense-100m", family="dense", num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=97, mlp="swiglu",
              source="examples/train_100m_hsgd.py")
_NUM = r"[-+0-9.e]+|inf|nan"


def _round_lines(out):
    pat = re.compile(rf"round +(\d+): P=Q= *(\d+) eta=({_NUM}) rung=(\d+) bytes=({_NUM})MB "
                     rf"loss= *({_NUM}) rho=({_NUM}) delta=({_NUM})")
    return [m.groups() for m in pat.finditer(out)]


def _near_printed(value, printed, decimals=None, sig=None):
    """The port's unrounded ``value`` against the reference's ``printed``
    number (``decimals`` after the point, or ``sig`` significant digits):
    within half a unit of its last digit plus rtol 1e-4."""
    p = float(printed)
    if decimals is not None:
        half = 0.5 * 10.0 ** -decimals
    else:
        half = 0.5 * 10.0 ** (np.floor(np.log10(abs(p))) - sig + 1) if p else 0.0
    assert abs(float(value) - p) <= half + RUN_RTOL * abs(p), (value, printed)


@pytest.mark.slow  # the reference's jit compiles: 10-35 s a case on a CPU
@pytest.mark.parametrize("flags", [["--steps", "8", "--seq", "32", "--max-interval", "4"],
                                   ["--fixed", "--q", "4", "--steps", "12", "--seq", "16"]])
def test_train_100m_twin_matches_reference(flags, monkeypatch, capsys):
    """``config_100m`` monkeypatched to a 2-layer narrow config in both
    modules; the twin starts from the reference example's initial model.
    The printed parameter counts, per-round trace (P, rung and bytes
    exact; η, loss, ρ, δ to their printed digits) or step losses, and the
    first and last loss agree."""
    from repro_torch.examples import train_100m_hsgd as twin

    ref = _reference_example("train_100m_hsgd")
    monkeypatch.setattr(ref, "config_100m", lambda: JaxModelConfig(**NARROW))
    monkeypatch.setattr(twin, "config_100m", lambda: ModelConfig(**NARROW))
    monkeypatch.setattr(sys, "argv", ["train_100m_hsgd.py"] + flags)
    init = []
    monkeypatch.setattr(ref, "init_llm_params", _capturing(ref.init_llm_params, init))
    ref.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(twin, "init_llm_params",
                        lambda gen, model, n_pods: ST.params_from_numpy(model, init[0]))
    res = twin.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]  # parameter counts
    losses = res["losses"]
    if "--fixed" in flags:
        pat = re.compile(rf"step +(\d+)  loss +({_NUM})")
        w = pat.findall(want)
        assert [s for s, _ in pat.findall(got)] == [s for s, _ in w] == ["0", "10"]
        for step, loss in w:
            _near_printed(losses[int(step)], loss, decimals=4)
    else:
        g, w = _round_lines(got), _round_lines(want)
        assert len(g) == len(w) == len(res["history"]) > 1
        for gr, wr, h in zip(g, w, res["history"]):
            assert (gr[0], gr[1], gr[3], gr[4]) == (wr[0], wr[1], wr[3], wr[4])
            _near_printed(h["eta"], wr[2], sig=4)
            _near_printed(h["loss_last"], wr[5], decimals=4)
            _near_printed(h["rho"], wr[6], sig=3)
            _near_printed(h["delta"], wr[7], sig=3)
    w0, w1 = re.search(rf"done: ({_NUM}) -> ({_NUM})", want).groups()
    _near_printed(losses[0], w0, decimals=3)
    _near_printed(losses[-1], w1, decimals=3)
    assert len(losses) == (12 if "--fixed" in flags else 8)


@pytest.mark.slow  # the reference's jit compiles: 10-35 s a case on a CPU
def test_serve_batched_twin_matches_reference(monkeypatch, capsys):
    """The twin's load runs start from the reference example's weights:
    every request's tokens equal the reference's (greedy, int8 caches,
    γ = 1, prefix cache), request and token counts equal; the closing
    temperature-0.8 serve run only by its counts."""
    from repro_torch.examples import serve_batched as twin

    ref = _reference_example("serve_batched")
    runs = {"ref": [], "port": []}

    def capture(tag, run_load):
        def wrapped(engine, trace, **kw):
            rep = run_load(engine, trace, **kw)
            runs[tag].append((engine, rep))
            return rep
        return wrapped

    monkeypatch.setattr(ref, "run_load", capture("ref", ref.run_load))
    monkeypatch.setattr(twin, "run_load", capture("port", twin.run_load))
    inputs = []
    monkeypatch.setattr(ref, "build_inputs", _capturing(ref.build_inputs, inputs))
    ref.main()
    want = capsys.readouterr().out
    cfg = get_config("gemma3-1b", smoke=True)
    monkeypatch.setattr(twin, "build_inputs", lambda c, b, s, device: (
        T.params_from_numpy(cfg, inputs[0][0]), None, None))
    res = twin.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert "serve_batched OK" in got and "serve_batched OK" in want
    assert len(runs["ref"]) == len(runs["port"]) == 3
    (jeng, jrep), (teng, trep) = runs["ref"][-1], runs["port"][-1]
    assert teng is res["engine"]
    assert trep["requests"] == jrep["requests"] == 16
    assert trep["generated_tokens"] == jrep["generated_tokens"] == 16 * 8
    jdone, tdone = {r.rid: r.tokens for r in jeng.done}, {r.rid: r.tokens for r in teng.done}
    assert sorted(jdone) == sorted(tdone) == list(range(48))
    assert tdone == jdone
    assert res["serve"]["generated_tokens"] == 48
    assert re.search(r"requests +16 +\(128 tokens", got)
