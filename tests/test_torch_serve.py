"""The port's serving slices (dense and ssm families) against the JAX package's.

Both packages get the same parameters (the reference's ``init_params``
output, carried over by ``params_from_numpy``) and the same numpy prompts.
The model modules (layers, MLP, int8 rows, ``decode_step`` with its cache
writes) agree within 1e-5; greedy tokens of the port's ``ServeEngine``
equal the reference engine's and the port's own ``sequential_generate``
exactly. The reference's integer semantics are checked one by one: the
dropped out-of-range vector write, the clamped scalar write, the dropped
pad rows of the insert, the INT32_MAX position sentinel.
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
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mlp as JM
from repro.models import quant as JQ
from repro.models import transformer as JT
from repro_torch.common.config import ModelConfig, get_config, list_configs
from repro_torch.launch import engine as E
from repro_torch.launch import serve
from repro_torch.launch.profile_serve import kernel_split
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T

TOL = 1e-5
DENSE_SW = dict(name="dense-sw", family="dense", sliding_window=8, local_global_ratio=5,
                qk_norm=True, num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                vocab_size=97)
REF_REPORT_KEYS = {"arch", "mode", "batch", "prefill_s", "decode_tok_per_s", "tokens_per_s_e2e",
                   "ms_per_decode_step", "wall_s", "requests", "compiled_executors",
                   "sample_output"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name):
    if name == "dense-sw":
        return JaxModelConfig(**DENSE_SW), ModelConfig(**DENSE_SW)
    return jax_get_config(name, smoke=True), get_config(name, smoke=True)


_PARAMS = {}


def _params(name, seed=0):
    """(reference params, port params) from one reference draw."""
    if (name, seed) not in _PARAMS:
        jcfg, cfg = _configs(name)
        jp = jax.jit(lambda k: JL.init_params(JT.model_specs(jcfg), k, jnp.float32))(
            jax.random.PRNGKey(seed))
        _PARAMS[name, seed] = (jp, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp)))
    return _PARAMS[name, seed]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _close_caches(got, want):
    for g, w in zip(got["kv"], want["kv"]):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.float().numpy(), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# Configs and layers
# ---------------------------------------------------------------------------


def test_model_config_and_registry_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert tf == jf
    assert list_configs() == ["falcon-mamba-7b", "gemma3-1b", "gemma3-4b", "nemotron-4-15b",
                              "paper-cnn", "paper-lstm", "stablelm-1.6b", "whisper-medium",
                              "zamba2-2.7b"]
    for name in list_configs():
        for smoke in (False, True):
            got, want = get_config(name, smoke), jax_get_config(name, smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
            assert got.resolved_head_dim == want.resolved_head_dim
    for name in ("deepseek-v3-671b", "grok-1-314b", "qwen2-vl-72b"):
        with pytest.raises(KeyError, match="not ported yet"):
            get_config(name)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(L.rmsnorm(tp, tx).numpy(), JL.rmsnorm(jp, jx))
    _close(L.layernorm(tp, tx).numpy(), JL.layernorm(jp, jx))
    for name in ("gelu", "silu", "relu", "squared_relu"):
        _close(L.ACTIVATIONS[name](tx).numpy(), JL.ACTIVATIONS[name](jx))
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) * 97
    for theta in (1e4, 1e6):
        _close(L.rope_frequencies(16, theta).numpy(), JL.rope_frequencies(16, theta))
        _close(L.apply_rope(tx, torch.from_numpy(pos), theta).numpy(),
               JL.apply_rope(jx, jnp.asarray(pos), theta))
    table = rng.standard_normal((11, 16)).astype(np.float32)
    ids = np.array([[3, 0, 10]], np.int32)
    _close(L.embed({"table": torch.from_numpy(table)}, torch.from_numpy(ids)).numpy(),
           JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids)))
    _close(L.unembed({"table": torch.from_numpy(table)}, tx).numpy(),
           JL.unembed({"table": jnp.asarray(table)}, jx))


@pytest.mark.parametrize("mlp", ["geglu", "swiglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(mlp):
    jcfg = JaxModelConfig(**{**DENSE_SW, "mlp": mlp})
    cfg = ModelConfig(**{**DENSE_SW, "mlp": mlp})
    jp = JL.init_params(JM.mlp_specs(jcfg), jax.random.PRNGKey(1))
    x = np.random.default_rng(1).standard_normal((2, 3, 32)).astype(np.float32)
    got = M.mlp_forward({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                        torch.from_numpy(x), cfg)
    _close(got.numpy(), JM.mlp_forward(jp, jnp.asarray(x), jcfg))


def test_quantize_rows_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: zero codes and zero scale
    x[1, 1, :3] = [127.0, 0.5, -1.5]  # exact halves: round half to even
    jc, js = JQ.quantize_rows(jnp.asarray(x))
    tc, ts = Q.quantize_rows(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and Q.is_int8(tc) and Q.is_int8(torch.int8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Q.dequantize_rows(tc, ts).numpy(),
                                  np.asarray(JQ.dequantize_rows(jc, js)))
    assert not Q.dequantize_rows(tc, ts)[0, 0].any()


# ---------------------------------------------------------------------------
# Cache writes: the reference's integer semantics
# ---------------------------------------------------------------------------


def test_vector_cache_write_drops_out_of_range_columns():
    """A [B] vector index writes S columns per row; columns at or past
    cache_len are dropped (``mode="drop"``), not clamped and not wrapped;
    a negative start wraps, as jnp's indexing does."""
    cache = np.arange(5 * 8 * 2, dtype=np.float32).reshape(5, 8, 2)
    upd = -np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2) - 1
    idx = np.array([0, 6, 8, 7, -1], np.int32)  # rows 1 and 3 partly out, row 2 parked
    want = JA._cache_write(jnp.asarray(cache), jnp.asarray(upd), jnp.asarray(idx))
    got = A._cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(upd),
                         torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[2], cache[2])  # parked row untouched


def test_scalar_cache_write_clamps_like_dynamic_update_slice():
    """``lax.dynamic_update_slice`` clamps its start so the span fits; the
    port reproduces the clamp."""
    cache = np.zeros((2, 8, 3), np.float32)
    upd = np.ones((2, 4, 3), np.float32) * np.arange(1, 5, dtype=np.float32)[None, :, None]
    for index in (0, 3, 6, 7):
        want = JA._cache_write(jnp.asarray(cache), jnp.asarray(upd), jnp.int32(index))
        got = A._cache_write(torch.from_numpy(cache.copy()), torch.from_numpy(upd), index)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[0, 4:, 0].tolist() == [1, 2, 3, 4]  # start 7 clamped to 4


def test_init_caches_carry_the_position_sentinel():
    jcfg, cfg = _configs("gemma3-1b")
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        got = T.init_decode_caches(cfg, 2, 16, dtype)
        want = JT.init_decode_caches(jcfg, 2, 16, jdtype)
        assert len(got["kv"]) == len(want["kv"])
        for g, w in zip(got["kv"], want["kv"]):
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
        assert int(got["kv"][-1].min()) == 2 ** 31 - 1


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------


# (name, cache) cases, ids as "cache-name"; nemotron-4-15b's int8 case is
# test_int8_codes_differ_only_at_rounding_boundaries below
DECODE_CASES = [pytest.param(name, cache, id=f"{cache}-{name}")
                for cache in ("f32", "int8")
                for name in ("gemma3-1b", "stablelm-1.6b", "dense-sw", "gemma3-4b",
                             "nemotron-4-15b")
                if (name, cache) != ("nemotron-4-15b", "int8")]


@pytest.mark.parametrize("name,cache", DECODE_CASES)
def test_decode_step_matches_reference(name, cache):
    """A multi-token prefill at index 0, a later block, then a [B] vector
    step with one slot parked at cache_len (its write dropped): logits and
    every cache leaf within 1e-5, int8 codes equal."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    dt, jdt = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}[cache]
    B, CL = 3, 16
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jdt)
    tc = T.init_decode_caches(cfg, B, CL, dt)
    steps = [(toks[:, :8], 0), (toks[:, 8:12], 8),
             (toks[:, :1], np.array([12, CL, 3], np.int32))]
    for t, idx in steps:
        jidx = jnp.asarray(idx) if isinstance(idx, np.ndarray) else jnp.int32(idx)
        tidx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, jidx)
        tl, tc = T.decode_step(cfg, tp, torch.from_numpy(t), tc, tidx)
        _close(tl.numpy(), jl)
        if cache == "f32":
            _close_caches(tc, jc)
        else:
            for g, w in zip(tc["kv"][:2], jc["kv"][:2]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            _close_caches({"kv": tc["kv"][2:]}, {"kv": jc["kv"][2:]})
    # the parked slot's write at cache_len was dropped: its row keeps the
    # sentinel past the prefill
    assert (tc["kv"][-1][:, 1, 12:] == 2 ** 31 - 1).all()


def test_int8_codes_differ_only_at_rounding_boundaries():
    """nemotron-4-15b smoke (LayerNorm, squared ReLU) with int8 caches, the
    steps of ``test_decode_step_matches_reference``: the fp32 K/V of the two
    packages differ by ~1e-6, and one V code of layer 1 sits 8e-5 from a
    rounding boundary, so it lands one step apart. Codes are equal except
    for such flips (at most one step, only where the port's unrounded code
    is within 1e-3 of a boundary), scales within 1e-5, and the logits
    within one code step's reach: 1e-3 of the largest |logit| (a code step
    is 1/127 of its row's max; the flip moves the logits by 1.2e-4 of it).
    The port's int8 engine equals its int8 sequential oracle exactly."""
    jcfg, cfg = _configs("nemotron-4-15b")
    jp, tp = _params("nemotron-4-15b")
    B, CL = 3, 16
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jnp.int8)
    tc = T.init_decode_caches(cfg, B, CL, torch.int8)
    unrounded = []

    def capture(x):
        xf = x.float()
        scale = torch.amax(torch.abs(xf), dim=-1) / Q.QMAX
        unrounded.append(xf / torch.clamp_min(scale, Q.SCALE_EPS)[..., None])
        return Q.quantize_rows(x)

    steps = [(toks[:, :8], 0), (toks[:, 8:12], 8),
             (toks[:, :1], np.array([12, CL, 3], np.int32))]
    flips = 0
    for t, idx in steps:
        jidx = jnp.asarray(idx) if isinstance(idx, np.ndarray) else jnp.int32(idx)
        tidx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, jidx)
        unrounded.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(A, "quantize_rows", capture)
            tl, tc = T.decode_step(cfg, tp, torch.from_numpy(t), tc, tidx)
        want = np.asarray(jl, np.float64)
        assert np.abs(tl.numpy() - want).max() <= 1e-3 * np.abs(want).max()
        # unrounded holds layer 0's k, v, then layer 1's, ...: the codes of
        # this step's columns
        for leaf in range(2):
            got, ref = tc["kv"][leaf].numpy().astype(np.int32), np.asarray(jc["kv"][leaf], np.int32)
            diff = np.abs(got - ref)
            assert diff.max() <= 1
            for layer in range(cfg.num_layers):
                u = unrounded[2 * layer + leaf].numpy()
                gap = np.abs(np.abs(u) - np.floor(np.abs(u)) - 0.5)
                d = diff[layer][:, idx:idx + t.shape[1]] if not isinstance(idx, np.ndarray) \
                    else diff[layer][np.arange(B), np.minimum(idx, CL - 1)][:, None]
                assert (gap[d > 0] < 1e-3).all()
            flips += int(diff.sum())
        _close_caches({"kv": tc["kv"][2:]}, {"kv": jc["kv"][2:]})
    assert flips >= 1  # the flip the docstring describes
    prompts = toks[:2]
    eng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.int8, decode_block=3)
    got, _ = eng.generate(list(prompts), 6)
    seq = E.sequential_generate(cfg, tp, prompts, 6, cache_dtype=torch.int8, cache_len=32)
    assert seq.tolist() == got


def test_fresh_cache_prefill_matches_sequential_steps():
    """The first prefill block with ``fresh_cache`` (attending within the
    block) equals S single-token steps, in both packages' logits."""
    jcfg, cfg = _configs("gemma3-1b")
    jp, tp = _params("gemma3-1b")
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    fresh, _ = T.decode_step(cfg, tp, torch.from_numpy(toks),
                             T.init_decode_caches(cfg, 2, 16, torch.float32), 0,
                             fresh_cache=True)
    seq_logits, _ = E.sequential_prefill(cfg, tp, toks, 16)
    _close(fresh[:, -1].numpy(), seq_logits[:, -1].numpy())
    want, _ = JT.decode_step(jcfg, jp, jnp.asarray(toks),
                             JT.init_decode_caches(jcfg, 2, 16, jnp.float32), jnp.int32(0),
                             fresh_cache=True)
    _close(fresh.numpy(), want)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _engine_pair(name, prompts_list, max_new, max_batch, cache, decode_block):
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    jdt, dt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[cache]
    jeng = JE.ServeEngine(jcfg, jp, max_batch=max_batch, cache_dtype=jdt,
                          decode_block=decode_block, temperature=0.0)
    teng = E.ServeEngine(cfg, tp, max_batch=max_batch, cache_dtype=dt,
                         decode_block=decode_block, temperature=0.0)
    out = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, n) for p, n in zip(prompts_list, max_new)]
        rep = eng.run()
        by_id = {r.rid: r for r in eng.done}
        out.append(([by_id[r].tokens for r in rids], rep))
    return out, teng


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_engine_matches_reference_and_sequential(cache):
    """gemma3-1b smoke, B=3, S=12, gen=10, decode_block=4: the port's engine
    gives the reference engine's greedy tokens and its own sequential
    oracle's, exactly."""
    name = "gemma3-1b"
    _, cfg = _configs(name)
    _, tp = _params(name)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    (jt, jrep), (tt, trep), = _engine_pair(name, list(prompts), [10] * 3, 3, cache, 4)[0]
    assert tt == jt
    assert trep["generated_tokens"] == jrep["generated_tokens"] == 30
    if cache == "f32":
        seq = E.sequential_generate(cfg, tp, prompts, 10, cache_len=32)
        assert seq.tolist() == tt


def test_engine_continuous_batching_reuses_slots():
    """Two prompt lengths and staggered max_new through 2 slots: freed slots
    are refilled mid-run, tokens equal the reference engine's and each
    request's solo sequential oracle."""
    name = "gemma3-1b"
    _, cfg = _configs(name)
    _, tp = _params(name)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 8, 5, 5)]
    max_new = [2, 6, 4, 5]
    ((jt, _), (tt, _)), teng = _engine_pair(name, prompts, max_new, 2, "f32", 2)
    assert tt == jt
    for p, n, got in zip(prompts, max_new, tt):
        seq = E.sequential_generate(cfg, tp, p[None], n, cache_len=16)
        assert seq[0].tolist() == got
    counts = teng.compile_counts()
    assert counts["insert_buckets"] == counts["insert_compiles"] >= 1


def test_engine_long_route_matches_reference(monkeypatch):
    """With both packages' BLOCKWISE_THRESHOLD at 8, a 16-token first block
    takes the long (flash on the card, blockwise here) route and the
    engines still agree token for token."""
    monkeypatch.setattr(JA, "BLOCKWISE_THRESHOLD", 8)
    monkeypatch.setattr(A, "BLOCKWISE_THRESHOLD", 8)
    name = "dense-sw"
    _, cfg = _configs(name)
    prompts = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ((jt, _), (tt, _)), _ = _engine_pair(name, list(prompts), [6, 6], 2, "f32", 3)
    assert tt == jt


def test_executor_cache_bounded():
    """One executor per (batch, cache, block) bucket: repeat traffic reuses
    them, a new cache bucket adds exactly one decode executor and new
    prefill/insert buckets."""
    name = "gemma3-1b"
    _, cfg = _configs(name)
    _, tp = _params(name)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.float32, decode_block=4)
    eng.generate(list(prompts), 8)
    c1 = eng.compile_counts()
    assert c1["decode_buckets"] == c1["decode_compiles"] == 1
    assert c1["prefill_compiles"] == c1["prefill_buckets"]
    assert c1["insert_compiles"] == c1["insert_buckets"]
    eng.generate(list(prompts), 8)
    assert eng.compile_counts() == c1
    eng.generate(list(prompts), 24)  # cache bucket 16 -> 32
    c3 = eng.compile_counts()
    assert c3["decode_buckets"] == c3["decode_compiles"] == 2
    assert c3["prefill_compiles"] == c3["prefill_buckets"] > c1["prefill_buckets"]
    assert c3["insert_compiles"] == c3["insert_buckets"] > c1["insert_buckets"]
    assert c3["spec_buckets"] == c3["harvest_buckets"] == 0


def test_insert_drops_pad_rows():
    """Prefill pad rows carry dst == max_batch and are dropped, as the
    reference's ``mode="drop"`` scatter drops them."""
    _, cfg = _configs("dense-sw")
    _, tp = _params("dense-sw")
    eng = E.ServeEngine(cfg, tp, max_batch=3, cache_dtype=torch.float32)
    eng._ensure_state(16)
    dec = eng._state["caches"]
    before = [c.clone() for c in dec["kv"]]
    pre = T.init_decode_caches(cfg, 2, 16, torch.float32)
    for c in pre["kv"]:
        c.copy_(torch.arange(c.numel()).reshape(c.shape).to(c.dtype))
    eng._insert_fn(2)(dec, pre, np.array([1, 3], np.int32))
    for d, p, b in zip(dec["kv"], pre["kv"], before):
        assert torch.equal(d[:, 1], p[:, 0])  # row 0 -> slot 1
        assert torch.equal(d[:, 0], b[:, 0]) and torch.equal(d[:, 2], b[:, 2])


def test_temperature_sampling_is_seeded():
    _, cfg = _configs("gemma3-1b")
    _, tp = _params("gemma3-1b")
    prompts = list(np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 8)).astype(np.int32))

    def tokens(temperature, seed):
        eng = E.ServeEngine(cfg, tp, max_batch=4, cache_dtype=torch.float32, decode_block=2,
                            temperature=temperature, seed=seed)
        return eng.generate(prompts, 4)[0]

    hot = tokens(8.0, 1)
    assert hot == tokens(8.0, 1)
    assert hot != tokens(0.0, 0)
    assert all(0 <= t < cfg.vocab_size for row in hot for t in row)


def test_engine_refuses_unported_features():
    _, cfg = _configs("gemma3-1b")
    _, tp = _params("gemma3-1b")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.model_specs(cfg.replace(family="moe"))
    assert E.parse_cache_dtype("int8") == torch.int8
    with pytest.raises(ValueError, match="unsupported cache dtype"):
        E.parse_cache_dtype("fp8")


# ---------------------------------------------------------------------------
# The ssm family: falcon-mamba-7b smoke
# ---------------------------------------------------------------------------

SSM_ARCH = "falcon-mamba-7b"


def _logits_close(got, want):
    """Logits within 1e-4 of the largest |logit|."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("prefill", [8, 64, 300])
def test_ssm_decode_step_matches_reference(prefill, cache):
    """A prefill block of 8, 64 or 300 tokens (300: two 256-step chunks, the
    second padded), then single tokens, the last with a [B] vector index
    (which the ssm family ignores): logits within 1e-4 of the largest
    |logit|, f32 states within 1e-5; int8 codes within one step and scales
    within 1e-5."""
    jcfg, cfg = _configs(SSM_ARCH)
    jp, tp = _params(SSM_ARCH)
    dt, jdt = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}[cache]
    B, CL = 2, 512
    toks = np.random.RandomState(prefill).randint(0, cfg.vocab_size,
                                                  (B, prefill + 3)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jdt)
    tc = T.init_decode_caches(cfg, B, CL, dt)
    assert list(tc) == ["ssm"] and len(tc["ssm"]) == len(jc["ssm"])
    steps = [(toks[:, :prefill], 0), (toks[:, prefill: prefill + 1], prefill),
             (toks[:, prefill + 1: prefill + 2], prefill + 1),
             (toks[:, prefill + 2:], np.array([prefill + 2, CL], np.int32))]
    for t, idx in steps:
        jidx = jnp.asarray(idx) if isinstance(idx, np.ndarray) else jnp.int32(idx)
        tidx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, jidx)
        tl, tc = T.decode_step(cfg, tp, torch.from_numpy(t), tc, tidx)
        _logits_close(tl.numpy(), jl)
        for g, w in zip(tc["ssm"], jc["ssm"]):
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
            if g.dtype == torch.int8:
                assert np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32)).max() <= 1
            else:
                _close(g.numpy(), w)


def test_ssm_engine_matches_reference_and_sequential():
    """A 300-token prompt pair and shorter prompts through 2 slots: more
    requests than slots, so ``serve_insert`` copies "ssm" rows into freed
    slots mid-run; greedy tokens equal the reference engine's and each
    request's solo sequential oracle, exactly."""
    _, cfg = _configs(SSM_ARCH)
    _, tp = _params(SSM_ARCH)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (300, 300, 12, 12)]
    max_new = [3, 6, 4, 5]
    ((jt, _), (tt, trep)), teng = _engine_pair(SSM_ARCH, prompts, max_new, 2, "f32", 2)
    assert tt == jt
    assert trep["generated_tokens"] == sum(max_new)
    for p, n, got in zip(prompts, max_new, tt):
        assert E.sequential_generate(cfg, tp, p[None], n)[0].tolist() == got
    counts = teng.compile_counts()
    assert counts["insert_buckets"] == counts["insert_compiles"] >= 2


def test_ssm_insert_copies_state_rows():
    """``serve_insert`` copies the "ssm" group's rows (the batch axis is 1
    of the layer-stacked leaves) and drops pad rows."""
    _, cfg = _configs(SSM_ARCH)
    _, tp = _params(SSM_ARCH)
    eng = E.ServeEngine(cfg, tp, max_batch=3, cache_dtype=torch.int8)
    eng._ensure_state(16)
    dec = eng._state["caches"]
    before = [c.clone() for c in dec["ssm"]]
    pre = T.init_decode_caches(cfg, 2, 16, torch.int8)
    assert len(pre["ssm"]) == 4
    for c in pre["ssm"]:
        c.copy_((torch.arange(c.numel()) % 100).reshape(c.shape).to(c.dtype))
    eng._insert_fn(2)(dec, pre, np.array([2, 3], np.int32))
    for d, p, b in zip(dec["ssm"], pre["ssm"], before):
        assert torch.equal(d[:, 2], p[:, 0])
        assert torch.equal(d[:, :2], b[:, :2])


@pytest.mark.parametrize("extra", [[], ["--sequential"], ["--cache-dtype", "int8"]])
def test_ssm_serve_cli_runs_on_cpu(extra, capsys):
    report = serve.main(["--device", "cpu", "--arch", SSM_ARCH, "--batch", "2",
                         "--prompt-len", "40", "--gen", "6"] + extra)
    assert json.loads(capsys.readouterr().out) == report
    assert report["arch"] == SSM_ARCH and len(report["sample_output"]) == 6
    if "--sequential" not in extra:
        assert REF_REPORT_KEYS <= set(report)
        assert report["generated_tokens"] == 12
        assert report["compiled_executors"]["prefill_buckets"] == 2  # blocks of 32 and 8


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--sequential"], ["--cache-dtype", "int8"]])
def test_serve_cli_runs_on_cpu(extra, capsys):
    report = serve.main(["--device", "cpu", "--arch", "gemma3-1b", "--batch", "2",
                         "--prompt-len", "32", "--gen", "8"] + extra)
    printed = json.loads(capsys.readouterr().out)
    assert printed == report
    if "--sequential" in extra:
        assert report["mode"] == "sequential"
        assert {"arch", "mode", "batch", "prefill_s", "decode_tok_per_s", "ms_per_decode_step",
                "wall_s", "sample_output"} <= set(report)
    else:
        assert REF_REPORT_KEYS <= set(report)
        assert report["generated_tokens"] == 16
        assert report["compiled_executors"]["decode_buckets"] == 1
    assert len(report["sample_output"]) == 8


def test_serve_cli_prompts_are_the_reference_prompts():
    cfg = get_config("gemma3-1b", smoke=True)
    _, prompts, extra = serve.build_inputs(cfg, 2, 32, seed=3)
    assert extra is None
    want = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    np.testing.assert_array_equal(prompts, want)


def test_serve_cli_default_device_is_cuda():
    args = serve.parse_args(["--arch", "gemma3-1b"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.run(args)


@pytest.mark.parametrize("flags", [["--arch", "qwen2-vl-72b", "--full"], ["--arch", "qwen2-vl-72b"],
                                   ["--arch", "deepseek-v3-671b"], ["--arch", "grok-1-314b"]])
def test_serve_cli_refuses_unported(flags, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu"] + flags)
    assert "not ported yet" in capsys.readouterr().err


def test_profile_serve_splits_device_time():
    """The flash and scan kernels, GEMM-like kernels and the rest, by kernel
    name; a copy is never a kernel."""
    intervals = [
        ("kernel", "void (anonymous namespace)::flash_fwd_kernel<256, float>(float const*)", 0.0, 5.0),
        ("kernel", "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", 5.0, 7.0),
        ("kernel", "void at::native::vectorized_elementwise_kernel<4>", 12.0, 1.0),
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 13.0, 2.0),
        ("kernel", "void (anonymous namespace)::ssm_scan_kernel<float, float>(float const*)",
         15.0, 4.0),
        ("kernel", "void (anonymous namespace)::ssm_scan_kernel<float, float>(float const*)",
         19.0, 0.5),
    ]
    assert kernel_split(intervals) == {"flash_us": 5.0, "gemm_us": 7.0, "other_us": 3.0,
                                       "flash_launches": 1, "scan_us": 4.5,
                                       "scan_launches": 2}
