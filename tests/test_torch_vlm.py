"""The port's VLM family (qwen2-vl: M-RoPE, the stubbed patch front end and
the VLM split of the hybrid model) against the JAX package's.

Both packages get the same parameters (the reference's ``init_params`` or
``HybridModel.init`` output, carried over by ``params_from_numpy``) and the
same numpy inputs: qwen2-vl-72b's smoke widths (sections (8, 4, 4)) and the
reference model tests' ``vlm`` config (``tests/test_models.py``, sections
(2, 1, 1)). Tolerances:

* ``apply_mrope``: within 1e-6 at grid ids up to 2^20, both packages
  rotating by the port's frequency table (at such ids one ulp of a
  frequency, which XLA's and PyTorch's ``pow`` may round apart, moves an
  angle by a tenth of a radian); the tables themselves within one ulp;
  text-only M-RoPE ``torch.equal`` to ``apply_rope``;
* ``_vlm_inputs``: x within 1e-6 relative, ``positions_3d`` exact;
* ``gqa_forward``, ``forward``, ``lm_loss`` and its gradients: rtol = atol
  = 1e-5;
* ``decode_step``: logits within 1e-4 of the largest |logit|, caches
  within 1e-5, position tracks exact; int8 codes equal except one-step
  flips whose unrounded code lies within 1e-3 of a rounding boundary; the
  flash plain version within 2e-5 of the Pallas kernel (interpret mode);
* compressed exchange messages: survivor masks equal, θ0 within 4 ulp of
  its row's max |x|, ζ within 1e-5 of it (at b = 128 a flip of one step
  only within 1e-3 of a rounding boundary);
* round and CLI losses: rtol 1e-4.

Greedy tokens of the port's ``ServeEngine`` equal the reference engine's
and the port's ``sequential_generate``, with speculation and the prefix
cache too. Serving is text only in both packages.
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
from repro.kernels import ops as jax_ops
from repro.launch import engine as JE
from repro.launch import serve as JSV
from repro.launch import steps as JST
from repro.launch import train as JTR
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.split_model import llm_hybrid as jax_llm_hybrid
from repro_torch.common.config import ModelConfig, get_config, list_configs
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core.compression import compress_rows_ref
from repro_torch.data import synthetic as SY
from repro_torch.kernels import compress as K
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.launch import engine as E
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.split_model import llm_hybrid

TOL = 1e-5
RUN_RTOL = 1e-4
ULP = 2.0 ** -23
ARCH = "qwen2-vl-72b"
# the reference model tests' vlm config (tests/test_models.py)
VLM = dict(name="vlm", family="vlm", mrope_sections=(2, 1, 1), num_layers=2, d_model=32,
           num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97)
NAMES = [ARCH, "vlm"]
# patch embeddings a forward takes: 8 (not a square: a 2 x 4 grid) at
# qwen2-vl smoke, 4 (the reference tests' _extra) at the vlm config
PATCHES = {ARCH: 8, "vlm": 4}
# row groups of the smoke training message (--batch 2 --seq 64, two pods):
# no row is wider than 512 floats, so one group (chip_smoke.py phase 3w)
SMOKE_GROUPS = 1
DTYPES = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name, smoke=True):
    if name == "vlm":
        return JaxModelConfig(**VLM), ModelConfig(**VLM)
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


def _patches(cfg, B, P, seed=1):
    return np.random.RandomState(seed).randn(B, P, cfg.d_model).astype(np.float32)


# ---------------------------------------------------------------------------
# Config and M-RoPE
# ---------------------------------------------------------------------------


def test_config_matches_reference():
    """``asdict`` and ``param_count`` of the full and smoke configs; the
    published widths; 16 of 80 layers (chip_smoke.py phase 3v) hold
    16 534 216 704 parameters."""
    assert ARCH in list_configs()
    for smoke in (False, True):
        jcfg, cfg = _configs(ARCH, smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.mrope_sections) == (80, 8192, 64, 8, 29568, 152064, (16, 24, 24))
    assert cfg.source == "arXiv:2409.12191"
    specs = T.model_specs(cfg.replace(num_layers=16))
    assert sum(int(np.prod(s.shape)) for s in tree_leaves(specs)) == 16_534_216_704


@pytest.mark.parametrize("sections", [(16, 24, 24), (8, 4, 4), (2, 1, 1)])
def test_mrope_matches_reference(sections, monkeypatch):
    """Grid ids up to 2^20 at qwen2-vl's theta: the port's indexing picks
    each slot's id as the reference's one-hot einsum does (within 1e-6,
    both rotating by the port's frequency table, which is within one ulp
    of the reference's); text-only M-RoPE is ``apply_rope`` bit for bit."""
    D, theta = 2 * sum(sections), 1e6
    freqs = L.rope_frequencies(D, theta).numpy()
    want_freqs = np.asarray(JL.rope_frequencies(D, theta))
    np.testing.assert_allclose(freqs, want_freqs, rtol=ULP, atol=0)
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    p3 = rng.integers(0, 2 ** 20, (2, 7, 3)).astype(np.int32)
    monkeypatch.setattr(JL, "rope_frequencies", lambda d, th: jnp.asarray(freqs))
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(p3), sections, theta)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), sections, theta)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    pos = torch.from_numpy(rng.integers(0, 5000, (2, 7)).astype(np.int32))
    p3 = L.text_positions_3d(pos)
    assert tuple(p3.shape) == (2, 7, 3) and torch.equal(p3[..., 2], pos)
    np.testing.assert_array_equal(p3.numpy(), np.asarray(JL.text_positions_3d(
        jnp.asarray(pos.numpy()))))
    assert torch.equal(L.apply_mrope(torch.from_numpy(x), p3, sections, theta),
                       L.apply_rope(torch.from_numpy(x), pos, theta))


@pytest.mark.parametrize("P", [4, 8, 1024])
def test_vlm_inputs_match_reference(P):
    """The patches in front of the tokens scaled by sqrt(float32(d)) rounded
    to bf16 (11.3125 at d 128, 5.65625 at d 32); the grid ids (0, i // side,
    i % side) with side = int(sqrt(P)), the text from max(h) + 1."""
    for name, scale in ((ARCH, 11.3125), ("vlm", 5.65625)):
        jcfg, cfg = _configs(name)
        jp, tp = _params(name)
        toks = np.random.RandomState(P).randint(0, cfg.vocab_size, (2, 6)).astype(np.int32)
        vis = _patches(cfg, 2, P, seed=P)
        wx, wp3 = JT._vlm_inputs(jcfg, jp, jnp.asarray(toks), jnp.asarray(vis))
        x, p3 = T._vlm_inputs(cfg, tp, torch.from_numpy(toks), torch.from_numpy(vis))
        np.testing.assert_allclose(x.numpy(), np.asarray(wx), rtol=1e-6, atol=0)
        assert p3.dtype == torch.int32
        np.testing.assert_array_equal(p3.numpy(), np.asarray(wp3))
        emb = tp["embed"]["table"][torch.from_numpy(toks).long()]
        assert torch.equal(x[:, P:], emb * scale)
        side = int(np.sqrt(P))
        assert int(p3[0, P, 0]) == (P - 1) // side + 1
        x0, none = T._vlm_inputs(cfg, tp, torch.from_numpy(toks), None)
        assert none is None and torch.equal(x0, x[:, P:])


def test_gqa_forward_with_grid_ids_matches_reference():
    """One attention layer over 16 patches (a 4 x 4 grid) and 8 tokens, with
    their grid ids, and with the text ids when none are given."""
    jcfg, cfg = _configs(ARCH)
    jp, tp = _params(ARCH)
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = tree_map(lambda a: a[0], tp["layers"]["attn"])
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    _, p3 = T._vlm_inputs(cfg, tp, torch.from_numpy(toks),
                          torch.from_numpy(_patches(cfg, 2, 16)))
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    for grid in (p3, None):
        want, _ = JA.gqa_forward(ja, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                 positions_3d=None if grid is None else jnp.asarray(grid.numpy()))
        got, _ = A.gqa_forward(ta, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                               positions_3d=grid)
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# Training forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_gradients_match_reference(name):
    """``forward`` over patch embeddings and tokens ([B, P + S, D]),
    ``lm_loss`` (the P patch positions dropped before the head) and its
    gradients against ``jax.value_and_grad`` (the port with remat on);
    ``backbone_forward`` with no grid ids runs on the text ids."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    P = PATCHES[name]
    rng = np.random.RandomState(4)
    vis = _patches(cfg, 2, P, seed=5)
    toks = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    reset_launch_counts()
    got, aux = T.forward(cfg, tp, torch.from_numpy(toks), extra_embeds=torch.from_numpy(vis))
    want, _ = jax.jit(lambda p, t, e: JT.forward(jcfg, p, t, extra_embeds=e))(
        jp, jnp.asarray(toks), jnp.asarray(vis))
    assert tuple(got.shape) == (2, P + 12, cfg.d_model) and float(aux) == 0.0
    _close(got.numpy(), want)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    got, _ = T.backbone_forward(cfg, tp, torch.from_numpy(x))
    want, _ = jax.jit(lambda p, h: JT.backbone_forward(jcfg, p, h, remat=False))(
        jp, jnp.asarray(x))
    _close(got.numpy(), want)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "extra_embeds": jnp.asarray(vis)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "extra_embeds": torch.from_numpy(vis)}
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(jcfg, p, jb)))(jp)
    got_l, got_g = ST._grads(lambda p: T.lm_loss(cfg, p, tb, True), tp)
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g)
    assert float(torch.abs(got_g["layers"]["attn"]["wq"]).max()) > 0
    assert not launch_counts


# ---------------------------------------------------------------------------
# Decode (text only, as in the reference)
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
def test_decode_step_matches_reference(name, cache):
    """A fresh 8-token block, a later 4-token block, then a [B] vector step
    with slot 1 parked at cache_len (its write dropped): logits within 1e-4
    of the largest |logit|, position tracks exact, f32 K/V within 1e-5.
    With int8 caches each step starts both packages from the reference's
    caches and codes may flip only at a rounding boundary."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    dt, jdt = DTYPES[cache]
    B, CL = 3, 16
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jdt)
    tc = T.init_decode_caches(cfg, B, CL, dt)
    steps = [(toks[:, :8], 0, True), (toks[:, 8:12], 8, False),
             (toks[:, :1], np.array([12, CL, 3], np.int32), False)]
    for t, idx, fresh in steps:
        if cache == "int8":
            tc = {"kv": tuple(torch.from_numpy(np.array(x)) for x in jc["kv"])}
        jidx = jnp.asarray(idx) if isinstance(idx, np.ndarray) else jnp.int32(idx)
        tidx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(A, "quantize_rows", _capture(log))
            tl, tc = T.decode_step(cfg, tp, torch.from_numpy(t), tc, tidx, fresh_cache=fresh)
        jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(t), jc, jidx, fresh_cache=fresh)
        _logits_close(tl.numpy(), jl)
        np.testing.assert_array_equal(tc["kv"][-1].numpy(), np.asarray(jc["kv"][-1]))
        if cache == "f32":
            for g, w in zip(tc["kv"], jc["kv"], strict=True):
                _close(g.numpy(), w)
            continue
        vector = isinstance(idx, np.ndarray)
        n = t.shape[1]
        for i in range(2 * cfg.num_layers):
            layer, leaf = divmod(i, 2)
            got, want = tc["kv"][leaf][layer], np.asarray(jc["kv"][leaf][layer])
            if vector:  # rows 0 and 2 wrote one column each; row 1 is parked
                for row in (0, 2):
                    c = int(idx[row])
                    _check_codes(got[row:row + 1, c:c + 1], want[row:row + 1, c:c + 1],
                                 log[i][row:row + 1])
            else:
                _check_codes(got[:, idx:idx + n], want[:, idx:idx + n], log[i])
        for g, w in zip(tc["kv"][2:4], jc["kv"][2:4]):
            _close(g.numpy(), w)
    assert (tc["kv"][-1][:, 1, 12:] == A.INT32_MAX).all()


def test_fresh_long_block_takes_the_flash_route(monkeypatch):
    """BLOCKWISE_THRESHOLD at 16 in both packages and the reference routed
    to its Pallas kernel (interpret mode): a fresh 64-token block of
    qwen2-vl smoke takes the long route in every layer. The plain flash
    version (``ops.flash_attention`` on a CPU tensor, what the card's route
    calls with K and V repeated to the query heads) is within 2e-5 of the
    Pallas kernel and within 1e-5 of the port's blockwise twin on each
    layer's q, k, v; the step's logits within 1e-4 of the largest |logit|
    and its caches within 1e-5 of the reference's."""
    monkeypatch.setattr(JA, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(A, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(JA, "default_interpret", lambda: False)
    jcfg, cfg = _configs(ARCH)
    jp, tp = _params(ARCH)
    seen, long_route = [], A._long_prefill_attention

    def record(q, k, v, positions, scale, window):
        out = long_route(q, k, v, positions, scale, window)
        seen.append((q, k, v, scale, window, out))
        return out

    monkeypatch.setattr(A, "_long_prefill_attention", record)
    B, S = 2, 64
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tl, tc = T.decode_step(cfg, tp, torch.from_numpy(toks),
                           T.init_decode_caches(cfg, B, 2 * S, torch.float32), 0,
                           fresh_cache=True)
    jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks),
                            JT.init_decode_caches(jcfg, B, 2 * S, jnp.float32), jnp.int32(0),
                            fresh_cache=True)
    _logits_close(tl.numpy(), jl)
    for g, w in zip(tc["kv"], jc["kv"], strict=True):
        _close(g.numpy(), w)
    assert len(seen) == cfg.num_layers
    G = cfg.num_heads // cfg.num_kv_heads
    for q, k, v, scale, window, blockwise in seen:
        kr, vr = torch.repeat_interleave(k, G, dim=2), torch.repeat_interleave(v, G, dim=2)
        plain = ops.flash_attention(q, kr, vr, scale=scale, window=window)
        pallas = jax_ops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, kr, vr)),
                                         scale=scale, window=window)
        np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
        _close(plain.numpy(), blockwise.numpy())


# ---------------------------------------------------------------------------
# Engine and the serve CLI
# ---------------------------------------------------------------------------


def _run_engine(eng, prompts, max_new):
    rids = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
    eng.run()
    by_id = {r.rid: r.tokens for r in eng.done}
    return [by_id[r] for r in rids]


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_engine_tokens_match_reference_and_sequential(cache):
    """Three requests of two lengths through 2 slots: greedy tokens equal
    the reference engine's and each request's solo
    ``sequential_generate``, executor counts equal the reference's; no
    kernel launches on the CPU."""
    jcfg, cfg = _configs(ARCH)
    jp, tp = _params(ARCH)
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


def test_speculative_and_prefix_cache_match_plain_and_reference():
    """γ = 2 with a 1-layer draft: tokens equal plain decode's and the
    reference's speculative engine's, with its drafted/accepted counts;
    requests sharing an 8-token head hit the prefix store (the reference's
    hit/miss/seeded stats) and reproduce their solo sequential runs."""
    jcfg, cfg = _configs(ARCH)
    jp, tp = _params(ARCH)
    assert T.supports_self_speculation(cfg)
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
    teng = E.ServeEngine(cfg, tp, cache_dtype=torch.float32, prefix_cache=True, **kw)
    jeng = JE.ServeEngine(jcfg, jp, cache_dtype=jnp.float32, prefix_cache=True,
                          temperature=0.0, **kw)
    got = _run_engine(teng, shared, [5] * 4)
    assert got == _run_engine(jeng, shared, [5] * 4)
    assert teng._prefix_stats == jeng._prefix_stats and teng._prefix_stats["hits"] > 0
    for p, toks in zip(shared, got):
        assert E.sequential_generate(cfg, tp, p[None], 5, cache_len=32)[0].tolist() == toks


def test_serve_inputs_are_the_reference_draws():
    """``build_inputs``' prompts are the reference's; the VLM family serves
    text only (no patch embeddings), as the reference's does."""
    jcfg, cfg = _configs(ARCH)
    _, prompts, extra = serve.build_inputs(cfg, 2, 16, seed=3)
    _, jprompts, jextra = JSV.build_inputs(jcfg, 2, 16, seed=3)
    np.testing.assert_array_equal(prompts, jprompts)
    assert extra is None and jextra is None


@pytest.mark.parametrize("extra", [[], ["--cache-dtype", "int8"], ["--spec-gamma", "2"],
                                   ["--prefix-cache"], ["--sequential"]])
def test_serve_cli_runs_on_cpu(extra, capsys):
    report = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2", "--prompt-len", "12",
                         "--gen", "5"] + extra)
    assert json.loads(capsys.readouterr().out) == report
    assert report["arch"] == ARCH and len(report["sample_output"]) == 5
    assert all(0 <= t < get_config(ARCH, smoke=True).vocab_size for t in report["sample_output"])
    if "--spec-gamma" in extra:
        assert report["speculative"]["drafted"] > 0


# ---------------------------------------------------------------------------
# The VLM split of the hybrid model
# ---------------------------------------------------------------------------


def _models(name=ARCH):
    """(reference model, port model): ``llm_hybrid(n_tower=1, remat=False)``,
    as both CLIs build it."""
    jcfg, cfg = _configs(name)
    return (jax_llm_hybrid(jcfg, n_tower=1, remat=False),
            llm_hybrid(cfg, n_tower=1, remat=False))


_HYBRID = {}


def _hybrid_params(name=ARCH):
    """The reference's ``llm_hybrid(n_tower=1).init(PRNGKey(0))``, as numpy."""
    if name not in _HYBRID:
        _HYBRID[name] = _np(jax.jit(_models(name)[0].init)(jax.random.PRNGKey(0)))
    return _HYBRID[name]


def _flat_batch(cfg, B=4, S=10, seed=0):
    """One exchange's batch of the VLM split: 8 float patch embeddings for
    the hospital (``llm_batch_fn``'s), S tokens for the device."""
    rng = np.random.RandomState(seed)
    b = {"x1": rng.randn(B, 8, cfg.d_model).astype(np.float32),
         "x2": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "y": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


def test_split_towers_loss_and_gradients_match_reference():
    """The hospital tower has no embedding and runs over the patches (a
    dense tower with M-RoPE on their text ids); h1, h2, the loss (ζ1 then
    ζ2 through the backbone on text ids, the untied head over the token
    positions) and its gradient; the exchange's snapshot; then
    ``hybrid_grads``' three gradients."""
    jmodel, tmodel = _models()
    jcfg, cfg = _configs(ARCH)
    assert "embed" not in tmodel.specs1 and "embed" in tmodel.specs2
    assert "head" in tmodel.specs0 and "embed" not in tmodel.specs0
    jp = jax.tree.map(jnp.asarray, _hybrid_params())
    tp = tmodel.params_from_numpy(_hybrid_params(), "cpu")
    jb, tb = _flat_batch(cfg)
    z1, z2 = tmodel.h1(tp["theta1"], tb["x1"]), tmodel.h2(tp["theta2"], tb["x2"])
    jz1, jz2 = jmodel.h1(jp["theta1"], jb["x1"]), jmodel.h2(jp["theta2"], jb["x2"])
    assert tuple(z1.shape) == (4, 8, cfg.d_model)
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
    assert all(float(torch.abs(x).max()) > 0 for x in (
        got_g["theta0"]["head"]["w"], got_g["theta1"]["layers"]["attn"]["wq"],
        got_g["theta2"]["embed"]["table"]))


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
    masks equal, θ0 within 4 ulp of its row's max |x|, ζ1 (the patch
    tower's) and ζ2 within 1e-5 of it; at b = 128 an entry may land one
    quantization step apart only where its unrounded code lies within 1e-3
    of a rounding boundary."""
    jmodel, tmodel = _models()
    jp = jax.tree.map(jnp.asarray, _hybrid_params())
    tp = tmodel.params_from_numpy(_hybrid_params(), "cpu")
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


def _message_widths(cfg, pods):
    """Widths of each row group of ``cfg``'s pod-stacked exchange message
    (``ST.message_specs``: meta tensors) at --batch 2 --seq 64."""
    params = tree_map(lambda x: torch.empty((pods,) + tuple(x.shape), device="meta"),
                      llm_hybrid(cfg, n_tower=1).specs())
    batch = SY.llm_batch_fn(cfg, 2, 64, n_pods=pods, seed=0)(0, 1)
    leaves = tree_leaves(ST.message_specs(params, batch))
    return [sorted({leaves[i].shape[-1] for i in g}) for g in K.row_groups(leaves)]


def test_row_groups_of_the_training_message():
    """The smoke message at two pods is one row group (SMOKE_GROUPS, pinned
    in chip_smoke.py phase 3w); one published-width layer at one pod
    (phase 3x) groups by width: 128 | 8192 | 29568 | the head's 152064."""
    assert len(_message_widths(get_config(ARCH, smoke=True), 2)) == SMOKE_GROUPS
    assert _message_widths(get_config(ARCH).replace(num_layers=1), 1) == [
        [128], [8192], [29568], [152064]]


def test_batch_fn_draws_the_reference_patches():
    """``llm_batch_fn``'s VLM batches: x1 fp32 [Λ, G, B, 8, d], x2 and y
    int32, each equal bit for bit to the reference's."""
    jcfg, cfg = _configs(ARCH)
    jbf, tbf = JSY.llm_batch_fn(jcfg, 2, 8, n_pods=2, seed=4), SY.llm_batch_fn(cfg, 2, 8,
                                                                              n_pods=2, seed=4)
    for _ in range(2):
        jb, tb = jbf(0, 2), tbf(0, 2)
        assert tb["x1"].dtype == torch.float32 and tb["x2"].dtype == torch.int32
        assert tuple(tb["x1"].shape) == (2, 2, 2, 8, cfg.d_model)
        for k in ("x1", "x2", "y"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("pods", [1, 2])
def test_round_runner_matches_reference(pods):
    """Two fixed-cadence rounds (P = 4, Q = 2, top-k at k = 0.25: the LLM
    rounds are held at top-k only, ROADMAP's held divergence) through
    run_fixed from the reference's initial model: the per-step losses
    within rtol 1e-4 and the final parameters within 1e-3."""
    jmodel, tmodel = _models()
    jcfg, cfg = _configs(ARCH)
    jp = jax.jit(lambda k: JST.init_llm_params(k, jmodel, n_pods=pods))(jax.random.PRNGKey(1))
    tp = ST.params_from_numpy(tmodel, _np(jp))
    kw = dict(steps=8, P=4, Q=2, lr=0.05, compression_k=0.25, quant_levels=0)
    jp, want = JST.LLMRoundRunner(jmodel, n_pods=pods).run_fixed(
        jp, JSY.llm_batch_fn(jcfg, 2, 8, n_pods=pods, seed=3), **kw)
    trun = ST.LLMRoundRunner(tmodel, n_pods=pods)
    tp, got = trun.run_fixed(tp, SY.llm_batch_fn(cfg, 2, 8, n_pods=pods, seed=3), **kw)
    assert got.shape == (8,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RUN_RTOL, atol=0)
    _close_trees(tp, jp, rtol=1e-3, atol=1e-5)
    assert len(trun._round_cache) == 1


def _capturing(fn, store):
    """``fn`` that also keeps a numpy copy of what it returns (the
    reference's runners donate their params)."""

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.append(_np(out))
        return out

    return wrapped


def test_cli_smoke_matches_reference(monkeypatch):
    """``--arch qwen2-vl-72b --smoke --steps 8 --compression-k 0.25
    --quantization 128 --pods 2``: the port's CLI, started from the
    reference CLI's initial model, reports the reference CLI's losses;
    every exchange compresses SMOKE_GROUPS row group, with no kernel
    launch on the CPU."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "8", "--compression-k", "0.25",
            "--quantization", "128", "--pods", "2"]
    init = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JST, "init_llm_params", _capturing(JST.init_llm_params, init))
        want = JTR.main(argv)
    build, compress, groups = TR.build_llm, ST.compress_pytree, []

    def from_reference(args, device):
        cfg, model, _, batch_fn = build(args, device)
        return cfg, model, ST.params_from_numpy(model, init[0]), batch_fn

    def counted(tree, *args, **kw):
        groups.append(len(K.row_groups(tree_leaves(tree))))
        return compress(tree, *args, **kw)

    monkeypatch.setattr(TR, "build_llm", from_reference)
    monkeypatch.setattr(ST, "compress_pytree", counted)
    reset_launch_counts()
    got, losses = TR.run_llm(TR.parse_args(["--device", "cpu"] + argv))
    assert not launch_counts
    assert groups == [SMOKE_GROUPS] * 4  # 8 steps at P = 4, Q = 2: 4 exchanges
    assert got["steps"] == want["steps"] == 8 and got["executors_compiled"] == 1
    assert np.isfinite(losses).all()
    for key in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[key], want[key], rtol=RUN_RTOL, atol=0, err_msg=key)
