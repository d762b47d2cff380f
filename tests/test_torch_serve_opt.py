"""The port's serving optimizations against the JAX package's
(``tests/test_serve_opt.py``'s twin): the self-speculative draft and decode,
the prefix cache and the load generator.

Both packages get the same parameters (the reference's ``init_params``
output, carried over by ``params_from_numpy``) and the same numpy prompts.
Tokens and integer stats are compared exactly, logits within 1e-4 of the
largest |logit|, cache values within 1e-5.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import engine as JE
from repro.launch import loadgen as JLG
from repro.models import transformer as JT
from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_map
from repro_torch.launch import engine as E
from repro_torch.launch import loadgen as LG
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_serve import (_close, _configs, _logits_close,  # noqa: F401
                              _one_torch_thread, _params)

DTYPES = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


def _leaf_close(got, want):
    """A cache leaf: integer leaves (int8 codes, int32 positions) exactly,
    float leaves within 1e-5."""
    want = np.asarray(want)
    if got.dtype in (torch.int32, torch.int8):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got.float().numpy(), want.astype(np.float32))


def _run_engine(eng, prompts, max_new):
    rids = [eng.submit(p, n) for p, n in zip(prompts, max_new)]
    eng.run()
    by_id = {r.rid: r.tokens for r in eng.done}
    return [by_id[r] for r in rids]


# ---------------------------------------------------------------------------
# The draft pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma3-1b", "dense-sw", "nemotron-4-15b"])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_draft_decode_step_matches_reference(name, cache):
    """After a prefill, a draft step at a [B] vector index (one slot parked
    at cache_len) gives the reference's logits, writes the reference's
    values into the first ``draft_layers`` layers' caches, and leaves the
    layers past them untouched."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(name)
    dt, jdt = DTYPES[cache]
    B, CL, dk = 3, 16, 1
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jdt)
    tc = T.init_decode_caches(cfg, B, CL, dt)
    _, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, :8]), jc, jnp.int32(0))
    _, tc = T.decode_step(cfg, tp, torch.from_numpy(toks[:, :8]), tc, 0)
    before = [c.clone() for c in tc["kv"]]
    idx = np.array([8, CL, 5], np.int32)
    jl, jc = JT.draft_decode_step(jcfg, jp, jnp.asarray(toks[:, 8:]), jc, jnp.asarray(idx), dk)
    tl, tc = T.draft_decode_step(cfg, tp, torch.from_numpy(toks[:, 8:]), tc,
                                 torch.from_numpy(idx), dk)
    assert tl.shape == (B, 1, cfg.vocab_size)
    _logits_close(tl.numpy(), jl)
    for g, w, b in zip(tc["kv"], jc["kv"], before):
        _leaf_close(g[:dk], np.asarray(w)[:dk])
        assert torch.equal(g[dk:], b[dk:])  # the layers past the draft: untouched
        _leaf_close(g[dk:], np.asarray(w)[dk:])
    assert (tc["kv"][-1][:dk, 1, 8:] == 2 ** 31 - 1).all()  # the parked write dropped


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_verify_block_writes_match_reference(cache):
    """A verify block (S = γ + 1 = 4 tokens at a [B] vector index) with one
    slot whose span crosses the cache's end, one parked at cache_len and one
    mid-cache: logits and every cache leaf equal the reference's; the
    columns past the end are dropped, the parked row keeps its caches."""
    jcfg, cfg = _configs("gemma3-1b")
    jp, tp = _params("gemma3-1b")
    dt, jdt = DTYPES[cache]
    B, CL = 3, 16
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (B, 14)).astype(np.int32)
    jc = JT.init_decode_caches(jcfg, B, CL, jdt)
    tc = T.init_decode_caches(cfg, B, CL, dt)
    _, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, :10]), jc, jnp.int32(0))
    _, tc = T.decode_step(cfg, tp, torch.from_numpy(toks[:, :10]), tc, 0)
    parked = [c[:, 1].clone() for c in tc["kv"]]
    idx = np.array([CL - 2, CL, 6], np.int32)
    jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, 10:]), jc, jnp.asarray(idx))
    tl, tc = T.decode_step(cfg, tp, torch.from_numpy(toks[:, 10:]), tc, torch.from_numpy(idx))
    _logits_close(tl.numpy(), jl)
    for g, w, p in zip(tc["kv"], jc["kv"], parked):
        _leaf_close(g, w)
        assert torch.equal(g[:, 1], p)
    assert tc["kv"][-1][:, 0, CL - 2:].tolist() == [[CL - 2, CL - 1]] * cfg.num_layers


def test_draft_decode_step_guards():
    """The reference's guards: a family that cannot self-speculate and a
    draft depth outside (0, num_layers) raise ValueError; the VLM arm is not
    ported yet, the MoE arm runs (its values: tests/test_torch_moe.py)."""
    _, cfg = _configs("gemma3-1b")
    _, tp = _params("gemma3-1b")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    idx = torch.zeros((1,), dtype=torch.int32)
    caches = T.init_decode_caches(cfg, 1, 8, torch.float32)
    for dk in (0, cfg.num_layers, -1):
        with pytest.raises(ValueError, match="draft_layers"):
            T.draft_decode_step(cfg, tp, tok, caches, idx, dk)
    ssm = get_config("falcon-mamba-7b", smoke=True)
    with pytest.raises(ValueError, match="self-speculation unsupported"):
        T.draft_decode_step(ssm, tp, tok, caches, idx, 1)
    logits, _ = T.draft_decode_step(cfg.replace(family="vlm"), tp, tok, caches, idx, 1)
    assert tuple(logits.shape) == (1, 1, cfg.vocab_size)
    moe = get_config("grok-1-314b", smoke=True)
    mp = L.init_params(T.model_specs(moe), torch.Generator().manual_seed(0))
    logits, _ = T.draft_decode_step(moe, mp, tok, T.init_decode_caches(moe, 1, 8, torch.float32),
                                    idx, 1)
    assert tuple(logits.shape) == (1, 1, moe.vocab_size)


# ---------------------------------------------------------------------------
# Self-speculative decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [1, 3])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_speculative_greedy_parity(gamma, cache):
    """Four requests through two slots (refilled mid-run, non-pow2 prompts):
    the port's spec tokens equal its plain tokens and the reference engine's
    spec tokens, and drafted/accepted equal the reference's."""
    jcfg, cfg = _configs("dense-sw")
    jp, tp = _params("dense-sw")
    dt, jdt = DTYPES[cache]
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, (s,)).astype(np.int32) for s in (7, 7, 11, 9)]
    max_new = [5, 9, 4, 7]
    plain = _run_engine(E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=dt, decode_block=3),
                        prompts, max_new)
    teng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=dt, decode_block=3,
                         spec_gamma=gamma)
    jeng = JE.ServeEngine(jcfg, jp, max_batch=2, cache_dtype=jdt, decode_block=3,
                          temperature=0.0, spec_gamma=gamma)
    spec = _run_engine(teng, prompts, max_new)
    assert spec == plain
    assert spec == _run_engine(jeng, prompts, max_new)
    got, want = teng.report(1.0, teng.done), jeng.report(1.0, jeng.done)
    assert got["speculative"] == want["speculative"]
    assert got["speculative"]["drafted"] > 0


def test_speculative_parity_with_an_untied_head():
    """nemotron-4-15b smoke (untied head, LayerNorm, squared ReLU): its
    random drafts are mostly rejected, where gemma3's tied, sqrt(d)-scaled
    embedding makes a random model repeat its last token and accept every
    draft. Spec tokens equal plain tokens and the reference's, and so do
    the drafted/accepted counts."""
    jcfg, cfg = _configs("nemotron-4-15b")
    jp, tp = _params("nemotron-4-15b")
    prompts = list(np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 10)).astype(np.int32))
    plain, _ = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.float32,
                             decode_block=2).generate(prompts, 9)
    spec, rep = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.float32, decode_block=2,
                              spec_gamma=4).generate(prompts, 9)
    jspec, jrep = JE.ServeEngine(jcfg, jp, max_batch=2, cache_dtype=jnp.float32, decode_block=2,
                                 temperature=0.0, spec_gamma=4).generate(prompts, 9)
    assert spec == plain == jspec
    assert rep["speculative"] == jrep["speculative"]
    assert rep["speculative"]["acceptance"] < 0.5  # the reject branch is exercised
    assert all(len(set(t)) > 3 for t in spec)


def test_speculative_executor_built_once_a_bucket():
    """One spec executor per (batch, cache, block, gamma, draft layers)
    bucket; repeat traffic builds none, and no plain decode executor."""
    _, cfg = _configs("dense-sw")
    _, tp = _params("dense-sw")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.float32, decode_block=4,
                        spec_gamma=2)
    eng.generate(list(prompts), 8)
    c1 = eng.compile_counts()
    assert c1["spec_buckets"] == c1["spec_compiles"] == 1
    assert c1["decode_buckets"] == c1["decode_compiles"] == 0
    eng.generate(list(prompts), 8)
    assert eng.compile_counts() == c1


def test_speculative_rejected_configs():
    """Greedy-only, and only for families whose caches can be rewritten:
    temperature > 0 and the ssm family raise ValueError at construction."""
    _, cfg = _configs("dense-sw")
    _, tp = _params("dense-sw")
    with pytest.raises(ValueError, match="greedy-only"):
        E.ServeEngine(cfg, tp, max_batch=1, temperature=0.7, spec_gamma=2)
    ssm = get_config("falcon-mamba-7b", smoke=True)
    sp = L.init_params(T.model_specs(ssm), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="recurrent state"):
        E.ServeEngine(ssm, sp, max_batch=1, spec_gamma=2)
    E.ServeEngine(cfg, tp, max_batch=1, temperature=0.7)  # no spec: accepted


def _pass_through(params, dk):
    """``params`` with the output projections of layers >= dk zeroed: those
    layers then pass the residual through exactly, so the dk-layer draft is
    the full model."""
    out = tree_map(lambda t: t.clone(), params)
    out["layers"]["attn"]["wo"][dk:] = 0
    out["layers"]["mlp"]["w_down"][dk:] = 0
    return out


@pytest.mark.parametrize("name", ["gemma3-1b", "nemotron-4-15b"])
def test_speculative_accepts_when_the_draft_is_the_model(name):
    """With the layers past the draft passing the residual through, nearly
    every draft is accepted, and the tokens are still plain decode's."""
    _, cfg = _configs(name)
    _, tp = _params(name)
    tp = _pass_through(tp, cfg.num_layers // 2)
    prompts = list(np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 12)).astype(np.int32))

    def run(**kw):
        eng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.float32, decode_block=2,
                            **kw)
        toks, rep = eng.generate(prompts, 17)
        return toks, rep

    plain, _ = run()
    spec, rep = run(spec_gamma=4)
    assert spec == plain
    assert rep["speculative"]["acceptance"] >= 0.9, rep["speculative"]


# ---------------------------------------------------------------------------
# The prefix cache
# ---------------------------------------------------------------------------


def _shared_head_prompts(cfg, seed, n, S=12, p=8):
    rng = np.random.RandomState(seed)
    head = rng.randint(0, cfg.vocab_size, (p,))
    return [np.concatenate([head, rng.randint(0, cfg.vocab_size, (S - p,))]).astype(np.int32)
            for _ in range(n)]


def test_prefix_cache_hit_and_parity():
    """Requests sharing a pow2 prompt head seed their caches from the store
    and reproduce their solo sequential runs, the reference engine's tokens
    and its hit/miss/seeded stats."""
    jcfg, cfg = _configs("dense-sw")
    jp, tp = _params("dense-sw")
    S, gen = 12, 5  # the prefix block p = pow2_floor(11) = 8 < S
    prompts = _shared_head_prompts(cfg, 2, 4, S)
    teng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.float32, decode_block=2,
                         prefix_cache=True)
    jeng = JE.ServeEngine(jcfg, jp, max_batch=2, cache_dtype=jnp.float32, decode_block=2,
                          temperature=0.0, prefix_cache=True)
    got = _run_engine(teng, prompts, [gen] * 4)
    assert got == _run_engine(jeng, prompts, [gen] * 4)
    stats = teng._prefix_stats
    assert stats == jeng._prefix_stats
    assert stats["hits"] > 0 and stats["seeded_tokens"] == 8 * stats["hits"]
    for p, toks in zip(prompts, got):
        seq = E.sequential_generate(cfg, tp, p[None], gen, cache_len=32)
        assert seq[0].tolist() == toks
    counts = teng.compile_counts()
    assert counts["harvest_buckets"] == counts["harvest_compiles"] == 1
    assert teng.report(1.0)["prefix_cache"] == stats


def test_prefix_store_reuse_across_runs_and_eviction():
    """The store lives across generate() calls and LRU-evicts past
    prefix_store_max; every run keeps the first run's tokens, and the
    stats follow the reference's step for step."""
    jcfg, cfg = _configs("dense-sw")
    jp, tp = _params("dense-sw")
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    other = rng.randint(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    teng = E.ServeEngine(cfg, tp, max_batch=1, cache_dtype=torch.float32, decode_block=2,
                         prefix_cache=True, prefix_store_max=1)
    jeng = JE.ServeEngine(jcfg, jp, max_batch=1, cache_dtype=jnp.float32, decode_block=2,
                          temperature=0.0, prefix_cache=True, prefix_store_max=1)
    t1, _ = teng.generate(list(prompt), 4)
    assert teng._prefix_stats == {"hits": 0, "misses": 1, "seeded_tokens": 0}
    t2, _ = teng.generate(list(prompt), 4)  # same head: a hit, same tokens
    assert teng._prefix_stats["hits"] == 1 and t2 == t1
    teng.generate(list(other), 4)  # another head: a miss, and the LRU evicts
    assert len(teng._prefix_store) == 1
    t3, _ = teng.generate(list(prompt), 4)  # evicted: a miss again, same tokens
    assert teng._prefix_stats["misses"] == 3 and t3 == t1
    for p in (prompt, prompt, other, prompt):
        jeng.generate(list(p), 4)
    assert teng._prefix_stats == jeng._prefix_stats
    assert list(teng._prefix_store) == list(jeng._prefix_store)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_harvest_matches_reference(cache):
    """The harvest mask of a prefilled batch equals the reference's
    ``serve_harvest``: columns < p kept, columns >= p back to the init
    values (INT32_MAX on the positions, 0 on the K/V codes and, under int8,
    on the f32 scales); the live caches are not touched."""
    jcfg, cfg = _configs("gemma3-1b")
    jp, tp = _params("gemma3-1b")
    dt, jdt = DTYPES[cache]
    Bp, CL, p = 2, 16, 8
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (Bp, 12)).astype(np.int32)
    _, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks), JT.init_decode_caches(jcfg, Bp, CL, jdt),
                           jnp.int32(0))
    _, tc = T.decode_step(cfg, tp, torch.from_numpy(toks), T.init_decode_caches(cfg, Bp, CL, dt), 0)
    live = [c.clone() for c in tc["kv"]]
    teng = E.ServeEngine(cfg, tp, cache_dtype=dt, prefix_cache=True)
    jeng = JE.ServeEngine(jcfg, jp, cache_dtype=jdt, prefix_cache=True)
    got = teng._harvest_fn(Bp, p, CL)(tc)
    want = jeng._harvest_fn(Bp, p, CL)(jc)
    assert len(got["kv"]) == len(want["kv"]) == (5 if cache == "int8" else 3)
    for g, w, c in zip(got["kv"], want["kv"], live):
        assert g.dtype == c.dtype
        _leaf_close(g, w)
        init = 2 ** 31 - 1 if g.dtype == torch.int32 else 0
        assert (g[:, :, p:] == init).all()
        assert torch.equal(g[:, :, :p], c[:, :, :p])
    for c, before in zip(tc["kv"], live):
        assert torch.equal(c, before)


@pytest.mark.parametrize("group", [1, 2])
def test_stored_rows_survive_the_caches_seeded_from_them(group):
    """The store's rows are their own tensors: a hit's prefill and decode
    write the caches seeded from them in place, and the rows stay as they
    were harvested (one request a group: a clone; two: a concatenation)."""
    _, cfg = _configs("dense-sw")
    _, tp = _params("dense-sw")
    prompts = _shared_head_prompts(cfg, 9, group)
    eng = E.ServeEngine(cfg, tp, max_batch=group, cache_dtype=torch.float32, decode_block=2,
                        prefix_cache=True)
    t1, _ = eng.generate(prompts, 6)  # a miss: harvested
    assert len(eng._prefix_store) == 1
    row = next(iter(eng._prefix_store.values()))
    snap = [c.clone() for c in row["kv"]]
    assert all(c.shape[1] == 1 for c in row["kv"])  # one batch row a stored entry
    t2, _ = eng.generate(prompts, 6)  # a hit: seeded, prefilled and decoded
    assert eng._prefix_stats["hits"] == group and t2 == t1
    for c, s in zip(row["kv"], snap):
        assert torch.equal(c, s)
    dec = eng._state["caches"]["kv"]
    assert all(c.data_ptr() != d.data_ptr() for c, d in zip(row["kv"], dec))


# ---------------------------------------------------------------------------
# The load generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,frac,n,prompt_len", [(7, 0.75, 6, 12), (0, 0.0, 5, 9),
                                                    (3, 0.5, 9, 4096)])
def test_poisson_trace_matches_reference(seed, frac, n, prompt_len):
    """Same seed, same trace as the reference, field for field."""
    got = LG.poisson_trace(n, 4.0, prompt_len, 16, 262144, seed=seed, shared_prefix_frac=frac)
    want = JLG.poisson_trace(n, 4.0, prompt_len, 16, 262144, seed=seed, shared_prefix_frac=frac)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert got[0].t_arrival == 0.0
    shared = int(prompt_len * frac)
    assert all(r.prompt[:shared] == got[0].prompt[:shared] for r in got)


def test_trace_save_load_round_trip(tmp_path):
    """A saved trace loads back equal, in either package."""
    trace = LG.poisson_trace(6, 50.0, 12, 4, 97, seed=7, shared_prefix_frac=0.75)
    path = tmp_path / "trace.json"
    LG.save_trace(str(path), trace)
    assert LG.load_trace(str(path)) == trace
    assert [vars(r) for r in JLG.load_trace(str(path))] == [vars(r) for r in trace]
    JLG.save_trace(str(path), JLG.poisson_trace(6, 50.0, 12, 4, 97, seed=7,
                                                shared_prefix_frac=0.75))
    assert LG.load_trace(str(path)) == trace


def test_run_load_report_schema():
    """A tiny replay drains every request and fills the reference's report
    schema (percentiles, sustained rate, SLO attainment, engine report with
    the spec and prefix stats)."""
    _, cfg = _configs("dense-sw")
    _, tp = _params("dense-sw")
    trace = LG.poisson_trace(5, 200.0, 12, 3, cfg.vocab_size, seed=0, shared_prefix_frac=0.75)
    eng = E.ServeEngine(cfg, tp, max_batch=2, cache_dtype=torch.int8, decode_block=2,
                        spec_gamma=1, prefix_cache=True)
    rep = LG.run_load(eng, trace, slo_first_token_s=60.0)
    assert set(rep) == {"requests", "generated_tokens", "span_s", "sustained_tokens_per_s",
                        "queue_s", "first_token_s", "total_s", "slo_first_token_s",
                        "slo_attainment", "wall_s", "engine"}
    assert rep["requests"] == 5 and rep["generated_tokens"] == 15
    assert rep["slo_attainment"] == 1.0
    for key in ("queue_s", "first_token_s", "total_s"):
        assert set(rep[key]) == {"p50", "p99"}
        assert rep[key]["p50"] <= rep[key]["p99"]
    assert rep["sustained_tokens_per_s"] > 0
    assert {"compiled_executors", "speculative", "prefix_cache"} <= set(rep["engine"])
    assert rep["engine"]["prefix_cache"]["hits"] > 0
    json.dumps(rep)


def test_load_report_matches_reference():
    """The same finished requests give the reference's summary."""
    rng = np.random.RandomState(11)
    finished = []
    for i in range(7):
        t = float(rng.uniform(0, 2))
        r = E.Request(i, np.zeros(4, np.int32), 5, t_submit=t)
        r.t_admit = t + float(rng.uniform(0, 0.5))
        r.t_first = r.t_admit + float(rng.uniform(0, 1.5))
        r.t_done = r.t_first + float(rng.uniform(0, 3))
        r.tokens = list(range(int(rng.randint(1, 6))))
        finished.append(r)
    for slo in (0.5, 1.0, 10.0):
        assert LG.load_report(finished, slo) == JLG.load_report(finished, slo)
    assert LG.load_report([], 1.0) == JLG.load_report([], 1.0)


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [["--spec-gamma", "2"], ["--prefix-cache"]])
def test_serve_cli_runs_spec_and_prefix_on_cpu(extra, capsys):
    """The serve CLI takes the flags into the engine and copies the
    reference's report keys; its spec tokens equal plain decode's."""
    argv = ["--device", "cpu", "--arch", "gemma3-1b", "--batch", "2", "--prompt-len", "32",
            "--gen", "8"]
    report = serve.main(argv + extra)
    assert json.loads(capsys.readouterr().out) == report
    assert report["generated_tokens"] == 16
    _, plain = serve.run(serve.parse_args(argv))
    _, tokens = serve.run(serve.parse_args(argv + extra))
    assert tokens == plain
    if "--prefix-cache" in extra:
        assert report["prefix_cache"] == {"hits": 0, "misses": 2, "seeded_tokens": 0}
        assert report["compiled_executors"]["harvest_buckets"] == 1
    else:
        spec = report["speculative"]
        assert spec["gamma"] == 2 and spec["draft_layers"] == 1 and spec["drafted"] > 0
        assert report["compiled_executors"]["spec_buckets"] == 1


def test_loadgen_cli_runs_on_cpu(tmp_path, capsys):
    path = tmp_path / "trace.json"
    rep = LG.main(["--device", "cpu", "--requests", "4", "--rate", "100", "--prefix-cache",
                   "--save-trace", str(path)])
    assert json.loads(capsys.readouterr().out) == rep
    assert rep["requests"] == 4 and rep["generated_tokens"] == 32 and rep["device"] == "cpu"
    assert rep["engine"]["prefix_cache"]["hits"] + rep["engine"]["prefix_cache"]["misses"] == 4
    again = LG.main(["--device", "cpu", "--trace", str(path), "--spec-gamma", "1"])
    assert again["requests"] == 4 and again["engine"]["speculative"]["drafted"] > 0
    assert LG.parse_args([]).device == "cuda"
