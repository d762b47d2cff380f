"""The port's LLM-scale hybrid federation against the JAX package's.

Params come from the reference's jitted ``init_params``/``HybridModel.init``/
``init_llm_params`` and cross as numpy arrays; batches from the two
packages' ``llm_batch_fn`` (equal bit for bit). Tolerances:

* token streams and batches: exact;
* forward, losses and gradients: fp32 rtol 1e-5 / atol 1e-6 (sums taken in
  another order by XLA and by PyTorch);
* compressed messages: the survivor masks are equal and the values agree
  within 4·2⁻²³·max|x| of their row (XLA contracts the dequantize into one
  fused multiply-add, the port rounds twice, as its kernel does);
* round losses: rtol 1e-4 (a few steps compound the above).

The compress repair: a message whose rows are wider than one block's
shared memory compresses group by group, each group equal to compressing
its leaves one by one.
"""
import dataclasses
import gc
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.common.config import ModelConfig as JaxModelConfig
from repro.common.config import get_config as jax_get_config
from repro.core.controller import AdaptiveConfig as JaxAdaptiveConfig
from repro.data import synthetic as JS
from repro.kernels.compress import compress_pytree as jax_compress_pytree
from repro.launch import steps as JST
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.split_model import llm_hybrid as jax_llm_hybrid
from repro_torch.common.config import ModelConfig, get_config
from repro_torch.common import pytree
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core.compression import compress_rows_ref
from repro_torch.core.controller import AdaptiveConfig
from repro_torch.data import synthetic as S
from repro_torch.kernels import compress as K
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.compress_cases import edge_case_rows, same_values
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.split_model import llm_hybrid

TINY = dict(name="tiny-test", family="dense", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=1, d_ff=64, vocab_size=64, mlp="swiglu", dtype="float32")
ULP = 2.0 ** -23
RTOL, ATOL = 1e-5, 1e-6
# gemma3-1b smoke widths: O(1) activations after sums of 128-512 terms
# taken in another order, as tests/test_torch_serve.py holds this model
MODEL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _close_trees(got, want, rtol=RTOL, atol=ATOL):
    got_leaves, want_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        _close(g.detach().numpy(), w, rtol, atol, msg=f"leaf {i}")


def _tiny():
    """(reference model, port model) of the reference tests' tiny config."""
    return (jax_llm_hybrid(JaxModelConfig(**TINY), n_tower=1, remat=False),
            llm_hybrid(ModelConfig(**TINY), n_tower=1, remat=False))


def _flat_params(jmodel, tmodel, seed=0):
    """(reference flat params, port flat params) from one reference draw."""
    jp = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    return jp, tmodel.params_from_numpy(_np(jp), "cpu")


def _pod_params(jmodel, tmodel, pods, seed=0):
    jp = jax.jit(lambda k: JST.init_llm_params(k, jmodel, n_pods=pods))(jax.random.PRNGKey(seed))
    return jp, ST.params_from_numpy(tmodel, _np(jp))


def _flat_batch(vocab, B=4, S=8, seed=0):
    rng = np.random.RandomState(seed)
    inp = rng.randint(0, vocab, (B, S))
    y = rng.randint(0, vocab, (B, S))
    b = {"x1": inp[:, :S // 2], "x2": inp[:, S // 2:], "y": y}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v.astype(np.int32)) for k, v in b.items()})


def _assert_messages_close(got, want, plain):
    """Survivor masks equal; values within 4 ulp of the row's max |x|."""
    for g, w, x in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(plain)):
        n = w.shape[-1]
        g, w = g.numpy().reshape(-1, n), np.asarray(w).reshape(-1, n)
        x = np.asarray(x).reshape(-1, n)
        np.testing.assert_array_equal(g != 0, w != 0)
        tol = 4 * ULP * np.abs(x).max(axis=-1, keepdims=True)
        assert (np.abs(g - w) <= tol).all()


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_token_stream_and_batches_match_reference():
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for want, got in zip(JS.token_stream(a, 97, 3, 11), S.token_stream(b, 97, 3, 11)):
        np.testing.assert_array_equal(got, want)
    cfg = get_config("gemma3-1b", smoke=True)
    jbf = JS.llm_batch_fn(jax_get_config("gemma3-1b", smoke=True), 2, 16, n_pods=2, seed=5)
    tbf = S.llm_batch_fn(cfg, 2, 16, n_pods=2, seed=5)
    for lam in (2, 1, 3):
        want, got = jbf(0, lam), tbf(0, lam)
        assert set(got) == set(want) == {"x1", "x2", "y"}
        for k in want:
            assert got[k].dtype == torch.int32 and tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# The train path of the transformer
# ---------------------------------------------------------------------------


# gemma3-1b keeps its cases' ids; the other dense configs' ids lead with
# their name
FORWARD_CASES = [pytest.param("gemma3-1b", remat, blockwise, id=f"{blockwise}-{remat}")
                 for remat in (False, True) for blockwise in (False, True)] + [
    pytest.param(arch, remat, blockwise, id=f"{arch}-{blockwise}-{remat}")
    for arch in ("stablelm-1.6b", "gemma3-4b", "nemotron-4-15b")
    for remat in (False, True) for blockwise in (False, True)]


@pytest.mark.parametrize("arch,remat,blockwise", FORWARD_CASES)
def test_forward_and_losses_match_reference(arch, remat, blockwise, monkeypatch):
    """forward, chunked_lm_head_loss (S = 40 against a chunk of 16, so the
    last chunk is padded with -1 labels) and lm_loss at the dense configs'
    smoke widths (gemma3-1b: window 32 < S, qk-norm, GeGLU; stablelm-1.6b:
    layernorm; gemma3-4b; nemotron-4-15b: squared ReLU, an untied head),
    values and gradients, with and without remat; ``blockwise`` lowers
    BLOCKWISE_THRESHOLD to 16 in both packages, so the online-softmax
    branch is the one differentiated."""
    monkeypatch.setattr(JT, "CE_CHUNK", 16)
    monkeypatch.setattr(T, "CE_CHUNK", 16)
    if blockwise:
        monkeypatch.setattr(JA, "BLOCKWISE_THRESHOLD", 16)
        monkeypatch.setattr(A, "BLOCKWISE_THRESHOLD", 16)
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.jit(lambda k: JL.init_params(JT.model_specs(jcfg), k, jnp.float32))(
        jax.random.PRNGKey(1))
    tp = T.params_from_numpy(cfg, _np(jp))
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    labels[0, -3:] = -1  # padding labels inside the sequence too
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}

    want_h, _ = jax.jit(lambda p: JT.forward(jcfg, p, jb["tokens"], remat=remat))(jp)
    got_h, aux = T.forward(cfg, tp, tb["tokens"], remat=remat)
    _close(got_h.numpy(), want_h, MODEL_TOL, MODEL_TOL)
    assert float(aux) == 0.0
    logits = rng.standard_normal((2, 40, cfg.vocab_size)).astype(np.float32) * 3
    _close(float(T.cross_entropy(torch.from_numpy(logits), tb["labels"].clamp_min(0), 0.1)),
           float(JT.cross_entropy(jnp.asarray(logits), jnp.maximum(jb["labels"], 0), 0.1)))

    hidden = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda t: JT.chunked_lm_head_loss(jcfg, t["p"], t["h"], jb["labels"], remat)))(
        {"p": jp, "h": jnp.asarray(hidden)})
    got_l, got_g = ST._grads(
        lambda t: T.chunked_lm_head_loss(cfg, t["p"], t["h"], tb["labels"], remat),
        {"p": tp, "h": torch.from_numpy(hidden)})
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g, MODEL_TOL, MODEL_TOL)

    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(jcfg, p, jb, remat)))(jp)
    got_l, got_g = ST._grads(lambda p: T.lm_loss(cfg, p, tb, remat), tp)
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g, MODEL_TOL, MODEL_TOL)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def test_hybrid_grads_and_step_stats_match_reference():
    jmodel, tmodel = _tiny()
    jp, tp = _flat_params(jmodel, tmodel)
    jb, tb = _flat_batch(64)
    jstale = jax.jit(JST.make_exchange_step(jmodel))(jp, jb)
    tstale = ST.make_exchange_step(tmodel)(tp, tb)
    _close_trees(tstale, jstale)
    want_loss, want_g = jax.jit(lambda p, s, b: JST.hybrid_grads(jmodel, p, s, b))(jp, jstale, jb)
    got_loss, got_g = ST.hybrid_grads(tmodel, tp, tstale, tb)
    _close(float(got_loss), float(want_loss))
    _close_trees(got_g, want_g)

    want_p, want_loss, want_aux = jax.jit(JST.make_hsgd_step_stats(jmodel, 2))(
        jp, jstale, jb, jnp.float32(0.05))
    got_p, got_loss, got_aux = ST.make_hsgd_step_stats(tmodel, 2)(
        tree_map(torch.clone, tp), tstale, tb, 0.05)
    _close(float(got_loss), float(want_loss))
    _close_trees(got_p, want_p)
    _close_trees(got_aux["gbar"], want_aux["gbar"])
    for key in ("gnorm2", "delta2"):
        _close(float(got_aux[key]), float(want_aux[key]), msg=key)
    # the probe step's update is the plain step's
    plain_p, plain_loss = ST.make_hsgd_train_step(tmodel)(tree_map(torch.clone, tp), tstale, tb,
                                                          0.05)
    _close_trees(plain_p, _np(want_p), rtol=1e-4)
    with pytest.raises(ValueError, match="divisible by n_shards"):
        ST.make_hsgd_step_stats(tmodel, 3)(tp, tstale, tb, 0.05)


def test_tree_unflatten_frees_its_leaves_without_the_cyclic_collector(monkeypatch):
    """With the cyclic garbage collector off, an exchange (k = 0.25, b = 128)
    and ``hybrid_grads`` at gemma3-1b smoke widths free, on return, every
    tensor they handed ``tree_unflatten`` (the detached leaves, the
    gradients, the messages) except the caller's own parameters and batch:
    ``tree_unflatten`` forms no reference cycle."""
    seen = []
    real = pytree.tree_unflatten

    def recording(treedef, leaves):
        seen.extend(weakref.ref(x) for x in leaves if isinstance(x, torch.Tensor))
        return real(treedef, leaves)

    for mod in [m for name, m in sys.modules.items() if name.startswith("repro_torch")]:
        if getattr(mod, "tree_unflatten", None) is real:
            monkeypatch.setattr(mod, "tree_unflatten", recording)
    cfg = get_config("gemma3-1b", smoke=True)
    model = llm_hybrid(cfg, n_tower=1, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    _, batch = _flat_batch(cfg.vocab_size, S=16)
    held = {id(x) for x in tree_leaves(params) + list(batch.values())}
    gc.collect()
    gc.disable()
    try:
        stale = ST.make_exchange_step(model, 0.25, 128)(params, batch)
        loss, grads = ST.hybrid_grads(model, params, stale, batch)
        assert torch.isfinite(loss)
        del stale, loss, grads
        alive = [r() for r in seen if r() is not None and id(r()) not in held]
    finally:
        gc.enable()
    assert len(seen) > 3 * len(held)
    assert not alive, f"{len(alive)} of {len(seen)} tensors handed to tree_unflatten stay alive"


def test_exchange_step_matches_reference():
    """k = 0.25, b = 128: the whole {θ0, ζ1, ζ2} message compressed, θ0
    included, as the reference compresses it; the uncompressed exchange
    snapshots θ0 (a copy: the steps update params in place)."""
    jmodel, tmodel = _tiny()
    jp, tp = _flat_params(jmodel, tmodel)
    jb, tb = _flat_batch(64)
    plain = jax.jit(JST.make_exchange_step(jmodel))(jp, jb)
    want = jax.jit(JST.make_exchange_step(jmodel, 0.25, 128))(jp, jb)
    got = ST.make_exchange_step(tmodel, 0.25, 128)(tp, tb)
    _assert_messages_close(got, want, plain)
    snap = ST.make_exchange_step(tmodel)(tp, tb)
    for a, b in zip(tree_leaves(snap["theta0"]), tree_leaves(tp["theta0"])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_global_agg_and_param_layout_match_reference():
    jmodel, tmodel = _tiny()
    jp, tp = _pod_params(jmodel, tmodel, pods=2)
    rng = np.random.RandomState(0)
    noisy = jax.tree.map(lambda x: x + rng.standard_normal(x.shape).astype(np.float32), _np(jp))
    w = np.array([0.25, 0.75], np.float32)
    for weights in (None, w):
        want = jax.jit(JST.make_global_agg())(noisy, None if weights is None else jnp.asarray(w))
        got = ST.make_global_agg()(ST.params_from_numpy(tmodel, noisy),
                                   None if weights is None else torch.from_numpy(w))
        _close_trees(got, want)
    _close_trees(ST.global_llm_params(tp), JST.global_llm_params(jp))
    bad = _np(jp)
    bad["theta0"]["head"]["w"] = bad["theta0"]["head"]["w"][:1]  # one pod of two
    with pytest.raises(ValueError, match="one G"):
        ST.params_from_numpy(tmodel, bad)


@pytest.mark.parametrize("pods", [1, 2])
def test_round_runner_matches_reference(pods):
    """Two rounds (P = 4, Q = 2, k = 0.25, b = 128): G = 1 through
    run_fixed, G = 2 through round_fn with semi-async pod weights."""
    jmodel, tmodel = _tiny()
    jp, tp = _pod_params(jmodel, tmodel, pods, seed=1)
    cfg = ModelConfig(**TINY)
    jbf = JS.llm_batch_fn(JaxModelConfig(**TINY), 4, 8, n_pods=pods, seed=3)
    tbf = S.llm_batch_fn(cfg, 4, 8, n_pods=pods, seed=3)
    jrun, trun = JST.LLMRoundRunner(jmodel, n_pods=pods), ST.LLMRoundRunner(tmodel, n_pods=pods)
    if pods == 1:
        jp, want = jrun.run_fixed(jp, jbf, steps=8, P=4, Q=2, lr=0.05, compression_k=0.25,
                                  quant_levels=128)
        tp, got = trun.run_fixed(tp, tbf, steps=8, P=4, Q=2, lr=0.05, compression_k=0.25,
                                 quant_levels=128)
    else:
        w = np.array([0.3, 0.7], np.float32)
        jfn = jrun.round_fn(4, 2, 0.25, 128, collect_stats=False)
        tfn = trun.round_fn(4, 2, 0.25, 128, collect_stats=False)
        want, got = [], []
        for r in range(2):
            jp, lj = jfn(jp, jbf(r, 2), 0.05, jnp.asarray(w))
            tp, lt = tfn(tp, tbf(r, 2), 0.05, torch.from_numpy(w))
            want.append(np.asarray(lj))
            got.append(lt.numpy())
        want, got = np.concatenate(want), np.concatenate(got)
    assert got.shape == (8,)
    _close(got, want, rtol=1e-4, atol=0)
    _close_trees(tp, jp, rtol=1e-3, atol=1e-5)
    assert len(trun._round_cache) == 1
    with pytest.raises(ValueError, match="multiple of P"):
        trun.run_fixed(tp, tbf, steps=10, P=4, Q=2, lr=0.01)
    with pytest.raises(ValueError, match="multiple of Q"):
        trun.round_fn(4, 3)


def _reference_round_noise(jmodel, jp, jbatches, dp_key, lam, pods, k_frac):
    """The reference's DP noise of one round, in the port's layout: per
    exchange i and pod g the reference draws ``normal(split(fold_in(key, i),
    G)[g], [rows of one pod, widest])`` over its padded per-pod matrix; the
    port stacks the pods leaf by leaf (leaf-major, pods within)."""
    out = []
    for i in range(lam):
        keys = jax.random.split(jax.random.fold_in(dp_key, i), pods)
        per_pod = []
        for g in range(pods):
            pg = jax.tree.map(lambda x: x[g], jp)
            bg = jax.tree.map(lambda x: x[i, g], jbatches)
            msg = JST.make_exchange_step(jmodel)(pg, bg)
            leaves = jax.tree_util.tree_leaves(msg)
            n_max = max(leaf.shape[-1] for leaf in leaves)
            rows = [leaf.size // leaf.shape[-1] for leaf in leaves]
            noise = np.asarray(jax.random.normal(keys[g], (sum(rows), n_max), jnp.float32))
            per_pod.append(np.split(noise, np.cumsum(rows)[:-1]))
        stacked = np.concatenate([per_pod[g][j] for j in range(len(per_pod[0]))
                                  for g in range(pods)])
        out.append(torch.from_numpy(stacked))
    return out


def test_round_fn_dp_matches_reference():
    """One DP round at G = 2 (clip 1, σ 0.5) with the reference's own noise
    rows handed in: the pod-stacked message goes through one compress call
    per exchange and lands on the reference's losses."""
    jmodel, tmodel = _tiny()
    pods, lam = 2, 2
    jp, tp = _pod_params(jmodel, tmodel, pods, seed=2)
    jbatches = JS.llm_batch_fn(JaxModelConfig(**TINY), 4, 8, n_pods=pods, seed=4)(0, lam)
    tbatches = S.llm_batch_fn(ModelConfig(**TINY), 4, 8, n_pods=pods, seed=4)(0, lam)
    dp_key = jax.random.PRNGKey(9)
    noise = _reference_round_noise(jmodel, jp, jbatches, dp_key, lam, pods, 0.25)
    jfn = JST.LLMRoundRunner(jmodel, n_pods=pods).round_fn(4, 2, 0.25, 128, collect_stats=False,
                                                          dp=True)
    runner = ST.LLMRoundRunner(tmodel, n_pods=pods)
    tfn = runner.round_fn(4, 2, 0.25, 128, collect_stats=False, dp=True)
    _, want = jfn(jp, jbatches, 0.05, jnp.float32(1.0), jnp.float32(0.5), dp_key)
    _, got = tfn(tp, tbatches, 0.05, 1.0, 0.5, dp_noise=noise)
    _close(got.numpy(), np.asarray(want), rtol=1e-4, atol=0)
    assert runner.round_fn(4, 2, 0.25, 128, collect_stats=False, dp=True) is tfn
    assert len(runner._round_cache) == 1
    with pytest.raises(ValueError, match="dp_generator or dp_noise"):
        tfn(tp, tbatches, 0.05, 1.0, 0.5)


def test_adaptive_runner_matches_reference():
    """The §VI loop over the LLM rounds (G = 2, byte budget, seed probe on):
    the same P, Q and rung every round, η within rtol 1e-4, the byte ledger
    exact, the per-step losses within rtol 1e-4, one executor a bucket."""
    jmodel, tmodel = _tiny()
    kw = dict(total_steps=12, byte_budget=1e5, max_interval=4, eta_min=0.01, eta_max=0.05)
    jad = JST.AdaptiveLLMRunner(jmodel, JaxAdaptiveConfig(**kw), n_pods=2, learning_rate=0.05)
    tad = ST.AdaptiveLLMRunner(tmodel, AdaptiveConfig(**kw), n_pods=2, learning_rate=0.05)
    jp, tp = _pod_params(jmodel, tmodel, 2)
    _, want, jhist = jad.run(jp, JS.llm_batch_fn(JaxModelConfig(**TINY), 4, 8, n_pods=2, seed=0))
    _, got, thist = tad.run(tp, S.llm_batch_fn(ModelConfig(**TINY), 4, 8, n_pods=2, seed=0))
    assert len(thist) == len(jhist) > 1
    for t, j in zip(thist, jhist):
        assert (t["P"], t["Q"], t["rung"]) == (j["P"], j["Q"], j["rung"])
        assert t["eta"] == pytest.approx(j["eta"], rel=1e-4)
        assert t["bytes_total"] == j["bytes_total"]
    _close(got, want, rtol=1e-4, atol=0)
    buckets = {(h["P"], h["Q"], h["compression_k"], h["quant_levels"]) for h in thist}
    assert len(tad.runner._round_cache) == len(buckets)
    sizes = tad._sizes_of(tp, S.llm_batch_fn(ModelConfig(**TINY), 4, 8, n_pods=2)(0, 1))(0.0, 0)
    want_sizes = jad._sizes_of(jp, JS.llm_batch_fn(JaxModelConfig(**TINY), 4, 8, n_pods=2)(0, 1))(
        0.0, 0)
    assert dataclasses.asdict(sizes) == dataclasses.asdict(want_sizes)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--arch", "gemma3-1b", "--smoke", "--steps", "8", "--compression-k",
       "0.25", "--quantization", "128"]


def test_cli_smoke_matches_runner_and_checkpoint_loads(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = TR.parse_args(CLI + ["--checkpoint", ckpt])
    out, losses = TR.run_llm(args)
    assert out["steps"] == 8 and out["executors_compiled"] == 1
    assert set(out) >= {"arch", "pods", "loss_first", "loss_last", "steps", "wall_s"}
    assert np.isfinite(losses).all()
    _, model, params, batch_fn = TR.build_llm(args, torch.device("cpu"))
    params, want = ST.LLMRoundRunner(model).run_fixed(params, batch_fn, 8, 4, 2, 0.01, 0.25, 128)
    _close(losses, want, rtol=1e-4, atol=0)
    tree, step, _ = jax_load_checkpoint(ckpt)
    assert step == 8
    _close_trees(ST.global_llm_params(params), tree, rtol=0, atol=0)
    assert TR.main(CLI[:-4] + ["--steps", "4"])["steps"] == 4


def test_cli_asks_for_the_card_and_refuses_unported_arches():
    """The CLI runs on the card unless asked for the CPU. --arch admits the
    dense, ssm, hybrid and audio families (falcon-mamba-7b, zamba2-2.7b,
    whisper-medium) and refuses the paper models and an arch absent from
    the port's registry (qwen2-vl-72b)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TR.main(CLI[2:])
    for arch in ("falcon-mamba-7b", "zamba2-2.7b", "whisper-medium"):
        assert TR.parse_args(["--arch", arch]).arch == arch
    for arch in ("paper-cnn", "qwen2-vl-72b"):
        with pytest.raises(SystemExit, match="not ported yet"):
            TR.parse_args(["--arch", arch])
    with pytest.raises(SystemExit):
        TR.parse_args(["--arch", "gemma3-1b", "--dp-clip", "1"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        llm_hybrid(get_config("falcon-mamba-7b", smoke=True).replace(family="vlm"))


# ---------------------------------------------------------------------------
# The compress repair: messages wider than one block's shared memory
# ---------------------------------------------------------------------------


def _wide_message():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 11), "b": (2, 2, 128), "c": (4, 1152), "d": (2, 6912), "e": (2, 70000),
              "f": (5, 128)}
    return {k: (rng.standard_normal(s) * (1 + i)).astype(np.float32)
            for i, (k, s) in enumerate(shapes.items())}


def test_compress_pytree_groups_rows_by_width():
    """Widths {11, 128, 1152, 6912, 70000}: one group of the narrow leaves
    padded to 128, one group a wider width; each group one call, the result
    equal to compressing each leaf alone (torch.equal) and, within the
    module's tolerance, to the reference's compress_pytree, which pads
    every leaf to 70000 columns."""
    msg = _wide_message()
    tmsg = {k: torch.from_numpy(v) for k, v in msg.items()}
    leaves = tree_leaves(tmsg)
    assert [[leaves[i].shape[-1] for i in g] for g in K.row_groups(leaves)] == \
        [[11, 128, 128], [1152], [6912], [70000]]
    calls = []
    route = K.compress_rows

    def counted(x, *a, **kw):
        calls.append(tuple(x.shape))
        return route(x, *a, **kw)

    K.compress_rows = counted
    try:
        got = K.compress_pytree(tmsg, 0.25, 128)
    finally:
        K.compress_rows = route
    assert calls == [(12, 128), (4, 1152), (2, 6912), (2, 70000)]
    for k, v in tmsg.items():
        n = v.shape[-1]
        per_leaf = compress_rows_ref(v.reshape(-1, n), max(1, round(0.25 * n)), 128)
        assert torch.equal(got[k], per_leaf.reshape(v.shape)), k
    want = jax.jit(lambda t: jax_compress_pytree(t, 0.25, 128))(
        {k: jnp.asarray(v) for k, v in msg.items()})
    _assert_messages_close(got, want, msg)


def test_compress_pytree_dp_noise_per_group():
    """DP over a grouped message: one noise matrix per group, each group's
    rows through the DP stage exactly as compress_rows_ref takes them; a
    generator draws group by group; a wrongly shaped noise list raises."""
    tmsg = {k: torch.from_numpy(v) for k, v in _wide_message().items()}
    leaves = tree_leaves(tmsg)
    groups = K.row_groups(leaves)
    stacked = [K.stack_rows([leaves[i] for i in g], 0.25) for g in groups]
    gen = torch.Generator().manual_seed(0)
    noise = [torch.randn(s[0].shape, generator=gen) for s in stacked]
    got = K.compress_pytree(tmsg, 0.25, 128, dp_clip=1.0, dp_sigma=0.5, dp_noise=noise)
    drawn = K.compress_pytree(tmsg, 0.25, 128, dp_clip=1.0, dp_sigma=0.5,
                              dp_generator=torch.Generator().manual_seed(0))
    for (mat, k_rows, len_rows, counts), g, z in zip(stacked, groups, noise):
        want = compress_rows_ref(mat, k_rows, 128, len_rows, 1.0, 0.5, z)
        off = 0
        for i, r in zip(g, counts):
            name = sorted(tmsg)[i]
            n = leaves[i].shape[-1]
            assert torch.equal(got[name], want[off:off + r, :n].reshape(leaves[i].shape)), name
            assert torch.equal(drawn[name], got[name]), name
            off += r
    with pytest.raises(ValueError, match="row groups"):
        K.compress_pytree(tmsg, 0.25, 128, dp_clip=1.0, dp_sigma=0.5, dp_noise=noise[0])
    with pytest.raises(ValueError, match="does not match row group 1"):
        K.compress_pytree(tmsg, 0.25, 128, dp_clip=1.0, dp_sigma=0.5,
                          dp_noise=[noise[0], noise[0]] + noise[2:])


def test_paper_cnn_message_stays_one_group():
    """The main path's message (paper-cnn c-hsgd at the CLI's widths): every
    leaf is at most 128 wide, so it is one group, the [2900, 128] matrix."""
    from repro_torch.core.baselines import make_runner
    from repro_torch.core.hsgd import exchange, init_state

    args = TR.parse_args(["--device", "cpu", "--algorithm", "c-hsgd", "--groups", "10",
                          "--devices", "64", "--samples", "2048"])
    model, fed, train, data, _, _ = TR.setup_ehealth(args, torch.device("cpu"))
    _, eff_fed = make_runner(args.algorithm, model, fed, train)
    state = init_state(torch.Generator().manual_seed(0), model, eff_fed, data)
    state = exchange(model, state, data, eff_fed)
    leaves = tree_leaves({k: state.stale[k] for k in ("theta0", "z1", "z2")})
    groups = K.row_groups(leaves)
    assert len(groups) == 1
    assert tuple(K.stack_rows(leaves, 0.25)[0].shape) == (2900, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [False, True])
def test_wide_body_matches_plain_on_the_card(dp):
    """Both kernels' wide body (rows past 58112 floats) against the plain
    version on the card: the edge-case rows at 58113, 65536 and 262144, and
    a [6, 262144] head-like matrix, levels 0, 16 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [tuple(t.to(dev) for t in edge_case_rows(n)) for n in (58113, 65536, 262144)]
    head = torch.randn((6, 262144), generator=g, device=dev)
    cases.append((head, torch.full((6,), 65536, dtype=torch.int32, device=dev),
                  torch.full((6,), 262144, dtype=torch.int32, device=dev)))
    reset_launch_counts()
    for x, k, ln in cases:
        extra = (torch.tensor(1.0, device=dev), torch.tensor(0.5, device=dev),
                 torch.randn(x.shape, generator=g, device=dev)) if dp else ()
        for lv in (0, 16, 128):
            got = K.fused_compress(x, k, lv, ln, *extra)
            want = compress_rows_ref(x, k, lv, ln, *extra)
            torch.cuda.synchronize()
            assert same_values(got, want), (tuple(x.shape), lv)
    assert launch_counts["fused_compress_dp" if dp else "fused_compress"] == 3 * len(cases)
