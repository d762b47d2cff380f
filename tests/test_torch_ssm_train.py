"""The port's train path of the ssm and hybrid families against the JAX package's.

falcon-mamba-7b (Mamba-1), zamba2-2.7b (Mamba-2 super-blocks with one shared
attention block) at their smoke widths, the reference engine tests' ``hyb``
config, and ``hyb3`` (``hyb`` with 3 layers in super-blocks of 2, so one
layer runs past the last shared block). Params come from the reference's
jitted ``init_params``/``HybridModel.init``/``init_llm_params`` and cross as
numpy arrays; token batches from the two packages' ``llm_batch_fn`` (equal
bit for bit). The scan's gradient is ``SSMScan``'s plain backward on the
CPU, where the reference differentiates its ``lax.scan`` with ``jax.grad``.
Tolerances:

* ``backbone_forward``, ``lm_loss`` and their gradients, ``hybrid_grads``:
  the fp32 model tolerance, rtol = atol = 1e-5 (sums taken in another
  order by XLA and by PyTorch);
* compressed messages: survivor masks equal, values within 4·2⁻²³·max|x|
  of their row (XLA contracts the dequantize into one fused multiply-add);
* round, adaptive and CLI losses: rtol 1e-4 (a few steps compound the
  above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JaxModelConfig
from repro.common.config import get_config as jax_get_config
from repro.core.controller import AdaptiveConfig as JaxAdaptiveConfig
from repro.data import synthetic as JS
from repro.launch import steps as JST
from repro.launch import train as JTR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.split_model import llm_hybrid as jax_llm_hybrid
from repro_torch.common.config import ModelConfig, get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.controller import AdaptiveConfig
from repro_torch.data import synthetic as S
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.models.split_model import llm_hybrid

MODEL_TOL = 1e-5
RUN_RTOL = 1e-4
ULP = 2.0 ** -23
HYB = dict(name="hyb", family="hybrid", ssm_state=8, ssm_version=2, ssm_headdim=16,
           hybrid_attn_every=1, sliding_window=16, num_layers=2, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=97)
# one Mamba layer past the last whole super-block
HYB3 = dict(HYB, name="hyb3", num_layers=3, hybrid_attn_every=2)
CONFIGS = ["zamba2-2.7b", "falcon-mamba-7b", "hyb"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(name):
    """(reference config, port config) of a smoke config or a test config."""
    if name in ("hyb", "hyb3"):
        kw = HYB if name == "hyb" else HYB3
        return JaxModelConfig(**kw), ModelConfig(**kw)
    return jax_get_config(name, smoke=True), get_config(name, smoke=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=MODEL_TOL, atol=MODEL_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _close_trees(got, want, rtol=MODEL_TOL, atol=MODEL_TOL):
    got_leaves, want_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        _close(g.detach().numpy(), w, rtol, atol, msg=f"leaf {i}")


def _models(name):
    """(reference model, port model): ``llm_hybrid(n_tower=1, remat=False)``,
    as both CLIs build it."""
    jcfg, cfg = _configs(name)
    return (jax_llm_hybrid(jcfg, n_tower=1, remat=False),
            llm_hybrid(cfg, n_tower=1, remat=False))


def _flat_params(jmodel, tmodel, seed=0):
    jp = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    return jp, tmodel.params_from_numpy(_np(jp), "cpu")


def _pod_params(jmodel, tmodel, pods, seed=0):
    jp = jax.jit(lambda k: JST.init_llm_params(k, jmodel, n_pods=pods))(jax.random.PRNGKey(seed))
    return jp, ST.params_from_numpy(tmodel, _np(jp))


def _flat_batch(vocab, B=4, S=16, seed=0):
    rng = np.random.RandomState(seed)
    inp = rng.randint(0, vocab, (B, S))
    y = rng.randint(0, vocab, (B, S))
    b = {"x1": inp[:, :S // 2], "x2": inp[:, S // 2:], "y": y}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v.astype(np.int32)) for k, v in b.items()})


# ---------------------------------------------------------------------------
# The model's train path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", CONFIGS + ["hyb3"])
def test_backbone_and_lm_loss_match_reference(name, remat):
    """``backbone_forward`` on embedded inputs and ``lm_loss`` (S = 40: the
    shared block attends over more than its 16- or 32-token window, which
    the train path does not apply), values and gradients, with and without
    remat; no kernel launches on the CPU."""
    jcfg, cfg = _configs(name)
    jp = jax.jit(lambda k: JL.init_params(JT.model_specs(jcfg), k, jnp.float32))(
        jax.random.PRNGKey(1))
    tp = T.params_from_numpy(cfg, _np(jp))
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want_x, _ = jax.jit(lambda p, h: JT.backbone_forward(jcfg, p, h, remat=remat))(
        jp, jnp.asarray(x))
    reset_launch_counts()
    got_x, aux = T.backbone_forward(cfg, tp, torch.from_numpy(x), remat=remat)
    _close(got_x.numpy(), want_x)
    assert float(aux) == 0.0
    assert not launch_counts

    tokens = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(jcfg, p, jb, remat)))(jp)
    got_l, got_g = ST._grads(lambda p: T.lm_loss(cfg, p, tb, remat), tp)
    _close(float(got_l), float(want_l))
    _close_trees(got_g, want_g)
    if cfg.family == "hybrid":  # the shared block's gradient sums its uses
        assert float(torch.abs(got_g["shared_attn"]["attn"]["wq"]).max()) > 0


# ---------------------------------------------------------------------------
# Steps, exchange and runners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_hybrid_grads_match_reference(name):
    jmodel, tmodel = _models(name)
    jp, tp = _flat_params(jmodel, tmodel)
    jb, tb = _flat_batch(_configs(name)[1].vocab_size)
    jstale = jax.jit(JST.make_exchange_step(jmodel))(jp, jb)
    tstale = ST.make_exchange_step(tmodel)(tp, tb)
    _close_trees(tstale, jstale)
    want_loss, want_g = jax.jit(lambda p, s, b: JST.hybrid_grads(jmodel, p, s, b))(jp, jstale, jb)
    got_loss, got_g = ST.hybrid_grads(tmodel, tp, tstale, tb)
    _close(float(got_loss), float(want_loss))
    _close_trees(got_g, want_g)


@pytest.mark.parametrize("name", CONFIGS)
def test_exchange_message_matches_reference(name):
    """k = 0.25, b = 128: the whole {θ0, ζ1, ζ2} message compressed. θ0's
    rows are the same numbers in both packages: values within 4 ulp of the
    row's max |x|; ζ1 and ζ2 come out of the towers, within the model
    tolerance of the row's max |x|. Survivor masks equal."""
    jmodel, tmodel = _models(name)
    jp, tp = _flat_params(jmodel, tmodel)
    jb, tb = _flat_batch(_configs(name)[1].vocab_size)
    plain = jax.jit(JST.make_exchange_step(jmodel))(jp, jb)
    want = jax.jit(JST.make_exchange_step(jmodel, 0.25, 128))(jp, jb)
    got = ST.make_exchange_step(tmodel, 0.25, 128)(tp, tb)
    for key, rel in (("theta0", 4 * ULP), ("z1", MODEL_TOL), ("z2", MODEL_TOL)):
        for g, w, x in zip(tree_leaves(got[key]), jax.tree_util.tree_leaves(want[key]),
                           jax.tree_util.tree_leaves(plain[key])):
            n = w.shape[-1]
            g, w = g.numpy().reshape(-1, n), np.asarray(w).reshape(-1, n)
            x = np.asarray(x).reshape(-1, n)
            np.testing.assert_array_equal(g != 0, w != 0)
            assert (np.abs(g - w) <= rel * np.abs(x).max(axis=-1, keepdims=True)).all(), key


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("name", CONFIGS)
def test_round_runner_matches_reference(name, pods):
    """Two fixed-cadence rounds (P = 4, Q = 2, top-k at k = 0.25) through
    run_fixed: the per-step losses and the final parameters. The exchange
    does not quantize here: the b-level quantizer is discontinuous at its
    rounding boundaries, so the fp32 differences of the two packages' ζ
    flip a code by a whole step (at zamba2 smoke, b = 128: 3 θ0 and 4 ζ2
    survivors of round 2's message), and the rounds part by 2.5e-4. The
    quantized message is held on equal inputs in
    ``test_exchange_message_matches_reference``, and the quantized CLI
    run in ``test_cli_smoke_matches_reference``."""
    jmodel, tmodel = _models(name)
    jcfg, cfg = _configs(name)
    jp, tp = _pod_params(jmodel, tmodel, pods, seed=1)
    jbf = JS.llm_batch_fn(jcfg, 2, 16, n_pods=pods, seed=3)
    tbf = S.llm_batch_fn(cfg, 2, 16, n_pods=pods, seed=3)
    kw = dict(steps=8, P=4, Q=2, lr=0.05, compression_k=0.25, quant_levels=0)
    jp, want = JST.LLMRoundRunner(jmodel, n_pods=pods).run_fixed(jp, jbf, **kw)
    trun = ST.LLMRoundRunner(tmodel, n_pods=pods)
    tp, got = trun.run_fixed(tp, tbf, **kw)
    assert got.shape == (8,) and np.isfinite(got).all()
    _close(got, want, rtol=RUN_RTOL, atol=0)
    _close_trees(tp, jp, rtol=1e-3, atol=1e-5)
    assert len(trun._round_cache) == 1


@pytest.mark.parametrize("name", CONFIGS)
def test_adaptive_runner_matches_reference(name):
    """The §VI loop over the LLM rounds (G = 2, byte budget, seed probe on):
    the same P, Q and rung every round, η within rtol 1e-4, the byte ledger
    exact, the per-step losses within rtol 1e-4."""
    jmodel, tmodel = _models(name)
    jcfg, cfg = _configs(name)
    kw = dict(total_steps=8, byte_budget=1e6, max_interval=4, eta_min=0.01, eta_max=0.05)
    jad = JST.AdaptiveLLMRunner(jmodel, JaxAdaptiveConfig(**kw), n_pods=2, learning_rate=0.05)
    tad = ST.AdaptiveLLMRunner(tmodel, AdaptiveConfig(**kw), n_pods=2, learning_rate=0.05)
    jp, tp = _pod_params(jmodel, tmodel, 2)
    _, want, jhist = jad.run(jp, JS.llm_batch_fn(jcfg, 2, 16, n_pods=2, seed=0))
    _, got, thist = tad.run(tp, S.llm_batch_fn(cfg, 2, 16, n_pods=2, seed=0))
    assert len(thist) == len(jhist) > 1
    for t, j in zip(thist, jhist):
        assert (t["P"], t["Q"], t["rung"]) == (j["P"], j["Q"], j["rung"])
        assert t["eta"] == pytest.approx(j["eta"], rel=RUN_RTOL)
        assert t["bytes_total"] == j["bytes_total"]
    _close(got, want, rtol=RUN_RTOL, atol=0)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "falcon-mamba-7b"])
def test_cli_smoke_matches_reference(arch, pods, monkeypatch):
    """``--arch <arch> --smoke --steps 8 --compression-k 0.25 --quantization
    128``: the port's CLI, started from the reference CLI's initial model
    (the two packages draw weights from other generators), reports the
    reference CLI's losses."""
    argv = ["--arch", arch, "--smoke", "--steps", "8", "--compression-k", "0.25",
            "--quantization", "128", "--pods", str(pods)]
    want = JTR.main(argv)
    jcfg = jax_get_config(arch, smoke=True)
    jp = JST.init_llm_params(jax.random.PRNGKey(0), jax_llm_hybrid(jcfg, n_tower=1, remat=False),
                             n_pods=pods)
    build = TR.build_llm

    def from_reference(args, device):
        cfg, model, _, batch_fn = build(args, device)
        return cfg, model, ST.params_from_numpy(model, _np(jp)), batch_fn

    monkeypatch.setattr(TR, "build_llm", from_reference)
    got, losses = TR.run_llm(TR.parse_args(["--device", "cpu"] + argv))
    assert got["steps"] == want["steps"] == 8 and got["executors_compiled"] == 1
    assert np.isfinite(losses).all()
    for key in ("loss_first", "loss_last"):
        _close(got[key], want[key], rtol=RUN_RTOL, atol=0, msg=key)

