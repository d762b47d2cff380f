"""The port's selective scan and Mamba-1 layer against the JAX package's.

The plain scan (``repro_torch.kernels.ssm_scan.ssm_scan_ref``) is held
against the Pallas kernel run in interpret mode, as ``tests/test_kernels.py``
runs it, and against the reference's oracle ``ref.ssm_scan_ref``, on the
same numpy inputs, within rtol = atol = 1e-5 in fp32 (XLA may contract the
oracle's multiply-add into an FMA; the port rounds the product and the sum
apart, as the kernel does). ``ops.ssm_scan``, ``chunked_linear_recurrence``,
``_chunk_recurrence`` and ``mamba1_forward`` (no state, an f32 state, an
int8 state) are held against the reference's within 1e-5; params come from
the reference's ``init_params`` through ``params_from_numpy``. The scan's
gradient (``SSMScan``, whose CPU backward is ``ssm_scan_bwd_ref``) equals
the plain backward bit for bit, is within 1e-6 of torch autograd through
``ssm_scan_ref`` (the same products and sums, accumulated in another
order) and within 1e-5 of ``jax.grad`` through the reference's
``chunked_linear_recurrence``. The CUDA kernels against the plain versions,
bit for bit, run only on the card (``gpu`` marker). Mamba-2 (zamba2's SSD heads) is held in
``tests/test_torch_hybrid.py``. Mamba-1's discretization route
(``ops.mamba1_discretize``) takes the eager chain on the CPU and on meta
tensors, so a layer's outputs, gradients and FLOP count are the chain's bit
for bit; its kernels are held against the chain on the card in
``tests/test_torch_discretize.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import layers as JL
from repro.models import quant as JQ
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.common.config import get_config
from repro_torch.kernels import build, launch_counts, ops, reset_launch_counts
from repro_torch.kernels import mamba1_discretize as MD
from repro_torch.launch.flops import traced_flops
from repro_torch.kernels.ssm_scan import (SSMScan, ssm_scan, ssm_scan_bwd_cuda,
                                          ssm_scan_bwd_ref, ssm_scan_cuda, ssm_scan_ref)
from repro_torch.models import quant as Q
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

TOL = 1e-5
SCAN_SHAPES = [(2, 100, 50), (1, 256, 128), (3, 37, 7), (2, 512, 200)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _scan_inputs(shape, kind, seed=0):
    """a, b [B, T, C] and h0 [B, C] from numpy: ``sigmoid`` decays in (0, 1),
    ``strong`` decays of 1e-6..1e-2 (a ≪ 1), ``tail`` the sigmoid inputs
    whose last third is a = 1, b = 0 (what the TPU kernel pads with)."""
    B, T, C = shape
    rng = np.random.default_rng(seed + B * T * C)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
    if kind == "strong":
        a = 10.0 ** rng.uniform(-6, -2, shape)
    b = rng.standard_normal(shape)
    if kind == "tail":
        a[:, 2 * T // 3:] = 1.0
        b[:, 2 * T // 3:] = 0.0
    h0 = rng.standard_normal((B, C))
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("kind", ["sigmoid", "strong", "tail"])
def test_plain_scan_matches_pallas_and_oracle(shape, kind):
    a, b, h0 = _scan_inputs(shape, kind)
    hs, hl = ssm_scan_ref(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    assert hs.dtype == torch.float32 and hl.dtype == torch.float32
    want = ssm_scan_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), block_t=64,
                           block_c=64, interpret=True)
    oracle = jax_ref.ssm_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    for w_hs, w_hl in (want, oracle):
        _close(hs.numpy(), w_hs)
        _close(hl.numpy(), w_hl)
    if kind == "tail":  # a = 1, b = 0 carries the state through exactly
        T = shape[1]
        assert torch.equal(hs[:, -1], hs[:, 2 * T // 3 - 1]) and torch.equal(hs[:, -1], hl)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
def test_plain_scan_bf16_matches_oracle(h_dtype):
    """bf16 a and b (read into fp32), hs in bf16 and h_last in h0's type,
    against the oracle on the same bf16 values: within one bf16 rounding."""
    a, b, h0 = _scan_inputs((2, 100, 50), "sigmoid")
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[h_dtype]
    ja, jb, jh = (jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                  jnp.asarray(h0, jdt))
    ta, tb, th = (torch.from_numpy(np.array(x, np.float32)) for x in (ja, jb, jh))
    hs, hl = ssm_scan_ref(ta.bfloat16(), tb.bfloat16(), th.to(h_dtype))
    assert hs.dtype == torch.bfloat16 and hl.dtype == h_dtype
    w_hs, w_hl = jax_ref.ssm_scan_ref(ja, jb, jh)
    _close(hs.float().numpy(), np.asarray(w_hs, np.float32), 1e-2)
    _close(hl.float().numpy(), np.asarray(w_hl, np.float32), 1e-2)


def test_router_takes_the_plain_version_on_the_cpu():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs((2, 37, 7), "sigmoid"))
    reset_launch_counts()
    got, want = ssm_scan(a, b, h0), ssm_scan_ref(a, b, h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts["ssm_scan"] == 0


@pytest.mark.parametrize("trail", [(8, 4), (3, 5, 2)])
def test_ops_scan_folds_trailing_dims_like_reference(trail):
    B, T = 2, 64
    rng = np.random.default_rng(len(trail))
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T) + trail)))).astype(np.float32)
    b = rng.standard_normal((B, T) + trail).astype(np.float32)
    h0 = rng.standard_normal((B,) + trail).astype(np.float32)
    hs, hl = ops.ssm_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    assert tuple(hs.shape) == (B, T) + trail and tuple(hl.shape) == (B,) + trail
    w_hs, w_hl = jax_ops.ssm_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    _close(hs.numpy(), w_hs)
    _close(hl.numpy(), w_hl)


@pytest.mark.parametrize("T", [1, 130, 256, 300])
def test_chunked_recurrence_matches_reference(T):
    """Chunks of min(256, T) steps, the last padded with a = 1, b = 0; with
    and without a per-chunk projection."""
    B, C, N = 2, 17, 3
    rng = np.random.default_rng(T)
    a = (np.exp(-np.abs(rng.standard_normal((B, T, C, N))))).astype(np.float32)
    b = rng.standard_normal((B, T, C, N)).astype(np.float32)
    h0 = rng.standard_normal((B, C, N)).astype(np.float32)
    aux = rng.standard_normal((B, T, N)).astype(np.float32)
    ta, tb, th, tx = (torch.from_numpy(x) for x in (a, b, h0, aux))
    ja, jb, jh, jx = (jnp.asarray(x) for x in (a, b, h0, aux))
    hs, hl = S.chunked_linear_recurrence(ta, tb, th)
    w_hs, w_hl = JS.chunked_linear_recurrence(ja, jb, jh)
    assert tuple(hs.shape) == (B, T, C, N)
    _close(hs.numpy(), w_hs)
    _close(hl.numpy(), w_hl)
    ys, yl = S.chunked_linear_recurrence(ta, tb, th, lambda h, c: torch.einsum(
        "bkcn,bkn->bkc", h, c), tx)
    w_ys, w_yl = JS.chunked_linear_recurrence(ja, jb, jh, lambda h, c: jnp.einsum(
        "bkcn,bkn->bkc", h, c), jx)
    _close(ys.numpy(), w_ys)
    _close(yl.numpy(), w_yl)
    K = min(T, 256)
    ch, cl = S._chunk_recurrence(ta[:, :K], tb[:, :K], th)
    w_ch, w_cl = JS._chunk_recurrence(ja[:, :K], jb[:, :K], jh)
    _close(ch.numpy(), w_ch)
    _close(cl.numpy(), w_cl)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    st = rng.standard_normal((2, 3, 10)).astype(np.float32)
    for state in (None, st):
        got = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                             None if state is None else torch.from_numpy(state))
        want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                               None if state is None else jnp.asarray(state))
        for g, wv in zip(got, want):
            _close(g.numpy(), wv)


# ---------------------------------------------------------------------------
# Mamba-1 layer
# ---------------------------------------------------------------------------


_PARAMS = {}


def _layer_params():
    """Layer 0's mamba params of falcon-mamba-7b smoke, from one reference
    draw of the whole model, carried over by ``params_from_numpy``."""
    if not _PARAMS:
        jcfg, cfg = jax_get_config("falcon-mamba-7b", True), get_config("falcon-mamba-7b", True)
        jp = jax.jit(lambda k: JL.init_params(JT.model_specs(jcfg), k, jnp.float32))(
            jax.random.PRNGKey(0))
        tp = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
        _PARAMS["p"] = (jcfg, cfg, jax.tree.map(lambda v: v[0], jp["layers"])["mamba"],
                        T.layer_params(tp["layers"], 0)["mamba"])
    return _PARAMS["p"]


@pytest.mark.parametrize("state", ["none", "f32", "int8"])
@pytest.mark.parametrize("T_len", [1, 37, 300])
def test_mamba1_forward_matches_reference(state, T_len):
    jcfg, cfg, jp, tp = _layer_params()
    B, D = 2, cfg.d_model
    d_in, N = cfg.ssm_expand * D, cfg.ssm_state
    rng = np.random.default_rng(T_len)
    x = rng.standard_normal((B, T_len, D)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, d_in)).astype(np.float32)
    h = rng.standard_normal((B, d_in, N)).astype(np.float32)
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
    got, gst = S.mamba_forward(tp, torch.from_numpy(x), cfg, tst)
    want, wst = JS.mamba_forward(jp, jnp.asarray(x), jcfg, jst)
    _close(got.numpy(), want)
    if state == "none":
        assert gst is None and wst is None
    elif state == "f32":
        for g, w in zip(gst, wst):
            _close(g.numpy(), w)
    else:
        assert [g.dtype for g in gst] == [torch.int8, torch.int8, torch.float32, torch.float32]
        for g, w in zip(gst[:2], wst[:2]):  # codes: a last-bit difference may flip a rounding
            assert np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32)).max() <= 1
        for g, w in zip(gst[2:], wst[2:]):
            _close(g.numpy(), w)
        _close(Q.dequantize_rows(gst[1], gst[3]).numpy(),
               JQ.dequantize_rows(wst[1], wst[3]), 2 * float(np.max(np.asarray(wst[3]))))


def test_state_specs_match_reference():
    jcfg, cfg = jax_get_config("falcon-mamba-7b", True), get_config("falcon-mamba-7b", True)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        shapes, axes = S.mamba_state_specs(cfg, 3, dt)
        jshapes, jaxes = JS.mamba_state_specs(jcfg, 3, jdt)
        assert [tuple(s.shape) for s in shapes] == [s.shape for s in jshapes]
        assert [str(s.dtype).split(".")[-1] for s in shapes] == [str(s.dtype) for s in jshapes]
        assert axes == jaxes
    assert S.mamba_specs(cfg).keys() == JS.mamba_specs(jcfg).keys()
    for k, spec in S.mamba_specs(cfg).items():
        js = JS.mamba_specs(jcfg)[k]
        assert (spec.shape, spec.axes, spec.init, spec.scale) == (js.shape, js.axes, js.init,
                                                                  js.scale)


# ---------------------------------------------------------------------------
# The scan's gradient
# ---------------------------------------------------------------------------


def _grad_inputs(shape, kind, with_last, seed=0):
    """Scan inputs that require grad, and output gradients: d_hs [B, T, C]
    and d_last [B, C] (None: h_last unused)."""
    a, b, h0 = (torch.from_numpy(x).requires_grad_() for x in _scan_inputs(shape, kind, seed))
    rng = np.random.default_rng(seed + 1)
    d_hs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    d_last = (torch.from_numpy(rng.standard_normal((shape[0], shape[2])).astype(np.float32))
              if with_last else None)
    return a, b, h0, d_hs, d_last


@pytest.mark.parametrize("with_last", [True, False])
@pytest.mark.parametrize("kind", ["sigmoid", "strong"])
@pytest.mark.parametrize("T_len", [1, 37, 300])
def test_scan_gradient_matches_plain_autograd_and_reference(T_len, kind, with_last):
    """SSMScan's CPU gradients equal ssm_scan_bwd_ref's (a missing ∂h_last is
    zeros), are within 1e-6 of torch autograd through ssm_scan_ref, and the
    gradient of the chunked recurrence (T = 300: two chunks, so the carried
    h_last gets a gradient) is within 1e-5 of jax.grad through the
    reference's."""
    a, b, h0, d_hs, d_last = _grad_inputs((2, T_len, 6), kind, with_last)
    outs = ssm_scan(a, b, h0)
    got = torch.autograd.grad(outs if with_last else outs[0],
                              (a, b, h0), (d_hs, d_last) if with_last else d_hs)
    hs = outs[0].detach()
    want = ssm_scan_bwd_ref(a.detach(), h0.detach(), hs, d_hs,
                            d_last if with_last else torch.zeros_like(h0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plain = ssm_scan_ref(a, b, h0)
    auto = torch.autograd.grad(plain if with_last else plain[0],
                               (a, b, h0), (d_hs, d_last) if with_last else d_hs)
    for g, w in zip(got, auto):
        _close(g.numpy(), w.numpy(), 1e-6)

    def port_loss(a, b, h0):
        hs, hl = S.chunked_linear_recurrence(a, b, h0)
        loss = torch.sum(hs * d_hs)
        return loss + torch.sum(hl * d_last) if with_last else loss

    def ref_loss(a, b, h0):
        hs, hl = JS.chunked_linear_recurrence(a, b, h0)
        loss = jnp.sum(hs * jnp.asarray(d_hs.numpy()))
        return loss + jnp.sum(hl * jnp.asarray(d_last.numpy())) if with_last else loss

    got = torch.autograd.grad(port_loss(a, b, h0), (a, b, h0))
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x.detach().numpy()) for x in (a, b, h0)))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_scan_gradient_takes_float32_only():
    """bf16 inputs that require grad raise (no cast); bf16 without grad, the
    serving path, runs."""
    a, b, h0 = (torch.from_numpy(x).bfloat16() for x in _scan_inputs((2, 8, 4), "sigmoid"))
    with pytest.raises(TypeError, match="float32 only"):
        ssm_scan(a.requires_grad_(), b, h0)
    hs, hl = ssm_scan(a.detach(), b, h0)
    assert hs.dtype == torch.bfloat16 and not hs.requires_grad


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def test_cuda_wrapper_refuses_what_it_does_not_take():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs((2, 8, 4), "sigmoid"))
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(a, b, h0)
    with pytest.raises(ValueError, match="rank 3"):
        ssm_scan_cuda(a[0], b[0], h0[0])


@pytest.mark.parametrize("d_in,N", [(16, 4), (64, 16)])
@pytest.mark.parametrize("T_len", [1, 37, 256, 300])
def test_discretize_route_is_the_chain_on_the_cpu(T_len, d_in, N):
    """On the CPU ``ops.mamba1_discretize`` is ``mamba1_discretize_ref``, the
    eager chain: a, b and the gradients of dt, x, B and A bit for bit, with
    no kernel launched. A Mamba-1 layer on the CPU, with and without a
    carried state, is held against the reference in
    ``test_mamba1_forward_matches_reference``."""
    B = 2
    g = torch.Generator().manual_seed(T_len)
    raw = (torch.rand(B, T_len, d_in, generator=g), torch.randn(B, T_len, d_in, generator=g),
           torch.randn(B, T_len, N, generator=g), -torch.exp(torch.randn(d_in, N, generator=g)))
    cots = (torch.randn(B, T_len, d_in, N, generator=g),
            torch.randn(B, T_len, d_in, N, generator=g))
    reset_launch_counts()
    outs = []
    for fn in (ops.mamba1_discretize, MD.mamba1_discretize_ref):
        leaves = [t.clone().requires_grad_() for t in raw]
        ab = fn(*leaves)
        outs.append([t.detach() for t in ab] + list(torch.autograd.grad(ab, leaves, cots)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert not launch_counts


def test_discretize_route_on_meta_tensors_takes_the_chain(monkeypatch):
    """Meta tensors take the chain: the route's outputs are meta tensors of
    the chunk's shape, and a Mamba-1 layer's forward-and-backward count in
    ``launch/flops.py`` equals the count with ``mamba1_discretize_ref`` in
    its place, at the cell's widths over one 256-token chunk."""
    cfg = get_config("falcon-mamba-7b")
    dev = torch.device("meta")
    a, b = ops.mamba1_discretize(torch.empty(2, 256, 8192, device=dev),
                                 torch.empty(2, 256, 8192, device=dev),
                                 torch.empty(2, 256, 16, device=dev),
                                 torch.empty(8192, 16, device=dev))
    assert a.is_meta and b.is_meta and a.shape == b.shape == (2, 256, 8192, 16)

    def layer_pass():
        params = {k: torch.empty(spec.shape, device=dev, requires_grad=True)
                  for k, spec in S.mamba_specs(cfg).items()}
        x = torch.empty(2, 256, cfg.d_model, device=dev, requires_grad=True)
        y, _ = S.mamba1_forward(params, x, cfg)
        torch.autograd.grad(y.sum(), [x, *params.values()])

    counts = []
    for fn in (ops.mamba1_discretize, MD.mamba1_discretize_ref):
        monkeypatch.setattr(ops, "mamba1_discretize", fn)
        counts.append(traced_flops(layer_pass))
    assert counts[0] == counts[1] and counts[0].total > counts[0].matmul > 0


@pytest.mark.parametrize("N,layout", [(16, (4, 2)), (8, (4, 1)), (12, (4, 2)), (7, (1, 3)),
                                      (64, (4, 4)), (2, (2, 0))])
def test_discretize_layout_and_refusals(N, layout):
    """The kernels' lanes a row for N (V floats a lane, log2 of the lanes,
    padded to a power of two) and the backward's time steps within 48 KB of
    shared memory; the CUDA wrappers refuse CPU tensors and N past 32 lanes."""
    big = torch.empty(2, 4, 8, N)
    assert MD._layout(N, big) == layout
    steps = MD._bwd_steps(N)
    assert 1 <= steps <= 32 and 4 * 8 * steps * N <= 48 * 1024
    dt, x, Bm, A = torch.rand(2, 4, 8), torch.rand(2, 4, 8), torch.rand(2, 4, N), torch.rand(8, N)
    with pytest.raises(ValueError, match="CUDA"):
        MD.mamba1_discretize_cuda(dt, x, Bm, A)
    with pytest.raises(ValueError, match="CUDA"):
        MD.mamba1_discretize_bwd_cuda(big, big, dt, x, Bm, A)
    with pytest.raises(ValueError, match="N up to"):
        MD._layout(129, torch.empty(1))


def test_discretize_source_builds_for_hopper():
    cmd = " ".join(build.nvcc_command(build.CSRC / "mamba1_discretize.cu", "/dev/null"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert {"mamba1_discretize_fwd", "mamba1_discretize_bwd",
            "cuda_error_string"} == set(build.SIGNATURES["mamba1_discretize"])
    src = (build.CSRC / "mamba1_discretize.cu").read_text()
    assert "__fmul_rn" in src and "__fadd_rn" in src and "expf(" in src
    assert not re.search(r"\batomic\w*\s*\(", src)  # deterministic sums: no atomics
    kernels = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\s+(\w+)", src)
    assert kernels == ["mamba1_discretize_fwd_kernel", "mamba1_discretize_bwd_kernel",
                       "mamba1_discretize_sum_kernel"]
    # the benchmark's readers find the scan and compress kernels by these names
    assert not any(bad in k for k in kernels
                   for bad in ("ssm_scan_kernel", "ssm_scan_bwd_kernel", "compress_"))


def test_scan_source_builds_for_hopper():
    cmd = " ".join(build.nvcc_command(build.CSRC / "ssm_scan.cu", "/dev/null"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert {"ssm_scan_fwd", "ssm_scan_bwd"} <= set(build.SIGNATURES["ssm_scan"])
    src = (build.CSRC / "ssm_scan.cu").read_text()
    assert "__fmul_rn" in src and "__fadd_rn" in src
    assert "ssm_scan_bwd_kernel" in src


GPU_CASES = [((2, 256, 131072), torch.float32, torch.float32),
             ((2, 1, 131072), torch.float32, torch.float32),
             ((3, 37, 7), torch.float32, torch.float32),
             ((2, 300, 200), torch.float32, torch.float32),
             ((2, 256, 4096), torch.bfloat16, torch.bfloat16),
             ((3, 37, 7), torch.bfloat16, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,a_dtype,h_dtype", GPU_CASES)
def test_kernel_matches_plain_on_the_card(shape, a_dtype, h_dtype):
    """The CUDA kernel against the plain version on the card: bit-identical
    (torch.equal), ragged C and T = 1 included, in fp32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a, b, h0 = (torch.from_numpy(x).to(dev) for x in _scan_inputs(shape, "sigmoid"))
    a, b, h0 = a.to(a_dtype), b.to(a_dtype), h0.to(h_dtype)
    reset_launch_counts()
    got = ssm_scan(a, b, h0)
    torch.cuda.synchronize()
    assert launch_counts["ssm_scan"] == 1
    want = ssm_scan_ref(a, b, h0)
    assert got[0].dtype == a_dtype and got[1].dtype == h_dtype
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_scan_refuses_inputs_that_require_grad():
    """The raw forward kernel's outputs carry no gradient: under grad mode it
    refuses inputs that require one and names the autograd route; with
    grad off it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a, b, h0 = (torch.from_numpy(x).to(dev) for x in _scan_inputs((2, 37, 7), "sigmoid"))
    with pytest.raises(RuntimeError, match="SSMScan"):
        ssm_scan_cuda(a.requires_grad_(), b, h0)
    with torch.no_grad():
        hs, _ = ssm_scan_cuda(a, b, h0)
    assert not hs.requires_grad


BWD_GPU_CASES = [((2, 64, 327680), "sigmoid", True), ((2, 32, 327680), "sigmoid", False),
                 ((2, 64, 131072), "sigmoid", True), ((2, 1, 4096), "sigmoid", True),
                 ((3, 37, 7), "sigmoid", True), ((2, 300, 200), "strong", False),
                 ((2, 45, 300), "tail", True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,with_last", BWD_GPU_CASES)
def test_backward_kernel_matches_plain_on_the_card(shape, kind, with_last):
    """The backward kernel against ssm_scan_bwd_ref on the card, bit for bit,
    directly and as SSMScan's gradient through torch.autograd.grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a, b, h0, d_hs, d_last = (None if x is None else x.detach().to(dev)
                              for x in _grad_inputs(shape, kind, with_last))
    d_last = torch.zeros_like(h0) if d_last is None else d_last
    hs = ssm_scan_ref(a, b, h0)[0]
    reset_launch_counts()
    got = ssm_scan_bwd_cuda(a, h0, hs, d_hs, d_last)
    torch.cuda.synchronize()
    assert launch_counts["ssm_scan_bwd"] == 1
    want = ssm_scan_bwd_ref(a, h0, hs, d_hs, d_last)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    leaves = [x.requires_grad_() for x in (a, b, h0)]
    auto = torch.autograd.grad(SSMScan.apply(*leaves), leaves, (d_hs, d_last))
    for g, w in zip(auto, want):
        assert torch.equal(g, w)
