"""The port's flash attention against the JAX package's.

The plain version (``repro_torch.kernels.flash_attention.flash_attention_ref``)
is held against the Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it, on the same numpy inputs: rtol and atol
2e-5 in fp32, 2e-2 in bf16 (the JAX package's own tolerances for its
kernel). The GQA wrapper, ``_long_prefill_attention`` and ``gqa_forward``
with a fresh cache are held against the reference's within 1e-5. The CUDA
kernel against the plain version runs only on the card (``gpu`` marker);
its arithmetic is emulated here instead: tile by tile with the kernel's
online softmax, fp32 products as 3xTF32 (hi = rna_tf32(x), lo =
rna_tf32(x - hi), lo.hi + hi.lo + hi.hi in fp32) and bf16 P.V with P
rounded to bf16, held against the Pallas kernel and the plain version
within the same tolerances; one-pass TF32 misses the fp32 tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as JA
from repro.common.config import get_config as jax_get_config
from repro.models import layers as JL
import jax

from repro_torch.common.config import get_config
from repro_torch.kernels import build, launch_counts, ops, reset_launch_counts
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.models import attention as A


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(seed, shape):
    return [_normal(seed + i, shape) for i in range(3)]


@pytest.mark.parametrize("S,D,window", [(128, 64, 0), (200, 32, 0), (256, 64, 32),
                                        (100, 128, 16), (96, 256, 0)])
def test_plain_version_matches_pallas(S, D, window):
    q, k, v = _qkv(S + D, (3, S, D))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, block_q=64, block_k=64, interpret=True)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    routed = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             window=window)
    assert torch.equal(routed, got)


def test_plain_version_bf16_matches_pallas():
    q, k, v = _qkv(7, (2, 128, 64))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("window", [0, 24])
def test_gqa_wrapper_matches_reference(window):
    """``ops.flash_attention`` on [B, S, H, D] with KV repeated from 1 head to 4."""
    B, S, H, D = 2, 96, 4, 32
    q = _normal(0, (B, S, H, D))
    kv = [np.repeat(_normal(s, (B, S, 1, D)), H, axis=2) for s in (1, 2)]
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                       window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                              torch.from_numpy(kv[1]), window=window)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _gqa_params(cfg, seed=0):
    """The reference's GQA params, as numpy."""
    specs = JA.gqa_specs(cfg)
    tree = JL.init_params(specs, jax.random.PRNGKey(seed), jnp.float32)
    return {k: np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("window", [0, 8])
def test_long_prefill_and_fresh_gqa_forward_match_reference(window, monkeypatch):
    """With both packages' threshold at 16, a 64-token fresh block takes the
    long route: ``_long_prefill_attention`` (blockwise on the CPU in both)
    and the whole ``gqa_forward`` with ``fresh_cache=True`` agree within
    1e-5, and the cache the port writes equals the reference's."""
    monkeypatch.setattr(JA, "BLOCKWISE_THRESHOLD", 16)
    monkeypatch.setattr(A, "BLOCKWISE_THRESHOLD", 16)
    jcfg = jax_get_config("gemma3-1b", smoke=True)
    cfg = get_config("gemma3-1b", smoke=True)
    B, S, H, KH, D = 2, 64, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _normal(1, (B, S, H, D)), _normal(2, (B, S, KH, D)), _normal(3, (B, S, KH, D))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = JA._long_prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), D ** -0.5, window)
    got = A._long_prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos), D ** -0.5,
                                    window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    params = _gqa_params(jcfg)
    x = _normal(4, (B, S, cfg.d_model))
    cache_len = 128
    jcache = (jnp.zeros((B, cache_len, KH, D)), jnp.zeros((B, cache_len, KH, D)),
              jnp.full((B, cache_len), np.iinfo(np.int32).max, jnp.int32))
    want_out, want_cache = JA.gqa_forward(
        {k_: jnp.asarray(v_) for k_, v_ in params.items()}, jnp.asarray(x), jnp.asarray(pos),
        jcfg, window=window, kv_cache=jcache, cache_index=jnp.int32(0), fresh_cache=True)
    tcache = tuple(torch.from_numpy(np.asarray(c).copy()) for c in jcache)
    got_out, got_cache = A.gqa_forward(
        {k_: torch.from_numpy(v_) for k_, v_ in params.items()}, torch.from_numpy(x),
        torch.from_numpy(pos), cfg, window=window, kv_cache=tcache, cache_index=0,
        fresh_cache=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for g, w in zip(got_cache, want_cache):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_cuda_wrapper_refuses_what_it_does_not_take():
    x = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)


def test_flash_source_builds_for_hopper():
    cmd = " ".join(build.nvcc_command(build.CSRC / "flash_attention.cu", "/dev/null"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "flash_attention_fwd" in build.SIGNATURES["flash_attention"]
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


GPU_CASES = ([((3, S, D), w, torch.float32) for S, D, w in
              [(128, 64, 0), (200, 32, 0), (256, 64, 32), (100, 128, 16), (96, 256, 0)]]
             + [((8, 512, 256), 100, torch.float32), ((3, 250, 128), 70, torch.float32),
                ((4, 256, 256), 0, torch.bfloat16), ((3, 200, 64), 33, torch.bfloat16)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window,dtype", GPU_CASES)
def test_kernel_matches_plain_on_the_card(shape, window, dtype):
    """The CUDA kernel against the plain version on the card, ragged S and
    bf16 included: within tol + tol·|plain|, tol 2e-5 in fp32 and 2e-2 in
    bf16 (the JAX package's rtol and atol for its kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(x).to(dev, dtype) for x in _qkv(sum(shape), shape))
    reset_launch_counts()
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1
    want = flash_attention_ref(q, k, v, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert bool((err <= tol + tol * want.float().abs()).all()), float(err.max())


# ---- the CUDA kernel's arithmetic, emulated on the CPU ---------------------

def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half a tf32 ulp to the
    bits and clear the 13 low ones."""
    bits = x.detach().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: each operand split into hi and lo, lo.lo dropped,
    the small terms summed first, all in fp32."""
    ah, bh = _rna_tf32(a), _rna_tf32(b)
    al, bl = _rna_tf32(a - ah), _rna_tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _rna_tf32(a) @ _rna_tf32(b)


def _emulate_kernel(q, k, v, window, mm, block_k, p_bf16=False):
    """The kernel's tiling on fp32 tensors [BH, S, D]: 64-row query tiles,
    ``block_k``-key tiles from the window's first one, scores scaled and
    masked with NEG_INF = -2e38, an online softmax (m, l in fp32), P.V with
    P rounded to bf16 where ``p_bf16``; products through ``mm``."""
    BH, S, D = q.shape
    scale = D ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, S, 64):
        rows = torch.arange(q0, min(q0 + 64, S))
        m = torch.full((BH, len(rows), 1), -2e38)
        l = torch.zeros_like(m)
        o = torch.zeros(BH, len(rows), D)
        first = max(0, q0 - window + 1) if window > 0 else 0
        for k0 in range(first // block_k * block_k, int(rows[-1]) + 1, block_k):
            keys = torch.arange(k0, min(k0 + block_k, S))
            s = mm(q[:, rows], k[:, keys].transpose(1, 2)) * scale
            ok = keys[None, :] <= rows[:, None]
            if window > 0:
                ok &= keys[None, :] > rows[:, None] - window
            s = torch.where(ok, s, torch.tensor(-2e38))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l, m = l * corr + p.sum(-1, keepdim=True), m_new
            if p_bf16:
                p = p.to(torch.bfloat16).float()
            o = o * corr + mm(p, v[:, keys])
        out[:, rows] = o / l
    return out


def _within(got, want, tol):
    """The card's criterion: |got - want| <= tol + tol·|want| everywhere."""
    err = (got.float() - want.float()).abs()
    return float((err - tol - tol * want.float().abs()).max())


@pytest.mark.parametrize("S,D,window", [(256, 64, 0), (200, 256, 0), (300, 64, 70),
                                        (129, 256, 33), (65, 128, 100)])
def test_3xtf32_emulation_matches_pallas_and_plain(S, D, window):
    """The fp32 route (3xTF32 products, 32-key tiles) against the Pallas
    kernel in interpret mode and the plain version, within 2e-5."""
    q, k, v = _qkv(3 * S + D + window, (2, S, D))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = _emulate_kernel(tq, tk, tv, window, _mm_3xtf32, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert _within(got, flash_attention_ref(tq, tk, tv, window=window), 2e-5) <= 0


@pytest.mark.parametrize("S,D,window", [(256, 256, 0), (200, 64, 40), (129, 32, 1)])
def test_bf16_emulation_matches_pallas_and_plain(S, D, window):
    """The bf16 route (bf16 inputs, fp32 scores, P rounded to bf16 before
    P.V, 64-key tiles) against the Pallas kernel on bf16 inputs and the
    plain version, within 2e-2."""
    q, k, v = _qkv(5 * S + D + window, (2, S, D))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = _emulate_kernel(tq.float(), tk.float(), tv.float(), window, torch.matmul, 64,
                          p_bf16=True).to(torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, window=window, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    assert _within(got, flash_attention_ref(tq, tk, tv, window=window), 2e-2) <= 0


def test_one_pass_tf32_misses_the_fp32_tolerance():
    """Why the fp32 route splits: the same tiling with one TF32 pass is
    about 50 times over the fp32 tolerance, with three it is inside it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, (2, 256, 256)))
    want = flash_attention_ref(q, k, v)
    assert _within(_emulate_kernel(q, k, v, 0, _mm_3xtf32, 32), want, 2e-5) <= 0
    assert _within(_emulate_kernel(q, k, v, 0, _mm_1xtf32, 32), want, 2e-5) > 10 * 2e-5


def test_rna_tf32_rounds_ties_away_and_splits_exactly():
    one_ulp = 2.0 ** -10  # tf32's ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4, 3.0],
                     dtype=torch.float32)
    assert _rna_tf32(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 3.0]
    r = torch.from_numpy(_normal(3, (1000,)) * 100)
    hi = _rna_tf32(r)
    lo = r - hi
    assert torch.equal(hi + lo, r)  # x - hi is exact in fp32
    assert bool(((r - hi - _rna_tf32(lo)).abs() <= 2.0 ** -22 * r.abs()).all())


def test_flash_source_uses_the_tensor_cores():
    """Both routes' products are tensor-core instructions, K/V tiles come
    through TMA and mbarriers, and the only block-wide barrier is the one
    after the barriers' set-up."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    for instr in ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                  "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                  "cp.async.bulk.tensor.3d", "mbarrier.try_wait.parity",
                  "cudaGetDriverEntryPoint"):
        assert instr in src, instr
    assert src.count("__syncthreads()") == 1
    assert "fmaf(" not in src
