"""The port's flash attention against the JAX package's.

The plain version (``repro_torch.kernels.flash_attention.flash_attention_ref``)
is held against the Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it, on the same numpy inputs: rtol and atol
2e-5 in fp32, 2e-2 in bf16 (the JAX package's own tolerances for its
kernel). The GQA wrapper, ``_long_prefill_attention`` and ``gqa_forward``
with a fresh cache are held against the reference's within 1e-5. The CUDA
kernel against the plain version runs only on the card (``gpu`` marker).
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
