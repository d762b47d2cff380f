"""Attention: GQA/MHA, MLA (DeepSeek latent), sliding window, blockwise, KV cache
(``repro/models/attention.py``).

Blockwise (online-softmax) attention is the plain twin of the flash kernel
and runs whenever the score matrix would not fit memory; dense einsum
attention runs for short sequences. Decode paths attend one query token (or
a short block) against the cached K/V. MLA caches the compressed latent and
the shared RoPE key; with a cache it attends through the absorbed weights
(never the flash kernel), without one through the expanded per-head K/V.

Caches are written IN PLACE (the reference donates them to its executors):
``_cache_write`` and ``_write_kv_cache`` update the cache tensors they are
given and return them.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.sharding import constrain, is_dtensor, shard_count, use_weight
from repro_torch.models import layers as L
from repro_torch.models.quant import dequantize_rows, is_int8, quantize_rows

NEG_INF = -2.0e38
INT32_MAX = 2 ** 31 - 1
# shape and dtype of one cache leaf (the port's ShapeDtypeStruct)
CacheSpec = namedtuple("CacheSpec", "shape dtype")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def gqa_specs(cfg: ModelConfig) -> Dict[str, L.Spec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = {
        "wq": L.Spec((d, cfg.num_heads, hd), ("embed", "heads", "head_dim")),
        "wk": L.Spec((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": L.Spec((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": L.Spec((cfg.num_heads, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = L.Spec((hd,), ("head_dim",), "ones")
        s["k_norm"] = L.Spec((hd,), ("head_dim",), "ones")
    return s


def mla_specs(cfg: ModelConfig) -> Dict[str, L.Spec]:
    """DeepSeek-V3 Multi-head Latent Attention."""
    d = cfg.d_model
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    qk_nope, qk_rope, vd = cfg.resolved_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": L.Spec((d, qr), ("embed", None)),
        "q_a_norm": L.Spec((qr,), (None,), "ones"),
        "wq_b": L.Spec((qr, cfg.num_heads, qk_nope + qk_rope), (None, "heads", "head_dim")),
        "wkv_a": L.Spec((d, kvr + qk_rope), ("embed", None)),
        "kv_a_norm": L.Spec((kvr,), (None,), "ones"),
        "wkv_b": L.Spec((kvr, cfg.num_heads, qk_nope + vd), (None, "heads", "head_dim")),
        "wo": L.Spec((cfg.num_heads, vd, d), ("heads", "head_dim", "embed")),
    }


def attention_specs(cfg: ModelConfig) -> Dict[str, L.Spec]:
    return mla_specs(cfg) if cfg.attention == "mla" else gqa_specs(cfg)


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------


def _window_ok(q_pos_col, k_pos_row, window: int):
    """Boolean band mask; ``window`` <= 0 means full causal attention."""
    in_window = k_pos_row > (q_pos_col - int(window))
    return in_window if int(window) > 0 else torch.ones_like(in_window)


def causal_mask_bias(q_pos, k_pos, window: int = 0):
    """Additive bias [..., Sq, Sk]; window > 0 adds a sliding-window band."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    ok = ok & _window_ok(q_pos[..., :, None], k_pos[..., None, :], window)
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


_WHOLE_HEADS = ("batch", "seq", None, None)


def _group_heads(q, KH: int):
    """q [B, S, H, D] as [B, S, KH, H/KH, D]. A DTensor whose heads are
    split over ranks that do not divide KH cannot be viewed so: its heads
    are replicated first (a named redistribution: the reference's XLA
    reshards by itself). The plain view otherwise."""
    B, S, H, D = q.shape
    if KH % shard_count(q, 2):
        q = constrain(q, _WHOLE_HEADS)
    return q.reshape(B, S, KH, H // KH, D)


def _ungroup_heads(out, KH: int, split: int):
    """out [B, S, KH, G, D] as [B, S, KH·G, D]. Where ``_group_heads`` made
    a DTensor's heads whole (``split``, the ranks q's heads were split over,
    does not divide KH), the gradient arriving here is made whole too
    before the view's backward regroups it."""
    B, S, _, _, D = out.shape
    out = out.reshape(B, S, -1, D)
    return constrain(out, _WHOLE_HEADS, force=True) if KH % split else out


def _sdpa(q, k, v, bias, scale):
    """q:[B,Sq,H,D] k,v:[B,Sk,KH,D] -> [B,Sq,H,D]; bias:[B?,Sq,Sk] additive."""
    KH = k.shape[2]
    qg = _group_heads(q, KH)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = scores + (bias[:, None, None] if bias.dim() == 3 else bias)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return _ungroup_heads(out, KH, shard_count(q, 2)).to(q.dtype)


def _blockwise_sdpa(q, k, v, q_pos, k_pos, scale, window: int, kv_block: int = 1024):
    """Online-softmax attention over KV blocks (flash-style, plain torch).

    Memory O(Sq * kv_block) instead of O(Sq * Sk).
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    nblk = (Sk + kv_block - 1) // kv_block
    pad = nblk * kv_block - Sk
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad) + tuple(k.shape[2:]))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad) + tuple(v.shape[2:]))], dim=1)
        k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), INT32_MAX)], dim=1)
    qg = _group_heads(q * scale, KH).float()
    qp = q_pos[:, None, None, :, None]
    m = torch.full((B, KH, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, KH, G, Sq), device=q.device)
    acc = torch.zeros((B, KH, G, Sq, D), device=q.device)

    def step(m, l, acc, kc, vc, pc):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.float())
        ok = (pc <= qp) & _window_ok(qp, pc, window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc.float())
        return m_new, l, acc

    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # remat the kv-block body, as the reference does: the backward
        # recomputes the [.., Sq, kv_block] score slab instead of saving one
        # fp32 slab per block
        body = step
        step = lambda *a: checkpoint(body, *a, use_reentrant=False)
    for i in range(nblk):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        m, l, acc = step(m, l, acc, k[:, blk], v[:, blk], k_pos[:, blk][:, None, None, None, :])
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return _ungroup_heads(out.permute(0, 3, 1, 2, 4), KH, shard_count(q, 2)).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA forward (train/prefill and decode)
# ---------------------------------------------------------------------------

BLOCKWISE_THRESHOLD = 2048  # use online-softmax above this Sk (memory roofline)


def _long_prefill_attention(q, k, v, positions, scale, window: int):
    """Attention for a long contiguous SERVING prefill block at position 0.

    A CUDA tensor goes to the hand-written flash kernel
    (``kernels/ops.py::flash_attention``), with K and V repeated to the
    query heads here, as the reference does; a CPU tensor goes to the plain
    online-softmax twin, as the reference does off-TPU. The routing depends
    on the tensors' device only. Inference-only: the kernel has no backward.
    """
    if q.device.type == "cuda":
        from repro_torch.kernels.ops import flash_attention

        G = q.shape[2] // k.shape[2]
        kr = torch.repeat_interleave(k, G, dim=2) if G > 1 else k
        vr = torch.repeat_interleave(v, G, dim=2) if G > 1 else v
        return flash_attention(q, kr, vr, scale=scale, window=window)
    return _blockwise_sdpa(q, k, v, positions, positions, scale, window)


def _cache_write(cache, update, index):
    """Write ``update`` into ``cache`` at ``index`` along axis 1, in place.

    A scalar index writes a contiguous [B, S, ...] span at the start
    ``lax.dynamic_update_slice`` would use: clamped into [0, cache_len - S],
    so the span always fits. An int32 [B] vector writes S tokens per batch
    row starting at per-slot positions (continuous batching); columns at or
    past ``cache_len`` are DROPPED, as the reference's ``mode="drop"``
    scatter drops them, which lets the serving engine park inactive slots
    at ``cache_len``; a negative column wraps, as jnp's does. The vector write
    needs no host sync: each column is written as ``where(valid, update,
    current)`` at a clamped column, one column after the other, so a dropped
    column rewrites the value a valid one has just put there.
    """
    S = update.shape[1]
    upd = update.to(cache.dtype)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        B, Lc = cache.shape[0], cache.shape[1]
        rows = torch.arange(B, device=cache.device)
        keep_shape = (B,) + (1,) * (cache.dim() - 2)
        for s in range(S):
            col = index.to(device=cache.device, dtype=torch.int64) + s
            c = torch.clamp(col, max=Lc - 1)
            keep = (col < Lc).view(keep_shape)
            cache[rows, c] = torch.where(keep, upd[:, s], cache[rows, c])
        return cache
    start = min(max(int(index), 0), cache.shape[1] - S)
    cache[:, start:start + S] = upd
    return cache


def _write_kv_cache(kv_cache, k, v, positions, index):
    """Write (k, v, positions) into the cache; return it plus read views.

    A 3-tuple cache is full precision. A 5-tuple is the int8 layout
    ``(k_codes, v_codes, k_scale, v_scale, pos)``: the update rows are
    quantized per (batch, position, kv_head) row before the write, and the
    read views are dequantized copies.
    """
    if len(kv_cache) == 5:
        ck, cv, cks, cvs, cpos = kv_cache
        kq, ksc = quantize_rows(k)
        vq, vsc = quantize_rows(v)
        ck, cks = _cache_write(ck, kq, index), _cache_write(cks, ksc, index)
        cv, cvs = _cache_write(cv, vq, index), _cache_write(cvs, vsc, index)
        cpos = _cache_write(cpos, positions, index)
        new_cache = (ck, cv, cks, cvs, cpos)
        return new_cache, dequantize_rows(ck, cks, k.dtype), dequantize_rows(cv, cvs, v.dtype), cpos
    ck, cv, cpos = kv_cache
    ck = _cache_write(ck, k, index)
    cv = _cache_write(cv, v, index)
    cpos = _cache_write(cpos, positions, index)
    return (ck, cv, cpos), ck, cv, cpos


def _project(x, w):
    """``bsd,dhk->bshk``."""
    B, S, d = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])


def gqa_forward(
    params,
    x,
    positions,
    cfg: ModelConfig,
    window: int = 0,
    positions_3d=None,
    kv_cache: Optional[Tuple] = None,
    cache_index=None,
    fresh_cache: bool = False,
):
    """Returns (out, new_kv) — new_kv only when kv_cache is given (decode).
    With ``cfg.mrope_sections`` (the VLM family) q and k take M-RoPE over
    ``positions_3d`` [B, S, 3], or over the text ids of ``positions``
    when none are given."""
    hd = cfg.resolved_head_dim
    q = _project(x, use_weight(params["wq"], ("embed", "heads", "head_dim")))
    k = _project(x, use_weight(params["wk"], ("embed", "kv_heads", "head_dim")))
    v = _project(x, use_weight(params["wv"], ("embed", "kv_heads", "head_dim")))
    if cfg.qk_norm:
        q = _head_rms(q, params["q_norm"])
        k = _head_rms(k, params["k_norm"])
    if cfg.mrope_sections:
        p3 = positions_3d if positions_3d is not None else L.text_positions_3d(positions)
        q = L.apply_mrope(q, p3, cfg.mrope_sections, cfg.rope_theta)
        k = L.apply_mrope(k, p3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", None))
    scale = hd ** -0.5

    if kv_cache is not None:
        new_cache, ck, cv, cpos = _write_kv_cache(kv_cache, k, v, positions, cache_index)
        Sq, Sk = k.shape[1], ck.shape[1]
        if fresh_cache:
            # single-pass prefill into an empty cache: attend within the
            # freshly projected K/V (the cache tail is all masked sentinels)
            if Sq > BLOCKWISE_THRESHOLD:
                out = _long_prefill_attention(q, k, v, positions, scale, window)
            else:
                out = _sdpa(q, k, v, causal_mask_bias(positions, positions, window), scale)
        elif Sq > 1 and Sq * Sk > BLOCKWISE_THRESHOLD ** 2:
            # later prefill blocks attend against earlier cache content too
            out = _blockwise_sdpa(q, ck, cv, positions, cpos, scale, window)
        else:
            out = _sdpa(q, ck, cv, _decode_bias(positions, cpos, window), scale)
    else:
        # a DTensor takes the blockwise route at any length (the same
        # attention): the full-score einsum's backward breaks a DTensor
        # view at a pod's batch with grouped KV heads
        if k.shape[1] > BLOCKWISE_THRESHOLD or is_dtensor(q):
            out = _blockwise_sdpa(q, k, v, positions, positions, scale, window)
        else:
            out = _sdpa(q, k, v, causal_mask_bias(positions, positions, window), scale)
        new_cache = None

    B, S = out.shape[:2]
    wo = use_weight(params["wo"], ("heads", "head_dim", "embed")).to(out.dtype)
    out = torch.matmul(out.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))
    return constrain(out, ("batch", "seq", "embed")), new_cache


def _head_rms(x, scale, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def _decode_bias(q_pos, k_pos, window: int):
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    ok = ok & _window_ok(q_pos[:, :, None], k_pos[:, None, :], window)
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# MLA forward — caches the compressed latent (DeepSeek-V3 style)
# ---------------------------------------------------------------------------


def mla_forward(params, x, positions, cfg: ModelConfig, window: int = 0,
                kv_cache: Optional[Tuple] = None, cache_index=None, fresh_cache: bool = False,
                **_):
    """Returns (out, new_cache) — new_cache only when kv_cache is given.

    With a cache (every serving step, ``fresh_cache`` ignored as in the
    reference) the attention is ABSORBED: wkv_b's K half folds into the
    query and its V half into the output, so the scores run over the
    cached latent [B, S, r] and never expand it to per-head K/V. The
    probabilities are rounded to the cache dtype before they weight the
    latent, and the products accumulate in fp32, as the reference's
    ``preferred_element_type``. Without a cache (training, the towers) the
    latent is expanded to per-head K/V over the sequence."""
    nope, rope_d, vd = cfg.resolved_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr, H = cfg.kv_lora_rank, cfg.num_heads
    B, Sq = x.shape[0], x.shape[1]

    qa = torch.matmul(x, use_weight(params["wq_a"], ("embed", None)).to(x.dtype))
    qa = L.rmsnorm({"scale": params["q_a_norm"]}, qa)
    q = _project(qa, use_weight(params["wq_b"], (None, "heads", "head_dim")))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = torch.matmul(x, use_weight(params["wkv_a"], ("embed", None)).to(x.dtype))
    latent, k_rope_flat = kv_a[..., :kvr], kv_a[..., kvr:]
    latent = L.rmsnorm({"scale": params["kv_a_norm"]}, latent)
    k_rope = L.apply_rope(k_rope_flat[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    scale = (nope + rope_d) ** -0.5
    wkv_b = use_weight(params["wkv_b"], (None, "heads", "head_dim"))
    wo = use_weight(params["wo"], ("heads", "head_dim", "embed"))

    if kv_cache is not None:
        # the (latent, RoPE key) pair takes the (K, V) slots of the cache
        # layout, the int8 5-tuple's scales included
        new_cache, c_lat, c_rope, cpos = _write_kv_cache(kv_cache, latent, k_rope, positions,
                                                         cache_index)
        Sk = c_lat.shape[1]
        lat_dtype = c_lat.dtype
        c_lat, c_rope = c_lat.float(), c_rope.float()
        q_abs = torch.einsum("bqhk,rhk->bhqr", q_nope, wkv_b[..., :nope].to(x.dtype))
        s = torch.bmm(q_abs.reshape(B, H * Sq, kvr).float(), c_lat.transpose(1, 2))
        qr = q_rope.permute(0, 2, 1, 3).reshape(B, H * Sq, rope_d).float()
        s += torch.bmm(qr, c_rope.transpose(1, 2))
        s *= scale
        s = s.view(B, H, Sq, Sk)
        ok = cpos[:, None, None, :] <= positions[:, None, :, None]
        ok = ok & _window_ok(positions[:, None, :, None], cpos[:, None, None, :], window)
        # in place, but for a DTensor: its in-place ops must keep its layout
        s = s.masked_fill(~ok, NEG_INF) if is_dtensor(s) else s.masked_fill_(~ok, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        p = p.to(lat_dtype).float().view(B, H * Sq, Sk)
        out_lat = torch.bmm(p, c_lat).view(B, H, Sq, kvr)
        del p
        out = torch.einsum("bhqr,rhv->bqhv", out_lat, wkv_b[..., nope:].float()).to(x.dtype)
    else:
        kv = _project(latent, wkv_b)
        k_nope, vv = kv[..., :nope], kv[..., nope:]
        s = torch.einsum("bqhk,bshk->bhqs", q_nope.float(), k_nope.float())
        s = (s + torch.einsum("bqhk,bsk->bhqs", q_rope.float(), k_rope.float())) * scale
        ok = positions[:, None, None, :] <= positions[:, None, :, None]
        ok = ok & _window_ok(positions[:, None, :, None], positions[:, None, None, :], window)
        p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
        out = torch.einsum("bhqs,bshv->bqhv", p, vv.float()).to(x.dtype)
        new_cache = None
    out = torch.matmul(out.reshape(B, Sq, H * vd), wo.to(out.dtype).reshape(H * vd, -1))
    return constrain(out, ("batch", "seq", "embed")), new_cache


def attention_forward(params, x, positions, cfg: ModelConfig, **kw):
    if cfg.attention == "mla":
        return mla_forward(params, x, positions, cfg, **kw)
    return gqa_forward(params, x, positions, cfg, **kw)


# ---------------------------------------------------------------------------
# KV cache construction
# ---------------------------------------------------------------------------


def make_kv_cache_specs(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16):
    """Per-layer cache ``CacheSpec``s + logical axes for one layer.

    int8 caches carry two extra leaves per tuple — f32 per-row scales for the
    K and V codes — laid out ``(k, v, k_scale, v_scale, pos)`` so the int32
    position track stays the last leaf in both layouts. MLA caches the
    latent [B, L, kv_lora_rank] and the RoPE key [B, L, qk_rope_head_dim]
    in their place, with [B, L] scales under int8.
    """
    if cfg.attention == "mla":
        kvr, rope_d = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        shapes = [CacheSpec((batch, cache_len, kvr), dtype),
                  CacheSpec((batch, cache_len, rope_d), dtype)]
        axes = [("batch", "cache_seq", None)] * 2
        if is_int8(dtype):
            shapes += [CacheSpec((batch, cache_len), torch.float32)] * 2
            axes += [("batch", "cache_seq")] * 2
        shapes.append(CacheSpec((batch, cache_len), torch.int32))
        axes.append(("batch", "cache_seq"))
        return tuple(shapes), tuple(axes)
    hd = cfg.resolved_head_dim
    shapes = [CacheSpec((batch, cache_len, cfg.num_kv_heads, hd), dtype)] * 2
    axes = [("batch", "cache_seq", "kv_heads", None)] * 2
    if is_int8(dtype):
        shapes += [CacheSpec((batch, cache_len, cfg.num_kv_heads), torch.float32)] * 2
        axes += [("batch", "cache_seq", "kv_heads")] * 2
    shapes.append(CacheSpec((batch, cache_len), torch.int32))
    axes.append(("batch", "cache_seq"))
    return tuple(shapes), tuple(axes)
