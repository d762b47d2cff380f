"""Model assembly, the dense, ssm, hybrid and audio families (``repro/models/transformer.py``).

Layer parameters stay stacked along a leading layer dimension, so the
reference's parameter tree maps onto the port's leaf for leaf; where the
reference scans over the stack, the port loops over its slices. gemma3's 5
local : 1 global schedule is a per-layer list of window ints, which the
flash kernel takes at run time.

Decode caches are stacked the same way and written IN PLACE through the
per-layer views (the reference donates them): ``decode_step`` returns the
cache tensors it was given, updated — the dense family's KV caches under
``"kv"``, the ssm family's (conv, h) states under ``"ssm"``, and the hybrid
family's (zamba2) both: the Mamba-2 states of every layer under ``"ssm"``
and, under ``"kv"``, one ring-buffer KV cache a super-block for its shared
attention block. The audio family (whisper) keeps its decoder's KV caches
under ``"kv"`` and, under ``"cross"``, every layer's cross-attention K/V,
projected once from the encoder output (``seed_audio_caches``) and only
read by decode. ``draft_decode_step`` runs the first layers of the dense
stack alone, the self-speculative draft. The MoE and VLM families raise
"not ported yet".

As in the reference, ``forward`` does not scale the audio family's token
embedding by sqrt(d), while ``decode_step`` scales every family's.

The train path (``forward``, ``backbone_forward``, ``lm_loss``) runs the
dense, ssm, hybrid and audio families under autograd (the scan's gradient is
``kernels/ssm_scan.py::SSMScan``); ``remat`` wraps each layer, and each
chunk of the fused head + cross-entropy, in ``torch.utils.checkpoint`` where
the reference has ``jax.checkpoint``. The hybrid family's shared block is
not rematerialized, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.mlp import mlp_forward, mlp_specs
from repro_torch.models.quant import dequantize_rows, is_int8, quantize_rows

PORTED_FAMILIES = ("dense", "ssm", "hybrid", "audio")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet")


# ---------------------------------------------------------------------------
# Per-layer specs
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, kind: str) -> Dict:
    """kind: attn_mlp | mamba (attn_moe is not ported yet). The audio
    family's encoder, decoder and cross blocks are all attn_mlp blocks."""
    d = cfg.d_model
    if kind == "mamba":
        return {"norm": L.norm_specs(cfg.norm, d), "mamba": SSM.mamba_specs(cfg)}
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return {
        "norm1": L.norm_specs(cfg.norm, d),
        "attn": A.attention_specs(cfg),
        "norm2": L.norm_specs(cfg.norm, d),
        "mlp": mlp_specs(cfg),
    }


def stack_specs(cfg: ModelConfig, n_layers: int, kind: str) -> Dict:
    """Stack per-layer specs along a leading layer dim."""
    return tree_map(lambda s: L.Spec((n_layers,) + s.shape, ("stack",) + s.axes, s.init, s.scale),
                    block_specs(cfg, kind))


# ---------------------------------------------------------------------------
# Block forward and the layer loop
# ---------------------------------------------------------------------------


def attn_mlp_block(params, x, positions, cfg, window, kv_cache=None, cache_index=None,
                   positions_3d=None, fresh_cache=False):
    h = L.apply_norm(cfg.norm, params["norm1"], x)
    a, new_cache = A.attention_forward(
        params["attn"], h, positions, cfg, window=window,
        kv_cache=kv_cache, cache_index=cache_index, positions_3d=positions_3d,
        fresh_cache=fresh_cache,
    )
    x = x + a
    h = L.apply_norm(cfg.norm, params["norm2"], x)
    x = x + mlp_forward(params["mlp"], h, cfg)
    return x, new_cache


def mamba_block(params, x, cfg, state=None):
    h = L.apply_norm(cfg.norm, params["norm"], x)
    m, new_state = SSM.mamba_forward(params["mamba"], h, cfg, state)
    return x + m, new_state


def layer_params(stacked, i: int):
    """Layer ``i``'s slice (views) of a stacked parameter tree."""
    return tree_map(lambda a: a[i], stacked)


def _remat(f, enabled: bool):
    """``f``, recomputed in the backward pass instead of saving its
    activations when ``enabled``."""
    if not enabled:
        return f
    return lambda *args: checkpoint(f, *args, use_reentrant=False)


def _unbind_layers(stacked) -> List:
    """Every layer's parameter tree of a stacked tree, from one ``unbind``
    a stacked leaf: its backward stacks the layers' gradients once, where
    indexing each layer would add a zero-filled full-stack gradient a layer."""
    leaves, treedef = tree_flatten(stacked)
    per_leaf = [torch.unbind(x, 0) for x in leaves]
    return [tree_unflatten(treedef, list(layer)) for layer in zip(*per_leaf)]


def dense_stack_forward(params, x, positions, cfg, windows, remat=True, positions_3d=None):
    """The reference's ``lax.scan`` over a stack of attention + MLP layers as
    a loop over its slices; ``windows`` holds each layer's window int."""

    def body(xc, p, win):
        y, _ = attn_mlp_block(p, xc, positions, cfg, win, positions_3d=positions_3d)
        return y

    body = _remat(body, remat)
    for p, win in zip(_unbind_layers(params), windows):
        x = body(x, p, win)
    return x


def _mamba_layers(layers, x, cfg, remat):
    """Mamba blocks over a list of layer trees, each rematerialized under
    ``remat``."""

    def body(xc, p):
        return mamba_block(p, xc, cfg)[0]

    body = _remat(body, remat)
    for p in layers:
        x = body(x, p)
    return x


def mamba_stack_forward(params, x, cfg, remat=True):
    """The reference's ``lax.scan`` over a stack of Mamba layers as a loop
    over its slices."""
    return _mamba_layers(_unbind_layers(params), x, cfg, remat)


def hybrid_forward(params, x, positions, cfg, windows, remat=True, force_window=False):
    """zamba2: super-blocks of ``hybrid_attn_every`` Mamba layers, each
    followed by the ONE shared attention + MLP block (its gradient is the
    sum over its uses, as ``jax.grad`` gives); the layers past the last
    whole super-block run at the end. The shared block attends over the
    whole sequence unless ``force_window``. ``windows`` is unused, as in
    the reference."""
    period = cfg.hybrid_attn_every or cfg.num_layers
    n_sb = cfg.num_layers // period
    win = cfg.sliding_window if (cfg.sliding_window and force_window) else 0
    layers = _unbind_layers(params["layers"])
    for i in range(n_sb):
        x = _mamba_layers(layers[i * period:(i + 1) * period], x, cfg, remat)
        x, _ = attn_mlp_block(params["shared_attn"], x, positions, cfg, win)
    return _mamba_layers(layers[n_sb * period:], x, cfg, remat)


def dense_stack_decode(params, x, positions, cfg, windows, caches, cache_index,
                       fresh_cache=False):
    """The reference's ``lax.scan`` over layers as a loop over the stack's
    slices; each layer writes its cache slice in place."""
    for i, win in enumerate(windows):
        x, _ = attn_mlp_block(layer_params(params, i), x, positions, cfg, win,
                              kv_cache=tuple(c[i] for c in caches), cache_index=cache_index,
                              fresh_cache=fresh_cache)
    return x, caches


def mamba_stack_decode(params, x, cfg, states, layers=None):
    """The reference's ``lax.scan`` over Mamba layers as a loop; each layer's
    new (conv, h) state is written into its slice of the stacked states.
    ``layers`` (a range of stack indices, default all) runs a slice of the
    stack, as the hybrid family's super-blocks do."""
    for i in layers if layers is not None else range(cfg.num_layers):
        st = tuple(s[i] for s in states)
        x, new_st = mamba_block(layer_params(params, i), x, cfg, state=st)
        for dst, src in zip(st, new_st):
            dst.copy_(src)
    return x, states


def hybrid_decode(cfg, params, x, positions, caches, index):
    """``_hybrid_decode``: super-blocks of ``hybrid_attn_every`` Mamba layers,
    each followed by the ONE shared attention + MLP block, which writes its
    own super-block's slice of the ``"kv"`` stack; the layers past the last
    whole super-block run without it. With a sliding window the KV caches
    are rings of ``min(cache_len, window)`` slots: a write lands at
    ``index mod ring`` and keeps its true position, which the window mask
    reads. All caches are written in place."""
    period = cfg.hybrid_attn_every or cfg.num_layers
    n_sb = cfg.num_layers // period
    win = cfg.sliding_window or 0
    ring = caches["kv"][0].shape[2]
    if not win:
        widx = index
    elif isinstance(index, torch.Tensor):
        widx = torch.remainder(index, ring)
    else:
        widx = int(index) % ring
    ssm, kv = caches["ssm"], caches["kv"]
    for i in range(n_sb):
        x, _ = mamba_stack_decode(params["layers"], x, cfg, ssm,
                                  range(i * period, (i + 1) * period))
        x = shared_attn_decode(cfg, params["shared_attn"], x, positions,
                               tuple(c[i] for c in kv), widx, win)
    x, _ = mamba_stack_decode(params["layers"], x, cfg, ssm,
                              range(n_sb * period, cfg.num_layers))
    return x, caches


def shared_attn_decode(cfg, p, x, positions, cache, write_idx, window: int):
    """``_shared_attn_decode``: the shared block's attention (never the
    fresh-cache route, as in the reference) and MLP over ``cache``."""
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    a, _ = A.gqa_forward(p["attn"], h, positions, cfg, window=window, kv_cache=cache,
                         cache_index=write_idx)
    x = x + a
    h = L.apply_norm(cfg.norm, p["norm2"], x)
    return x + mlp_forward(p["mlp"], h, cfg)


# ---------------------------------------------------------------------------
# Layer schedules
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig, n_layers: int, force_window: bool = False) -> List[int]:
    """Per-layer window ints. gemma3: 5 local (sliding) : 1 global (full)."""
    win = cfg.sliding_window or 0
    if win == 0:
        return [0] * n_layers
    if cfg.local_global_ratio > 0 and not force_window:
        period = cfg.local_global_ratio + 1
        return [0 if (i % period) == cfg.local_global_ratio else win for i in range(n_layers)]
    return [win] * n_layers


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def model_specs(cfg: ModelConfig) -> Dict:
    _require_ported(cfg)
    d = cfg.d_model
    kind = "mamba" if cfg.family in ("ssm", "hybrid") else "attn_mlp"
    s: Dict = {"embed": L.embed_specs(cfg.vocab_size, d),
               "layers": stack_specs(cfg, cfg.num_layers, kind)}  # audio: the decoder's
    if cfg.family == "audio":
        s["enc_layers"] = stack_specs(cfg, cfg.encoder_layers, "attn_mlp")
        s["enc_norm"] = L.norm_specs(cfg.norm, d)
        s["cross_layers"] = stack_specs(cfg, cfg.num_layers, "attn_mlp")  # cross-attn + mlp
    if cfg.family == "hybrid":
        s["shared_attn"] = block_specs(cfg, "attn_mlp")  # zamba2 shared block
    s["final_norm"] = L.norm_specs(cfg.norm, d)
    if not cfg.tie_embeddings:
        s["head"] = L.dense_specs(d, cfg.vocab_size, (None, "vocab"), scale=0.02)
    return s


def params_from_numpy(cfg: ModelConfig, tree, device="cpu", dtype=torch.float32):
    """The reference's ``L.init_params(T.model_specs(cfg), key)`` output, as
    a nested dict of numpy arrays, in the port's layout (the same tree and
    shapes: the stacked leaves map one to one)."""
    specs = model_specs(cfg)
    spec_leaves, treedef = tree_flatten(specs)
    leaves, got_def = tree_flatten(tree)
    if got_def != treedef:
        raise ValueError("parameter tree does not match model_specs(cfg)")
    out = []
    for spec, arr in zip(spec_leaves, leaves):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"parameter of shape {arr.shape}, expected {spec.shape}")
        out.append(torch.from_numpy(np.array(arr, np.float32)).to(device=device, dtype=dtype))
    return tree_unflatten(treedef, out)


def _embed_scale(cfg: ModelConfig, dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``, as the reference's
    ``jnp.asarray(np.sqrt(d), x.dtype)``, as a Python scalar (a tensor built
    on the card would stall the stream on its host copy)."""
    return float(torch.tensor(np.sqrt(cfg.d_model), dtype=dtype))


def forward(cfg: ModelConfig, params, tokens, *, extra_embeds=None, remat: bool = True,
            force_window: bool = False):
    """Training/prefill forward -> (hidden [B, S, D], aux_loss). The audio
    family's ``extra_embeds`` are the encoder's frame embeddings [B, Se, D];
    its token embedding is not scaled by sqrt(d), as in the reference (the
    VLM front end is not ported yet)."""
    if cfg.family == "vlm":
        raise NotImplementedError(f"the {cfg.family!r} family's front end is not ported yet")
    x = L.embed(params["embed"], tokens)
    if cfg.family == "audio":
        x = audio_forward(params, x, extra_embeds, cfg, remat)
        return L.apply_norm(cfg.norm, params["final_norm"], x), torch.zeros((), device=x.device)
    x = x * _embed_scale(cfg, x.dtype)
    x, aux = backbone_forward(cfg, params, x, remat=remat, force_window=force_window)
    return L.apply_norm(cfg.norm, params["final_norm"], x), aux


def backbone_forward(cfg: ModelConfig, params, x, *, remat=True, force_window=False,
                     positions_3d=None):
    """Run the layer stack over already-embedded inputs x [B, S, D] ->
    (x, aux). The dense, ssm and hybrid families; the audio family has no
    single stack (``audio_forward``) and raises ``ValueError``, as in the
    reference; the others raise "not ported yet"."""
    _require_ported(cfg)
    if cfg.family == "audio":
        raise ValueError(cfg.family)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    windows = layer_windows(cfg, cfg.num_layers, force_window)
    if cfg.family == "dense":
        x = dense_stack_forward(params["layers"], x, positions, cfg, windows, remat, positions_3d)
    elif cfg.family == "ssm":
        x = mamba_stack_forward(params["layers"], x, cfg, remat)
    else:
        x = hybrid_forward(params, x, positions, cfg, windows, remat, force_window)
    return x, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# The audio family: whisper's encoder and cross-attention
# ---------------------------------------------------------------------------


def cross_attention(params, xq, xkv, cfg):
    """Unmasked attention of ``xq``'s queries over ``xkv``'s keys and values
    (no RoPE, so no positions)."""
    return cross_attention_cached(params, xq, A._project(xkv, params["wk"]),
                                  A._project(xkv, params["wv"]), cfg)


def cross_attention_cached(params, xq, k, v, cfg):
    """Cross-attention against pre-projected encoder K/V ([B, Se, KH, hd]),
    with the reference's zero fp32 bias [B, Sq, Se]: only the query
    projection runs a decode step."""
    hd = cfg.resolved_head_dim
    q = A._project(xq, params["wq"])
    bias = torch.zeros((xq.shape[0], xq.shape[1], k.shape[1]), dtype=torch.float32,
                       device=xq.device)
    out = A._sdpa(q, k.to(xq.dtype), v.to(xq.dtype), bias, hd ** -0.5)
    B, S = out.shape[:2]
    wo = params["wo"].to(out.dtype)
    return torch.matmul(out.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]))  # bshk,hkd->bsd


def _cross_block(cfg, p, x, attend):
    """An attention + MLP block whose attention is ``attend(p["attn"],
    normed x)``: the encoder's and the decoder's cross blocks."""
    x = x + attend(p["attn"], L.apply_norm(cfg.norm, p["norm1"], x))
    h = L.apply_norm(cfg.norm, p["norm2"], x)
    return x + mlp_forward(p["mlp"], h, cfg)


def encode_audio(cfg: ModelConfig, params, enc_embeds, remat: bool = False):
    """whisper's encoder over the stubbed frame embeddings [B, Se, D] ->
    [B, Se, D]: bidirectional self-attention (cross-attention of the frames
    with themselves) and an MLP a layer, then ``enc_norm``. The training
    forward (``audio_forward``) and the serving prefill
    (``seed_audio_caches``) both run it."""

    def body(h, p):
        # bidirectional self-attention == unmasked cross-attention with itself
        return _cross_block(cfg, p, h, lambda a, hn: cross_attention(a, hn, hn, cfg))

    body = _remat(body, remat)
    x = enc_embeds
    for p in _unbind_layers(params["enc_layers"]):
        x = body(x, p)
    return L.apply_norm(cfg.norm, params["enc_norm"], x)


def audio_forward(params, dec_tokens_embedded, enc_embeds, cfg: ModelConfig,
                  remat: bool = True):
    """whisper: the encoder over the frames, then a decoder layer's causal
    self-attention block (``gqa_forward(window=0)``, its positions counting
    from 0, as in the reference) followed by its cross block over the
    encoder output."""
    x = dec_tokens_embedded
    B, Sd = x.shape[0], x.shape[1]
    enc = encode_audio(cfg, params, enc_embeds.to(x.dtype), remat)
    dpos = torch.arange(Sd, dtype=torch.int32, device=x.device).expand(B, Sd)

    def body(h, p_self, p_cross):
        h, _ = attn_mlp_block(p_self, h, dpos, cfg, 0)
        return _cross_block(cfg, p_cross, h, lambda a, hn: cross_attention(a, hn, enc, cfg))

    body = _remat(body, remat)
    for p_self, p_cross in zip(_unbind_layers(params["layers"]),
                               _unbind_layers(params["cross_layers"])):
        x = body(x, p_self, p_cross)
    return x


def audio_cross_kv(cfg: ModelConfig, params, enc):
    """The encoder output [B, Se, D] projected to every layer's cross K/V,
    each [L, B, Se, KH, hd], by one einsum over the layer-stacked weights."""
    wk = params["cross_layers"]["attn"]["wk"]
    wv = params["cross_layers"]["attn"]["wv"]
    k = torch.einsum("bsd,ldhk->lbshk", enc, wk.to(enc.dtype))
    v = torch.einsum("bsd,ldhk->lbshk", enc, wv.to(enc.dtype))
    return k, v


def seed_audio_caches(cfg: ModelConfig, params, caches, enc_embeds):
    """Run the encoder and write the read-only ``cross`` cache leaves in
    place: quantized a row under the int8 layout (4 leaves: codes, codes,
    scales, scales), else cast to the cache dtype. Returns ``caches``."""
    enc = encode_audio(cfg, params, enc_embeds)
    k, v = audio_cross_kv(cfg, params, enc)
    del enc
    cross = caches["cross"]
    if len(cross) == 4:
        (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
        new = (kq, vq, ks, vs)
    else:
        new = (k, v)
    for dst, src in zip(cross, new):
        dst.copy_(src)
    return caches


def audio_decode(cfg: ModelConfig, params, x, positions, caches, index, fresh_cache=False):
    """``_audio_decode``: each decoder layer's causal self-attention over its
    KV cache (written in place; ``fresh_cache`` as the dense family takes
    it), its MLP, then cross-attention over the layer's read-only cross K/V
    (dequantized under int8) and the cross block's MLP. The cross leaves
    are returned unchanged."""
    cross, kv = caches["cross"], caches["kv"]
    for i in range(cfg.num_layers):
        if len(cross) == 4:
            ck = dequantize_rows(cross[0][i], cross[2][i], x.dtype)
            cv = dequantize_rows(cross[1][i], cross[3][i], x.dtype)
        else:
            ck, cv = cross[0][i], cross[1][i]
        x, _ = attn_mlp_block(layer_params(params["layers"], i), x, positions, cfg, 0,
                              kv_cache=tuple(c[i] for c in kv), cache_index=index,
                              fresh_cache=fresh_cache)
        x = _cross_block(cfg, layer_params(params["cross_layers"], i), x,
                         lambda a, hn: cross_attention_cached(a, hn, ck, cv, cfg))
    return x, caches


def logits_from_hidden(cfg: ModelConfig, params, hidden):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], hidden)
    return L.dense(params["head"], hidden)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, z_loss: float = 0.0):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


CE_CHUNK = 512


def chunked_lm_head_loss(cfg: ModelConfig, params, hidden, labels, remat=True):
    """Fused head-matmul + cross-entropy over sequence chunks.

    The full [B, S, V] logits never materialize: each chunk computes a
    [B, CE_CHUNK, V] slab and reduces it to a scalar, recomputed in the
    backward pass under ``remat``. Padding labels are -1: they read the
    logit of token 0 and are masked out of the sum, which is divided by
    the unpadded B * S.
    """
    B, S, D = hidden.shape
    chunk = min(CE_CHUNK, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def body(hc, yc):
        logits = logits_from_hidden(cfg, params, hc).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, torch.clamp_min(yc, 0).long()[..., None])[..., 0]
        valid = (yc >= 0).float()
        return torch.sum((lse - ll) * valid)

    body = _remat(body, remat)
    total = torch.zeros((), device=hidden.device)
    for c in range(0, hidden.shape[1], chunk):
        total = total + body(hidden[:, c:c + chunk], labels[:, c:c + chunk])
    return total / (B * S)


def lm_loss(cfg: ModelConfig, params, batch, remat=True, aux_weight=0.01, force_window=False):
    hidden, aux = forward(cfg, params, batch["tokens"], extra_embeds=batch.get("extra_embeds"),
                          remat=remat, force_window=force_window)
    return chunked_lm_head_loss(cfg, params, hidden, batch["labels"], remat) + aux_weight * aux


# ---------------------------------------------------------------------------
# Decode (serve_step core)
# ---------------------------------------------------------------------------


def make_decode_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16):
    """``CacheSpec``s of the stacked per-layer caches + logical axes trees.

    ``dtype=torch.int8`` selects the quantized layout (extra f32 scale
    leaves; see models/quant.py). SSM states stay f32 for every non-int8
    dtype (the recurrence is precision-sensitive) and take the quantized
    layout under int8, as the reference's do. The hybrid family has both
    groups: ``"ssm"`` stacked over every layer, ``"kv"`` over the
    super-blocks, at ring length ``min(cache_len, sliding_window)``. The
    audio family has its decoder's ``"kv"`` and the ``"cross"`` K/V, each
    [L, B, Se, KH, hd] in the cache dtype, plus their [L, B, Se, KH] fp32
    scales under int8.
    """
    _require_ported(cfg)

    def stacked(n, specs):
        shapes, axes = specs
        return (tuple(A.CacheSpec((n,) + tuple(s.shape), s.dtype) for s in shapes),
                tuple(("stack",) + a for a in axes))

    groups = {}
    if cfg.family in ("ssm", "hybrid"):
        sdtype = dtype if is_int8(dtype) else torch.float32
        groups["ssm"] = stacked(cfg.num_layers, SSM.mamba_state_specs(cfg, batch, sdtype))
    if cfg.family in ("dense", "audio"):
        groups["kv"] = stacked(cfg.num_layers,
                               A.make_kv_cache_specs(cfg, batch, cache_len, dtype))
    if cfg.family == "audio":
        KH, hd, Se = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.encoder_seq
        shapes = [A.CacheSpec((batch, Se, KH, hd), dtype)] * 2
        axes = [("batch", None, "kv_heads", None)] * 2
        if is_int8(dtype):
            shapes += [A.CacheSpec((batch, Se, KH), torch.float32)] * 2
            axes += [("batch", None, "kv_heads")] * 2
        groups["cross"] = stacked(cfg.num_layers, (tuple(shapes), tuple(axes)))
    elif cfg.family == "hybrid":
        n_sb = cfg.num_layers // (cfg.hybrid_attn_every or cfg.num_layers)
        ring = min(cache_len, cfg.sliding_window or cache_len)
        groups["kv"] = stacked(n_sb, A.make_kv_cache_specs(cfg, batch, ring, dtype))
    return {k: v[0] for k, v in groups.items()}, {k: v[1] for k, v in groups.items()}


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                       device="cpu"):
    """Concrete zero caches with the position track set to the INT32_MAX
    sentinel so unwritten slots never pass the causal mask."""
    sds, _ = make_decode_caches(cfg, batch, cache_len, dtype)

    def init_one(s):
        if s.dtype == torch.int32:
            return torch.full(s.shape, A.INT32_MAX, dtype=torch.int32, device=device)
        return torch.zeros(s.shape, dtype=s.dtype, device=device)

    return {k: tuple(init_one(s) for s in v) for k, v in sds.items()}


def decode_positions(index, B: int, S: int, device):
    """int32 [B, S] positions of a write at ``index`` (an int, or an int32
    [B] tensor of per-slot positions)."""
    ar = torch.arange(S, dtype=torch.int32, device=device)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        return index.to(device=device, dtype=torch.int32)[:, None] + ar[None, :]
    return (int(index) + ar).expand(B, S)


def decode_hidden(cfg: ModelConfig, params, tokens, caches, index, force_window=False,
                  fresh_cache=False):
    """``decode_step`` up to the final norm: (hidden [B, S, D], caches).

    The serving engine unembeds only the last position of a prefill block
    from this, instead of the full [B, S, V] logits. The ssm family ignores
    ``index`` and ``fresh_cache``, as the reference does: its state is the
    whole past, and a parked slot's state advances until the slot is
    refilled. The hybrid family ignores ``fresh_cache`` and ``force_window``
    (its shared block always attends over its ring at the config's window),
    and takes a vector ``index`` with single tokens only. The audio family
    reads its ``"cross"`` caches, which ``seed_audio_caches`` wrote."""
    _require_ported(cfg)
    B, S = tokens.shape
    vector = isinstance(index, torch.Tensor) and index.dim() == 1
    if vector and S != 1 and cfg.family == "hybrid":
        # ring-buffer attention caches wrap write positions with a
        # remainder; the vector multi-token write drops instead of
        # wrapping, so spans crossing the ring edge would be lost
        raise ValueError("hybrid ring caches take single-token vector writes only")
    x = L.embed(params["embed"], tokens)
    x = x * _embed_scale(cfg, x.dtype)
    if cfg.family == "ssm":
        x, new_ssm = mamba_stack_decode(params["layers"], x, cfg, caches["ssm"])
        new_caches = {"ssm": new_ssm}
    elif cfg.family == "hybrid":
        positions = decode_positions(index, B, S, x.device)
        x, new_caches = hybrid_decode(cfg, params, x, positions, caches, index)
    elif cfg.family == "audio":
        positions = decode_positions(index, B, S, x.device)
        x, new_caches = audio_decode(cfg, params, x, positions, caches, index, fresh_cache)
    else:
        positions = decode_positions(index, B, S, x.device)
        windows = layer_windows(cfg, cfg.num_layers, force_window)
        x, new_kv = dense_stack_decode(params["layers"], x, positions, cfg, windows,
                                       caches["kv"], index, fresh_cache)
        new_caches = {"kv": new_kv}
    return L.apply_norm(cfg.norm, params["final_norm"], x), new_caches


def decode_step(cfg: ModelConfig, params, tokens, caches, index, force_window=False,
                fresh_cache=False):
    """One cache-threading forward: single decode token OR a whole prefill block.

    tokens: [B, S] token ids. ``index`` is either a scalar cache write
    position — the S tokens land contiguously at [index, index + S) — or an
    int32 [B] tensor of per-slot positions (continuous batching), whose
    writes at or past ``cache_len`` are dropped. ``fresh_cache`` asserts
    nothing precedes this write in the cache, routing long prefill blocks
    through the flash attention path instead of cache-wide scores.

    Returns (logits [B, S, V], caches), the caches updated in place.
    """
    hidden, new_caches = decode_hidden(cfg, params, tokens, caches, index, force_window,
                                       fresh_cache)
    return logits_from_hidden(cfg, params, hidden), new_caches


def supports_self_speculation(cfg: ModelConfig) -> bool:
    """Self-speculative decoding needs a homogeneous stacked layer scan to
    truncate and caches that can be safely overwritten on rejection."""
    return cfg.family in ("dense", "vlm", "moe")


def draft_decode_step(cfg: ModelConfig, params, tokens, caches, index, draft_layers: int):
    """Truncated-depth (early-exit self-speculative) draft pass.

    Runs only the FIRST ``draft_layers`` layers of the stack and reads draft
    logits off the shared residual trunk (final norm + head). tokens:
    [B, 1]; ``index``: int32 [B] per-slot write positions. Layers below
    ``draft_layers`` write their cache slices in place, with what the
    verify pass rewrites there (same trunk, same inputs); the reference's
    splice of the head caches back into the full stack is implicit.
    Returns (logits [B, 1, V], caches).
    """
    if not supports_self_speculation(cfg):
        raise ValueError(f"self-speculation unsupported for family {cfg.family!r}")
    if not (0 < draft_layers < cfg.num_layers):
        raise ValueError(f"draft_layers must be in (0, {cfg.num_layers}), got {draft_layers}")
    _require_ported(cfg)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = x * _embed_scale(cfg, x.dtype)
    positions = decode_positions(index, B, S, x.device)
    windows = layer_windows(cfg, cfg.num_layers)[:draft_layers]
    x, _ = dense_stack_decode(params["layers"], x, positions, cfg, windows, caches["kv"], index)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), caches
