"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2)
(``repro/models/ssm.py``).

Prefill runs the recurrence h_t = a_t ⊙ h_{t−1} + b_t chunk by chunk: the
reference's ``lax.scan`` over chunks is a loop here, and each chunk's
recurrence goes through ``kernels/ops.py::ssm_scan``, so a CUDA tensor takes
the hand-written scan kernel and a CPU tensor its sequential plain version.
Only the chunk's states exist at a time, never the whole history: [B, K,
d_inner, N] for Mamba-1, [B, K, H, P, N] for Mamba-2, whose per-head scalar
decay is broadcast over P·N as the reference broadcasts it (the scan folds
H·P·N into channels). Mamba-1 builds each chunk's a and b through
``ops.mamba1_discretize`` (the discretize kernels for a CUDA tensor, the
plain chain otherwise); Mamba-2's scalar decay stays eager. Decode is one
recurrence step on the carried state (K = 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.sharding import constrain, shard_count, use_weight
from repro_torch.common.spans import span
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.attention import CacheSpec
from repro_torch.models.quant import dequantize_rows, is_int8, quantize_rows

CHUNK = 256


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def mamba_specs(cfg: ModelConfig) -> Dict[str, L.Spec]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    N = cfg.ssm_state
    conv = cfg.ssm_conv
    if cfg.ssm_version == 1:
        dt_rank = max(1, d // 16)
        return {
            "w_in": L.Spec((d, 2 * d_in), ("embed", "ssm_inner")),
            "conv_w": L.Spec((conv, d_in), ("conv", "ssm_inner"), "normal", 0.5),
            "conv_b": L.Spec((d_in,), ("ssm_inner",), "zeros"),
            "w_bcdt": L.Spec((d_in, 2 * N + dt_rank), ("ssm_inner", None)),
            "w_dt": L.Spec((dt_rank, d_in), (None, "ssm_inner"), "normal", 0.1),
            "dt_bias": L.Spec((d_in,), ("ssm_inner",), "zeros"),
            "a_log": L.Spec((d_in, N), ("ssm_inner", "ssm_state"), "zeros"),
            "d_skip": L.Spec((d_in,), ("ssm_inner",), "ones"),
            "w_out": L.Spec((d_in, d), ("ssm_inner", "embed")),
        }
    # mamba2 (SSD): scalar decay per head
    H = d_in // cfg.ssm_headdim
    return {
        "w_in": L.Spec((d, 2 * d_in + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": L.Spec((conv, d_in + 2 * N), ("conv", "ssm_inner"), "normal", 0.5),
        "conv_b": L.Spec((d_in + 2 * N,), ("ssm_inner",), "zeros"),
        "dt_bias": L.Spec((H,), (None,), "zeros"),
        "a_log": L.Spec((H,), (None,), "zeros"),
        "d_skip": L.Spec((H,), (None,), "ones"),
        "norm": L.Spec((d_in,), ("ssm_inner",), "ones"),
        "w_out": L.Spec((d_in, d), ("ssm_inner", "embed")),
    }


def mamba_state_specs(cfg: ModelConfig, batch: int, dtype=torch.float32):
    """Decode-time carried state (per layer): (conv_buffer, ssm_state).

    int8 appends per-row f32 scales — ``(conv, h, conv_scale, h_scale)`` —
    quantized on every state write and dequantized on read (the recurrence
    itself always runs in f32).
    """
    d_in = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    conv = cfg.ssm_conv
    if cfg.ssm_version == 1:
        shapes = [CacheSpec((batch, conv - 1, d_in), dtype), CacheSpec((batch, d_in, N), dtype)]
        axes = [("batch", None, "ssm_inner"), ("batch", "ssm_inner", "ssm_state")]
        scale_shapes = [(batch, conv - 1), (batch, d_in)]
        scale_axes = [("batch", None), ("batch", "ssm_inner")]
    else:
        H = d_in // cfg.ssm_headdim
        shapes = [CacheSpec((batch, conv - 1, d_in + 2 * N), dtype),
                  CacheSpec((batch, H, cfg.ssm_headdim, N), dtype)]
        axes = [("batch", None, "ssm_inner"), ("batch", None, None, "ssm_state")]
        scale_shapes = [(batch, conv - 1), (batch, H, cfg.ssm_headdim)]
        scale_axes = [("batch", None), ("batch", None, None)]
    if is_int8(dtype):
        shapes += [CacheSpec(s, torch.float32) for s in scale_shapes]
        axes += scale_axes
    return tuple(shapes), tuple(axes)


def _state_unpack(state):
    """(conv, h) read views — dequantized f32 when the state is int8."""
    if len(state) == 4:
        conv, h, conv_s, h_s = state
        return dequantize_rows(conv, conv_s), dequantize_rows(h, h_s)
    return state[0], state[1]


def _state_pack(template, conv, h):
    """Re-pack (conv, h) in the layout of ``template`` (quantizing for int8)."""
    if len(template) == 4:
        cq, cs = quantize_rows(conv)
        hq, hs = quantize_rows(h)
        return (cq, hq, cs, hs)
    return (conv, h)


# ---------------------------------------------------------------------------
# Chunked linear recurrence: h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------


def _pad_time(x, pad: int, value: float = 0.0):
    """Pad axis 1 of [B, T, ...] at the end with ``pad`` entries of ``value``."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value) if pad else x


def _to_chunks(x, nchunk: int, pad: int, chunk: int = CHUNK):
    """[B, T, ...] -> [nchunk, B, chunk, ...] (pad with zeros). A DTensor
    split along T is gathered along it first (the view needs T whole; the
    identity on a plain tensor)."""
    if shard_count(x, 1) > 1:
        x = constrain(x, ("batch", "seq") + (None,) * (x.dim() - 2))
    x = _pad_time(x, pad)
    return x.reshape((x.shape[0], nchunk, chunk) + tuple(x.shape[2:])).movedim(1, 0)


def _from_chunks(ys, T: int):
    """A list of nchunk [B, chunk, ...] outputs -> [B, T, ...]. For a
    DTensor the gradient arriving here is made whole along T (a forced
    constrain) before the view's backward splits T into chunks again; the
    identity on a plain tensor."""
    y = torch.stack(ys, 1)
    y = y.reshape((y.shape[0], -1) + tuple(y.shape[3:]))
    return constrain(y, ("batch", "seq") + (None,) * (y.dim() - 2), force=True)[:, :T]


def chunked_linear_recurrence(a, b, h0, project=None, aux=None):
    """a, b: [B, T, ...]; h0: [B, ...]. Returns (outputs over T, final state).

    The sequence is cut into chunks of ``min(CHUNK, T)`` steps, padded at the
    end with a = 1, b = 0 (which carries the state through unchanged), and
    each chunk's recurrence runs through ``_chunk_recurrence``.
    ``project(hs_chunk, aux_chunk)`` (optional) is applied to each chunk's
    states so the whole history is never kept; without it, returns the raw
    states.
    """
    B, T = a.shape[0], a.shape[1]
    K = min(CHUNK, T)  # never pad a short sequence (decode: T=1) up to CHUNK
    nchunk = (T + K - 1) // K
    pad = nchunk * K - T
    a = _pad_time(a, pad, 1.0)
    a_ch, b_ch = _to_chunks(a, nchunk, 0, K), _to_chunks(b, nchunk, pad, K)
    aux_ch = _to_chunks(aux, nchunk, pad, K) if aux is not None else [None] * nchunk
    h, outs = h0, []
    for ac, bc, xc in zip(a_ch, b_ch, aux_ch):
        hs, h = _chunk_recurrence(ac, bc, h)
        outs.append(project(hs, xc) if project is not None else hs)
    out = torch.stack(outs, 1)
    return out.reshape((B, nchunk * K) + tuple(out.shape[3:]))[:, :T], h


def _chunk_recurrence(ac, bc, h):
    """Solve h_t = a_t*h_{t-1} + b_t within one chunk. ac, bc: [B, K, ...].

    Through ``ops.ssm_scan`` (the trailing dims folded into channels): the
    scan kernel for a CUDA tensor, the sequential plain version for a CPU
    one. Returns (hs [B, K, ...], h_last [B, ...]).
    """
    return ops.ssm_scan(ac, bc, h)


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """x: [B, T, C]; w: [K, C] depthwise; state: [B, K-1, C] carried context."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i: i + T, :] * w[i][None, None, :].to(x.dtype) for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):, :] if K > 1 else x[:, :0]
    return out + b.to(x.dtype), new_state


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# Mamba-1 forward
# ---------------------------------------------------------------------------


def mamba1_forward(params, x, cfg: ModelConfig, state: Optional[Tuple] = None):
    """x: [B, T, D]. state: (conv_state, h) for decode; None for train/prefill."""
    B, T, D = x.shape
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_state

    w_in = use_weight(params["w_in"], ("embed", "ssm_inner"))
    proj = torch.matmul(x, w_in.to(x.dtype))
    xz, z = proj[..., :d_in], proj[..., d_in:]
    conv_state, h_read = _state_unpack(state) if state is not None else (None, None)
    xc, new_conv = _causal_conv(xz, params["conv_w"], params["conv_b"], conv_state)
    xc = constrain(F.silu(xc), ("batch", "seq", "ssm_inner"))

    bcdt = torch.matmul(xc, params["w_bcdt"].to(x.dtype))
    Bm, Cm, dt_in = bcdt[..., :N], bcdt[..., N: 2 * N], bcdt[..., 2 * N:]
    dt = softplus(torch.matmul(dt_in, params["w_dt"].to(x.dtype))
                  + params["dt_bias"].to(x.dtype)).float()  # [B, T, d_in]
    A = -torch.exp(params["a_log"].float())  # [d_in, N]
    h = (h_read.float() if state is not None
         else torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device))

    # the chunk's a and b are built inside the loop, so only [B, K, d_in, N]
    # exists at a time; K tracks T downward, so a decode token (T=1) is ONE
    # recurrence step, not a 256-step padded scan
    K = min(CHUNK, T)
    nchunk = (T + K - 1) // K
    pad = nchunk * K - T
    xcf = xc.float()
    chunks = [_to_chunks(v, nchunk, pad, K) for v in (dt, xcf, Bm.float(), Cm.float())]
    ys = []
    for dtc, xcc, Bc, Cc in zip(*chunks):  # [B,K,d_in] [B,K,d_in] [B,K,N] [B,K,N]
        with span("mamba1.discretize"):  # ac = exp(dt·A), bxc = (dt·x)·B
            ac, bxc = ops.mamba1_discretize(dtc, xcc, Bc, A)
        hs, h = _chunk_recurrence(ac, bxc, h)
        ys.append(torch.einsum("bkcn,bkn->bkc", hs, Cc))
    y = _from_chunks(ys, T)
    y = y + params["d_skip"].float() * xcf
    y = (y * F.silu(z.float())).to(x.dtype)
    w_out = use_weight(params["w_out"], ("ssm_inner", "embed"))
    out = constrain(torch.matmul(y, w_out.to(x.dtype)), ("batch", "seq", "embed"))
    new_state = _state_pack(state, new_conv, h) if state is not None else None
    return out, new_state


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) forward — scalar decay per head
# ---------------------------------------------------------------------------


def mamba2_forward(params, x, cfg: ModelConfig, state: Optional[Tuple] = None):
    """x: [B, T, D]. state: (conv_state, h [B, H, P, N]) for decode; None for
    train/prefill."""
    B, T, D = x.shape
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_state
    P = cfg.ssm_headdim
    H = d_in // P

    proj = torch.matmul(x, use_weight(params["w_in"], ("embed", "ssm_inner")).to(x.dtype))
    z = proj[..., :d_in]
    xBC = proj[..., d_in: 2 * d_in + 2 * N]
    dt_in = proj[..., 2 * d_in + 2 * N:]  # [B, T, H]
    conv_state, h_read = _state_unpack(state) if state is not None else (None, None)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs = xBC[..., :d_in].reshape(B, T, H, P)
    Bm = xBC[..., d_in: d_in + N]
    Cm = xBC[..., d_in + N:]

    dt = softplus(dt_in.float() + params["dt_bias"].float())  # [B, T, H]
    A = -torch.exp(params["a_log"].float())  # [H]
    h = (h_read.float() if state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    K = min(CHUNK, T)  # T=1 decode: one recurrence step, not a padded CHUNK
    nchunk = (T + K - 1) // K
    pad = nchunk * K - T
    xsf = xs.float()
    chunks = [_to_chunks(v, nchunk, pad, K) for v in (dt, xsf, Bm.float(), Cm.float())]
    ys = []
    for dtc, xcc, Bc, Cc in zip(*chunks):  # [B,K,H] [B,K,H,P] [B,K,N] [B,K,N]
        # the per-head decay broadcast over [P, N]; ops.ssm_scan makes it real
        ac = torch.exp(dtc * A)[..., None, None].expand(dtc.shape + (P, N))
        bxc = dtc[..., None, None] * xcc[..., None] * Bc[:, :, None, None, :]
        hs, h = _chunk_recurrence(ac, bxc, h)
        ys.append(torch.einsum("bkhpn,bkn->bkhp", hs, Cc))
    y = _from_chunks(ys, T)
    y = y + params["d_skip"].float()[None, None, :, None] * xsf
    y = y.reshape(B, T, d_in)
    y = y * F.silu(z.float())
    y = L.rmsnorm({"scale": params["norm"]}, y.to(x.dtype))
    w_out = use_weight(params["w_out"], ("ssm_inner", "embed"))
    out = constrain(torch.matmul(y, w_out.to(x.dtype)), ("batch", "seq", "embed"))
    new_state = _state_pack(state, new_conv, h) if state is not None else None
    return out, new_state


def mamba_forward(params, x, cfg: ModelConfig, state=None):
    if cfg.ssm_version == 1:
        return mamba1_forward(params, x, cfg, state)
    return mamba2_forward(params, x, cfg, state)
