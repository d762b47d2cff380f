"""The benchmark's LLM-scale hybrid split in plain PyTorch, fp32.

The model is the one the cells' configurations state (keys of the
configuration files' ``model`` group), split as the paper's hybrid
federation splits it:

  h1(θ1, x1) -> ζ1    the hospital's tower over the first half of each sequence
  h2(θ2, x2) -> ζ2    the device's tower over the second half
  loss(θ0, ζ1, ζ2, y) the combined model over [ζ1; ζ2] and the mean
                      next-token cross-entropy over every position

A tower is a token embedding scaled by sqrt(d), ``n_tower`` Mamba blocks of
the model's own kind and an RMSNorm. The combined model is the backbone
(the ``ssm`` family: a stack of Mamba-1 blocks; the ``hybrid`` family:
Mamba-2 blocks with ONE shared attention + SwiGLU block after every
``hybrid_attn_every`` of them), a final RMSNorm and an untied head.

Blocks are pre-norm residual: x + mixer(rmsnorm(x)). Mamba-1 (falcon-mamba):
in-projection to x and the gate z, a causal depthwise convolution and SiLU,
a projection to (B, C, dt-rank), dt = softplus(dt_rank·W_dt + bias),
A = -exp(a_log) [d_in, N], the recurrence h_t = exp(dt A) h_{t-1} + dt x B,
y = C·h + D x, y·SiLU(z), out-projection. Mamba-2 (zamba2): one in-projection
to z, x, B, C and one dt a head; A is one scalar a head, so the decay is
exp(dt_h A_h) over the head's P x N state; y is RMS-normalised before the
out-projection. Attention is causal over the whole sequence with rotary
position embeddings (halves rotated) and 1/sqrt(head_dim) scaling.

Departures from the published models, which the program shares: the
falcon-mamba B/C/dt RMS norms are absent; zamba2 has one shared block (the
published model alternates two, with LoRA adapters and a concatenated
input) and one B/C group. RMSNorm's epsilon is 1e-6 everywhere.

Parameters are a nested dict per pod; ``param_layout`` gives every leaf's
shape and the distribution the benchmark draws it from.

This module is one reference module of the harness: a configuration file
names its module under ``"reference"`` (``"model"``, this one, when it names
none) and ``spec.load_cell`` loads ``reference/<name>.py`` by its path. Every
reference module holds these functions (``spec.REFERENCE_CONTRACT``), plain
PyTorch, importing nothing of the port or of JAX; ``cfg`` is the
configuration's ``model`` group:

  check_supported(cfg)           raises ValueError for a model it does not cover
  param_layout(cfg, n_tower)     {θ0, θ1, θ2} of one pod, nested dicts of ``Leaf``s
  tower(cfg, t, ids)             ζ = h(θ, x): [B, T] token ids -> [B, T, d]
  loss(cfg, t0, z1, z2, y)       the combined model's mean cross-entropy
  backbone_flops(cfg, batch, seq)           forward FLOPs of θ0's body over
                                            [batch, seq]: {"weight", "act"}
  tower_flops(cfg, batch, seq, n_tower)     the same for one tower
  in_proj_flops(cfg)                        forward FLOPs a token of θ0's
                                            first in-projection
  backbone_scans(cfg)                       the scans a forward of θ0 runs:
  tower_scans(cfg, n_tower)                 [(state floats a token, how many)]

The FLOP counts follow ``counts.py``'s rules ("weight": products with a
weight operand, "act": products of two activations) and leave out the
head, which ``counts.py`` counts with the split's structure, the exchange
and the scans' bytes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from hsgd_bench.reference.scan import recurrence

NORM_EPS = 1e-6
# (shape, kind, std): kind "normal" is a normal truncated at ±2 std, "embed"
# a plain normal, "zeros" and "ones" constants (std unused)
Leaf = Tuple[Tuple[int, ...], str, float]


def _normal(shape, std=None) -> Leaf:
    """Truncated normal at ±2 std; by default std = 1/sqrt(product of all
    but the last dim of the leaf as stored, stack dim included)."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    return (tuple(shape), "normal", std if std is not None else 1.0 / math.sqrt(max(fan_in, 1)))


def _const(shape, kind) -> Leaf:
    return (tuple(shape), kind, 0.0)


def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    out = {"d": d, "d_in": d_in, "N": cfg["ssm_state"], "conv": cfg["ssm_conv"],
           "V": cfg["vocab_size"], "R": max(1, d // 16)}
    if cfg["ssm_version"] == 2:
        out["P"] = cfg["ssm_headdim"]
        out["H"] = d_in // cfg["ssm_headdim"]
    if cfg.get("num_heads"):
        out["heads"] = cfg["num_heads"]
        out["kv_heads"] = cfg["num_kv_heads"]
        out["hd"] = cfg.get("head_dim") or d // cfg["num_heads"]
        out["ff"] = cfg["d_ff"]
        out["theta"] = cfg.get("rope_theta", 10000.0)
    return out


def _mamba_leaves(cfg: Dict, n: int):
    """A stack of ``n`` Mamba blocks (leading [n] axis on every leaf)."""
    k = dims(cfg)
    d, d_in, N, conv = k["d"], k["d_in"], k["N"], k["conv"]
    if cfg["ssm_version"] == 1:
        mixer = {
            "w_in": (d, 2 * d_in), "conv_w": (conv, d_in), "conv_b": (d_in,),
            "w_bcdt": (d_in, 2 * N + k["R"]), "w_dt": (k["R"], d_in), "dt_bias": (d_in,),
            "a_log": (d_in, N), "d_skip": (d_in,), "w_out": (d_in, d),
        }
        std = {"conv_w": 0.5, "w_dt": 0.1}
        const = {"conv_b": "zeros", "dt_bias": "zeros", "a_log": "zeros", "d_skip": "ones"}
    else:
        H = k["H"]
        mixer = {
            "w_in": (d, 2 * d_in + 2 * N + H), "conv_w": (conv, d_in + 2 * N),
            "conv_b": (d_in + 2 * N,), "dt_bias": (H,), "a_log": (H,), "d_skip": (H,),
            "norm": (d_in,), "w_out": (d_in, d),
        }
        std = {"conv_w": 0.5}
        const = {"conv_b": "zeros", "dt_bias": "zeros", "a_log": "zeros", "d_skip": "ones",
                 "norm": "ones"}
    leaves = {name: (_const((n,) + s, const[name]) if name in const
                     else _normal((n,) + s, std.get(name))) for name, s in mixer.items()}
    return {"mamba": leaves, "norm": {"scale": _const((n, d), "ones")}}


def _shared_block_leaves(cfg: Dict):
    k = dims(cfg)
    d, H, KH, hd, ff = k["d"], k["heads"], k["kv_heads"], k["hd"], k["ff"]
    return {
        "norm1": {"scale": _const((d,), "ones")},
        "attn": {"wq": _normal((d, H, hd)), "wk": _normal((d, KH, hd)),
                 "wv": _normal((d, KH, hd)), "wo": _normal((H, hd, d))},
        "norm2": {"scale": _const((d,), "ones")},
        "mlp": {"w_gate": _normal((d, ff)), "w_up": _normal((d, ff)),
                "w_down": _normal((ff, d))},
    }


def check_supported(cfg: Dict) -> None:
    """The reference covers the ssm and hybrid families as configured here."""
    if cfg["family"] not in ("ssm", "hybrid"):
        raise ValueError(f"no reference for the {cfg['family']!r} family")
    if cfg["family"] == "hybrid" and (cfg.get("qk_norm") or cfg.get("mrope_sections")
                                      or cfg.get("mlp", "swiglu") != "swiglu"):
        raise ValueError("the hybrid reference has SwiGLU, no qk-norm and no M-RoPE")
    if cfg.get("norm", "rmsnorm") != "rmsnorm":
        raise ValueError("the reference normalises with RMSNorm")


def param_layout(cfg: Dict, n_tower: int = 1) -> Dict:
    """{θ0, θ1, θ2} of one pod: nested dicts of ``Leaf``s."""
    check_supported(cfg)
    k = dims(cfg)
    d, V = k["d"], k["V"]
    tower = {"layers": _mamba_leaves({**cfg, "family": "ssm"}, n_tower),
             "norm": {"scale": _const((d,), "ones")},
             "embed": {"table": ((V, d), "embed", 0.02)}}
    theta0 = {"layers": _mamba_leaves(cfg, cfg["num_layers"]),
              "final_norm": {"scale": _const((d,), "ones")},
              "head": {"w": _normal((d, V), 0.02)}}
    if cfg["family"] == "hybrid":
        theta0["shared_attn"] = _shared_block_leaves(cfg)
    return {"theta0": theta0, "theta1": tower, "theta2": tower}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def rmsnorm(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + NORM_EPS) * scale


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def causal_conv(x, w, b):
    """Depthwise causal convolution over time: x [B, T, C], w [K, C]."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def mamba1(p, x, k):
    d_in, N = k["d_in"], k["N"]
    proj = torch.matmul(x, p["w_in"])
    xc = F.silu(causal_conv(proj[..., :d_in], p["conv_w"], p["conv_b"]))
    z = proj[..., d_in:]
    bcdt = torch.matmul(xc, p["w_bcdt"])
    Bm, Cm, dt_low = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    dt = softplus(torch.matmul(dt_low, p["w_dt"]) + p["dt_bias"])  # [B, T, d_in]
    A = -torch.exp(p["a_log"])  # [d_in, N]
    a = torch.exp(dt[..., None] * A)
    b = (dt * xc)[..., None] * Bm[:, :, None, :]
    hs = recurrence(a, b)  # [B, T, d_in, N]
    y = torch.einsum("btcn,btn->btc", hs, Cm) + p["d_skip"] * xc
    return torch.matmul(y * F.silu(z), p["w_out"])


def mamba2(p, x, k):
    d_in, N, P, H = k["d_in"], k["N"], k["P"], k["H"]
    B, T, _ = x.shape
    proj = torch.matmul(x, p["w_in"])
    z = proj[..., :d_in]
    xbc = F.silu(causal_conv(proj[..., d_in:2 * d_in + 2 * N], p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(B, T, H, P)
    Bm, Cm = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
    dt = softplus(proj[..., 2 * d_in + 2 * N:] + p["dt_bias"])  # [B, T, H]
    A = -torch.exp(p["a_log"])  # [H]
    a = torch.exp(dt * A)[..., None, None]  # [B, T, H, 1, 1]
    b = (dt[..., None] * xs)[..., None] * Bm[:, :, None, None, :]
    hs = recurrence(a, b)  # [B, T, H, P, N]
    y = torch.einsum("bthpn,btn->bthp", hs, Cm) + p["d_skip"][:, None] * xs
    y = rmsnorm(y.reshape(B, T, d_in) * F.silu(z), p["norm"])
    return torch.matmul(y, p["w_out"])


def rope(x, theta):
    """x [B, S, H, D] at positions 0..S-1, its two halves rotated."""
    S, D = x.shape[1], x.shape[-1]
    exponent = torch.arange(0, D, 2, dtype=torch.float32) / D
    inv = 1.0 / torch.pow(torch.tensor(float(theta)), exponent)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv  # [S, D/2]
    ang = ang.to(x.device)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, k):
    B, S, d = x.shape
    H, KH, hd = k["heads"], k["kv_heads"], k["hd"]
    q = torch.matmul(x, p["wq"].reshape(d, H * hd)).reshape(B, S, H, hd)
    kk = torch.matmul(x, p["wk"].reshape(d, KH * hd)).reshape(B, S, KH, hd)
    v = torch.matmul(x, p["wv"].reshape(d, KH * hd)).reshape(B, S, KH, hd)
    q, kk = rope(q, k["theta"]), rope(kk, k["theta"])
    rep = H // KH
    q = q.permute(0, 2, 1, 3)  # [B, H, S, hd]
    kk = kk.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    scores = torch.matmul(q, kk.transpose(-1, -2)) * hd ** -0.5
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, -math.inf), dim=-1)
    out = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(B, S, H * hd)
    return torch.matmul(out, p["wo"].reshape(H * hd, d))


def swiglu(p, x):
    h = F.silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
    return torch.matmul(h, p["w_down"])


def _layer(stack, i):
    return {name: (_layer(v, i) if isinstance(v, dict) else v[i]) for name, v in stack.items()}


def mamba_stack(layers, x, k, version, lo, hi):
    mixer = mamba1 if version == 1 else mamba2
    for i in range(lo, hi):
        p = _layer(layers, i)
        x = x + mixer(p["mamba"], rmsnorm(x, p["norm"]["scale"]), k)
    return x


def backbone(cfg: Dict, t0, x):
    k, L = dims(cfg), cfg["num_layers"]
    version = cfg["ssm_version"]
    if cfg["family"] == "ssm":
        return mamba_stack(t0["layers"], x, k, version, 0, L)
    period = cfg["hybrid_attn_every"] or L
    n_sb = L // period
    sb = t0["shared_attn"]
    for i in range(n_sb):
        x = mamba_stack(t0["layers"], x, k, version, i * period, (i + 1) * period)
        x = x + attention(sb["attn"], rmsnorm(x, sb["norm1"]["scale"]), k)
        x = x + swiglu(sb["mlp"], rmsnorm(x, sb["norm2"]["scale"]))
    return mamba_stack(t0["layers"], x, k, version, n_sb * period, L)


def tower(cfg: Dict, t, ids):
    k = dims(cfg)
    scale = float(torch.sqrt(torch.tensor(float(k["d"]), dtype=torch.float32)))
    x = t["embed"]["table"][ids.long()] * scale
    x = mamba_stack(t["layers"], x, k, cfg["ssm_version"], 0, t["layers"]["norm"]["scale"].shape[0])
    return rmsnorm(x, t["norm"]["scale"])


def loss(cfg: Dict, t0, z1, z2, y):
    """Mean cross-entropy of the combined model over [ζ1; ζ2] against y."""
    h = rmsnorm(backbone(cfg, t0, torch.cat([z1, z2], dim=1)), t0["final_norm"]["scale"])
    logits = torch.matmul(h, t0["head"]["w"])
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


# ---------------------------------------------------------------------------
# Work counts (the model's part of ``hsgd_bench/counts.py``)
# ---------------------------------------------------------------------------


def _mamba_layer_flops(cfg: Dict, tokens: int) -> Dict[str, float]:
    """Forward FLOPs of one Mamba layer over ``tokens`` tokens: ``weight``
    products, ``act`` products of two activations, and ``in_proj`` (the
    in-projection alone, whose input gradient is counted apart)."""
    k = dims(cfg)
    d, d_in, N = k["d"], k["d_in"], k["N"]
    if cfg["ssm_version"] == 1:
        w_in = d * 2 * d_in
        weight = w_in + d_in * (2 * N + k["R"]) + k["R"] * d_in + d_in * d
        act = d_in * N  # y = C·h
    else:
        w_in = d * (2 * d_in + 2 * N + k["H"])
        weight = w_in + d_in * d
        act = k["H"] * k["P"] * N
    return {"weight": 2.0 * tokens * weight, "act": 2.0 * tokens * act,
            "in_proj": 2.0 * tokens * w_in}


def _shared_block_flops(cfg: Dict, batch: int, seq: int) -> Dict[str, float]:
    k = dims(cfg)
    d, H, KH, hd, ff = k["d"], k["heads"], k["kv_heads"], k["hd"], k["ff"]
    tokens = batch * seq
    weight = 2.0 * tokens * (d * H * hd + 2 * d * KH * hd + H * hd * d + 3 * d * ff)
    pairs = seq * (seq + 1) / 2
    act = 2 * (2.0 * batch * H * hd * pairs)  # scores and the weighted sum of values
    return {"weight": weight, "act": act}


def backbone_flops(cfg: Dict, batch: int, seq: int) -> Dict[str, float]:
    """Forward FLOPs of θ0's Mamba stack and shared blocks over [batch, seq]."""
    layer = _mamba_layer_flops(cfg, batch * seq)
    L = cfg["num_layers"]
    out = {"weight": L * layer["weight"], "act": L * layer["act"]}
    if cfg["family"] == "hybrid":
        blocks = L // (cfg["hybrid_attn_every"] or L)
        sb = _shared_block_flops(cfg, batch, seq)
        out = {key: out[key] + blocks * sb[key] for key in out}
    return out


def tower_flops(cfg: Dict, batch: int, seq: int, n_tower: int) -> Dict[str, float]:
    """Forward FLOPs of one tower's Mamba blocks over [batch, seq]."""
    layer = _mamba_layer_flops({**cfg, "family": "ssm"}, batch * seq)
    return {key: n_tower * layer[key] for key in ("weight", "act")}


def in_proj_flops(cfg: Dict) -> float:
    """Forward FLOPs of θ0's first in-projection, a token."""
    return _mamba_layer_flops(cfg, 1)["in_proj"]


def _scan_state(cfg: Dict) -> int:
    k = dims(cfg)
    return k["d_in"] * k["N"] if cfg["ssm_version"] == 1 else k["H"] * k["P"] * k["N"]


def backbone_scans(cfg: Dict) -> List[Tuple[int, int]]:
    """One scan a Mamba layer of θ0."""
    return [(_scan_state(cfg), cfg["num_layers"])]


def tower_scans(cfg: Dict, n_tower: int) -> List[Tuple[int, int]]:
    """One scan a Mamba block of a tower."""
    return [(_scan_state({**cfg, "family": "ssm"}), n_tower)]
