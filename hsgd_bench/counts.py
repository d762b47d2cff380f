"""The work a C-HSGD round needs, counted from the configuration and the
traffic alone (the yardstick of the per-layer metrics).

FLOPs are 2·M·N·K of every matrix product and einsum that eqs. (5)–(7) and
the exchange need at the cell's shapes, each once: no recomputation, no
padding, no scan, convolution or elementwise operation. Causal attention
counts the S(S+1)/2 query-key pairs it needs. A product whose one operand
is a weight costs its forward once more for the input's gradient and once
more for the weight's; a product of two activations costs its forward
twice more. Per pod and local step:

  * the hospital's loss: the tower h1 over the first segment, θ0 over the
    whole sequence and the head; backward with every weight's gradient;
    the input gradient of θ0's first in-projection only over ζ1's positions;
  * the device's loss: θ0 (stale) and the head, backward with input
    gradients only (the first in-projection's over ζ2's positions), and
    the tower h2 with its weights' gradients;

and per pod and exchange the two towers' forwards.

Bytes: an exchange reads and writes every element of its message {θ0 of
every pod, ζ1, ζ2} once; a scan reads a, b and h0 and writes every state
and the last one, its backward reads a, h0, the states and their gradients
and writes the gradients of a, b and h0 (``kernels/ssm_scan.py``'s layout:
a and b [B, T, C], C the state size a token). fp32 throughout.
"""
from __future__ import annotations

from typing import Dict

from hsgd_bench.reference.model import dims

F32 = 4


def _mamba_layer(cfg: Dict, tokens: int) -> Dict[str, float]:
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


def _shared_block(cfg: Dict, batch: int, seq: int) -> Dict[str, float]:
    k = dims(cfg)
    d, H, KH, hd, ff = k["d"], k["heads"], k["kv_heads"], k["hd"], k["ff"]
    tokens = batch * seq
    weight = 2.0 * tokens * (d * H * hd + 2 * d * KH * hd + H * hd * d + 3 * d * ff)
    pairs = seq * (seq + 1) / 2
    act = 2 * (2.0 * batch * H * hd * pairs)  # scores and the weighted sum of values
    return {"weight": weight, "act": act}


def _backbone(cfg: Dict, batch: int, seq: int) -> Dict[str, float]:
    layer = _mamba_layer(cfg, batch * seq)
    L = cfg["num_layers"]
    out = {"weight": L * layer["weight"], "act": L * layer["act"]}
    if cfg["family"] == "hybrid":
        blocks = L // (cfg["hybrid_attn_every"] or L)
        sb = _shared_block(cfg, batch, seq)
        out = {key: out[key] + blocks * sb[key] for key in out}
    return out


def _tower(cfg: Dict, tokens: int, n_tower: int) -> Dict[str, float]:
    layer = _mamba_layer({**cfg, "family": "ssm"}, tokens)
    return {key: n_tower * layer[key] for key in ("weight", "act")}


def step_flops(cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    """One pod's local step: the hospital's and the device's loss, forward and backward."""
    B, S = traffic["batch"], traffic["seq"]
    s1, s2 = S // 2, S - S // 2
    t1, t2 = _tower(cfg, B * s1, n_tower), _tower(cfg, B * s2, n_tower)
    body = _backbone(cfg, B, S)
    head = 2.0 * B * S * cfg["d_model"] * cfg["vocab_size"]
    first = _mamba_layer(cfg, 1)["in_proj"]  # the first in-projection, a token
    fwd = lambda p: p["weight"] + p["act"]
    # input gradients of the first in-projection over the whole sequence are
    # in ``body``'s backward; only one segment's are needed
    hospital = 3 * (fwd(t1) + fwd(body) + head) - first * B * s2
    device = (fwd(body) + head) + (body["weight"] + 2 * body["act"] + head) \
        - first * B * s1 + 3 * fwd(t2)
    return hospital + device


def exchange_flops(cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    """One pod's exchange: both towers' forwards."""
    B, S = traffic["batch"], traffic["seq"]
    fwd = lambda p: p["weight"] + p["act"]
    return fwd(_tower(cfg, B * (S // 2), n_tower)) + fwd(_tower(cfg, B * (S - S // 2), n_tower))


def round_flops(cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    G, P, Q = traffic["pods"], traffic["P"], traffic["Q"]
    return G * (P * step_flops(cfg, traffic, n_tower) + (P // Q) * exchange_flops(cfg, traffic,
                                                                                   n_tower))


def param_count(layout) -> int:
    from hsgd_bench.weights import leaves
    total = 0
    for _, spec in leaves(layout):
        n = 1
        for s in spec[0]:
            n *= s
        total += n
    return total


def exchange_bytes(cfg: Dict, traffic: Dict, layout) -> float:
    """One exchange's message {θ0 of every pod, ζ1, ζ2}, read once and written once."""
    G, B, S, d = traffic["pods"], traffic["batch"], traffic["seq"], cfg["d_model"]
    elements = G * (param_count(layout["theta0"]) + B * S * d)
    return 2.0 * F32 * elements


def _scan_state(cfg: Dict) -> int:
    k = dims(cfg)
    return k["d_in"] * k["N"] if cfg["ssm_version"] == 1 else k["H"] * k["P"] * k["N"]


def _scan_bytes(B: int, T: int, C: int, backward: bool) -> float:
    if backward:
        return F32 * (5.0 * B * T * C + 3.0 * B * C)
    return F32 * (3.0 * B * T * C + 2.0 * B * C)


def round_scan_bytes(cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    """Every scan a round needs, forward and backward, over the real tokens."""
    G, P, Q, B, S = traffic["pods"], traffic["P"], traffic["Q"], traffic["batch"], traffic["seq"]
    s1, s2 = S // 2, S - S // 2
    C, Ct, L = _scan_state(cfg), _scan_state({**cfg, "family": "ssm"}), cfg["num_layers"]
    both = lambda T, C_, n: n * (_scan_bytes(B, T, C_, False) + _scan_bytes(B, T, C_, True))
    # hospital: h1 and θ0 forward and backward; device: θ0 and h2 the same
    step = both(s1, Ct, n_tower) + 2 * both(S, C, L) + both(s2, Ct, n_tower)
    exch = n_tower * (_scan_bytes(B, s1, Ct, False) + _scan_bytes(B, s2, Ct, False))
    return G * (P * step + (P // Q) * exch)
