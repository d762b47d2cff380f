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

The model's part, the forward FLOPs of θ0's body and of a tower, its first
in-projection's and the scans a forward runs, comes from the cell's
reference module (``reference/model.py`` describes the contract), passed
in as ``model``; this module adds the split's structure, the head, the
exchange and the bytes.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

F32 = 4


def step_flops(model: ModuleType, cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    """One pod's local step: the hospital's and the device's loss, forward and backward."""
    B, S = traffic["batch"], traffic["seq"]
    s1, s2 = S // 2, S - S // 2
    t1, t2 = model.tower_flops(cfg, B, s1, n_tower), model.tower_flops(cfg, B, s2, n_tower)
    body = model.backbone_flops(cfg, B, S)
    head = 2.0 * B * S * cfg["d_model"] * cfg["vocab_size"]
    first = model.in_proj_flops(cfg)  # the first in-projection, a token
    fwd = lambda p: p["weight"] + p["act"]
    # input gradients of the first in-projection over the whole sequence are
    # in ``body``'s backward; only one segment's are needed
    hospital = 3 * (fwd(t1) + fwd(body) + head) - first * B * s2
    device = (fwd(body) + head) + (body["weight"] + 2 * body["act"] + head) \
        - first * B * s1 + 3 * fwd(t2)
    return hospital + device


def exchange_flops(model: ModuleType, cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    """One pod's exchange: both towers' forwards."""
    B, S = traffic["batch"], traffic["seq"]
    fwd = lambda p: p["weight"] + p["act"]
    return fwd(model.tower_flops(cfg, B, S // 2, n_tower)) \
        + fwd(model.tower_flops(cfg, B, S - S // 2, n_tower))


def round_flops(model: ModuleType, cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    G, P, Q = traffic["pods"], traffic["P"], traffic["Q"]
    return G * (P * step_flops(model, cfg, traffic, n_tower)
                + (P // Q) * exchange_flops(model, cfg, traffic, n_tower))


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


def _scan_bytes(B: int, T: int, C: int, backward: bool) -> float:
    if backward:
        return F32 * (5.0 * B * T * C + 3.0 * B * C)
    return F32 * (3.0 * B * T * C + 2.0 * B * C)


def round_scan_bytes(model: ModuleType, cfg: Dict, traffic: Dict, n_tower: int = 1) -> float:
    """Every scan a round needs, forward and backward, over the real tokens."""
    G, P, Q, B, S = traffic["pods"], traffic["P"], traffic["Q"], traffic["batch"], traffic["seq"]
    s1, s2 = S // 2, S - S // 2
    body, towers = model.backbone_scans(cfg), model.tower_scans(cfg, n_tower)
    both = lambda T, scans: sum(n * (_scan_bytes(B, T, C, False) + _scan_bytes(B, T, C, True))
                                for C, n in scans)
    fwd = lambda T, scans: sum(n * _scan_bytes(B, T, C, False) for C, n in scans)
    # hospital: h1 and θ0 forward and backward; device: θ0 and h2 the same
    step = both(s1, towers) + 2 * both(S, body) + both(s2, towers)
    exch = fwd(s1, towers) + fwd(s2, towers)
    return G * (P * step + (P // Q) * exch)
