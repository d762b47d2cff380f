"""Mixture-of-Experts: top-k router + capacity-based scatter dispatch (``repro/models/moe.py``).

Every token picks ``experts_per_token`` experts by router probability;
each expert takes at most C tokens (``_capacity``), in token order, and the
assignments past C are dropped. Tokens are scattered into per-expert
buffers [E, C, D], the experts run as three batched products, and each
token's output is the gate-weighted sum of its picks.

What differs from the reference, and why:
  * ``jax.lax.top_k`` breaks ties toward the lower expert index; the port
    takes a stable descending sort, which keeps that order
    (``torch.topk`` promises none).
  * The reference scatter-adds into the buffers, the dropped assignments
    adding zeros at slot C - 1. The kept assignments land on distinct
    (expert, slot) pairs, so the port copies them (``index_put``) and
    sends the dropped ones to one spare row past the buffers: the same
    values, without atomics.
  * The reference scatter-adds each token's k weighted picks into its
    output, left to right; the port adds them in that order, so a rerun on
    the card gives the same bits.

The dispatch (router, slots, scatter), the experts' products and the
combine run inside spans (``common/spans.py``) named by ``MOE_RANGES``:
while a profiler traces, each is a ``torch.profiler.record_function``
range, which ``launch/profile_serve.py`` reads to split the device time by
kernel class; otherwise each costs one check of the profiler's flag.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.sharding import constrain, use_weight
from repro_torch.common.spans import span
from repro_torch.models import layers as L
from repro_torch.models.mlp import mlp_forward, mlp_specs

CAPACITY_FACTOR = 1.25
MOE_RANGES = ("moe_dispatch", "moe_experts", "moe_combine")


def moe_specs(cfg: ModelConfig) -> Dict[str, L.Spec]:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    s: Dict[str, L.Spec] = {
        "router": L.Spec((d, E), ("embed", "experts"), "normal", 0.02),
        "w_gate": L.Spec((E, d, f), ("experts", "embed", "mlp")),
        "w_up": L.Spec((E, d, f), ("experts", "embed", "mlp")),
        "w_down": L.Spec((E, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(cfg, d_ff=cfg.num_shared_experts * f)
    return s


def _capacity(num_tokens: int, E: int, k: int) -> int:
    """Slots an expert: 1.25x the mean load, rounded up to 128, at least
    128 (the reference's rounding, which sets which tokens drop)."""
    c = int(num_tokens * k * CAPACITY_FACTOR / E) + 1
    return max(128, -(-c // 128) * 128)


def route(params, flat, cfg: ModelConfig):
    """Router over tokens [T, D] -> (probs [T, E], gate [T, k], idx [T, k]):
    fp32 softmax probabilities, the top k of them in descending order (ties
    to the lower expert index, as ``jax.lax.top_k``) and their expert ids;
    the gates renormalized to sum to 1."""
    router = use_weight(params["router"], ("embed", "experts"))
    logits = torch.matmul(flat.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gate, idx = srt[:, :k], order[:, :k]
    gate = gate / torch.clamp_min(torch.sum(gate, dim=-1, keepdim=True), 1e-9)
    return probs, gate, idx


def dispatch_positions(idx, E: int, C: int):
    """Each assignment's slot in its expert's buffer: its 0-based rank
    among the expert's assignments in token-major order ([T * k]), and
    whether it is kept (rank < C)."""
    flat_idx = idx.reshape(-1)
    ranks = torch.cumsum(torch.nn.functional.one_hot(flat_idx, E), dim=0)
    pos = torch.gather(ranks, 1, flat_idx[:, None])[:, 0] - 1
    return pos, pos < C


def moe_forward(params, x, cfg: ModelConfig):
    """x: [B, S, D] -> (out [B, S, D], aux_loss scalar: the Switch-style
    load-balance loss E · sum(density · mean probability))."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, E, k)
    flat = x.reshape(T, D)
    with span(MOE_RANGES[0]):
        probs, gate, idx = route(params, flat, cfg)
        density = torch.mean(torch.nn.functional.one_hot(idx[:, 0], E).float(), dim=0)
        aux_loss = E * torch.sum(density * torch.mean(probs, dim=0))
        pos, keep = dispatch_positions(idx, E, C)
        flat_idx = idx.reshape(-1)
        # kept assignments on distinct rows of the [E * C] buffers; the
        # dropped ones all on the spare row E * C, which is cut off
        dst = torch.where(keep, flat_idx * C + pos, E * C)
        src = flat.repeat_interleave(k, dim=0)
        buf = x.new_zeros((E * C + 1, D)).index_put((dst,), src)[:E * C].view(E, C, D)
        buf = constrain(buf, ("experts", "expert_tokens", None))
        del src

    with span(MOE_RANGES[1]):
        act = L.ACTIVATIONS["silu" if cfg.mlp in ("swiglu", "geglu") else "gelu"]
        wg = use_weight(params["w_gate"], ("experts", "embed", "mlp"))
        wu = use_weight(params["w_up"], ("experts", "embed", "mlp"))
        g = torch.bmm(buf, wg.to(x.dtype))
        u = torch.bmm(buf, wu.to(x.dtype))
        h = constrain(act(g) * u, ("experts", "expert_tokens", "mlp"))
        del g, u
        wd = use_weight(params["w_down"], ("experts", "mlp", "embed"))
        eout = constrain(torch.bmm(h, wd.to(x.dtype)), ("experts", "expert_tokens", None))
        eout = eout.view(E * C, D)
        del h

    with span(MOE_RANGES[2]):
        picked = eout[flat_idx * C + torch.where(keep, pos, C - 1)]
        picked = torch.where(keep[:, None], picked, 0.0)
        weighted = (picked * gate.reshape(-1)[:, None].to(x.dtype)).view(T, k, D)
        out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
        for j in range(k):  # the reference's scatter-add order: pick 0, 1, ...
            out = out + weighted[:, j]

    if cfg.num_shared_experts:
        out = out + mlp_forward(params["shared"], flat, cfg)
    # a DTensor whose tokens are split over data and model cannot be viewed
    # back as [B, S, D] when B alone does not take both: keep the tokens on
    # the batch axes only (the identity on a plain tensor)
    return constrain(out, ("batch", None)).reshape(B, S, D), aux_loss
