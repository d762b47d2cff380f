"""Adaptive strategies 1–3 (paper §VI) + the ρ/δ pre-training probes.

Theorem 1 (eq. 17):  with η ≤ 1/(8Pρ),
  E[ (1/R) Σ ||∇F(θ̃^{rP})||² ] ≤ 4(F(θ̃⁰) − F*)/(ηT) + 12Pρηδ² + 96Q²ρ²η²δ²

Strategy 1: minimum communication for a target bound Ξ is at Λ = P/Q = 1.
Strategy 2: P* = Q* = sqrt( F(θ̃⁰) / (24 ρ² η² δ² T) )   (E[F(θ̃^T)] ≈ 0).
Strategy 3: η* = min(η₂, 1/(8Pρ)) with η₂ the positive root of
  3aη² + 2bη − c = 0,  a = 24Q²Pρ²δ², b = 3P²ρδ², c = (P/4)||∇F||²;
  η* decreases when P grows (Q fixed) and when Q grows (P/Q fixed).

The formulas are host-side float math, the reference's line for line
(``repro/core/adaptive.py``), so the same inputs give the same numbers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import grad

from repro_torch.common.config import FederationConfig
from repro_torch.common.pytree import tree_dot, tree_leaves, tree_map, tree_norm, tree_sub
from repro_torch.models.split_model import HybridModel


# ---------------------------------------------------------------------------
# Theorem 1
# ---------------------------------------------------------------------------


def convergence_bound(F0: float, FT: float, rho: float, delta: float,
                      eta: float, P: int, Q: int, T: int) -> float:
    """The right-hand side Γ(P,Q) of eq. (17)."""
    return 4.0 * (F0 - FT) / (eta * T) + 12.0 * P * rho * eta * delta**2 \
        + 96.0 * Q**2 * rho**2 * eta**2 * delta**2


def max_learning_rate(P: int, rho: float) -> float:
    """Theorem 1's step-size condition η ≤ 1/(8Pρ)."""
    return 1.0 / (8.0 * P * rho)


# ---------------------------------------------------------------------------
# Strategy 1 — P = Q
# ---------------------------------------------------------------------------


def strategy1_lambda_lower_bound(F0: float, FT: float, rho: float, delta: float,
                                 eta: float, P: int, T: int, target: float) -> float:
    """Λ ≥ 4√6·Pρηδ / sqrt(Ξ − 4(F0−FT)/(ηT) − 12Pρηδ²)  (Prop. 1)."""
    denom_sq = target - 4.0 * (F0 - FT) / (eta * T) - 12.0 * P * rho * eta * delta**2
    if denom_sq <= 0:
        return math.inf  # target unreachable at this P/η
    return 4.0 * math.sqrt(6.0) * P * rho * eta * delta / math.sqrt(denom_sq)


def strategy1_intervals(Q: int) -> Tuple[int, int]:
    """Adaptive strategy 1: set P = Q."""
    return Q, Q


# ---------------------------------------------------------------------------
# Strategy 2 — optimal P = Q
# ---------------------------------------------------------------------------


def strategy2_optimal_interval(F0: float, rho: float, delta: float, eta: float, T: int,
                               FT: float = 0.0) -> int:
    """P* = Q* = sqrt((F0 − E[F_T]) / (24 ρ² η² δ² T)), E[F_T] approximated by 0."""
    q = math.sqrt(max(F0 - FT, 1e-12) / (24.0 * rho**2 * eta**2 * delta**2 * T))
    return max(1, int(round(q)))


# ---------------------------------------------------------------------------
# Strategy 3 — learning-rate adjustment
# ---------------------------------------------------------------------------


def strategy3_learning_rate(P: int, Q: int, rho: float, delta: float,
                            grad_norm_sq: float) -> float:
    """η* = min(η₂, 1/(8Pρ)) from Prop. 3."""
    a = 24.0 * Q**2 * P * rho**2 * delta**2
    b = 3.0 * P**2 * rho * delta**2
    c = (P / 4.0) * grad_norm_sq
    if a <= 0:
        return max_learning_rate(P, rho)
    eta2 = (-2.0 * b + math.sqrt(4.0 * b**2 + 12.0 * a * c)) / (6.0 * a)
    return min(eta2, max_learning_rate(P, rho))


# ---------------------------------------------------------------------------
# ρ / δ estimation probes (pre-training, §VI-B "small number of pre-training")
# ---------------------------------------------------------------------------


def probe_draws(params, total: int, generator: torch.Generator, n_probes: int = 8,
                n_perturb: int = 4, batch: int = 32) -> Dict[str, Any]:
    """The random draws of one ``estimate_rho_delta`` call, from a CPU
    ``generator``: ``probe_idx`` [n_probes, batch] and ``lip_idx``
    [lip_batch] sample rows without replacement, ``perturb`` holds
    n_perturb standard-normal trees shaped like ``params``."""
    batch = int(min(batch, total))
    lip_batch = int(min(4 * batch, total))
    probe_idx = torch.stack([torch.randperm(total, generator=generator)[:batch]
                             for _ in range(n_probes)])
    lip_idx = torch.randperm(total, generator=generator)[:lip_batch]
    perturb = [tree_map(lambda p: torch.randn(p.shape, generator=generator, dtype=p.dtype),
                        params) for _ in range(n_perturb)]
    return {"probe_idx": probe_idx, "lip_idx": lip_idx, "perturb": perturb}


def estimate_rho_delta(
    model: HybridModel,
    params,
    data: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    n_probes: int = 8,
    n_perturb: int = 4,
    batch: int = 32,
    perturb: float = 1e-2,
    draws: Optional[Dict[str, Any]] = None,
) -> Dict[str, float]:
    """Estimate the Lipschitz constant ρ and gradient noise δ of Assumptions 1–2.

    δ²: variance of mini-batch gradients around their mean.
    ρ : max ||∇F(θ+u) − ∇F(θ)|| / ||u|| over random perturbations u.
    Returns also F0 (initial loss) for strategies 1–2.

    The mini-batches (drawn without replacement, clamped to the M·K
    samples) and the perturbations come from ``generator`` (a CPU
    generator), or from ``draws`` as ``probe_draws`` lays them out — so a
    test can replay the reference's draws.
    """
    M, K = data["y"].shape[:2]
    total = M * K
    if draws is None:
        draws = probe_draws(params, total, generator, n_probes, n_perturb, batch)
    device = data["y"].device
    x1 = data["x1"].reshape((total,) + tuple(data["x1"].shape[2:]))
    x2 = data["x2"].reshape((total,) + tuple(data["x2"].shape[2:]))
    y = data["y"].reshape(-1)
    grad_fn = grad(model.full_loss)

    def batch_of(idx):
        idx = torch.as_tensor(idx, dtype=torch.long).to(device)
        return x1[idx], x2[idx], y[idx]

    grads = [grad_fn(params, *batch_of(idx)) for idx in draws["probe_idx"]]
    stacked = tree_map(lambda *g: torch.stack(g), *grads)
    dev = tree_map(lambda g: torch.sum((g - torch.mean(g, dim=0)[None]) ** 2,
                                       dim=tuple(range(1, g.dim()))), stacked)
    delta2 = torch.mean(sum(tree_leaves(dev)))

    xb1, xb2, yb = batch_of(draws["lip_idx"])
    g_base = grad_fn(params, xb1, xb2, yb)
    secants = []
    for z in draws["perturb"]:
        u = tree_map(lambda zz: perturb * torch.as_tensor(zz).to(device), z)
        g2 = grad_fn(tree_map(torch.add, params, u), xb1, xb2, yb)
        secants.append(tree_norm(tree_sub(g2, g_base)) / torch.clamp_min(tree_norm(u), 1e-12))
    rho = torch.max(torch.stack(secants))
    F0 = model.full_loss(params, xb1, xb2, yb)
    gnorm2 = tree_dot(g_base, g_base)
    rho, delta2, F0, gnorm2 = torch.stack([rho, delta2, F0, gnorm2]).tolist()
    return {"rho": float(rho), "delta": math.sqrt(max(float(delta2), 1e-12)),
            "F0": float(F0), "grad_norm_sq": float(gnorm2)}


def recommend_settings(probe: Dict[str, float], T: int, eta: float,
                       fed: FederationConfig) -> Dict[str, float]:
    """One-stop application of the three strategies."""
    rho, delta, F0 = probe["rho"], probe["delta"], probe["F0"]
    Pstar = strategy2_optimal_interval(F0, rho, delta, eta, T)
    eta_star = strategy3_learning_rate(Pstar, Pstar, rho, delta, probe["grad_norm_sq"])
    return {
        "P": Pstar,
        "Q": Pstar,  # strategy 1
        "eta": eta_star,
        "eta_max": max_learning_rate(Pstar, rho),
        "bound_at_star": convergence_bound(F0, 0.0, rho, delta, eta_star, Pstar, Pstar, T),
    }
