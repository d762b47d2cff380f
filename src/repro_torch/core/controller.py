"""Closed-loop adaptive HSGD controller — the paper's §VI strategies, online.

``AdaptiveHSGDRunner`` turns the offline one-shot formulas of
``core/adaptive.py`` into a between-rounds control loop. Code ↔ §VI map:

  Theorem 1, eq. (17)   Γ(P,Q) = 4(F−F*)/(ηT) + 12Pρηδ² + 96Q²ρ²η²δ²
                        -> ``adaptive.convergence_bound``; the controller
                        keeps Γ ≤ the user's target Ξ (Prop. 1's accuracy
                        target) by shrinking P when the bound would overshoot.
  Strategy 1 (Prop. 1)  Λ = P/Q = 1 minimizes C(P,Q) at a given Ξ
                        -> every plan sets Q = P.
  Strategy 2 (Prop. 2)  P* = Q* = sqrt((F − E[F_T]) / (24 ρ² η² δ² T))
                        -> ``adaptive.strategy2_optimal_interval`` re-evaluated
                        every round with the *remaining* iteration budget T_rem
                        and the current loss standing in for F(θ̃⁰).
  Strategy 3 (Prop. 3)  η* = min(η₂, 1/(8Pρ))
                        -> ``adaptive.strategy3_learning_rate`` re-picked after
                        every P change from the online ‖∇F‖² estimate.
  §VI-B probes          ρ, δ estimated "with a small number of pre-training
                        iterations" -> ``adaptive.estimate_rho_delta`` seeds
                        the loop; afterwards each round's OWN gradients are
                        reused (``local_sgd_step_stats``): δ² from per-worker
                        gradient spread, ρ from within-interval secants
                        ‖ḡ_{t+1} − ḡ_t‖ / (η‖ḡ_t‖), ‖∇F‖² from ‖ḡ‖². No
                        extra forward passes — the probes are free.
  Eq. (19) governor     C(P,Q)/T per-iteration wire cost
                        -> ``comm_model.comm_cost_per_iteration`` projects the
                        end-of-run bytes; when the projection exceeds the
                        user's byte budget the governor tightens the message
                        (``COMPRESSION_LADDER`` top-k/quantization rungs, then
                        larger P = Q), never loosening within a run.

Every executed round goes through ``HSGDRunner.round_fn`` — one cached
round executor per (P, Q, compression) bucket (P snaps to powers of two).

The loop's bookkeeping is representation-agnostic: ``ControllerCore`` holds
the probe EMA, the step/byte/seconds/ρ ledgers, and the ladder ratchets, and
only ever sees (a) a ``sizes_of(k, b)`` callback for the eq. (19) cost model
and (b) the per-step stats a round executor emits. ``AdaptiveHSGDRunner``
binds it to the e-health ``HSGDState`` path. Planning is host-side float
math, the reference's (``repro/core/controller.py``) line for line, so the
same probes and stats give the same ``RoundPlan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.buckets import pow2_floor as _pow2_floor
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_leaves, tree_map, tree_size
from repro_torch.core import comm_model as CM
from repro_torch.core import federation as F
from repro_torch.core.adaptive import (
    convergence_bound,
    estimate_rho_delta,
    max_learning_rate,
    strategy2_optimal_interval,
    strategy3_learning_rate,
)
from repro_torch.core.compression import (
    COMPRESSION_LADDER,
    DP_SIGMA_LADDER,
    compressed_bytes,
)
from repro_torch.core.hsgd import (
    HSGDRunner,
    HSGDState,
    dp_noise_generator,
    global_model,
    place_on_mesh,
)
from repro_torch.models.split_model import HybridModel


@dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the closed loop (all byte quantities are *modeled* wire bytes
    across ALL groups, per the eq. (19) cost model)."""

    total_steps: int = 128          # T: total SGD iterations to spend
    target_bound: float = math.inf  # Ξ: keep Γ(P,Q) ≤ this (Prop. 1 target)
    byte_budget: float = math.inf   # honor this end-of-run byte projection
    time_budget: float = math.inf   # honor this end-of-run wall-clock projection (s)
    max_interval: int = 32          # cap on P = Q
    eta_min: float = 1e-4
    eta_max: float = 0.1
    ema: float = 0.5                # probe smoothing: old*ema + new*(1-ema)
    probe_slew: float = 4.0         # per-round cap on a probe's growth/shrink ratio
    ladder: Tuple[Tuple[float, int], ...] = COMPRESSION_LADDER
    init_probe: bool = True         # §VI-B pre-training probe before round 1
    probe_batch: int = 32
    # -- privacy knobs (DP off unless clip AND sigma are positive) ----------
    privacy_budget: float = math.inf  # ε: refuse plans whose projection busts it
    privacy_delta: float = 1e-5       # δ of the (ε, δ) conversion
    dp_clip: float = 0.0              # per-row L2 clip C of the fused DP stage
    dp_sigma: float = 0.0             # base noise multiplier (noise std = σ·C)
    dp_ladder: Tuple[float, ...] = DP_SIGMA_LADDER  # σ multipliers, ratcheted up
    secure_agg: bool = False          # pairwise-mask the eq. (1) uplink


@dataclass(frozen=True)
class RoundPlan:
    """One round's settings as picked by strategies 1–3 + the governor."""

    P: int
    Q: int
    eta: float
    rung: int                 # index into the compression ladder
    gamma: float              # Γ(P,Q) at the picked settings
    projected_bytes: float    # end-of-run byte projection at these settings
    projected_seconds: float = 0.0  # end-of-run wall-clock projection (0 = unmodeled)
    dp_rung: int = 0          # index into the DP σ ladder (0 when DP is off)
    dp_sigma: float = 0.0     # effective noise multiplier this round (0 = off)
    projected_epsilon: float = 0.0  # end-of-run ε projection (0 = unmodeled)
    dp_exhausted: bool = False  # True: even the governed plan busts ε — refuse


class AdaptiveResult(NamedTuple):
    state: HSGDState
    losses: np.ndarray        # [total_steps]
    history: List[Dict[str, Any]]  # one record per executed round


def ladder_from(compression_k: float, quant_levels: int,
                base: Tuple[Tuple[float, int], ...] = COMPRESSION_LADDER,
                ) -> Tuple[Tuple[float, int], ...]:
    """Governor ladder that STARTS at an explicitly requested compression
    setting (e.g. c-hsgd's k=0.25/b=128) and only tightens from there: the
    user's (k, b) becomes rung 0, followed by the base rungs with strictly
    smaller wire size. No compression requested -> the base ladder."""
    if not (compression_k or quant_levels):
        return base
    n_ref = 1 << 20
    user_bytes = compressed_bytes(n_ref, compression_k or 1.0, quant_levels)
    tail = tuple((k, b) for k, b in base
                 if compressed_bytes(n_ref, k or 1.0, b) < user_bytes)
    return ((compression_k, quant_levels),) + tail


def gaussian_rho(sigma: float) -> float:
    """zCDP cost ρ of ONE Gaussian-mechanism release at noise multiplier σ
    (sensitivity is normalized away by the per-row clip: std = σ·C for
    sensitivity C, so ρ = 1/(2σ²)). σ ≤ 0 means no noise — infinite cost."""
    if sigma <= 0.0:
        return math.inf
    return 1.0 / (2.0 * sigma * sigma)


def epsilon_of(rho: float, delta: float) -> float:
    """(ε, δ) bound of accumulated zCDP budget ρ: ε = ρ + 2√(ρ·ln(1/δ)).

    zCDP composes additively across rounds (ρ_total = Σ ρ_i), so the ledger
    stores ρ and converts once at read time — tighter than naive (ε, δ)
    composition and monotone in both arguments, which the governor relies on."""
    if rho <= 0.0:
        return 0.0
    if not math.isfinite(rho):
        return math.inf
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


def plan_round(
    probe: Dict[str, float],
    steps_done: int,
    bytes_spent: float,
    rung: int,
    eta_prev: float,
    cfg: AdaptiveConfig,
    fed: FederationConfig,
    sizes_of,
    time_of=None,
    seconds_spent: float = 0.0,
    dp_rung: int = 0,
    privacy_spent: float = 0.0,
) -> RoundPlan:
    """Pure planning step: probes -> (P, Q, η, compression rung).

    ``sizes_of(k_frac, levels)`` returns the per-group ``MessageSizes`` at a
    ladder rung. Separated from the runner so the governor logic is unit-
    testable without training anything.

    ``time_of(P, rung)`` (optional) returns the modeled wall-clock seconds of
    ONE global round at P = Q and that ladder rung — under straggler tails
    when the caller is a population run (``population.expected_round_seconds``).
    With it, the eq. (19) byte governor becomes a joint byte + wall-clock
    governor: the projection that busts EITHER budget first ratchets the
    compression ladder, then amortizes harder with a larger P = Q (which
    divides the per-round t_g and per-interval exchange overheads over more
    SGD steps), so the loop optimizes time-to-accuracy rather than bytes
    alone.
    """
    rho = max(probe["rho"], 1e-6)
    delta = max(probe["delta"], 1e-9)
    F_cur = max(probe["F0"], 1e-9)
    gnorm2 = max(probe["grad_norm_sq"], 0.0)
    T_rem = max(cfg.total_steps - steps_done, 1)

    def eta_for(P: int) -> float:
        eta = strategy3_learning_rate(P, P, rho, delta, gnorm2)  # strategy 3
        # the anti-stall floor yields to Theorem 1's cap 1/(8Pρ): Γ's formula
        # (and the guard below) is only valid under η ≤ that cap
        floor = min(cfg.eta_min, max_learning_rate(P, rho))
        return min(max(eta, floor), cfg.eta_max)

    def gamma(P: int, eta: float) -> float:
        return convergence_bound(F_cur, 0.0, rho, delta, eta, P, P, T_rem)

    def projected(P: int, rung: int) -> float:
        k, b = cfg.ladder[rung]
        per_iter = CM.comm_cost_per_iteration(
            sizes_of(k, b),
            FederationConfig(local_interval=P, global_interval=P),
        ) * fed.num_groups
        return bytes_spent + per_iter * T_rem

    def projected_s(P: int, rung: int) -> float:
        if time_of is None:
            return 0.0
        return seconds_spent + time_of(P, rung) * (T_rem / P)

    def over_budget(P: int, rung: int) -> bool:
        return (projected(P, rung) > cfg.byte_budget
                or projected_s(P, rung) > cfg.time_budget)

    # strategies 2 + 1: optimal sync interval, with Q = P
    P = strategy2_optimal_interval(F_cur, rho, delta, eta_prev, T_rem)
    P = _pow2_floor(max(1, min(P, cfg.max_interval, T_rem)))
    eta = eta_for(P)

    # Theorem-1 guard: Γ grows with P at fixed η, so shrink P until Γ ≤ Ξ
    while P > 1 and gamma(P, eta) > cfg.target_bound:
        P //= 2
        eta = eta_for(P)

    # byte/wall-clock governor: tighten the message until both projections fit
    while over_budget(P, rung) and rung < len(cfg.ladder) - 1:
        rung += 1
    # tightest rung still over a budget -> amortize harder with a larger
    # P = Q, as long as the Theorem-1 target allows it
    while (over_budget(P, rung)
           and 2 * P <= min(cfg.max_interval, T_rem)
           and gamma(2 * P, eta_for(2 * P)) <= cfg.target_bound):
        P *= 2
        eta = eta_for(P)

    # privacy governor: each global round releases P/Q = 1 Gaussian-mechanism
    # message per group-pair (strategy 1), so the run has ceil(T_rem/P) more
    # releases ahead. Project the end-of-run ε; when it busts the budget, walk
    # the σ ladder UP (σ is a traced kernel operand — zero extra compiles),
    # then amortize with a larger P = Q (fewer releases), and only if BOTH are
    # exhausted refuse the plan outright (dp_exhausted — the caller must stop
    # training rather than silently overspend ε).
    dp = cfg.dp_clip > 0.0 and cfg.dp_sigma > 0.0
    dp_sigma, eps_proj, dp_exhausted = 0.0, 0.0, False
    if dp:
        def eps_after(P_: int, dr: int) -> float:
            releases = math.ceil(T_rem / P_)  # one release per round (Q = P)
            rho_more = releases * gaussian_rho(cfg.dp_sigma * cfg.dp_ladder[dr])
            return epsilon_of(privacy_spent + rho_more, cfg.privacy_delta)

        while (eps_after(P, dp_rung) > cfg.privacy_budget
               and dp_rung < len(cfg.dp_ladder) - 1):
            dp_rung += 1
        while (eps_after(P, dp_rung) > cfg.privacy_budget
               and 2 * P <= min(cfg.max_interval, T_rem)
               and gamma(2 * P, eta_for(2 * P)) <= cfg.target_bound):
            P *= 2
            eta = eta_for(P)
        dp_sigma = cfg.dp_sigma * cfg.dp_ladder[dp_rung]
        eps_proj = eps_after(P, dp_rung)
        dp_exhausted = eps_proj > cfg.privacy_budget

    return RoundPlan(P=P, Q=P, eta=eta, rung=rung,
                     gamma=gamma(P, eta), projected_bytes=projected(P, rung),
                     projected_seconds=projected_s(P, rung),
                     dp_rung=dp_rung, dp_sigma=dp_sigma,
                     projected_epsilon=eps_proj, dp_exhausted=dp_exhausted)


# neutral probe seed: the first plan degenerates to P = Q = 1 and the online
# stats take over from round 1 (used when no §VI-B pre-training probe runs)
NEUTRAL_PROBE = {"rho": 1.0, "delta": 1.0, "F0": 1.0, "grad_norm_sq": 1.0}


def probe_from_stats(stats, Q: int, fallback_rho: float = 1.0) -> Dict[str, float]:
    """Raw §VI-B probe measurement from one round's [P] stats arrays.

    ``stats`` is the dict every round executor emits (loss/gnorm2/delta2/rho/
    rho_ok per step) — shared by the e-health and LLM runners, so the probe
    extraction lives here, independent of either state representation.
    """
    loss = np.asarray(stats["loss"])
    rho = np.asarray(stats["rho"])
    ok = np.asarray(stats["rho_ok"]) > 0.5
    return {
        "F0": float(np.mean(loss[-Q:])),
        "delta": float(np.sqrt(max(float(np.mean(np.asarray(stats["delta2"]))), 1e-16))),
        "grad_norm_sq": float(np.mean(np.asarray(stats["gnorm2"]))),
        # median valid secant ≈ local Lipschitz constant along the
        # trajectory (median, not max: a single staleness spike must not
        # collapse η through the 1/(8Pρ) cap). Q=1 rounds have no
        # within-interval pair — the caller keeps its standing estimate.
        "rho": float(np.median(rho[ok])) if ok.any() else fallback_rho,
    }


def update_probe(probe: Dict[str, float], stats, Q: int,
                 cfg: AdaptiveConfig) -> Dict[str, float]:
    """EMA + slew-limited probe update from one round's stats."""
    new = probe_from_stats(stats, Q, fallback_rho=probe["rho"])
    e, slew = cfg.ema, cfg.probe_slew
    out = {}
    for k in probe:
        v = e * probe[k] + (1.0 - e) * new[k]
        if slew > 1.0 and probe[k] > 0:  # trust region: bounded per-round drift
            v = min(max(v, probe[k] / slew), probe[k] * slew)
        out[k] = v
    return out


class ControllerCore:
    """State-representation-agnostic §VI loop: plan -> (caller runs the
    round) -> record.

    The caller owns the model state and the compiled round executors; the core
    owns everything else — the probe EMA, the ladder ratchet, the step/byte
    ledgers, and the per-round history. One core instance is one run.
    """

    def __init__(self, cfg: AdaptiveConfig, fed: FederationConfig, sizes_of,
                 eta0: float, probe: Optional[Dict[str, float]] = None,
                 time_of=None):
        self.cfg, self.fed, self.sizes_of = cfg, fed, sizes_of
        self.time_of = time_of  # (P, rung) -> modeled seconds of one round
        self.probe = dict(probe) if probe is not None else dict(NEUTRAL_PROBE)
        self.steps_done = 0
        self.bytes_spent = 0.0
        self.seconds_spent = 0.0  # wall-clock ledger (modeled, simulated time)
        self.rung = 0
        self.eta_prev = eta0
        self.history: List[Dict[str, Any]] = []
        # (ε, δ) ledger — zCDP ρ accumulates per executed DP round; the σ
        # rung ratchets up like the compression rung; privacy_exhausted stops
        # the run BEFORE a budget-busting round executes.
        self.rho_spent = 0.0
        self.dp_rung = 0
        self.privacy_exhausted = False

    @property
    def done(self) -> bool:
        return self.steps_done >= self.cfg.total_steps or self.privacy_exhausted

    @property
    def epsilon_spent(self) -> float:
        """ε of the (ε, δ=cfg.privacy_delta) guarantee spent so far."""
        return epsilon_of(self.rho_spent, self.cfg.privacy_delta)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-able ledger snapshot (everything plan/record mutate) so a
        checkpointed run resumes with bit-identical controller decisions."""
        return {
            "probe": dict(self.probe),
            "steps_done": int(self.steps_done),
            "bytes_spent": float(self.bytes_spent),
            "seconds_spent": float(self.seconds_spent),
            "rung": int(self.rung),
            "eta_prev": float(self.eta_prev),
            "rho_spent": float(self.rho_spent),
            "dp_rung": int(self.dp_rung),
            "privacy_exhausted": bool(self.privacy_exhausted),
            "history": [dict(h) for h in self.history],
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.probe = dict(sd["probe"])
        self.steps_done = int(sd["steps_done"])
        self.bytes_spent = float(sd["bytes_spent"])
        self.seconds_spent = float(sd["seconds_spent"])
        self.rung = int(sd["rung"])
        self.eta_prev = float(sd["eta_prev"])
        # pre-privacy checkpoints carry no ledger — resume with ε = 0 spent
        self.rho_spent = float(sd.get("rho_spent", 0.0))
        self.dp_rung = int(sd.get("dp_rung", 0))
        self.privacy_exhausted = bool(sd.get("privacy_exhausted", False))
        self.history = [dict(h) for h in sd["history"]]

    def plan(self) -> Tuple[RoundPlan, Tuple[float, int]]:
        """Next round's settings + its (k_frac, levels) ladder rung."""
        plan = plan_round(self.probe, self.steps_done, self.bytes_spent,
                          self.rung, self.eta_prev, self.cfg, self.fed,
                          self.sizes_of, time_of=self.time_of,
                          seconds_spent=self.seconds_spent,
                          dp_rung=self.dp_rung,
                          privacy_spent=self.rho_spent)
        self.rung = plan.rung  # the ladder is a ratchet: never loosened
        self.dp_rung = plan.dp_rung  # σ ratchet: never lowered within a run
        if plan.dp_exhausted:
            # refuse BEFORE executing: the caller's loop sees done == True and
            # stops with the (ε, δ) guarantee intact
            self.privacy_exhausted = True
        return plan, self.cfg.ladder[plan.rung]

    def record(self, plan: RoundPlan, stats,
               seconds: Optional[float] = None) -> Dict[str, Any]:
        """Charge the executed round's eq. (19) bill, log it, update probes.

        ``seconds`` is the round's realized simulated wall-clock (e.g. the
        population scheduler's deadline); when omitted the ``time_of`` model
        at the executed (P, rung) is charged instead. Both feed the same
        ledger the planner projects against.
        """
        k_frac, levels = self.cfg.ladder[plan.rung]
        round_bytes = CM.per_round_bytes(
            self.sizes_of(k_frac, levels), plan.P, plan.Q, self.fed.num_groups)
        self.bytes_spent += round_bytes
        self.steps_done += plan.P
        if seconds is None and self.time_of is not None:
            seconds = self.time_of(plan.P, plan.rung)
        round_seconds = float(seconds) if seconds is not None else 0.0
        self.seconds_spent += round_seconds
        if plan.dp_sigma > 0.0:
            # strategy 1: one Gaussian release per executed round (P/Q = 1)
            self.rho_spent += (plan.P // plan.Q) * gaussian_rho(plan.dp_sigma)
        rec = {
            "round": len(self.history), "P": plan.P, "Q": plan.Q,
            "eta": plan.eta, "rung": plan.rung,
            "compression_k": k_frac, "quant_levels": levels,
            "gamma": plan.gamma, "target_bound": self.cfg.target_bound,
            "rho": self.probe["rho"], "delta": self.probe["delta"],
            "grad_norm_sq": self.probe["grad_norm_sq"], "F0": self.probe["F0"],
            "round_bytes": round_bytes, "bytes_total": self.bytes_spent,
            "projected_bytes": plan.projected_bytes,
            "round_seconds": round_seconds, "seconds_total": self.seconds_spent,
            "projected_seconds": plan.projected_seconds,
            "dp_sigma": plan.dp_sigma, "dp_rung": plan.dp_rung,
            "epsilon_total": self.epsilon_spent,
            "projected_epsilon": plan.projected_epsilon,
            "steps_done": self.steps_done,
            "loss_last": float(np.asarray(stats["loss"])[-1]),
        }
        self.history.append(rec)
        self.eta_prev = plan.eta
        self.probe = update_probe(self.probe, stats, plan.Q, self.cfg)
        return rec


def hsgd_sizes_of(state: HSGDState, fed: FederationConfig):
    """sizes_of(k, levels) -> per-group MessageSizes for the governor, with
    z1/z2 element counts read off the live exchange buffers (per group =
    total / groups held). Shared by the adaptive runner and the population
    runner."""
    meta = lambda x, lead: torch.empty(x.shape[lead:], dtype=x.dtype, device="meta")
    params_shapes = {
        "theta0": tree_map(lambda x: meta(x, 1), state.theta0),
        "theta1": tree_map(lambda x: meta(x, 1), state.theta1),
        "theta2": tree_map(lambda x: meta(x, 2), state.theta2),
    }
    # per group: a state a group-sharded run returned holds M/n of them
    groups = tree_leaves(state.theta0)[0].shape[0]
    z1_el = tree_size(state.stale["z1"]) // groups
    z2_el = tree_size(state.stale["z2"]) // groups

    def sizes_of(k_frac: float, levels: int):
        return CM.message_sizes(params_shapes, z1_el, z2_el,
                                fed.sampled_devices, k_frac, levels)

    return sizes_of


class AdaptiveHSGDRunner:
    """Closed-loop trainer: plan -> run one round -> re-probe."""

    def __init__(
        self,
        model: HybridModel,
        fed: FederationConfig,
        train: TrainConfig,
        cfg: Optional[AdaptiveConfig] = None,
        do_global_agg: bool = True,
        fused_compression: bool = True,
    ):
        self.model, self.fed, self.train = model, fed, train
        self.cfg = cfg or AdaptiveConfig()
        self.runner = HSGDRunner(model, fed, train, do_global_agg=do_global_agg,
                                 fused_compression=fused_compression)

    # -- comm-model plumbing -------------------------------------------------

    def _sizes_of(self, state: HSGDState):
        return hsgd_sizes_of(state, self.fed)

    # -- main loop -----------------------------------------------------------

    def run(self, state: HSGDState, data, group_weights,
            probe_generator: Optional[torch.Generator] = None,
            participants: Optional[torch.Tensor] = None,
            dp_noise: Optional[Sequence[torch.Tensor]] = None, mesh=None) -> AdaptiveResult:
        """Drive ``cfg.total_steps`` SGD iterations adaptively.

        Consumes ``state`` round by round (rebind the returned state).
        Returns per-step losses and a per-round history of every decision the
        controller took (P, Q, η, rung, Γ, probes, modeled bytes, σ, ε).

        ``probe_generator`` (CPU) drives the §VI-B pre-training probe. Every
        round has Λ = P/Q = 1 exchange; ``participants`` ([n, M, A]) and
        ``dp_noise`` (n matrices) replace the draws of the first n exchanges,
        e.g. with the reference's. Without ``dp_noise`` the DP rows come
        from ``dp_noise_generator`` seeded with the A_m generator's seed.

        ``mesh`` shards the group axis as ``HSGDRunner.run(mesh=)`` does,
        after the probe (which reads the whole data and the global model on
        every process). The private legs run sharded too, with the meshless
        values: the DP noise of each exchange is the whole message's (drawn
        from the same generator, or the whole injected matrix) and each
        process keeps its groups' rows; the secure-aggregation masks are
        drawn for this process's groups only, under their global index.
        """
        cfg = self.cfg
        device = data["x1"].device
        if cfg.init_probe:
            gen = probe_generator if probe_generator is not None else torch.Generator().manual_seed(0)
            probe = estimate_rho_delta(self.model, global_model(state, group_weights, mesh),
                                       data, gen, batch=cfg.probe_batch)
        else:
            probe = None  # NEUTRAL_PROBE: first plan degenerates to P = Q = 1

        core = ControllerCore(cfg, self.fed, self._sizes_of(state),
                              eta0=self.train.learning_rate, probe=probe)
        dp = cfg.dp_clip > 0.0 and cfg.dp_sigma > 0.0
        kwargs: Dict[str, Any] = {}
        if dp:
            kwargs["dp_clip"] = torch.tensor(cfg.dp_clip, dtype=torch.float32, device=device)
            if dp_noise is None:
                kwargs["dp_generator"] = dp_noise_generator(state.generator.initial_seed(), device)
        state, data, group_weights, axis = place_on_mesh(state, data, group_weights, mesh)
        with F.group_axis(axis):
            if participants is not None:
                participants = torch.stack([F.local_rows(p) for p in participants])
            losses: List[np.ndarray] = []
            exchanges = 0
            while not core.done:
                plan, (k_frac, levels) = core.plan()
                if core.privacy_exhausted:
                    break  # refused round: executing it would bust the ε budget
                fn = self.runner.round_fn(plan.P, plan.Q, k_frac, levels,
                                          collect_stats=True,
                                          dp=dp, secure_agg=cfg.secure_agg)
                lam = plan.P // plan.Q
                draws = slice(exchanges, exchanges + lam)
                if dp:
                    kwargs["dp_sigma"] = torch.tensor(plan.dp_sigma, dtype=torch.float32,
                                                      device=device)
                    if dp_noise is not None:
                        kwargs["dp_noise"] = dp_noise[draws]
                if cfg.secure_agg:
                    # keyed on TrainConfig.seed, as the reference keys them
                    kwargs["agg_masks"] = F.secure_agg_masks(
                        state.theta2, self.train.seed, len(core.history))
                if participants is not None:
                    kwargs["participants"] = participants[draws]
                state, stats = fn(state, data, group_weights, plan.eta, **kwargs)
                exchanges += lam
                names = list(stats)  # one copy to the host (and sync) a round
                stats = dict(zip(names, torch.stack([stats[k] for k in names]).cpu().numpy()))
                losses.append(stats["loss"])
                core.record(plan, stats)

        losses_flat = (np.concatenate(losses) if losses
                       else np.zeros((0,), np.float32))
        return AdaptiveResult(state, losses_flat, core.history)
