"""Population-scale federation: device registry, cohorts, semi-async rounds,
and the fault-tolerant runtime (``repro/core/population.py``).

The paper's experiments march every group in lockstep; real e-health fleets
are large device populations with availability windows, heterogeneous
links and stragglers. This module layers that population on top of the
partition/HSGD machinery *as a simulation*:

  DeviceRegistry      — per-group device traces drawn from a single seed:
                        latency and compute multipliers (lognormal) plus a
                        periodic availability window per device. Each device
                        holds one valid data row of ``data/partition.py``'s
                        non-IID split.
  Cohort sampling     — each round samples the available devices of every
                        group (without replacement, capped at
                        ``target_cohort``), pads to the next power-of-two
                        bucket by repeating real members, and records a
                        participation mask + per-group straggler tails. The
                        round executors are cached per bucket
                        (``HSGDRunner.cohort_round_fn``).
  PopulationScheduler — the simulated clock. ``sync`` waits for the slowest
                        participating group; ``semi_async`` closes the round
                        at a duration quantile (the deadline) and applies
                        late groups' updates at the NEXT global aggregation
                        with staleness-damped weights (``damping**staleness``;
                        dropped past ``max_staleness``).
  make_time_of        — the wall-clock model ``time_of(P, rung)`` the
                        adaptive controller's governor projects against.

The registry, cohorts, scheduler and time model are the reference's host
numpy line for line: traces use ``default_rng([seed, 0])``, round r's cohort
``default_rng([seed, 1, r])`` and the typical tails ``default_rng([seed,
2])``, so one seed gives the reference's participant schedule and latency
draws bit for bit. The run loops drive the port's round executors on the
data's device; the initial model comes from ``params`` (e.g. the
reference's) or from a CPU generator seeded with ``PopulationConfig.seed``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.common.buckets import pow2_ceil
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.core import comm_model as CM
from repro_torch.core.controller import ControllerCore, hsgd_sizes_of
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.hsgd import (
    HSGDRunner,
    HSGDState,
    init_state,
    make_group_weights,
    resize_cohort,
)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class PopulationConfig:
    """Simulated-fleet knobs (all randomness derives from ``seed``)."""

    seed: int = 0
    devices_per_group: int = 64     # simulated population N per group
    target_cohort: int = 8          # devices sampled per group per round
    lat_sigma: float = 0.6          # lognormal sigma of device link multipliers
    comp_sigma: float = 0.4         # lognormal sigma of device compute multipliers
    duty_min: float = 0.5           # availability duty-cycle range
    duty_max: float = 0.95
    period: float = 600.0           # availability window period (sim seconds)
    deadline_quantile: float = 0.8  # semi-async: close the round here
    staleness_damping: float = 0.6  # late update weight *= damping**staleness
    max_staleness: int = 4          # older than this -> dropped
    # retry/backoff (fault tolerance): when a semi-async round's on-time
    # fraction falls below min_quorum, the deadline re-extends by
    # backoff_factor, up to max_retries times (capped at the slowest
    # participant); groups still late after the last retry go down the
    # usual staleness path and are dropped past max_staleness.
    min_quorum: float = 0.5
    max_retries: int = 2
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.devices_per_group < 1 or self.target_cohort < 1:
            raise ValueError(
                f"devices_per_group/target_cohort must be >= 1, got "
                f"{self.devices_per_group}/{self.target_cohort}")
        if not 0.0 < self.deadline_quantile <= 1.0:
            raise ValueError(
                f"deadline_quantile must be in (0, 1], got {self.deadline_quantile}")
        if not 0.0 <= self.min_quorum <= 1.0:
            raise ValueError(f"min_quorum must be in [0, 1], got {self.min_quorum}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_factor <= 1.0:
            raise ValueError(
                f"backoff_factor must be > 1, got {self.backoff_factor}")


class Cohort(NamedTuple):
    """One round's sampled participants, padded to a pow2 bucket."""

    idx: np.ndarray        # [M, A] data-row indices (pads repeat real members)
    pmask: np.ndarray      # [M, A] 1.0 on real slots, 0.0 on padding
    counts: np.ndarray     # [M] real members per group (0 = group absent)
    dev_tail: np.ndarray   # [M] max link multiplier over real members (1 if none)
    comp_tail: np.ndarray  # [M] max compute multiplier over real members


class DeviceRegistry:
    """Seeded per-device traces for M groups × N simulated devices.

    ``lat_mult``/``comp_mult`` [M, N] are fixed per-device multipliers on the
    nominal WAN link and compute times. ``duty``/``phase`` define a periodic
    availability window: device (m, j) is online at sim time t iff
    ``(t/period + phase) mod 1 < duty``. ``data_row`` [M, N] maps each device
    to a valid data row of the stacked partition.
    """

    def __init__(self, data: Dict[str, Any], cfg: PopulationConfig):
        valid = _host(data["valid"]).astype(bool)
        M, K = valid.shape
        N = cfg.devices_per_group
        rng = np.random.default_rng([cfg.seed, 0])
        self.cfg = cfg
        self.num_groups, self.pop_per_group = M, N
        self.lat_mult = np.exp(rng.normal(0.0, cfg.lat_sigma, (M, N)))
        self.comp_mult = np.exp(rng.normal(0.0, cfg.comp_sigma, (M, N)))
        # devices never beat the nominal link/compute speed: the paper's
        # constants are the fleet's best case, multipliers only slow down
        self.lat_mult = np.maximum(self.lat_mult, 1.0)
        self.comp_mult = np.maximum(self.comp_mult, 1.0)
        self.duty = rng.uniform(cfg.duty_min, cfg.duty_max, (M, N))
        self.phase = rng.uniform(0.0, 1.0, (M, N))
        rows = np.zeros((M, N), np.int64)
        for m in range(M):
            vm = np.flatnonzero(valid[m])
            if vm.size == 0:
                vm = np.arange(K)
            rows[m] = vm[rng.integers(0, vm.size, N)]
        self.data_row = rows

    def available(self, now: float) -> np.ndarray:
        """[M, N] bool: which devices are inside their window at sim time now."""
        return ((now / self.cfg.period + self.phase) % 1.0) < self.duty

    def sample_cohort(self, round_idx: int, now: float) -> Cohort:
        """Round r's participants, deterministic in (seed, r, availability)."""
        cfg = self.cfg
        M = self.num_groups
        rng = np.random.default_rng([cfg.seed, 1, round_idx])
        avail = self.available(now)
        picks: List[np.ndarray] = []
        counts = np.zeros(M, np.int64)
        for m in range(M):
            cand = np.flatnonzero(avail[m])
            n_take = min(cfg.target_cohort, cand.size)
            picks.append(rng.choice(cand, size=n_take, replace=False)
                         if n_take else np.zeros(0, np.int64))
            counts[m] = n_take
        A = pow2_ceil(max(1, int(counts.max())))
        idx = np.zeros((M, A), np.int64)
        pmask = np.zeros((M, A), np.float32)
        dev_tail = np.ones(M)
        comp_tail = np.ones(M)
        for m in range(M):
            devs = picks[m]
            if devs.size:
                padded = devs[np.arange(A) % devs.size]  # pads repeat members
                idx[m] = self.data_row[m, padded]
                pmask[m, : devs.size] = 1.0
                dev_tail[m] = self.lat_mult[m, devs].max()
                comp_tail[m] = self.comp_mult[m, devs].max()
            else:
                idx[m] = self.data_row[m, 0]  # unread: pmask stays 0, weight 0
        return Cohort(idx, pmask, counts, dev_tail, comp_tail)

    def typical_tails(self, quantile: float, n_draws: int = 8):
        """Representative per-group cohort tails for the planner's time model:
        the mean over ``n_draws`` seeded cohort draws of the max multiplier in
        a ``target_cohort``-sized subset. Returns ([M] dev, [M] comp)."""
        cfg = self.cfg
        M, N = self.lat_mult.shape
        rng = np.random.default_rng([cfg.seed, 2])
        A = min(cfg.target_cohort, N)
        dev = np.zeros((n_draws, M))
        comp = np.zeros((n_draws, M))
        for d in range(n_draws):
            for m in range(M):
                pick = rng.choice(N, size=A, replace=False)
                dev[d, m] = self.lat_mult[m, pick].max()
                comp[d, m] = self.comp_mult[m, pick].max()
        return dev.mean(axis=0), comp.mean(axis=0)


def cohort_durations(cohort: Cohort, sizes, P: int, Q: int, t_compute: float,
                     links=CM.WAN) -> np.ndarray:
    """[M] simulated seconds for each group's round under its cohort's tails."""
    fed_pq = FederationConfig(local_interval=Q, global_interval=P)
    return np.array([
        CM.round_time_hetero(sizes, fed_pq, t_compute, links,
                             dev_tail=float(cohort.dev_tail[m]),
                             compute_tail=float(cohort.comp_tail[m]))
        for m in range(len(cohort.counts))
    ])


class PopulationScheduler:
    """Simulated clock + staleness ledger over a DeviceRegistry.

    Per round: sample a cohort at the current sim time, run the compiled
    round, then ``settle`` with the per-group durations. ``settle`` advances
    the clock by the round's deadline (max duration in ``sync`` mode, the
    ``deadline_quantile`` in ``semi_async``), updates per-group staleness
    (on-time -> 0, late -> +1), and returns the effective group weights the
    NEXT round's global aggregation applies to the updates just produced:
    ``base_w * damping**staleness``, zero for absent groups and for updates
    older than ``max_staleness``.
    """

    def __init__(self, registry: DeviceRegistry, base_weights: np.ndarray,
                 mode: str = "semi_async"):
        if mode not in ("sync", "semi_async"):
            raise ValueError(f"mode must be sync|semi_async, got {mode!r}")
        self.registry = registry
        self.cfg = registry.cfg
        self.base_w = np.asarray(base_weights, np.float64)
        self.mode = mode
        self.now = 0.0
        self.round = 0
        self.staleness = np.zeros(registry.num_groups, np.int64)
        self.stale_hist: Dict[int, int] = {}

    def next_cohort(self) -> Cohort:
        return self.registry.sample_cohort(self.round, self.now)

    def settle(self, cohort: Cohort, durations: np.ndarray):
        """Advance the clock; return (next-round weights [M], round record).

        Semi-async retry/backoff: when the quantile deadline leaves fewer
        than ``min_quorum`` of the participating groups on time (mass
        stragglers — e.g. injected latency spikes), the deadline re-extends
        by ``backoff_factor`` up to ``max_retries`` times, capped at the
        slowest participant. The extension seconds are realized sim time —
        they advance the clock, so the adaptive governor's wall-clock ledger
        is charged for every retry (``core.record(..., seconds=now-prev)``).
        Groups still late after the last retry follow the usual staleness
        path (damped, dropped past ``max_staleness``).
        """
        part = cohort.counts > 0
        dur = np.asarray(durations, np.float64)
        retries = 0
        base_deadline = 0.0
        if not part.any():
            deadline = 0.0
            on_time = part
        elif self.mode == "sync":
            deadline = float(dur[part].max())
            on_time = part
        else:
            deadline = float(np.quantile(dur[part], self.cfg.deadline_quantile))
            base_deadline = deadline
            on_time = part & (dur <= deadline)
            worst = float(dur[part].max())
            while (retries < self.cfg.max_retries
                   and on_time.sum() < self.cfg.min_quorum * part.sum()
                   and deadline < worst):
                deadline = min(deadline * self.cfg.backoff_factor, worst)
                retries += 1
                on_time = part & (dur <= deadline)
        self.staleness = np.where(on_time, 0, self.staleness + 1)
        for s in self.staleness[part]:
            self.stale_hist[int(s)] = self.stale_hist.get(int(s), 0) + 1
        damp = np.where(self.staleness > self.cfg.max_staleness, 0.0,
                        self.cfg.staleness_damping ** self.staleness)
        w = self.base_w * part * damp
        if w.sum() <= 0.0:  # nobody usable: fall back, never divide by zero
            w = self.base_w.copy()
        self.now += deadline
        self.round += 1
        rec = {
            "round": self.round - 1,
            "deadline": deadline,
            "now": self.now,
            "cohort_sizes": cohort.counts.tolist(),
            "bucket": int(cohort.pmask.shape[1]),
            "late": int((part & ~on_time).sum()),
            "staleness": self.staleness.tolist(),
            "retries": retries,
            "retry_seconds": max(deadline - base_deadline, 0.0) if retries else 0.0,
        }
        return w, rec

    def state_dict(self) -> Dict[str, Any]:
        """Ledger snapshot for checkpointing (everything ``settle`` mutates)."""
        return {
            "now": float(self.now),
            "round": int(self.round),
            "staleness": self.staleness.tolist(),
            "stale_hist": {str(k): int(v) for k, v in self.stale_hist.items()},
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.now = float(sd["now"])
        self.round = int(sd["round"])
        self.staleness = np.asarray(sd["staleness"], np.int64)
        self.stale_hist = {int(k): int(v) for k, v in sd["stale_hist"].items()}


def make_time_of(sizes_of, ladder, registry: DeviceRegistry, t_compute: float,
                 mode: str = "semi_async", links=CM.WAN):
    """Build the controller's ``time_of(P, rung)`` wall-clock model.

    Projects one P = Q round's simulated seconds at a ladder rung using the
    registry's typical cohort tails — the semi-async deadline quantile across
    groups (or the max, in sync mode). This is what turns the byte governor
    into a time-to-accuracy governor: compression rungs shrink the
    device-gated exchange legs, larger P amortizes t_g, both visible to the
    planner through this one callback.
    """
    cfg = registry.cfg
    dev_t, comp_t = registry.typical_tails(cfg.deadline_quantile)

    def time_of(P: int, rung: int) -> float:
        k, b = ladder[rung]
        sizes = sizes_of(k, b)
        fed_pq = FederationConfig(local_interval=P, global_interval=P)
        dur = np.array([
            CM.round_time_hetero(sizes, fed_pq, t_compute, links,
                                 dev_tail=float(dev_t[m]),
                                 compute_tail=float(comp_t[m]))
            for m in range(registry.num_groups)
        ])
        if mode == "sync":
            return float(dur.max())
        return float(np.quantile(dur, cfg.deadline_quantile))

    return time_of


# ---------------------------------------------------------------------------
# Run loops (fixed-interval sync/semi-async, and the adaptive governor)
# ---------------------------------------------------------------------------


def _lr_at(train: TrainConfig, step: int) -> float:
    if train.lr_halve_every:
        return train.learning_rate * 0.5 ** (step // train.lr_halve_every)
    return train.learning_rate


def _initial_state(model, fed: FederationConfig, data, pop: PopulationConfig,
                   params=None) -> HSGDState:
    """Every group starts from ``params`` ({theta0, theta1, theta2} on the
    data's device), or from a draw of a CPU generator seeded with
    ``pop.seed``."""
    return init_state(torch.Generator().manual_seed(pop.seed), model, fed, data, params=params)


def run_population(model, fed: FederationConfig, train: TrainConfig,
                   data, pop: PopulationConfig, rounds: int,
                   mode: str = "semi_async", t_compute: float = 0.05,
                   links=CM.WAN, params=None,
                   runner: Optional[HSGDRunner] = None) -> Dict[str, Any]:
    """Fixed-(P, Q) population run over ``rounds`` sampled-cohort rounds.

    Returns per-step losses, the sim-clock time at the END of each step's
    round (for time-to-target curves), the scheduler's round records, and the
    runner (``len(runner._round_cache)`` is the executors built, one per
    cohort bucket). The losses are copied to the host once, at the end.
    """
    runner = runner or HSGDRunner(model, fed, train)
    state = _initial_state(model, fed, data, pop, params)
    base_w = _host(make_group_weights(data))
    registry = DeviceRegistry(data, pop)
    sched = PopulationScheduler(registry, base_w, mode=mode)
    sizes_of = hsgd_sizes_of(state, fed)
    sizes = sizes_of(train.compression_k, train.quantization_bits)
    P, Q = fed.global_interval, fed.local_interval

    w = base_w.copy()
    losses: List[torch.Tensor] = []
    times: List[float] = []
    history: List[Dict[str, Any]] = []
    step = 0
    for _ in range(rounds):
        cohort = sched.next_cohort()
        A = int(cohort.pmask.shape[1])
        state = resize_cohort(state, model, data, A)
        fn = runner.cohort_round_fn(P, Q, A, collect_stats=False)
        state, round_losses = fn(state, data, w.astype(np.float32),
                                 _lr_at(train, step), cohort.idx, cohort.pmask)
        dur = cohort_durations(cohort, sizes, P, Q, t_compute, links)
        w, rec = sched.settle(cohort, dur)
        losses.append(round_losses)
        times.extend([sched.now] * P)
        history.append(rec)
        step += P
    return {
        "losses": _host(torch.cat(losses)) if losses else np.zeros(0),
        "times": np.asarray(times),
        "history": history,
        "staleness_hist": dict(sched.stale_hist),
        "sim_seconds": sched.now,
        "runner": runner,
        "state": state,
    }


class CoordinatorPreempted(RuntimeError):
    """The fault plan killed the coordinator at a round boundary. Re-run with
    ``resume=True`` to continue bit-identically from the last auto-checkpoint."""

    def __init__(self, round_idx: int, ckpt_dir: Optional[str]):
        super().__init__(
            f"coordinator preempted at round {round_idx}"
            + (f"; resume from {ckpt_dir}" if ckpt_dir else " (no checkpoint dir)"))
        self.round_idx = round_idx
        self.ckpt_dir = ckpt_dir


def run_population_resilient(model, fed: FederationConfig, train: TrainConfig,
                             data, pop: PopulationConfig, rounds: int,
                             faults=None, injector=None,
                             mode: str = "semi_async", robust: bool = True,
                             monitor: bool = True, t_compute: float = 0.05,
                             links=CM.WAN, params=None,
                             runner: Optional[HSGDRunner] = None,
                             ckpt_dir: Optional[str] = None,
                             ckpt_every: int = 0, resume: bool = False,
                             divergence_factor: float = 20.0,
                             eta_shrink: float = 0.5,
                             max_rollbacks: int = 3) -> Dict[str, Any]:
    """Fault-tolerant population run: seeded injection + the recovery loop.

    Per round, the injector realizes the plan's faults: dropped devices leave
    the participation mask, NaN/outlier gradient terms and corrupted uplink
    multipliers ride into the round executor as operands, latency spikes
    stretch the settle durations (charging the retry/backoff machinery and
    the wall-clock ledger), and lost/duplicated round updates re-weight the
    next global aggregation. ``robust=True`` runs the screened executor
    (``HSGDRunner.fault_round_fn``) with ``fed.robust_agg`` aggregation;
    ``robust=False`` is the naive stack under the same faults.

    Recovery: every ``ckpt_every`` rounds the ``HSGDState`` plus the
    scheduler ledger, loss/time curves and weights are checkpointed
    atomically; the divergence monitor (non-finite round loss, or a spike
    past ``divergence_factor`` × the best round loss) rolls back to the last
    checkpoint with the learning rate shrunk by ``eta_shrink`` (at most
    ``max_rollbacks`` times). A planned coordinator preemption raises
    ``CoordinatorPreempted`` at the round boundary; calling again with
    ``resume=True`` reloads everything onto the data's device and continues
    bit-identically (round r's faults are redrawn from ``default_rng([seed,
    3, r])``, so the fault schedule needs no serialized RNG state).
    """
    if injector is None:
        injector = FaultInjector(faults or FaultPlan())
    runner = runner or HSGDRunner(model, fed, train)
    device = data["x1"].device
    state = _initial_state(model, fed, data, pop, params)
    base_w = _host(make_group_weights(data))
    registry = DeviceRegistry(data, pop)
    sched = PopulationScheduler(registry, base_w, mode=mode)
    sizes_of = hsgd_sizes_of(state, fed)
    sizes = sizes_of(train.compression_k, train.quantization_bits)
    P, Q = fed.global_interval, fed.local_interval
    M = fed.num_groups

    w = base_w.copy()
    losses: List[np.ndarray] = []
    times: List[float] = []
    history: List[Dict[str, Any]] = []
    fault_log: List[Dict[str, Any]] = []
    step = 0
    lr_scale = 1.0
    best = float("inf")
    rollbacks = 0
    manifest = os.path.join(ckpt_dir, "manifest.json") if ckpt_dir else None
    have_ckpt = bool(manifest and os.path.exists(manifest))

    def save(tag: str):
        payload = {
            "state": state,
            "losses": (np.concatenate(losses).astype(np.float32)
                       if losses else np.zeros(0, np.float32)),
            "times": np.asarray(times, np.float64),
            "w": np.asarray(w, np.float64),
        }
        extra = {
            "sched": sched.state_dict(),
            "step": int(step),
            "lr_scale": float(lr_scale),
            "best": best if np.isfinite(best) else None,
            "rollbacks": int(rollbacks),
            "history": history,
            "tag": tag,
        }
        save_checkpoint(ckpt_dir, payload, step=step, extra=extra)

    def restore():
        nonlocal state, losses, times, w, step, lr_scale, best, rollbacks, history
        payload, _, extra = load_checkpoint(ckpt_dir, device=device)
        state = payload["state"]  # on the run's device, generator rebuilt
        arr = _host(payload["losses"])
        losses = [arr] if arr.size else []
        times = list(_host(payload["times"]))
        w = _host(payload["w"]).astype(np.float64)
        sched.load_state_dict(extra["sched"])
        step = int(extra["step"])
        lr_scale = float(extra["lr_scale"])
        best = float("inf") if extra["best"] is None else float(extra["best"])
        rollbacks = int(extra["rollbacks"])
        history = list(extra["history"])

    if resume:
        if not have_ckpt:
            raise FileNotFoundError(f"resume requested but no checkpoint at {ckpt_dir!r}")
        restore()

    while sched.round < rounds:
        r = sched.round
        cohort = sched.next_cohort()
        A = int(cohort.pmask.shape[1])
        flt = injector.faults(r, M, A, cohort.pmask)
        if flt.preempt and not resume:
            raise CoordinatorPreempted(r, ckpt_dir)
        state = resize_cohort(state, model, data, A)
        pmask_eff = (cohort.pmask * (1.0 - flt.drop)).astype(np.float32)
        cohort_eff = cohort._replace(
            pmask=pmask_eff, counts=pmask_eff.sum(axis=1).astype(np.int64))
        fn = runner.fault_round_fn(P, Q, A, robust=robust)
        state, round_losses, flagged = fn(
            state, data, w.astype(np.float32), _lr_at(train, step) * lr_scale,
            cohort.idx, pmask_eff, flt.grad_fault, flt.msg_fault)
        dur = cohort_durations(cohort_eff, sizes, P, Q, t_compute, links)
        dur = dur * flt.latency_mult
        w, rec = sched.settle(cohort_eff, dur)
        # lost/duplicated round updates re-weight the NEXT global aggregation
        w = w * np.where(flt.lost, 0.0, 1.0) * np.where(flt.dup, 2.0, 1.0)
        rl = _host(round_losses)
        flagged = float(flagged)
        fault_log.append({
            "round": r,
            "dropped": int(flt.drop.sum()),
            "grad_faulted": int((np.nan_to_num(flt.grad_fault, nan=1.0) != 0).sum()),
            "msg_faulted": int((np.nan_to_num(flt.msg_fault, nan=1.0) != 0).sum()),
            "lost": int(flt.lost.sum()), "dup": int(flt.dup.sum()),
            "latency_spikes": int((flt.latency_mult > 1.0).sum()),
            "flagged_updates": flagged,
            "retries": rec["retries"],
        })
        mean_loss = float(np.mean(rl)) if rl.size else float("nan")
        diverged = (not np.isfinite(mean_loss)
                    or (np.isfinite(best)
                        and mean_loss > divergence_factor * max(best, 1e-9)))
        if monitor and diverged and have_ckpt and rollbacks < max_rollbacks:
            # both survive the restore (which reloads the checkpoint's older
            # values): repeated rollbacks to the SAME checkpoint keep
            # compounding the η shrink instead of retrying at the same rate
            rb = rollbacks + 1
            ls = lr_scale * eta_shrink
            restore()
            rollbacks, lr_scale = rb, ls
            fault_log[-1]["rolled_back"] = True
            continue
        losses.append(rl)
        times.extend([sched.now] * P)
        history.append(rec)
        step += P
        if np.isfinite(mean_loss):
            best = min(best, mean_loss)
        if ckpt_dir and ckpt_every and sched.round % ckpt_every == 0:
            save(f"round-{sched.round}")
            have_ckpt = True

    final = np.concatenate(losses) if losses else np.zeros(0)
    return {
        "losses": final,
        "times": np.asarray(times),
        "history": history,
        "fault_log": fault_log,
        "staleness_hist": dict(sched.stale_hist),
        "sim_seconds": sched.now,
        "runner": runner,
        "state": state,
        "injector": injector,
        "rollbacks": rollbacks,
        "lr_scale": lr_scale,
        "recovered": bool(final.size and np.isfinite(final[-1])),
    }


def run_population_adaptive(model, fed: FederationConfig, train: TrainConfig,
                            data, pop: PopulationConfig, cfg,
                            t_compute: float = 0.05, links=CM.WAN,
                            params=None,
                            runner: Optional[HSGDRunner] = None) -> Dict[str, Any]:
    """Adaptive population run: ControllerCore + wall-clock governor.

    Each round the controller picks (P, Q, η, rung) against BOTH ledgers
    (bytes and simulated seconds, via ``make_time_of``), the scheduler samples
    a cohort, and the realized semi-async deadline is charged back with
    ``core.record(..., seconds=...)``. ``cfg`` is a
    ``controller.AdaptiveConfig`` (set ``time_budget`` to engage the
    wall-clock governor). The round's stats come to the host once a round,
    as the controller plans from them.
    """
    runner = runner or HSGDRunner(model, fed, train)
    state = _initial_state(model, fed, data, pop, params)
    base_w = _host(make_group_weights(data))
    registry = DeviceRegistry(data, pop)
    sched = PopulationScheduler(registry, base_w, mode="semi_async")
    sizes_of = hsgd_sizes_of(state, fed)
    time_of = make_time_of(sizes_of, cfg.ladder, registry, t_compute,
                           mode="semi_async", links=links)
    core = ControllerCore(cfg, fed, sizes_of, eta0=train.learning_rate,
                          time_of=time_of)

    w = base_w.copy()
    losses: List[np.ndarray] = []
    times: List[float] = []
    while not core.done:
        plan, (k_frac, levels) = core.plan()
        cohort = sched.next_cohort()
        A = int(cohort.pmask.shape[1])
        state = resize_cohort(state, model, data, A)
        fn = runner.cohort_round_fn(plan.P, plan.Q, A, k_frac, levels,
                                    collect_stats=True)
        state, stats = fn(state, data, w.astype(np.float32), plan.eta,
                          cohort.idx, cohort.pmask)
        names = list(stats)  # one copy to the host (and sync) a round
        stats = dict(zip(names, _host(torch.stack([stats[k] for k in names]))))
        sizes = sizes_of(k_frac, levels)
        dur = cohort_durations(cohort, sizes, plan.P, plan.Q, t_compute, links)
        prev_now = sched.now
        w, _ = sched.settle(cohort, dur)
        # charge the realized semi-async deadline, not the planner's model
        core.record(plan, stats, seconds=sched.now - prev_now)
        losses.append(np.asarray(stats["loss"]))
        times.extend([sched.now] * plan.P)
    return {
        "losses": np.concatenate(losses) if losses else np.zeros(0),
        "times": np.asarray(times),
        "history": core.history,
        "staleness_hist": dict(sched.stale_hist),
        "sim_seconds": sched.now,
        "runner": runner,
        "state": state,
        "core": core,
    }
