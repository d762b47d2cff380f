"""Seeded fault injection for the federation runtime (host numpy, the
reference's ``repro/core/faults.py`` line for line, so the same plan draws
the same faults and a trace written by either package replays in the other).

Real e-health fleets fail in ways the paper's simulation never exercises:
patient devices vanish mid-round, wireless uplinks corrupt or drop the
compressed exchange message, sick clients emit NaN/Inf or wildly-scaled
gradients, links stall, and the coordinator itself gets preempted. This
module schedules all of those deterministically from one seed, with the same
RNG discipline as ``DeviceRegistry``: round r's faults come from
``np.random.default_rng([seed, 3, r])``, so a trace replays bit-identically
from the seed alone, and every drawn round is also recordable to a JSON
trace that a replay injector serves back verbatim.

What each fault means downstream (see ``core/population.py``'s resilient run
loop for the routing):

  drop          [M, A] device gone mid-round: its participation-mask slot is
                zeroed before the round executes (missing update).
  grad_fault    [M, A] additive per-device gradient term: NaN for sick
                clients, ``outlier_scale`` for wildly-scaled updates; 0 =
                clean. Injected inside the round through a ``torch.where``
                select so clean devices stay bit-identical.
  msg_fault     [M] multiplier on the group's compressed uplink payload (ζ2):
                NaN or ``corrupt_scale`` for bit-flip corruption; 0 = clean.
  lost / dup    [M] the group's round update is lost (weight x0) or applied
                twice (weight x2) at the next global aggregation.
  latency_mult  [M] straggler spike: multiplies the group's simulated round
                duration before the scheduler settles the deadline.
  preempt       the coordinator dies at this round boundary (raise; resume
                from the last auto-checkpoint).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.common.io import atomic_write_json


@dataclass(frozen=True)
class FaultPlan:
    """Fault schedule knobs; all randomness derives from ``seed``. The default
    instance is the empty plan (every rate 0, no preemption)."""

    seed: int = 0
    dropout_rate: float = 0.0        # P(device vanishes mid-round)
    nan_rate: float = 0.0            # P(device emits NaN gradients this round)
    outlier_rate: float = 0.0        # P(device emits outlier-scaled gradients)
    outlier_scale: float = 1e4       # additive magnitude of outlier gradients
    msg_corrupt_rate: float = 0.0    # P(group uplink payload corrupted)
    corrupt_scale: float = 1e6       # finite bit-flip multiplier (else NaN)
    msg_loss_rate: float = 0.0       # P(group round update lost)
    msg_dup_rate: float = 0.0        # P(group round update duplicated)
    latency_spike_rate: float = 0.0  # P(group link stalls this round)
    latency_spike_mult: float = 8.0  # stall duration multiplier
    preempt_round: int = -1          # coordinator dies at this round (-1 = never)

    def __post_init__(self):
        for name in ("dropout_rate", "nan_rate", "outlier_rate",
                     "msg_corrupt_rate", "msg_loss_rate", "msg_dup_rate",
                     "latency_spike_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.latency_spike_mult < 1.0:
            raise ValueError(
                f"latency_spike_mult must be >= 1, got {self.latency_spike_mult}")
        if self.preempt_round < -1:
            raise ValueError(
                f"preempt_round must be >= 0 (or -1 = never), got {self.preempt_round}")

    @property
    def empty(self) -> bool:
        return (self.dropout_rate == self.nan_rate == self.outlier_rate
                == self.msg_corrupt_rate == self.msg_loss_rate
                == self.msg_dup_rate == self.latency_spike_rate == 0.0
                and self.preempt_round < 0)


class RoundFaults(NamedTuple):
    """One round's realized faults (host numpy; the gradient/message terms
    ride into the round executor as operands)."""

    drop: np.ndarray          # [M, A] 1.0 = device dropped mid-round
    grad_fault: np.ndarray    # [M, A] additive gradient term (0 = clean)
    msg_fault: np.ndarray     # [M] uplink payload multiplier (0 = clean)
    lost: np.ndarray          # [M] bool: round update lost
    dup: np.ndarray           # [M] bool: round update duplicated
    latency_mult: np.ndarray  # [M] round duration multiplier (>= 1)
    preempt: bool             # coordinator dies at this round boundary

    @property
    def any_device_fault(self) -> bool:
        return bool(self.drop.any() or (self.grad_fault != 0).any()
                    or (self.msg_fault != 0).any())


def _empty_round(M: int, A: int) -> RoundFaults:
    return RoundFaults(
        drop=np.zeros((M, A), np.float32),
        grad_fault=np.zeros((M, A), np.float32),
        msg_fault=np.zeros(M, np.float32),
        lost=np.zeros(M, bool),
        dup=np.zeros(M, bool),
        latency_mult=np.ones(M, np.float64),
        preempt=False,
    )


class FaultInjector:
    """Draws each round's faults from the plan's seeded stream and records a
    replayable trace. Construct with ``replay=`` (or via ``from_trace``) to
    serve a recorded trace back instead of drawing."""

    def __init__(self, plan: Optional[FaultPlan] = None,
                 replay: Optional[List[Dict[str, Any]]] = None):
        self.plan = plan or FaultPlan()
        self._replay = {int(r["round"]): r for r in replay} if replay else None
        self.trace: List[Dict[str, Any]] = list(replay) if replay else []

    # -- drawing / replay ----------------------------------------------------

    def faults(self, round_idx: int, M: int, A: int,
               pmask: Optional[np.ndarray] = None) -> RoundFaults:
        """Round ``round_idx``'s faults for an [M, A]-slot cohort. ``pmask``
        restricts device-level faults to real cohort slots. Deterministic in
        (seed, round): the bucket shape only crops/pads the per-slot draws."""
        if self._replay is not None:
            return self._from_record(self._replay.get(round_idx), M, A)
        plan = self.plan
        real = np.ones((M, A), bool) if pmask is None else np.asarray(pmask) > 0
        rf = _empty_round(M, A)
        if not plan.empty:
            rng = np.random.default_rng([plan.seed, 3, round_idx])
            # each field draws unconditionally, in a fixed order, so one
            # rate's value never shifts another field's stream
            drop = (rng.random((M, A)) < plan.dropout_rate) & real
            nan_dev = (rng.random((M, A)) < plan.nan_rate) & real
            out_dev = (rng.random((M, A)) < plan.outlier_rate) & real
            grad_fault = np.where(nan_dev, np.nan,
                                  np.where(out_dev, plan.outlier_scale, 0.0))
            # a dropped device's update never reaches the server — it cannot
            # also poison the aggregate with a faulty gradient
            grad_fault = np.where(drop, 0.0, grad_fault)
            corrupt = rng.random(M) < plan.msg_corrupt_rate
            corrupt_nan = rng.random(M) < 0.5
            msg_fault = np.where(
                corrupt, np.where(corrupt_nan, np.nan, plan.corrupt_scale), 0.0)
            lost = rng.random(M) < plan.msg_loss_rate
            dup = rng.random(M) < plan.msg_dup_rate
            spike = rng.random(M) < plan.latency_spike_rate
            latency = np.where(spike, plan.latency_spike_mult, 1.0)
            rf = RoundFaults(
                drop=drop.astype(np.float32),
                grad_fault=grad_fault.astype(np.float32),
                msg_fault=msg_fault.astype(np.float32),
                lost=lost, dup=dup, latency_mult=latency,
                preempt=(round_idx == plan.preempt_round),
            )
        self.trace.append(self._to_record(round_idx, rf))
        return rf

    # -- JSON trace ----------------------------------------------------------

    @staticmethod
    def _to_record(round_idx: int, rf: RoundFaults) -> Dict[str, Any]:
        def clean(a):  # JSON has no NaN literal — encode as the string "nan"
            return [["nan" if (isinstance(v, float) and math.isnan(v)) else v
                     for v in row] if isinstance(row, list) else
                    ("nan" if (isinstance(row, float) and math.isnan(row)) else row)
                    for row in a.tolist()]

        return {
            "round": int(round_idx),
            "drop": rf.drop.tolist(),
            "grad_fault": clean(rf.grad_fault.astype(float)),
            "msg_fault": clean(rf.msg_fault.astype(float)),
            "lost": rf.lost.astype(int).tolist(),
            "dup": rf.dup.astype(int).tolist(),
            "latency_mult": rf.latency_mult.tolist(),
            "preempt": bool(rf.preempt),
        }

    @staticmethod
    def _from_record(rec: Optional[Dict[str, Any]], M: int, A: int) -> RoundFaults:
        if rec is None:
            return _empty_round(M, A)

        def arr(key, dtype):
            raw = rec[key]
            a = np.array([[np.nan if v == "nan" else v for v in row]
                          if isinstance(row, list)
                          else (np.nan if row == "nan" else row)
                          for row in raw], dtype)
            return a

        def fit(a, shape):  # crop/pad a recorded array onto this bucket shape
            out = np.zeros(shape, a.dtype)
            if a.ndim == 1:
                n = min(a.shape[0], shape[0])
                out[:n] = a[:n]
            else:
                m, k = min(a.shape[0], shape[0]), min(a.shape[1], shape[1])
                out[:m, :k] = a[:m, :k]
            return out

        lat = fit(arr("latency_mult", np.float64), (M,))
        lat[lat == 0.0] = 1.0
        return RoundFaults(
            drop=fit(arr("drop", np.float32), (M, A)),
            grad_fault=fit(arr("grad_fault", np.float32), (M, A)),
            msg_fault=fit(arr("msg_fault", np.float32), (M,)),
            lost=fit(arr("lost", np.int64), (M,)) > 0,
            dup=fit(arr("dup", np.int64), (M,)) > 0,
            latency_mult=lat,
            preempt=bool(rec.get("preempt", False)),
        )

    def save_trace(self, path: str) -> None:
        """Persist the drawn rounds as a replayable JSON trace (atomic)."""
        atomic_write_json(path, {
            "plan": {k: (None if isinstance(v, float) and math.isnan(v) else v)
                     for k, v in vars(self.plan).items()},
            "rounds": self.trace,
        })

    @classmethod
    def from_trace(cls, path: str) -> "FaultInjector":
        """Replay injector serving a recorded trace back verbatim."""
        with open(path) as f:
            doc = json.load(f)
        plan = FaultPlan(**doc.get("plan", {}))
        return cls(plan, replay=doc.get("rounds", []))
