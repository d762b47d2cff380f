"""Hybrid Stochastic Gradient Descent — the paper's Algorithm 1.

Training runs the reference's 3-level loop, eagerly:

  for R global rounds                             (t mod P == 0 events)
    ├─ local agg (eq 1) + global agg (eq 2) + broadcasts (Alg. 1 lines 3–9)
    └─ for Λ = P/Q local intervals                (t mod Q == 0 events)
         ├─ local aggregation (eq 1, lines 10–12)
         ├─ A_m/ξ_m agreement + intermediate-result EXCHANGE (lines 13–21):
         │    ζ1 = h1(θ1; X1ξ), ζ2 = h2(θ2; X2ξ), stale θ0 snapshot
         │    (optionally top-k/quantize compressed — C-HSGD)
         └─ for Q SGD steps (lines 22–26):
              hospital: (θ0,θ1) step with FRESH ζ1, STALE ζ2   (eqs 5–6)
              devices:  θ2_n step with STALE θ0, STALE ζ1      (eq 7)

Only the sampled devices A_m are materialized ([M, A, ...]): unsampled
devices are reset to θ2_m at every local aggregation anyway (line 15).
Per-group and per-device gradients are ``torch.func.vmap`` over
``torch.func.grad``, as the reference vmaps ``jax.grad``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core import federation as F
from repro_torch.kernels.compress import compress_pytree
from repro_torch.models.split_model import HybridModel
from repro_torch.optim import halving_schedule


class HSGDState(NamedTuple):  # reprolint: disable=RP8 — registered with the checkpoint slice
    theta0: Any  # [M, ...] combined models
    theta1: Any  # [M, ...] hospital towers
    theta2: Any  # [M, A, ...] sampled-device towers
    stale: Dict[str, Any]  # {"theta0": [M,...], "z1": [M,A,...], "z2": [M,A,...]}
    batch: Dict[str, torch.Tensor]  # gathered ξ_m: x1,x2,y,valid [M,A,...]
    generator: torch.Generator  # CPU generator for the A_m draws
    step: int


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def _placeholder_ctx(model: HybridModel, theta1, theta2, data, M: int, A: int):
    """Placeholder (batch, z1, z2) shaped for A device slots per group.

    Every run exchanges before its first SGD step, so the placeholders are
    overwritten unread; the ζ shapes come from a forward on the meta device
    (no FLOPs), as the reference uses ``eval_shape``.
    """
    device = data["x1"].device
    batch = F.gather_batch(data, torch.zeros((M, A), dtype=torch.long, device=device))
    meta = lambda t: t.to("meta")
    z1 = _h1_groups(model, tree_map(meta, theta1), meta(batch["x1"]))
    z2 = _h2_groups(model, tree_map(meta, F.local_aggregate(theta2)), meta(batch["x2"]))
    zeros = lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device)
    return batch, zeros(z1), zeros(z2)


def init_state(generator: torch.Generator, model: HybridModel, fed: FederationConfig,
               data, params=None, dtype=torch.float32) -> HSGDState:
    """All groups start from the same global model (Alg. 1 line 1).

    ``params`` (a {theta0, theta1, theta2} dict) replaces the draw from
    ``generator``, e.g. to start from the reference's initial model;
    ``generator`` then drives only the A_m sampling.
    """
    device = data["x1"].device
    if params is None:
        params = model.init(generator, dtype, device)
    M, A = fed.num_groups, fed.sampled_devices
    theta0 = F.broadcast_to_groups(params["theta0"], M)
    theta1 = F.broadcast_to_groups(params["theta1"], M)
    theta2 = F.broadcast_to_devices(F.broadcast_to_groups(params["theta2"], M), A)
    batch, z1, z2 = _placeholder_ctx(model, theta1, theta2, data, M, A)
    stale = {"theta0": tree_map(torch.clone, theta0), "z1": z1, "z2": z2}
    return HSGDState(theta0, theta1, theta2, stale, batch, generator, 0)


# ---------------------------------------------------------------------------
# Forward helpers (vmapped over groups / devices)
# ---------------------------------------------------------------------------


def _h1_groups(model, theta1, x1):
    """[M,...]θ1 × [M,A,...]x1 -> ζ1 [M,A,...]."""
    return vmap(model.h1)(theta1, x1)


def _h2_groups(model, theta2_group, x2):
    """[M,...]θ2_m × [M,A,...]x2 -> ζ2 [M,A,...] (device outputs from θ2_m)."""
    return vmap(model.h2)(theta2_group, x2)


# ---------------------------------------------------------------------------
# The three gradient rules (eqs. (5)–(7))
# ---------------------------------------------------------------------------


def _hospital_loss(model, theta0_m, theta1_m, batch_m, stale_z2_m):
    """Group-level loss with fresh ζ1(θ1), stale ζ2 — drives eqs. (5)(6)."""
    z1 = model.h1(theta1_m, batch_m["x1"])
    return model.loss(theta0_m, z1, stale_z2_m.detach(), batch_m["y"])


def _device_loss(model, theta2_n, x2_n, y_n, stale_theta0_m, stale_z1_n):
    """Per-device loss with stale θ0, stale ζ1, fresh ζ2(θ2_n) — eq. (7)."""
    z2 = model.h2(theta2_n, x2_n[None])
    return model.loss(
        tree_map(torch.Tensor.detach, stale_theta0_m),
        stale_z1_n[None].detach(),
        z2,
        y_n[None],
    )


def _local_grads(model: HybridModel, state: HSGDState):
    """Per-worker gradients of lines 22–26: (losses [M], g0 [M,...], g1 [M,...],
    g2 [M,A,...])."""
    h_grads = vmap(grad_and_value(partial(_hospital_loss, model), argnums=(0, 1)))
    (g0, g1), losses = h_grads(state.theta0, state.theta1, state.batch, state.stale["z2"])
    per_device = vmap(grad(partial(_device_loss, model)), in_dims=(0, 0, 0, None, 0))
    g2 = vmap(per_device)(  # over groups
        state.theta2, state.batch["x2"], state.batch["y"], state.stale["theta0"], state.stale["z1"]
    )
    return losses, g0, g1, g2


def _apply_sgd(state: HSGDState, lr: float, g0, g1, g2) -> HSGDState:
    upd = lambda p, g: p - lr * g.to(p.dtype)
    return state._replace(
        theta0=tree_map(upd, state.theta0, g0),
        theta1=tree_map(upd, state.theta1, g1),
        theta2=tree_map(upd, state.theta2, g2),
        step=state.step + 1,
    )


def local_sgd_step(model: HybridModel, state: HSGDState, lr: float) -> Tuple[HSGDState, torch.Tensor]:
    """One iteration of lines 22–26 for every group and sampled device."""
    losses, g0, g1, g2 = _local_grads(model, state)
    return _apply_sgd(state, lr, g0, g1, g2), torch.mean(losses)


# ---------------------------------------------------------------------------
# Exchange + aggregations
# ---------------------------------------------------------------------------


def exchange(
    model: HybridModel,
    state: HSGDState,
    data,
    fed: FederationConfig,
    compression_k: float = 0.0,
    quant_levels: int = 0,
    idx: Optional[torch.Tensor] = None,
) -> HSGDState:
    """Local aggregation (eq 1) + A_m/ξ_m agreement + ζ/θ0 exchange.

    With compression on, the whole exchange message (θ0 snapshot tree + ζ1
    + ζ2) is compressed in ONE fused top-k+quantize row-matrix call: the
    CUDA kernel on the card, its plain version on the CPU.

    ``idx`` ([M, A] data-row indices) pins the participants instead of
    drawing them from the state's generator.
    """
    device = data["x1"].device
    theta2_group = F.local_aggregate(state.theta2)  # eq (1)
    A = fed.sampled_devices if idx is None else idx.shape[1]
    theta2 = F.broadcast_to_devices(theta2_group, A)  # line 15

    if idx is None:
        idx = F.sample_participants(state.generator, fed)  # line 13
    batch = F.gather_batch(data, idx.to(device))

    z1 = _h1_groups(model, state.theta1, batch["x1"])
    z2 = _h2_groups(model, theta2_group, batch["x2"])
    stale_theta0 = state.theta0

    if compression_k or quant_levels:
        msg = compress_pytree({"theta0": stale_theta0, "z1": z1, "z2": z2},
                              compression_k or 1.0, quant_levels)
        stale_theta0, z1, z2 = msg["theta0"], msg["z1"], msg["z2"]

    stale = {"theta0": stale_theta0, "z1": z1, "z2": z2}
    return state._replace(theta2=theta2, stale=stale, batch=batch)


def global_aggregation(state: HSGDState, fed: FederationConfig, group_weights) -> HSGDState:
    """Eq. (2) + broadcasts (Alg. 1 lines 3–9)."""
    M = fed.num_groups
    A = tree_leaves(state.theta2)[0].shape[1]
    theta2_group = F.local_aggregate(state.theta2)
    g0 = F.global_aggregate(state.theta0, group_weights)
    g1 = F.global_aggregate(state.theta1, group_weights)
    g2 = F.global_aggregate(theta2_group, group_weights)
    return state._replace(
        theta0=F.broadcast_to_groups(g0, M),
        theta1=F.broadcast_to_groups(g1, M),
        theta2=F.broadcast_to_devices(F.broadcast_to_groups(g2, M), A),
    )


def global_model(state: HSGDState, group_weights) -> Dict[str, Any]:
    """The observable global model θ̃ (eq. (2))."""
    return {
        "theta0": F.global_aggregate(state.theta0, group_weights),
        "theta1": F.global_aggregate(state.theta1, group_weights),
        "theta2": F.global_aggregate(F.local_aggregate(state.theta2), group_weights),
    }


# ---------------------------------------------------------------------------
# Training run
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HSGDRunner:
    """HSGD trainer for a (model, federation, train) configuration."""

    model: HybridModel
    fed: FederationConfig
    train: TrainConfig
    do_global_agg: bool = True  # False reproduces TDCD's missing phase

    def run(self, state: HSGDState, data, group_weights, rounds: int,
            participants: Optional[torch.Tensor] = None):
        """Execute ``rounds`` global rounds; returns (state, per-step losses).

        Each round: global aggregation, then Λ × (exchange, Q SGD steps).
        ``participants`` ([rounds·Λ, M, A]) pins every exchange's A_m, as
        ``exchange(idx=)`` does. The caller's ``state`` is consumed — this
        may update it in place, as the reference donates it — so rebind the
        returned state. Losses stay on the state's device, one per step.
        """
        fed, model, train = self.fed, self.model, self.train
        if participants is not None and participants.shape[0] != rounds * fed.lam:
            raise ValueError(f"participants holds {participants.shape[0]} draws; "
                             f"{rounds} rounds need rounds·Λ = {rounds * fed.lam}")
        lr_fn = halving_schedule(train.learning_rate, train.lr_halve_every)
        losses = []
        for r in range(rounds):
            if self.do_global_agg:
                state = global_aggregation(state, fed, group_weights)
            for i in range(fed.lam):
                idx = None if participants is None else participants[r * fed.lam + i]
                state = exchange(model, state, data, fed, train.compression_k,
                                 train.quantization_bits, idx=idx)
                for _ in range(fed.local_interval):
                    state, loss = local_sgd_step(model, state, lr_fn(state.step))
                    losses.append(loss)
        out = torch.stack(losses) if losses else torch.zeros(0, device=data["x1"].device)
        return state, out


def make_group_weights(data) -> torch.Tensor:
    """K_m weights from the per-group valid-sample counts."""
    return torch.sum(data["valid"].float(), dim=1)
