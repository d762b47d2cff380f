"""Baselines of §VII-A1.

* JFL  (Yu et al. 2022): VFL per (device, hospital) pair — NO local
  aggregation, so every sampled device owns a full private (θ0,θ1,θ2) triple;
  global aggregation over all pairs every P steps.
* TDCD (Das et al.): two-tier — NO global aggregation. Raw data of all groups
  is merged into a single group first; then the HSGD machinery runs with M=1
  and the global phase disabled.
* C-HSGD / C-TDCD: the respective algorithm with top-k + b-level quantization
  applied to the exchanged messages.
* Centralized SGD: reference upper bound (== HSGD with M=1, α=1, P=Q=1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.checkpoint.ckpt import register_state_class
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.common.pytree import tree_map
from repro_torch.core import federation as F
from repro_torch.core.hsgd import HSGDRunner
from repro_torch.models.split_model import HybridModel
from repro_torch.optim import halving_schedule


class JFLState(NamedTuple):
    params: Dict[str, Any]  # each leaf [M, A, ...] — unique model per pair
    generator: torch.Generator
    step: int


register_state_class(JFLState)


@dataclass(frozen=True)
class JFLRunner:
    model: HybridModel
    fed: FederationConfig
    train: TrainConfig

    def init(self, generator: torch.Generator, device="cpu", params=None,
             dtype=torch.float32) -> JFLState:
        p = self.model.init(generator, dtype, device) if params is None else params
        M, A = self.fed.num_groups, self.fed.sampled_devices
        rep = lambda x: x[None, None].expand((M, A) + x.shape).clone()
        return JFLState(tree_map(rep, p), generator, 0)

    def _pair_loss(self, p, x1_n, x2_n, y_n):
        return self.model.full_loss(p, x1_n[None], x2_n[None], y_n[None])

    def run(self, state: JFLState, data, group_weights, rounds: int,
            participants: Optional[torch.Tensor] = None):
        """``rounds`` rounds of (global aggregation over ALL pairs, P pair
        steps); returns (state, per-step losses). ``participants``
        ([rounds, M, A]) pins each round's A_m."""
        fed, train = self.fed, self.train
        P = fed.global_interval
        lr_fn = halving_schedule(train.learning_rate, train.lr_halve_every)
        pair_vg = vmap(vmap(grad_and_value(self._pair_loss)))
        device = data["x1"].device
        params, step, losses = state.params, state.step, []
        for r in range(rounds):
            gm = self.global_model(JFLState(params, state.generator, step), group_weights)
            params = tree_map(lambda g, x: g[None, None].expand(x.shape).clone(), gm, params)
            idx = (F.sample_participants(state.generator, fed) if participants is None
                   else participants[r])
            batch = F.gather_batch(data, idx.to(device))
            for _ in range(P):
                g, loss = pair_vg(params, batch["x1"], batch["x2"], batch["y"])
                lr = lr_fn(step)
                params = tree_map(lambda p_, g_: p_ - lr * g_.to(p_.dtype), params, g)
                losses.append(torch.mean(loss))
                step += 1
        out = torch.stack(losses) if losses else torch.zeros(0, device=device)
        return JFLState(params, state.generator, step), out

    def global_model(self, state: JFLState, group_weights):
        w = group_weights / torch.sum(group_weights)

        def agg(x):
            wb = w.reshape((-1,) + (1,) * (x.dim() - 2)).to(x.dtype)
            return torch.sum(torch.mean(x, dim=1) * wb, dim=0)

        return tree_map(agg, state.params)


def merge_groups_for_tdcd(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Combine all hospital-patient groups into one (raw-data transmission)."""
    return {k: np.asarray(v).reshape((1, -1) + v.shape[2:]) for k, v in data.items()}


def tdcd_runner(model: HybridModel, fed: FederationConfig, train: TrainConfig) -> Tuple[HSGDRunner, FederationConfig]:
    merged_fed = FederationConfig(
        num_groups=1,
        devices_per_group=fed.devices_per_group * fed.num_groups,
        alpha=fed.alpha,
        local_interval=fed.local_interval,
        global_interval=fed.local_interval,  # Λ=1; global phase disabled anyway
        hospital_feature_frac=fed.hospital_feature_frac,
        non_iid_labels_per_group=fed.non_iid_labels_per_group,
    )
    return HSGDRunner(model, merged_fed, train, do_global_agg=False), merged_fed


def centralized_runner(model: HybridModel, fed: FederationConfig, train: TrainConfig):
    cfed = FederationConfig(
        num_groups=1,
        devices_per_group=fed.devices_per_group * fed.num_groups,
        alpha=1.0,
        local_interval=1,
        global_interval=1,
        hospital_feature_frac=fed.hospital_feature_frac,
    )
    return HSGDRunner(model, cfed, train), cfed


def make_runner(name: str, model: HybridModel, fed: FederationConfig, train: TrainConfig):
    """Algorithm registry: hsgd | c-hsgd | jfl | tdcd | c-tdcd | centralized."""
    name = name.lower()
    compressed = name in ("c-hsgd", "c-tdcd")
    if compressed and not (train.compression_k or train.quantization_bits):
        train = dataclasses.replace(train, compression_k=0.25, quantization_bits=128)
    if name in ("hsgd", "c-hsgd"):
        return HSGDRunner(model, fed, train), fed
    if name == "jfl":
        return JFLRunner(model, fed, train), fed
    if name in ("tdcd", "c-tdcd"):
        return tdcd_runner(model, fed, train)
    if name == "centralized":
        return centralized_runner(model, fed, train)
    raise ValueError(f"unknown algorithm {name}")
