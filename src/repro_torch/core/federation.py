"""Federation bookkeeping: group/device sampling and weighted aggregation.

Eq. (1) (local aggregation over the sampled device subset A_m), eq. (2)
(global weighted aggregation over groups) and the A_m / mini-batch
agreement of Algorithm 1 line 13. The plain path of
``repro/core/federation.py``; secure and robust aggregation come with later
slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common.config import FederationConfig
from repro_torch.common.pytree import tree_map


def local_aggregate(theta2_active, mask: Optional[torch.Tensor] = None):
    """Eq. (1): θ2_m = mean over the sampled devices. [M, A, ...] -> [M, ...].

    ``mask`` ([M, A], 1 = real cohort member, 0 = padding slot) restricts the
    mean to the round's actual participants; a group with an empty cohort
    falls back to the plain mean.
    """
    if mask is None:
        return tree_map(lambda x: torch.mean(x, dim=1), theta2_active)
    w = mask.float()
    cnt = torch.sum(w, dim=1)  # [M]
    safe = torch.clamp_min(cnt, 1.0)

    def agg(x):
        tail = (1,) * (x.dim() - 2)
        wb = w.reshape(w.shape + tail).to(x.dtype)
        masked = torch.sum(x * wb, dim=1) / safe.reshape((-1,) + tail).to(x.dtype)
        plain = torch.mean(x, dim=1)
        keep = (cnt > 0).reshape((-1,) + tail)
        return torch.where(keep, masked, plain)

    return tree_map(agg, theta2_active)


def global_aggregate(theta, group_weights: torch.Tensor):
    """Eq. (2): weighted mean over groups. [M, ...] -> [...]."""
    w = group_weights / torch.sum(group_weights)

    def agg(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return torch.sum(x * wb, dim=0)

    return tree_map(agg, theta)


def broadcast_to_groups(theta, M: int):
    """Send the global model back to every group. [...] -> [M, ...].

    Materialized (not an expanded view), so each group's copy can be
    updated on its own."""
    return tree_map(lambda x: x.unsqueeze(0).expand((M,) + x.shape).clone(), theta)


def broadcast_to_devices(theta2_group, A: int):
    """Line 15: every sampled device restarts from the aggregated θ2_m."""
    return tree_map(
        lambda x: x.unsqueeze(1).expand((x.shape[0], A) + x.shape[1:]).clone(), theta2_group)


def sample_participants(generator: torch.Generator, fed: FederationConfig,
                        device="cpu") -> torch.Tensor:
    """A_m + ξ_m: per-group device subset (== its samples). [M, A] indices.

    Drawn from ``generator`` (a CPU generator) one group at a time, then
    moved to ``device``."""
    M, K, A = fed.num_groups, fed.devices_per_group, fed.sampled_devices
    idx = torch.stack([torch.randperm(K, generator=generator)[:A] for _ in range(M)])
    return idx.to(device)


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """data: {x1,x2,y,valid} with leading [M, K]; idx: [M, A] -> [M, A, ...]."""
    idx = idx.long()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: v[rows, idx] for k, v in data.items()}
