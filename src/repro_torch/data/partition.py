"""The paper's 3-step hybrid partition (§VII-A2 "Data split").

A numpy copy of ``repro/data/partition.py``; the same seed gives
bit-identical arrays.

  (i)   horizontal, non-iid: M hospital-patient groups, each dominated by
        a few labels (label-skew: ``major`` samples of 2 labels + ``minor``
        samples of the others);
  (ii)  vertical: every sample's features split hospital/device;
  (iii) horizontal again: the device-side slices scatter across K_m wearable
        devices, one sample per device (paper assumption).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.common.config import FederationConfig
from repro_torch.data.synthetic import DatasetSpec, flatten_for_tower, vertical_split


@dataclass
class GroupData:
    """Per-group arrays, already padded to a common K."""

    x1: np.ndarray  # [K, ...hospital slice]  (hospital holds all samples)
    x2: np.ndarray  # [K, ...device slice]    (row n lives on device n)
    y: np.ndarray  # [K]
    valid: np.ndarray  # [K] bool (padding mask)


@dataclass
class FederatedData:
    spec: DatasetSpec
    groups: List[GroupData]

    def stacked(self) -> Dict[str, np.ndarray]:
        """[M, K, ...] arrays — the layout the batched trainer consumes."""
        return {
            "x1": np.stack([g.x1 for g in self.groups]),
            "x2": np.stack([g.x2 for g in self.groups]),
            "y": np.stack([g.y for g in self.groups]),
            "valid": np.stack([g.valid for g in self.groups]),
        }


def non_iid_group_indices(
    y: np.ndarray, M: int, n_classes: int, labels_per_group: int, rng: np.random.RandomState
) -> List[np.ndarray]:
    """Label-skew split: group m is dominated by ``labels_per_group`` labels."""
    idx_by_class = [np.where(y == c)[0] for c in range(n_classes)]
    for a in idx_by_class:
        rng.shuffle(a)
    cursors = [0] * n_classes
    n = len(y)
    per_group = n // M
    major_frac = 0.85 if n_classes > labels_per_group else 1.0
    groups = []
    for m in range(M):
        major = [(m * labels_per_group + j) % n_classes for j in range(labels_per_group)]
        take = []
        n_major = int(per_group * major_frac)
        for c in major:
            want = n_major // len(major)
            avail = idx_by_class[c][cursors[c] : cursors[c] + want]
            cursors[c] += len(avail)
            take.append(avail)
        n_rest = per_group - sum(len(t) for t in take)
        rest_pool = []
        for c in range(n_classes):
            if c in major:
                continue
            rest_pool.append(idx_by_class[c][cursors[c] :])
        rest_pool = np.concatenate(rest_pool) if rest_pool else np.array([], np.int64)
        rng.shuffle(rest_pool)
        chosen_rest = rest_pool[:n_rest]
        # advance cursors for chosen rest
        chosen_set = set(chosen_rest.tolist())
        for c in range(n_classes):
            a = idx_by_class[c]
            keep = np.array([i for i in a[cursors[c] :] if i not in chosen_set], np.int64)
            idx_by_class[c] = np.concatenate([a[: cursors[c]], keep])
        take.append(chosen_rest)
        groups.append(np.concatenate(take).astype(np.int64))
    return groups


def hybrid_partition(
    spec: DatasetSpec,
    X: np.ndarray,
    y: np.ndarray,
    fed: FederationConfig,
    seed: int = 0,
) -> FederatedData:
    rng = np.random.RandomState(seed)
    M = fed.num_groups
    gidx = non_iid_group_indices(y, M, spec.n_classes, fed.non_iid_labels_per_group, rng)
    K = max(len(g) for g in gidx)
    K = min(K, fed.devices_per_group) if fed.devices_per_group else K
    groups = []
    for g in gidx:
        g = g[:K]
        Xg, yg = X[g], y[g]
        X1, X2 = vertical_split(spec, Xg)
        X1 = flatten_for_tower(spec, X1)
        X2 = flatten_for_tower(spec, X2)
        pad = K - len(g)
        valid = np.ones(K, bool)
        if pad:
            X1 = np.concatenate([X1, np.zeros((pad,) + X1.shape[1:], X1.dtype)])
            X2 = np.concatenate([X2, np.zeros((pad,) + X2.shape[1:], X2.dtype)])
            yg = np.concatenate([yg, np.zeros(pad, yg.dtype)])
            valid[-pad:] = False
        groups.append(GroupData(X1, X2, yg, valid))
    return FederatedData(spec, groups)


def sample_minibatch(
    data: Dict[str, np.ndarray], batch: int, rng: np.random.RandomState
) -> Dict[str, np.ndarray]:
    """Per-group mini-batch ξ_m over ``valid`` rows only (replacement only
    when the batch exceeds a group's valid count)."""
    M, K = data["y"].shape
    valid = np.asarray(data["valid"], bool)
    rows = []
    for m in range(M):
        vm = np.flatnonzero(valid[m])
        if vm.size == 0:  # degenerate group: nothing real to sample
            vm = np.arange(K)
        rows.append(rng.choice(vm, size=batch, replace=batch > vm.size))
    idx = np.stack(rows)
    out = {}
    for k in ("x1", "x2", "y", "valid"):
        out[k] = np.take_along_axis(
            data[k], idx.reshape(M, batch, *([1] * (data[k].ndim - 2))), axis=1
        )
    out["idx"] = idx
    return out
