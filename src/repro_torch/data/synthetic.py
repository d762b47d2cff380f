"""Synthetic dataset generators shaped like the paper's three datasets.

A numpy copy of the e-health part of ``repro/data/synthetic.py``: the same
seed gives bit-identical arrays. Class-conditional data with the exact
shapes/cardinalities of §VII-A2:
  * OrganAMNIST-like: 28x28 grayscale, 11 classes
  * MIMIC-III-like:   48 timesteps x 76 features, 2 classes
  * ESR-like:         178 features (treated as 178x1 time series), 5 classes
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    feature_shape: Tuple[int, ...]  # per-sample
    # vertical split sizes (hospital, device) along the split axis
    split_axis: int
    hospital_size: int
    raw_size_mb: float  # paper-reported raw dataset size (comm model)

    @property
    def device_size(self) -> int:
        return self.feature_shape[self.split_axis] - self.hospital_size


ORGANAMNIST = DatasetSpec("organamnist", 11, (28, 28), 0, 11, 63.0)
MIMIC3 = DatasetSpec("mimic3", 2, (48, 76), 1, 36, 42.3 * 1024)
ESR = DatasetSpec("esr", 5, (178, 1), 0, 89, 7.3)

DATASETS = {d.name: d for d in (ORGANAMNIST, MIMIC3, ESR)}


def make_dataset(spec: DatasetSpec, n_samples: int, seed: int = 0, noise: float = 0.7):
    """Returns (X [n, *feature_shape] float32, y [n] int32)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(spec.n_classes, *spec.feature_shape).astype(np.float32)
    y = rng.randint(0, spec.n_classes, size=n_samples).astype(np.int32)
    X = protos[y] + noise * rng.randn(n_samples, *spec.feature_shape).astype(np.float32)
    return X, y


def vertical_split(spec: DatasetSpec, X: np.ndarray):
    """Paper step (ii): split features between hospital (X1) and device (X2)."""
    h = spec.hospital_size
    if spec.split_axis == 0:
        X1, X2 = X[:, :h], X[:, h:]
    else:
        X1, X2 = X[:, :, :h], X[:, :, h:]
    return X1, X2


def flatten_for_tower(spec: DatasetSpec, X_part: np.ndarray) -> np.ndarray:
    """CNN towers consume flat pixel slices; LSTM towers keep [T, F_slice]."""
    if spec.name == "organamnist":
        return X_part.reshape(X_part.shape[0], -1)
    return X_part
