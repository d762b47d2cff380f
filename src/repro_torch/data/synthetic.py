"""Synthetic dataset generators shaped like the paper's three datasets.

A numpy copy of ``repro/data/synthetic.py``: the same seed gives
bit-identical arrays. Class-conditional data with the exact
shapes/cardinalities of §VII-A2:
  * OrganAMNIST-like: 28x28 grayscale, 11 classes
  * MIMIC-III-like:   48 timesteps x 76 features, 2 classes
  * ESR-like:         178 features (treated as 178x1 time series), 5 classes

and the LLM-scale synthetic token streams of the ``llm_hybrid`` runner,
drawn on the host and handed to the run's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# LLM-scale synthetic token streams (the llm_hybrid training workload)
# ---------------------------------------------------------------------------


def token_stream(rng: np.random.RandomState, vocab: int, batch: int, seq: int,
                 drift: int = 17, p_drift: float = 0.7):
    """Markov-ish synthetic tokens: the next token is correlated with the
    previous one, so the hybrid model genuinely learns (unlike uniform noise,
    whose loss floor is log V regardless of training)."""
    base = rng.randint(0, vocab, (batch, seq + 1))
    drifted = (base[:, :-1] + rng.randint(0, drift, (batch, seq))) % vocab
    mask = rng.rand(batch, seq) < p_drift
    return base[:, :-1], np.where(mask, drifted, base[:, 1:])


def llm_batch_fn(cfg, batch: int, seq: int, n_pods: int = 1, seed: int = 0, device="cpu"):
    """Seeded per-exchange batch sampler for the LLM federated runner.

    Returns ``batch_fn(round_idx, lam)`` producing a fresh {x1, x2, y} dict
    of tensors on ``device`` with leading [Λ, G, ...] axes — one resampled
    mini-batch per exchange interval per pod group, family-aware (text
    splits the sequence between the hospital and device towers; vlm/audio
    feed the modality frontend to the hospital side). The host draws are
    the reference's, bit for bit.
    """
    rng = np.random.RandomState(seed)
    modality = cfg.family in ("vlm", "audio")
    enc = 8 if cfg.family == "vlm" else getattr(cfg, "encoder_seq", 0)

    def sample_one():
        if modality:
            x1 = rng.randn(batch, enc, cfg.d_model).astype(np.float32)
            x2_in, y = token_stream(rng, cfg.vocab_size, batch, seq)
            return x1, x2_in, y
        inp, tgt = token_stream(rng, cfg.vocab_size, batch, seq)
        s1 = seq // 2
        return inp[:, :s1], inp[:, s1:], tgt

    def batch_fn(round_idx: int, lam: int):
        del round_idx  # the shared rng advances monotonically across calls
        draws = [[sample_one() for _ in range(n_pods)] for _ in range(lam)]
        stack = lambda i: np.stack([[d[i] for d in pod] for pod in draws])
        as_t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
        return {
            "x1": as_t(stack(0), np.float32 if modality else np.int32),
            "x2": as_t(stack(1), np.int32),
            "y": as_t(stack(2), np.int32),
        }

    return batch_fn
