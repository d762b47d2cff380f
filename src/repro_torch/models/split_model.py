"""The paper's hybrid decomposition θ = [θ0 (combined), θ1 (hospital), θ2 (device)].

A ``HybridModel`` exposes exactly the objects Algorithm 1 manipulates:
  h1(θ1, X1) -> ζ1      hospital tower
  h2(θ2, X2) -> ζ2      device tower
  loss(θ0, ζ1, ζ2, y)   combined model + loss

This slice holds the paper's own e-health models (``cnn_hybrid``,
``lstm_hybrid``); ``llm_hybrid`` comes with the LLM slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.common.pytree import tree_map
from repro_torch.models import cnn as C
from repro_torch.models import layers as L
from repro_torch.models import lstm as R


@dataclass(frozen=True)
class HybridModel:
    name: str
    specs0: Any  # combined θ0
    specs1: Any  # hospital θ1
    specs2: Any  # device θ2
    h1: Callable  # (θ1, x1) -> ζ1
    h2: Callable  # (θ2, x2) -> ζ2
    loss: Callable  # (θ0, ζ1, ζ2, y) -> scalar
    predict: Callable  # (θ0, ζ1, ζ2) -> outputs

    def specs(self) -> Dict[str, Any]:
        return {"theta0": self.specs0, "theta1": self.specs1, "theta2": self.specs2}

    def init(self, generator: torch.Generator, dtype=torch.float32, device="cpu"):
        return {
            part: L.init_params(specs, generator, dtype, device)
            for part, specs in self.specs().items()
        }

    def params_from_numpy(self, tree, device) -> Dict[str, Any]:
        """The reference's ``HybridModel.init`` output (leaves converted with
        ``np.asarray``) as this package's parameter dict on ``device``.

        Every leaf's shape is checked against the specs; a missing or
        mismatched leaf raises.
        """

        def convert(spec, arr):
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"param shape {arr.shape} does not match spec {spec.shape}")
            return torch.as_tensor(arr.copy(), device=device)

        specs = self.specs()
        if set(tree) != set(specs):
            raise ValueError(f"expected parts {sorted(specs)}, got {sorted(tree)}")
        return tree_map(convert, specs, tree)

    def full_loss(self, params, x1, x2, y):
        """Centralized view: fresh towers + combined (used by baselines/tests)."""
        z1 = self.h1(params["theta1"], x1)
        z2 = self.h2(params["theta2"], x2)
        return self.loss(params["theta0"], z1, z2, y)


def cnn_hybrid(
    h_rows: int = 11,
    width: int = 28,
    n_classes: int = 11,
    embed_dim: int = 64,
) -> HybridModel:
    """OrganAMNIST: hospital holds top h_rows rows (≈300px), device the rest."""
    d_rows = width - h_rows

    def h1(t, x1):
        return C.tower_forward(t, x1, h_rows, width)

    def h2(t, x2):
        return C.tower_forward(t, x2, d_rows, width)

    def predict(t0, z1, z2):
        return C.combined_forward(t0, z1, z2)

    def loss(t0, z1, z2, y):
        return C.classification_loss(predict(t0, z1, z2), y)

    return HybridModel(
        name="paper_cnn",
        specs0=C.combined_specs(embed_dim, n_classes),
        specs1=C.tower_specs(h_rows, width, embed_dim=embed_dim),
        specs2=C.tower_specs(d_rows, width, embed_dim=embed_dim),
        h1=h1,
        h2=h2,
        loss=loss,
        predict=predict,
    )


def lstm_hybrid(
    n_features: int = 76,
    hospital_features: int = 36,
    n_classes: int = 2,
    d_hidden: int = 64,
    embed_dim: int = 64,
) -> HybridModel:
    """MIMIC-III / ESR: per-timestep feature split (36/40 for MIMIC)."""
    dev_features = n_features - hospital_features

    def predict(t0, z1, z2):
        return C.combined_forward(t0, z1, z2)

    def loss(t0, z1, z2, y):
        return C.classification_loss(predict(t0, z1, z2), y)

    return HybridModel(
        name="paper_lstm",
        specs0=C.combined_specs(embed_dim, n_classes),
        specs1=R.tower_specs(hospital_features, d_hidden, embed_dim),
        specs2=R.tower_specs(dev_features, d_hidden, embed_dim),
        h1=R.tower_forward,
        h2=R.tower_forward,
        loss=loss,
        predict=predict,
    )
