"""Quickstart: train the paper's CNN on a synthetic OrganAMNIST-like e-health
federation with HSGD (Algorithm 1), then evaluate the global model.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The twin of the reference's ``examples/quickstart.py``: the same federation,
data, model, rounds and learning rate, on the card by default.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.backend import resolve_device
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.core.hsgd import HSGDRunner, global_model, init_state, make_group_weights
from repro_torch.core.metrics import evaluate_global
from repro_torch.data.partition import hybrid_partition
from repro_torch.data.synthetic import ORGANAMNIST, flatten_for_tower, make_dataset, vertical_split
from repro_torch.models.split_model import cnn_hybrid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises if absent) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # --- the 3-tier e-health federation (paper §III) ---------------------
    fed = FederationConfig(
        num_groups=4,          # M hospital-patient groups
        devices_per_group=64,  # K_m wearable devices (1 sample each)
        alpha=0.25,            # fraction sampled into A_m
        local_interval=2,      # Q: local agg + ζ exchange every 2 steps
        global_interval=4,     # P: cloud aggregation every 4 steps
    )
    train = TrainConfig(learning_rate=0.02)

    # --- data: horizontal (non-iid groups) -> vertical -> horizontal -----
    X, y = make_dataset(ORGANAMNIST, 1024, seed=0)
    fdata = hybrid_partition(ORGANAMNIST, X, y, fed, seed=0)
    data = {k: torch.as_tensor(v, device=device) for k, v in fdata.stacked().items()}

    # --- model: hospital tower h1, device tower h2, combined f -----------
    model = cnn_hybrid(h_rows=11, n_classes=ORGANAMNIST.n_classes)

    # --- HSGD ------------------------------------------------------------
    runner = HSGDRunner(model, fed, train)
    state = init_state(torch.Generator().manual_seed(0), model, fed, data)
    weights = make_group_weights(data)
    state, losses = runner.run(state, data, weights, rounds=25)
    losses = losses.cpu()
    print(f"train loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")

    # --- evaluate the global model (eq. 2) --------------------------------
    gm = global_model(state, weights)
    X1, X2 = vertical_split(ORGANAMNIST, X)
    metrics = evaluate_global(model, gm,
                              flatten_for_tower(ORGANAMNIST, X1),
                              flatten_for_tower(ORGANAMNIST, X2), y)
    for k, v in metrics.items():
        print(f"{k:10s} {v:.4f}")
    if not metrics["auc_roc"] > 0.6:
        raise AssertionError(f"expected the federation to learn: auc_roc {metrics['auc_roc']}")
    print("quickstart OK")
    return metrics


if __name__ == "__main__":
    main()
