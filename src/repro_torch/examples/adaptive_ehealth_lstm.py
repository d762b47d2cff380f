"""Closed-loop adaptive HSGD on the MIMIC-III-like LSTM task (paper §VI):

1. the controller seeds ρ, δ, F(θ⁰) with a short pre-training probe (§VI-B),
2. every global round it re-estimates ρ/δ/‖∇F‖² from that round's own
   gradients and re-picks P = Q (strategies 1-2) and η (strategy 3),
3. a byte governor walks the compression ladder so the whole run stays under
   a user byte budget (here: 40% of the naive P=Q=1 bill),
4. we compare quality + modeled communication against the naive fixed run.

  PYTHONPATH=src python -m repro_torch.examples.adaptive_ehealth_lstm [--device cpu]

The twin of the reference's ``examples/adaptive_ehealth_lstm.py``, on the
card by default.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.backend import resolve_device
from repro_torch.common.config import FederationConfig, TrainConfig
from repro_torch.core.comm_model import comm_cost_per_iteration, message_sizes
from repro_torch.core.controller import AdaptiveConfig, AdaptiveHSGDRunner
from repro_torch.core.hsgd import HSGDRunner, global_model, init_state, make_group_weights
from repro_torch.core.metrics import evaluate_global
from repro_torch.data.partition import hybrid_partition
from repro_torch.data.synthetic import MIMIC3, make_dataset, vertical_split
from repro_torch.models.split_model import lstm_hybrid

TOTAL_STEPS = 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises if absent) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    fed = FederationConfig(num_groups=4, devices_per_group=32, alpha=0.25,
                           local_interval=1, global_interval=1)
    train = TrainConfig(learning_rate=0.01)
    X, y = make_dataset(MIMIC3, 512, seed=0)
    fdata = hybrid_partition(MIMIC3, X, y, fed, seed=0)
    data = {k: torch.as_tensor(v, device=device) for k, v in fdata.stacked().items()}
    model = lstm_hybrid(n_features=76, hospital_features=36, n_classes=MIMIC3.n_classes)
    weights = make_group_weights(data)
    X1, X2 = vertical_split(MIMIC3, X)

    # naive fixed baseline: P = Q = 1, uncompressed
    runner = HSGDRunner(model, fed, train)
    state = init_state(torch.Generator().manual_seed(0), model, fed, data)
    state, losses_naive = runner.run(state, data, weights, rounds=TOTAL_STEPS)
    gm_naive = global_model(state, weights)

    params0 = model.init(torch.Generator().manual_seed(0))
    sizes = message_sizes(params0, 8 * 64, 8 * 64, fed.sampled_devices)
    naive_bytes = comm_cost_per_iteration(sizes, fed) * fed.num_groups * TOTAL_STEPS

    # closed loop under a 40% byte budget
    cfg = AdaptiveConfig(total_steps=TOTAL_STEPS, byte_budget=0.4 * naive_bytes,
                         max_interval=16, eta_max=0.05)
    controller = AdaptiveHSGDRunner(model, fed, train, cfg)
    state2 = init_state(torch.Generator().manual_seed(0), model, fed, data)
    state2, losses_ad, history = controller.run(
        state2, data, weights, probe_generator=torch.Generator().manual_seed(1))
    gm_ad = global_model(state2, weights)

    print("round  P=Q   eta      rung  Γ(P,Q)    bytes(MB)  loss")
    for h in history:
        print(f"{h['round']:5d} {h['P']:4d}  {h['eta']:.5f}  {h['rung']:4d}  "
              f"{h['gamma']:8.3g}  {h['bytes_total'] / 1e6:8.2f}  {h['loss_last']:.4f}")

    m_naive = evaluate_global(model, gm_naive, X1, X2, y)
    m_ad = evaluate_global(model, gm_ad, X1, X2, y)
    ad_bytes = history[-1]["bytes_total"]
    print(f"\nnaive    P=Q=1   : loss={float(losses_naive[-1]):.4f} "
          f"auc={m_naive['auc_roc']:.3f}  comm={naive_bytes / 1e6:.2f} MB")
    print(f"adaptive (closed): loss={float(losses_ad[-1]):.4f} "
          f"auc={m_ad['auc_roc']:.3f}  comm={ad_bytes / 1e6:.2f} MB")
    print(f"communication saved: {100 * (1 - ad_bytes / naive_bytes):.0f}%")
    return {"naive": m_naive, "adaptive": m_ad, "naive_bytes": naive_bytes,
            "adaptive_bytes": ad_bytes}


if __name__ == "__main__":
    main()
