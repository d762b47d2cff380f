"""End-to-end example: train a ~100M-parameter dense transformer with the
paper's HSGD federation through the LLM round runner (hospital tower /
device tower / combined backbone; ζ exchange every Q, a fresh synthetic
stream every exchange).

By default the §VI adaptive controller drives the run — it re-picks P = Q and
η every round from the step's own gradient probes and ratchets the
compression ladder until --byte-budget-mb is honored — and prints the
per-round trace. --fixed keeps a constant cadence.

  PYTHONPATH=src python -m repro_torch.examples.train_100m_hsgd                 # 300 steps
  PYTHONPATH=src python -m repro_torch.examples.train_100m_hsgd --steps 20      # smoke
  PYTHONPATH=src python -m repro_torch.examples.train_100m_hsgd --fixed --q 4   # baseline
  PYTHONPATH=src python -m repro_torch.examples.train_100m_hsgd --device cpu --steps 20

The twin of the reference's ``examples/train_100m_hsgd.py``: the same
model, data stream, cadence and controller, on the card by default. The
weights are drawn from a generator seeded with 0 on the run's device, so
they are not the reference's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.backend import resolve_device
from repro_torch.common.config import ModelConfig
from repro_torch.common.pytree import tree_size
from repro_torch.core.controller import AdaptiveConfig
from repro_torch.core.metrics import smoothed_losses
from repro_torch.data.synthetic import llm_batch_fn
from repro_torch.launch.steps import (AdaptiveLLMRunner, LLMRoundRunner, global_llm_params,
                                      init_llm_params)
from repro_torch.models.split_model import llm_hybrid


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="dense-100m", family="dense", num_layers=12, d_model=640,
        num_heads=10, num_kv_heads=5, d_ff=2560, vocab_size=32768,
        mlp="swiglu", source="examples/train_100m_hsgd.py",
    )


def _synced_time(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--pods", type=int, default=1, help="pod groups G")
    ap.add_argument("--fixed", action="store_true",
                    help="constant cadence instead of the adaptive controller")
    ap.add_argument("--q", type=int, default=4, help="fixed exchange interval Q")
    ap.add_argument("--max-interval", type=int, default=16,
                    help="adaptive cap on P = Q")
    ap.add_argument("--byte-budget-mb", type=float, default=float("inf"))
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises if absent) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config_100m()
    model = llm_hybrid(cfg, n_tower=2, remat=False)
    params = init_llm_params(torch.Generator(device=device).manual_seed(0), model,
                             n_pods=args.pods)
    n_params = sum(tree_size(params[k]) // args.pods for k in params)
    print(f"hybrid model: {n_params/1e6:.1f}M params "
          f"(combined {tree_size(params['theta0'])/args.pods/1e6:.1f}M)")
    batch_fn = llm_batch_fn(cfg, args.batch, args.seq, n_pods=args.pods, seed=0, device=device)

    history = None
    t0 = _synced_time(device)
    if args.fixed:
        steps = max(1, args.steps // args.q) * args.q  # whole rounds
        runner = LLMRoundRunner(model, n_pods=args.pods)
        params, losses = runner.run_fixed(params, batch_fn, steps=steps,
                                          P=args.q, Q=args.q, lr=args.lr)
        wall = _synced_time(device) - t0
        for t in range(0, len(losses), 10):
            print(f"step {t:4d}  loss {losses[t]:7.4f}")
        print(f"{wall / len(losses):.2f}s/step overall ({len(losses) / wall:.4f} steps/s)")
    else:
        acfg = AdaptiveConfig(total_steps=args.steps,
                              byte_budget=args.byte_budget_mb * 1e6,
                              max_interval=args.max_interval,
                              # anti-stall floor at half the seed η (yields to
                              # Theorem 1's 1/(8Pρ) cap inside plan_round)
                              eta_min=0.5 * args.lr,
                              eta_max=max(args.lr, 0.05))
        runner = AdaptiveLLMRunner(model, acfg, n_pods=args.pods,
                                   learning_rate=args.lr)
        params, losses, history = runner.run(params, batch_fn)
        wall = _synced_time(device) - t0
        for h in history:
            print(f"round {h['round']:3d}: P=Q={h['P']:3d} eta={h['eta']:.4g} "
                  f"rung={h['rung']} bytes={h['bytes_total']/1e6:.1f}MB "
                  f"loss={h['loss_last']:7.4f} rho={h['rho']:.3g} "
                  f"delta={h['delta']:.3g}")
        print(f"round executors: {len(runner.runner._round_cache)} "
              f"(one per distinct (P, Q, k, b) bucket)")
        print(f"{len(losses) / wall:.4f} steps/s overall")

    sm = smoothed_losses(losses, window=8)
    if not sm[-1] < sm[0]:
        raise AssertionError(f"training must reduce the smoothed loss: {sm[0]} -> {sm[-1]}")
    print(f"done: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(smoothed {sm[0]:.3f} -> {sm[-1]:.3f}) in {wall:.0f}s")
    if args.checkpoint:
        # flat {θ0, θ1, θ2} global model (pod mean)
        save_checkpoint(args.checkpoint, global_llm_params(params), step=len(losses))
        print(f"checkpoint -> {args.checkpoint}")
    return {"losses": losses, "history": history, "wall_s": wall,
            "steps_per_s": len(losses) / wall, "params": params}


if __name__ == "__main__":
    main()
