"""Training launcher — the end-to-end driver for the HSGD federation.

E-health simulation (paper reproduction): --model paper-cnn|paper-lstm with
--dataset organamnist|mimic3|esr runs Algorithm 1 (or a baseline) on the
3-tier partitioned synthetic data and reports the paper's metrics. It runs on
the card unless ``--device cpu`` is given.

The parser takes every flag of ``repro.launch.train``. This package runs
the fixed-interval e-health path, its privacy-hardened variant (``--dp-clip``,
``--dp-sigma``, ``--epsilon``, ``--delta``, ``--secure-agg``), the §VI
adaptive loop (``--adaptive``, with ``--byte-budget-mb``, ``--target-bound``,
``--max-interval`` and the privacy flags), the population runtime
(``--population sync|semi_async|adaptive`` over a simulated device fleet),
its fault-tolerant variant (the ``--fault-*`` flags, ``--preempt-round``,
``--no-defense``, ``--ckpt-every``, ``--resume``) and ``--checkpoint``.

LLM-scale federation: --arch <name> [--smoke] trains the ``llm_hybrid``
decomposition of an assigned architecture on synthetic token streams
(``launch/steps.py``): fixed-cadence rounds (--steps, --p, --q, --pods,
--compression-k, --quantization) or the §VI loop (--adaptive). The dense
(gemma3-1b, gemma3-4b, stablelm-1.6b, nemotron-4-15b), ssm (falcon-mamba-7b),
hybrid (zamba2-2.7b) and audio (whisper-medium) families run; other --arch
values (the paper models, the MoE and VLM configs) exit with "not ported
yet". Without --smoke the widths are the published ones.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --model paper-cnn \
      --algorithm c-hsgd --rounds 50
  PYTHONPATH=src python -m repro_torch.launch.train --algorithm c-hsgd \
      --dp-clip 1 --dp-sigma 1 --secure-agg --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --algorithm c-hsgd \
      --adaptive --dp-clip 1 --dp-sigma 1 --epsilon 25 --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --population semi_async \
      --compression-k 0.25 --quantization 128 --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train --population sync \
      --fault-nan 0.05 --fault-dropout 0.1 --ckpt-every 2 --checkpoint ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 20 \
      --compression-k 0.25 --quantization 128 --pods 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --steps 20 \
      --compression-k 0.25 --quantization 128 --pods 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium --steps 20 \
      --compression-k 0.25 --quantization 128 --pods 2
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common.backend import resolve_device
from repro_torch.common.config import FederationConfig, TrainConfig, get_config, list_configs
from repro_torch.core import metrics as MET
from repro_torch.core.baselines import make_runner, merge_groups_for_tdcd
from repro_torch.core.controller import (
    AdaptiveConfig,
    AdaptiveHSGDRunner,
    epsilon_of,
    gaussian_rho,
    ladder_from,
)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.hsgd import global_model, init_state, make_group_weights
from repro_torch.core.population import (
    PopulationConfig,
    run_population,
    run_population_adaptive,
    run_population_resilient,
)
from repro_torch.data.partition import hybrid_partition
from repro_torch.data.synthetic import (DATASETS, flatten_for_tower, llm_batch_fn, make_dataset,
                                        vertical_split)
from repro_torch.launch.steps import (AdaptiveLLMRunner, LLMRoundRunner, global_llm_params,
                                      init_llm_params)
from repro_torch.models.split_model import cnn_hybrid, llm_hybrid, lstm_hybrid

FAULT_RATES = ("fault_dropout", "fault_nan", "fault_outlier", "fault_msg_corrupt",
               "fault_msg_loss", "fault_msg_dup", "fault_latency")


def make_paper_model(name: str, dataset: str):
    if name == "paper-cnn":
        return cnn_hybrid(h_rows=11, n_classes=DATASETS[dataset].n_classes)
    spec = DATASETS[dataset]
    if spec.name == "esr":
        return lstm_hybrid(n_features=178, hospital_features=89, n_classes=spec.n_classes)
    return lstm_hybrid(n_features=76, hospital_features=36, n_classes=spec.n_classes)


def setup_ehealth(args, device):
    """The configs, model and federated data of an e-health run: (model,
    fed, train, data on ``device``, group weights, (X, y) host dataset)."""
    spec = DATASETS[args.dataset]
    fed = FederationConfig(
        num_groups=args.groups,
        devices_per_group=args.devices,
        alpha=args.alpha,
        local_interval=args.q,
        global_interval=args.p,
        robust_agg=args.robust_agg,
        trim_frac=args.trim_frac,
    )
    train = TrainConfig(
        learning_rate=args.lr,
        lr_halve_every=args.lr_halve_every,
        compression_k=args.compression_k,
        quantization_bits=args.quantization,
    )
    model = make_paper_model(args.model, args.dataset)
    X, y = make_dataset(spec, args.samples, seed=args.seed)
    raw = hybrid_partition(spec, X, y, fed, seed=args.seed).stacked()
    if args.algorithm in ("tdcd", "c-tdcd", "centralized"):
        # both run one merged group; the reference merges for tdcd only, so
        # its centralized run fails on the [M, K] vs [1, M·K] data shapes
        raw = merge_groups_for_tdcd(raw)
    data = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    return model, fed, train, data, make_group_weights(data), (X, y)


def is_private(args) -> bool:
    return args.dp_clip > 0.0 or args.secure_agg


def train_rounds(args, model, fed, runner, state, data, w, rounds: int):
    """Train ``rounds`` rounds on the path the flags pick: the §VI adaptive
    loop, the fixed-interval private run, or the plain fixed-interval run.
    Returns (state, per-step losses, adaptive history or None, the runner
    whose round cache the run filled)."""
    algo = args.algorithm
    if is_private(args) and algo not in ("hsgd", "c-hsgd"):
        raise SystemExit(f"--dp-clip/--dp-sigma/--secure-agg drive the HSGD exchange; "
                         f"got --algorithm {algo}")
    if args.adaptive:
        if algo not in ("hsgd", "c-hsgd"):
            raise SystemExit(f"--adaptive drives the HSGD loop; got --algorithm {algo}")
        eff_train = runner.train  # c-hsgd defaults (k=0.25, b=128) applied
        acfg = AdaptiveConfig(
            total_steps=rounds * fed.global_interval,
            target_bound=args.target_bound,
            byte_budget=args.byte_budget_mb * 1e6,
            max_interval=args.max_interval,
            eta_max=max(args.lr * 10, 0.05),
            # explicit --compression-k/--quantization (or c-hsgd defaults)
            # become the governor's rung 0 — never silently loosened
            ladder=ladder_from(eff_train.compression_k, eff_train.quantization_bits),
            privacy_budget=args.epsilon,
            privacy_delta=args.delta,
            dp_clip=args.dp_clip,
            dp_sigma=args.dp_sigma,
            secure_agg=args.secure_agg,
        )
        controller = AdaptiveHSGDRunner(model, fed, eff_train, acfg)
        state, losses, history = controller.run(
            state, data, w, probe_generator=torch.Generator().manual_seed(args.seed + 1))
        return state, losses, history, controller.runner
    if is_private(args):
        state, losses = runner.run_private(
            state, data, w, rounds=rounds, seed=args.seed, dp_clip=args.dp_clip,
            dp_sigma=args.dp_sigma, secure_agg=args.secure_agg)
        return state, losses, None, runner
    state, losses = runner.run(state, data, w, rounds=rounds)
    return state, losses, None, runner


def run_ehealth(args) -> Tuple[dict, np.ndarray]:
    """Train and evaluate; prints the metrics JSON (after the ``[adaptive]``
    round lines of an adaptive run) and returns it with the per-step
    training losses. ``--population`` runs go to ``run_population_cli``."""
    if args.population:
        out, res = run_population_cli(args)
        return out, res["losses"]
    device = resolve_device(args.device)
    spec = DATASETS[args.dataset]
    algo = args.algorithm
    dp = args.dp_clip > 0.0 and args.dp_sigma > 0.0
    private = is_private(args)
    model, fed, train, data, w, (X, y) = setup_ehealth(args, device)
    runner, eff_fed = make_runner(algo, model, fed, train)
    generator = torch.Generator().manual_seed(args.seed)
    if algo == "jfl":
        state = runner.init(generator, device)
    else:
        state = init_state(generator, model, eff_fed, data)

    t0 = time.time()
    state, losses, history, runner = train_rounds(
        args, model, fed, runner, state, data, w, args.rounds)
    losses = torch.as_tensor(losses).cpu().numpy()  # waits for the device
    dt = time.time() - t0
    gm = runner.global_model(state, w) if algo == "jfl" else global_model(state, w)
    for h in history or ():
        eps = (f" σ={h['dp_sigma']:.3g} ε={h['epsilon_total']:.3g}"
               if h.get("dp_sigma") else "")
        print(f"[adaptive] round {h['round']:3d}: P=Q={h['P']:3d} "
              f"eta={h['eta']:.4g} rung={h['rung']} Γ={h['gamma']:.3g} "
              f"bytes={h['bytes_total'] / 1e6:.2f}MB "
              f"loss={h['loss_last']:.4f}{eps}")

    X1, X2 = vertical_split(spec, X)
    m = MET.evaluate_global(
        model, gm, flatten_for_tower(spec, X1), flatten_for_tower(spec, X2), y
    )
    m["train_loss_final"] = float(losses[-1]) if len(losses) else float("nan")
    m["steps"] = int(len(losses))
    m["wall_s"] = round(dt, 2)
    if history is not None:
        m["adaptive_rounds"] = len(history)
        m["adaptive_bytes_total"] = history[-1]["bytes_total"]
        m["adaptive_final_PQ"] = history[-1]["P"]
        if dp and history:
            m["epsilon"] = history[-1]["epsilon_total"]
            m["delta"] = args.delta
    elif dp:
        # fixed-interval ledger: one Gaussian release per exchange, Λ = P/Q
        # exchanges per round (zCDP composition, same math as the controller)
        releases = args.rounds * eff_fed.lam
        m["epsilon"] = epsilon_of(releases * gaussian_rho(args.dp_sigma), args.delta)
        m["delta"] = args.delta
    if private:
        m["secure_agg"] = bool(args.secure_agg)
        m["executors_compiled"] = len(runner._round_cache)
    print(json.dumps(m, indent=1))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, gm, step=len(losses), extra={"metrics": m})
        print(f"checkpoint -> {args.checkpoint}")
    return m, losses


def _fault_plan_of(args):
    """The CLI's FaultPlan, or None when every fault knob is at its default
    (fault-free runs stay on the plain population executors)."""
    plan = FaultPlan(
        seed=args.fault_seed if args.fault_seed is not None else args.seed,
        dropout_rate=args.fault_dropout,
        nan_rate=args.fault_nan,
        outlier_rate=args.fault_outlier,
        msg_corrupt_rate=args.fault_msg_corrupt,
        msg_loss_rate=args.fault_msg_loss,
        msg_dup_rate=args.fault_msg_dup,
        latency_spike_rate=args.fault_latency,
        preempt_round=args.preempt_round,
    )
    return None if plan.empty else plan


def is_resilient(args) -> bool:
    """Any fault, checkpoint-cadence or resume flag routes a population run
    to the resilient runtime."""
    return _fault_plan_of(args) is not None or args.ckpt_every > 0 or args.resume


def population_rounds(args, model, fed, train, data, rounds: int, params=None) -> dict:
    """A population run of ``rounds`` rounds on the path the flags pick: the
    resilient runtime, the adaptive wall-clock governor, or the plain
    sync/semi-async cohort loop. Returns the runner's result dict."""
    pop = PopulationConfig(
        seed=args.trace_seed if args.trace_seed is not None else args.seed,
        devices_per_group=args.pop_devices,
        target_cohort=args.cohort,
        deadline_quantile=args.deadline_quantile,
        staleness_damping=args.staleness_damping,
        max_staleness=args.max_staleness,
        min_quorum=args.min_quorum,
        max_retries=args.max_retries,
        backoff_factor=args.backoff_factor,
    )
    if is_resilient(args):
        return run_population_resilient(
            model, fed, train, data, pop, rounds=rounds, faults=_fault_plan_of(args),
            mode=args.population, robust=not args.no_defense, t_compute=args.t_compute,
            params=params, ckpt_dir=args.checkpoint, ckpt_every=args.ckpt_every,
            resume=args.resume)
    if args.population == "adaptive":
        acfg = AdaptiveConfig(
            total_steps=rounds * fed.global_interval,
            target_bound=args.target_bound,
            byte_budget=args.byte_budget_mb * 1e6,
            time_budget=args.time_budget,
            max_interval=args.max_interval,
            eta_max=max(args.lr * 10, 0.05),
            ladder=ladder_from(args.compression_k, args.quantization),
            init_probe=False,
        )
        return run_population_adaptive(model, fed, train, data, pop, acfg,
                                       t_compute=args.t_compute, params=params)
    return run_population(model, fed, train, data, pop, rounds=rounds,
                          mode=args.population, t_compute=args.t_compute, params=params)


def run_population_cli(args) -> Tuple[dict, dict]:
    """Population-scale cohort run over a simulated device fleet (sync,
    semi-async or adaptive); any fault/checkpoint/resume flag routes it to
    the resilient runtime. Prints the reference's report and returns it
    with the run's result dict."""
    device = resolve_device(args.device)
    model, fed, train, data, _, _ = setup_ehealth(args, device)
    pop_seed = args.trace_seed if args.trace_seed is not None else args.seed
    t0 = time.time()
    res = population_rounds(args, model, fed, train, data, args.rounds)
    out = {
        "mode": args.population,
        "trace_seed": pop_seed,
        "steps": int(len(res["losses"])),
        "loss_first": float(res["losses"][0]),
        "loss_last": float(res["losses"][-1]),
        "sim_seconds": res["sim_seconds"],
    }
    if is_resilient(args):
        fl = res["fault_log"]
        out.update({
            "recovered": res["recovered"],
            "rollbacks": res["rollbacks"],
            "devices_dropped": int(sum(r["dropped"] for r in fl)),
            "grad_faults": int(sum(r["grad_faulted"] for r in fl)),
            "msg_faults": int(sum(r["msg_faulted"] for r in fl)),
            "updates_flagged": float(sum(r["flagged_updates"] for r in fl)),
            "round_retries": int(sum(r["retries"] for r in fl)),
        })
    else:
        out["staleness_hist"] = {str(k): v for k, v in res["staleness_hist"].items()}
    out["executors_compiled"] = len(res["runner"]._round_cache)
    out["wall_s"] = round(time.time() - t0, 2)
    print(json.dumps(out, indent=1))
    if is_resilient(args) and args.fault_trace:
        res["injector"].save_trace(args.fault_trace)
        print(f"fault trace -> {args.fault_trace}")
    if args.checkpoint and not args.ckpt_every:
        # no periodic cadence: persist the final state the classic way
        save_checkpoint(args.checkpoint, res["state"], step=len(res["losses"]),
                        extra={"sim_seconds": res["sim_seconds"]})
        print(f"checkpoint -> {args.checkpoint}")
    return out, res


def build_llm(args, device):
    """(config, model, pod-stacked initial params, batch_fn) of an --arch
    run: the weights drawn from ``--seed`` on a generator of ``device``
    (CPU draws are the same whatever the run's device; card draws differ)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    model = llm_hybrid(cfg, n_tower=1, remat=False)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_llm_params(generator, model, n_pods=args.pods)
    batch_fn = llm_batch_fn(cfg, args.batch, args.seq, n_pods=args.pods, seed=args.seed,
                            device=device)
    return cfg, model, params, batch_fn


def run_llm(args) -> Tuple[dict, np.ndarray]:
    """LLM-scale federation on synthetic token streams: fixed-cadence rounds
    (one executor per (P, Q, k, b) bucket, a fresh stream every exchange
    interval) or the §VI adaptive loop. Prints the reference's report (with
    the peak device memory of the training, the draw of the weights left
    out) and returns it with the per-step losses."""
    device = resolve_device(args.device)
    _, model, params, batch_fn = build_llm(args, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    history = None
    if args.adaptive:
        acfg = AdaptiveConfig(
            total_steps=args.steps,
            target_bound=args.target_bound,
            byte_budget=args.byte_budget_mb * 1e6,
            max_interval=args.max_interval,
            eta_max=max(args.lr * 10, 0.05),
            ladder=ladder_from(args.compression_k, args.quantization),
        )
        ad = AdaptiveLLMRunner(model, acfg, n_pods=args.pods, learning_rate=args.lr)
        params, losses, history = ad.run(params, batch_fn)
        runner = ad.runner
        for h in history:
            print(f"[adaptive] round {h['round']:3d}: P=Q={h['P']:3d} "
                  f"eta={h['eta']:.4g} rung={h['rung']} Γ={h['gamma']:.3g} "
                  f"bytes={h['bytes_total'] / 1e6:.2f}MB loss={h['loss_last']:.4f}")
    else:
        steps = max(1, args.steps // args.p) * args.p  # whole rounds
        if steps != args.steps:
            print(f"# rounding --steps {args.steps} -> {steps} (whole P={args.p} rounds)")
        runner = LLMRoundRunner(model, n_pods=args.pods)
        params, losses = runner.run_fixed(
            params, batch_fn, steps=steps, P=args.p, Q=args.q, lr=args.lr,
            compression_k=args.compression_k, quant_levels=args.quantization)
        for t in range(0, len(losses), max(1, len(losses) // 10)):
            print(f"step {t:4d} loss {float(losses[t]):.4f}")
    wall = time.time() - t0
    out = {"arch": args.arch, "pods": args.pods,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "steps": int(len(losses)), "wall_s": round(wall, 2)}
    if history is not None:
        out["adaptive_rounds"] = len(history)
        out["adaptive_bytes_total"] = history[-1]["bytes_total"]
        out["adaptive_final_PQ"] = history[-1]["P"]
    out["executors_compiled"] = len(runner._round_cache)
    if device.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    print(json.dumps(out))
    if args.checkpoint:
        # flat {θ0, θ1, θ2} global model (pod mean), the reference's format
        save_checkpoint(args.checkpoint, global_llm_params(params), step=len(losses))
        print(f"checkpoint -> {args.checkpoint}")
    return out, losses


def llm_arch_ported(name: str) -> bool:
    """An --arch this package trains: a registered config of the dense, ssm,
    hybrid or audio family."""
    return name in list_configs() and get_config(name).family in ("dense", "ssm", "hybrid",
                                                                  "audio")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises if absent) or cpu")
    ap.add_argument("--model", default=None, choices=["paper-cnn", "paper-lstm"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dataset", default="organamnist", choices=list(DATASETS))
    ap.add_argument("--algorithm", default="hsgd",
                    choices=["hsgd", "c-hsgd", "jfl", "tdcd", "c-tdcd", "centralized"])
    ap.add_argument("--groups", type=int, default=10)
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--lr-halve-every", type=int, default=0)
    ap.add_argument("--compression-k", type=float, default=0.0)
    ap.add_argument("--quantization", type=int, default=0)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--byte-budget-mb", type=float, default=float("inf"))
    ap.add_argument("--target-bound", type=float, default=float("inf"))
    ap.add_argument("--max-interval", type=int, default=32)
    ap.add_argument("--population", default=None, choices=["sync", "semi_async", "adaptive"])
    ap.add_argument("--pop-devices", type=int, default=64)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--deadline-quantile", type=float, default=0.8)
    ap.add_argument("--staleness-damping", type=float, default=0.6)
    ap.add_argument("--max-staleness", type=int, default=4)
    ap.add_argument("--t-compute", type=float, default=0.05)
    ap.add_argument("--time-budget", type=float, default=float("inf"))
    ap.add_argument("--trace-seed", type=int, default=None)
    ap.add_argument("--robust-agg", default="mean", choices=["mean", "median", "trimmed"])
    ap.add_argument("--trim-frac", type=float, default=0.1)
    ap.add_argument("--no-defense", action="store_true")
    ap.add_argument("--fault-dropout", type=float, default=0.0)
    ap.add_argument("--fault-nan", type=float, default=0.0)
    ap.add_argument("--fault-outlier", type=float, default=0.0)
    ap.add_argument("--fault-msg-corrupt", type=float, default=0.0)
    ap.add_argument("--fault-msg-loss", type=float, default=0.0)
    ap.add_argument("--fault-msg-dup", type=float, default=0.0)
    ap.add_argument("--fault-latency", type=float, default=0.0)
    ap.add_argument("--preempt-round", type=int, default=-1)
    ap.add_argument("--fault-seed", type=int, default=None)
    ap.add_argument("--fault-trace", default=None)
    ap.add_argument("--min-quorum", type=float, default=0.5)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--backoff-factor", type=float, default=2.0)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dp-clip", type=float, default=0.0)
    ap.add_argument("--dp-sigma", type=float, default=0.0)
    ap.add_argument("--epsilon", type=float, default=float("inf"))
    ap.add_argument("--delta", type=float, default=1e-5)
    ap.add_argument("--secure-agg", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def validate_args(ap: argparse.ArgumentParser, args) -> None:
    """The reference's flag checks, as argparse errors before any work; the
    population path's flag combinations are checked here too."""
    for flag in FAULT_RATES:
        v = getattr(args, flag)
        if not 0.0 <= v <= 1.0:
            ap.error(f"--{flag.replace('_', '-')} must be in [0, 1], got {v}")
    if args.max_retries < 0:
        ap.error(f"--max-retries must be >= 0, got {args.max_retries}")
    if args.backoff_factor <= 1.0:
        ap.error(f"--backoff-factor must be > 1, got {args.backoff_factor}")
    if not 0.0 <= args.min_quorum <= 1.0:
        ap.error(f"--min-quorum must be in [0, 1], got {args.min_quorum}")
    if not 0.0 <= args.trim_frac < 0.5:
        ap.error(f"--trim-frac must be in [0, 0.5), got {args.trim_frac}")
    if args.preempt_round < -1:
        ap.error(f"--preempt-round must be >= 0 (or -1 = never), got {args.preempt_round}")
    if args.ckpt_every < 0:
        ap.error(f"--ckpt-every must be >= 0, got {args.ckpt_every}")
    if (args.resume or args.ckpt_every > 0) and not args.checkpoint:
        ap.error("--resume/--ckpt-every need --checkpoint <dir> to hold the checkpoints")
    if args.population:
        if args.algorithm != "hsgd":
            ap.error(f"--population drives the HSGD cohort loop; got --algorithm {args.algorithm}")
        if is_private(args):
            ap.error("--population does not combine with the privacy flags yet; "
                     "use the fixed-interval or --adaptive e-health path")
        if args.population == "adaptive" and is_resilient(args):
            ap.error("--population adaptive does not combine with fault injection / "
                     "checkpoint-resume; use sync or semi_async")
    if args.dp_clip < 0.0:
        ap.error(f"--dp-clip must be >= 0, got {args.dp_clip}")
    if args.dp_sigma < 0.0:
        ap.error(f"--dp-sigma must be >= 0, got {args.dp_sigma}")
    if args.dp_sigma > 0.0 and args.dp_clip <= 0.0:
        ap.error("--dp-sigma > 0 needs --dp-clip > 0 (noise std is σ·C)")
    if not 0.0 < args.delta < 1.0:
        ap.error(f"--delta must be in (0, 1), got {args.delta}")
    if args.epsilon <= 0.0:
        ap.error(f"--epsilon must be > 0, got {args.epsilon}")
    if is_private(args) and args.arch:
        ap.error("the privacy flags drive the e-health HSGD path, not --arch")


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_args(ap, args)
    if args.arch and not llm_arch_ported(args.arch):
        raise SystemExit(f"--arch {args.arch}: not ported yet")
    if not args.model:
        args.model = "paper-cnn"
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.arch:
        return run_llm(args)[0]
    return run_ehealth(args)[0]


if __name__ == "__main__":
    main()
