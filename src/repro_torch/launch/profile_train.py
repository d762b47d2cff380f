"""Where the time of an e-health training run goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      --algorithm c-hsgd --rounds 5 [--trace out.json] [train flags]

Runs one warm-up round, then times ``--rounds`` rounds twice: once
on the host clock alone (ending in ``torch.cuda.synchronize``), once under
``torch.profiler``. From the profiler's trace it reads the interval of
every kernel, copy and memset the device ran, and prints one JSON line:
steps/s, the time the device was busy (the union of those intervals)
against the unprofiled wall time, kernels per step, the launches and
device time of the port's own kernels, and the kernels that took the most
device time. ``--trace`` keeps the Chrome trace. It takes the training
flags of ``repro_torch.launch.train``, the privacy flags and ``--adaptive``
included (each timed call then runs the private round loop, or a whole
adaptive run of ``--rounds`` × P steps), and the population and fault
flags (each timed call is then a whole population run of ``--rounds``
rounds from the initial model, on the runtime the flags pick, and the line
adds its simulated seconds). A population run builds its runner, initial
state, device registry and scheduler inside the call; that setup is timed
on its own (the mean of three zero-round runs, ``setup_s``) and taken out
of ``wall_s`` before steps/s and the busy share are computed
(``wall_with_setup_s`` keeps the whole). It needs a CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.profile_train --population semi_async \
      --compression-k 0.25 --quantization 128 --rounds 10 [--fault-nan 0.05 ...]

With ``--arch`` each timed call runs ``--rounds`` fixed-cadence rounds of the
LLM-scale federation (``launch/steps.py``, P steps a round, ``--pods``,
``--compression-k``, ``--quantization``) from the model the previous call
left, on a fresh token stream every exchange interval:

  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch gemma3-1b \
      --compression-k 0.25 --quantization 128 --rounds 2

(or ``--arch falcon-mamba-7b``, ``--arch zamba2-2.7b``: their Mamba layers
launch the scan's forward and backward kernels, counted in the line). The
round's spans (``common/spans.py``: ``hsgd.round``, ``hsgd.global_agg``,
``hsgd.exchange`` and its towers and compress, ``hsgd.step`` and its
hospital, device and update phases) record under the profiled pass: the
line's ``spans`` holds, for each span name, that pass's count, device ms,
self device ms, host ms and launches of the port's kernels, summed over its
rounds (``spans.summed(spans.rounds())``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from repro_torch.common import spans
from repro_torch.common.backend import resolve_device
from repro_torch.core.baselines import make_runner
from repro_torch.core.hsgd import init_state
from repro_torch.launch import train as T
from repro_torch.launch.steps import LLMRoundRunner


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The port's hand-written kernels, by the name of their __global__ function.
PORT_KERNELS = ("compress_rows_kernel", "compress_rows_dp_kernel", "ssm_scan_kernel",
                "ssm_scan_bwd_kernel")


def device_intervals(trace_path: str):
    """(category, name, start µs, duration µs) of every kernel, copy and
    memset the device ran, from a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["cat"], e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(intervals) -> float:
    """Length of the union of the device intervals."""
    total, end = 0.0, float("-inf")
    for _, _, ts, dur in sorted(intervals, key=lambda k: k[2]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


def port_kernel_times(intervals):
    """Launches and device µs of each of the port's own kernels."""
    out = {}
    for key in PORT_KERNELS:
        durs = [dur for cat, name, _, dur in intervals if cat == "kernel" and key in name]
        out[key] = {"launches": len(durs), "us": sum(durs)}
    return out


def _round_runner(args, device, sim_seconds):
    """(initial state, run_rounds(state, rounds) -> (state, losses)) of the
    path the flags pick; a population run writes its simulated seconds
    into ``sim_seconds["last"]``."""
    if args.arch:
        if args.adaptive:
            raise SystemExit("profile_train --arch times fixed-cadence rounds; drop --adaptive")
        _, model, params, batch_fn = T.build_llm(args, device)
        llm_round = LLMRoundRunner(model, n_pods=args.pods).round_fn(
            args.p, args.q, args.compression_k, args.quantization, collect_stats=False)

        def run_llm_rounds(params, rounds):
            losses = [torch.zeros(0, device=device)]
            for r in range(rounds):
                params, loss = llm_round(params, batch_fn(r, args.p // args.q), args.lr)
                losses.append(loss)
            return params, torch.cat(losses)

        return params, run_llm_rounds
    model, fed, train, data, w, _ = T.setup_ehealth(args, device)
    if args.population:
        def run_population_rounds(state, rounds):
            res = T.population_rounds(args, model, fed, train, data, rounds)
            sim_seconds["last"] = res["sim_seconds"]
            return state, res["losses"]

        return None, run_population_rounds
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)

    def run_train_rounds(state, rounds):
        state, losses, _, _ = T.train_rounds(args, model, fed, runner, state, data, w, rounds)
        return state, losses

    return init_state(torch.Generator().manual_seed(args.seed), model, eff_fed, data), \
        run_train_rounds


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--trace", default=None)
    own, rest = ap.parse_known_args(argv)
    args = T.parse_args(rest)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_train measures the card: run it with --device cuda")
    sim_seconds = {}
    state, run_rounds = _round_runner(args, device, sim_seconds)
    state, _ = run_rounds(state, 1)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    setup_s = 0.0
    if args.population:  # the population run's own setup, timed apart
        for _ in range(3):
            t0 = time.perf_counter()
            run_rounds(state, 0)
            torch.cuda.synchronize()
            setup_s += (time.perf_counter() - t0) / 3

    t0 = time.perf_counter()
    state, losses = run_rounds(state, args.rounds)
    torch.cuda.synchronize()
    wall_with_setup_s = time.perf_counter() - t0
    wall_s = wall_with_setup_s - setup_s
    steps = int(len(losses))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    if args.arch:
        spans.clear()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = run_rounds(state, args.rounds)
        torch.cuda.synchronize()
        profiled_wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = own.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        intervals = device_intervals(path)
    by_name = defaultdict(float)
    for _, name, _, dur in intervals:
        by_name[name] += dur
    busy = busy_us(intervals) / 1e6
    n_kernels = sum(1 for cat, *_ in intervals if cat == "kernel")
    out = {
        "device": torch.cuda.get_device_name(0),
        "arch": args.arch, "pods": args.pods,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "algorithm": args.algorithm, "groups": args.groups, "devices": args.devices,
        "adaptive": args.adaptive, "dp_clip": args.dp_clip, "dp_sigma": args.dp_sigma,
        "secure_agg": args.secure_agg,
        "population": args.population, "no_defense": args.no_defense,
        "faults": {flag: getattr(args, flag) for flag in T.FAULT_RATES},
        "sim_seconds": sim_seconds.get("last"),
        "rounds": args.rounds, "steps": steps,
        "wall_s": wall_s, "steps_per_s": steps / wall_s,
        "setup_s": setup_s, "wall_with_setup_s": wall_with_setup_s,
        "profiled_wall_s": profiled_wall_s,
        "device_busy_s": busy,
        "device_busy_share_of_wall": busy / wall_s,
        "kernels_per_step": n_kernels / steps,
        "port_kernels": port_kernel_times(intervals),
        "top_kernels_us": sorted(((n, t) for n, t in by_name.items()),
                                 key=lambda kv: -kv[1])[:8],
    }
    if args.arch:
        out["spans"] = spans.summed(spans.rounds())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
