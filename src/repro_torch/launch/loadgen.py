"""Poisson/trace-driven load generator for the serving engine
(``repro/launch/loadgen.py``).

A fixed batch decoding in lockstep is not what e-health traffic looks like:
requests land on the scheduler at random times, queue for a slot, and care
about first-token latency, not just aggregate tokens/s.

* ``poisson_trace`` builds a seeded, reproducible trace (exponential
  inter-arrival gaps at a target request rate, optional shared prompt head
  to exercise the prefix cache) that can be saved/loaded as JSON. It draws
  from numpy's ``default_rng`` exactly as the reference does, so one seed
  gives both packages the same trace.
* ``run_load`` replays a trace against a :class:`ServeEngine` in real wall
  clock — submitting each request at its timestamp while the engine keeps
  decoding via the public ``step()``/``pending()`` API — and reports
  p50/p99 queue, first-token and total latency, sustained tokens/s, and
  SLO attainment (fraction of requests under the first-token deadline).

Runs on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.loadgen --arch gemma3-1b --full \\
      --requests 8 --rate 4 --prompt-len 4096 --gen 16 --shared-prefix-frac 0.75 \\
      --prefix-cache --cache-dtype bf16 --max-batch 2
  PYTHONPATH=src python -m repro_torch.launch.loadgen --device cpu --arch gemma3-1b \\
      --requests 20 --rate 20 --seed 0 --prefix-cache
  PYTHONPATH=src python -m repro_torch.launch.loadgen --device cpu --arch zamba2-2.7b \\
      --requests 8 --rate 20 --prompt-len 40

The prefix cache and speculation serve the dense family only: a recurrent
state can be neither shared by prompt head nor rolled back.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict, dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.common.backend import resolve_device
from repro_torch.common.config import get_config
from repro_torch.common.io import atomic_write_json
from repro_torch.launch.engine import ServeEngine, parse_cache_dtype
from repro_torch.launch.serve import build_inputs


@dataclass
class TraceRequest:
    rid: int
    t_arrival: float  # seconds from trace start
    prompt: List[int]
    max_new: int


def poisson_trace(n: int, rate: float, prompt_len: int, max_new: int,
                  vocab_size: int, seed: int = 0,
                  shared_prefix_frac: float = 0.0) -> List[TraceRequest]:
    """Seeded Poisson arrivals: n requests at ``rate`` req/s on average.

    ``shared_prefix_frac`` of each prompt is drawn ONCE and shared by every
    request (the common system-prompt head that prefix caching exploits);
    the tail stays per-request random. For the prefix cache to hit, the
    shared head must cover the engine's pow2 prefix block —
    ``pow2_floor(prompt_len - 1)`` tokens — so fractions below ~0.75 of a
    non-pow2 prompt length produce misses by construction. The first
    arrival is at t=0 so a replay never starts with dead air.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
    arrivals = np.cumsum(gaps) - gaps[0]
    shared_len = int(prompt_len * shared_prefix_frac)
    shared = rng.integers(1, vocab_size, size=shared_len)
    out = []
    for i in range(n):
        tail = rng.integers(1, vocab_size, size=prompt_len - shared_len)
        prompt = np.concatenate([shared, tail]).astype(np.int32)
        out.append(TraceRequest(i, float(arrivals[i]), prompt.tolist(), max_new))
    return out


def save_trace(path: str, trace: List[TraceRequest]) -> None:
    atomic_write_json(path, [asdict(r) for r in trace], indent=None)


def load_trace(path: str) -> List[TraceRequest]:
    with open(path) as f:
        return [TraceRequest(**d) for d in json.load(f)]


def _pct(vals, q):
    return round(float(np.percentile(np.asarray(vals), q)), 6) if vals else 0.0


def _latency(vals) -> Dict:
    return {"p50": _pct(vals, 50), "p99": _pct(vals, 99)}


def load_report(finished, slo_first_token_s: float) -> Dict:
    """Latency/SLO summary over finished engine Requests."""
    queue = [r.t_admit - r.t_submit for r in finished]
    first = [r.t_first - r.t_submit for r in finished]
    total = [r.t_done - r.t_submit for r in finished]
    gen = sum(len(r.tokens) for r in finished)
    span = (max(r.t_done for r in finished) - min(r.t_submit for r in finished)
            if finished else 0.0)
    met = sum(1 for f in first if f <= slo_first_token_s)
    return {
        "requests": len(finished),
        "generated_tokens": gen,
        "span_s": round(span, 6),
        "sustained_tokens_per_s": round(gen / max(span, 1e-9), 1),
        "queue_s": _latency(queue),
        "first_token_s": _latency(first),
        "total_s": _latency(total),
        "slo_first_token_s": slo_first_token_s,
        "slo_attainment": round(met / max(len(finished), 1), 4),
    }


def run_load(engine, trace: List[TraceRequest],
             slo_first_token_s: float = 1.0, time_scale: float = 1.0) -> Dict:
    """Replay ``trace`` against ``engine`` in real wall clock.

    Each request is submitted once its (scaled) arrival time has passed;
    between arrivals the engine keeps stepping — admissions interleave with
    decode blocks exactly as they would under live traffic. Returns the
    load report plus the engine's own run report (executor counts, spec /
    prefix stats).
    """
    trace = sorted(trace, key=lambda r: r.t_arrival)
    done_before = len(engine.done)
    i = 0
    t0 = time.perf_counter()
    while i < len(trace) or engine.pending():
        now = time.perf_counter() - t0
        while i < len(trace) and trace[i].t_arrival * time_scale <= now:
            engine.submit(np.asarray(trace[i].prompt, np.int32), trace[i].max_new)
            i += 1
        if engine.pending():
            engine.step()
        elif i < len(trace):
            # idle until the next arrival (engine fully drained)
            time.sleep(min(trace[i].t_arrival * time_scale - now, 0.05))
    wall = time.perf_counter() - t0
    finished = engine.done[done_before:]
    rep = load_report(finished, slo_first_token_s)
    rep["wall_s"] = round(wall, 6)
    rep["engine"] = engine.report(wall, finished)
    return rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--rate", type=float, default=20.0, help="mean req/s")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shared-prefix-frac", type=float, default=0.75)
    ap.add_argument("--trace", default="", help="load arrivals from JSON instead")
    ap.add_argument("--save-trace", default="", help="write the trace JSON")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--cache-dtype", default="f32")
    ap.add_argument("--spec-gamma", type=int, default=0)
    ap.add_argument("--spec-draft-layers", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--slo-first-token-s", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        args.cache_dtype = parse_cache_dtype(args.cache_dtype)
    except ValueError as e:
        ap.error(str(e))
    return args


def run(args):
    """Replay the trace the flags describe: (report, engine, trace). The
    engine keeps its finished requests (``engine.done``) and parameters."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params, _, _ = build_inputs(cfg, 1, args.prompt_len, args.seed, device)
    if args.trace:
        trace = load_trace(args.trace)
    else:
        trace = poisson_trace(args.requests, args.rate, args.prompt_len,
                              args.gen, cfg.vocab_size, args.seed,
                              args.shared_prefix_frac)
    if args.save_trace:
        save_trace(args.save_trace, trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    engine = ServeEngine(
        cfg, params, max_batch=args.max_batch, cache_dtype=args.cache_dtype,
        decode_block=args.decode_block, temperature=0.0, seed=args.seed,
        spec_gamma=args.spec_gamma, spec_draft_layers=args.spec_draft_layers or None,
        prefix_cache=args.prefix_cache,
    )
    rep = run_load(engine, trace, args.slo_first_token_s)
    rep["device"] = str(device)
    if device.type == "cuda":
        rep["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    return rep, engine, trace


def main(argv=None):
    rep, _, _ = run(parse_args(argv))
    print(json.dumps(rep, indent=1))
    return rep


if __name__ == "__main__":
    main()
