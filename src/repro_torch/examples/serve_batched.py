"""Serving example: drive the serving engine with the trace-driven load
generator and print a latency/SLO report.

A reduced gemma3-style model serves a seeded Poisson trace (shared prompt
heads exercise the prefix cache) with the full serving stack — int8
decode caches, self-speculative decode, prefix caching — and the run
reports p50/p99 queue / first-token / total latency, sustained tokens/s,
and SLO attainment. A plain batched `serve` run is kept at the end as the
minimal non-load usage.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

The twin of the reference's ``examples/serve_batched.py``, on the card by
default. The weights come from ``serve.build_inputs`` (a generator seeded
with 0 on the run's device), so they are not the reference's; the
temperature-0.8 draws of the last run use a ``torch.Generator``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.backend import resolve_device
from repro_torch.common.config import get_config
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.loadgen import poisson_trace, run_load
from repro_torch.launch.serve import build_inputs
from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default; raises if absent) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = get_config("gemma3-1b", smoke=True)
    params, _, _ = build_inputs(cfg, 1, 24, device=device)
    trace = poisson_trace(n=16, rate=50.0, prompt_len=24, max_new=8,
                          vocab_size=cfg.vocab_size, seed=0,
                          shared_prefix_frac=0.75)
    engine = ServeEngine(cfg, params, max_batch=4, cache_dtype=torch.int8,
                         decode_block=8, temperature=0.0,
                         spec_gamma=1, prefix_cache=True)
    # warm-up replays: build the per-bucket executors and seed the prefix
    # store, so the printed report shows steady-state serving latency (two
    # passes because admission group sizes — and thus executor buckets —
    # depend on wall-clock arrival timing)
    for _ in range(2):
        run_load(engine, trace, slo_first_token_s=1.0)
    rep = run_load(engine, trace, slo_first_token_s=1.0)

    print(f"requests          {rep['requests']}  "
          f"({rep['generated_tokens']} tokens in {rep['span_s']:.2f}s)")
    print(f"sustained         {rep['sustained_tokens_per_s']} tok/s")
    for name, key in (("queue", "queue_s"), ("first token", "first_token_s"),
                      ("total", "total_s")):
        p = rep[key]
        print(f"{name:<17} p50 {p['p50'] * 1e3:8.1f} ms   "
              f"p99 {p['p99'] * 1e3:8.1f} ms")
    print(f"SLO attainment    {rep['slo_attainment']:.0%} "
          f"(first token <= {rep['slo_first_token_s']}s)")
    eng = rep["engine"]
    print(f"speculative       acceptance {eng['speculative']['acceptance']}")
    print(f"prefix cache      {eng['prefix_cache']['hits']} hits / "
          f"{eng['prefix_cache']['misses']} misses "
          f"({eng['prefix_cache']['seeded_tokens']} tokens seeded)")
    if not (rep["requests"] == 16 and rep["sustained_tokens_per_s"] > 0):
        raise AssertionError(f"load run: {rep['requests']} requests, "
                             f"{rep['sustained_tokens_per_s']} tok/s")

    # minimal non-load usage: one fixed batch through the same engine path
    report = serve_main([
        "--arch", "gemma3-1b",
        "--batch", "4",
        "--prompt-len", "24",
        "--gen", "12",
        "--temperature", "0.8",
        "--device", device.type,
    ])
    if not report["decode_tok_per_s"] > 0:
        raise AssertionError(f"serve run: {report['decode_tok_per_s']} tok/s")
    print("serve_batched OK")
    return {"load": rep, "engine": engine, "serve": report}


if __name__ == "__main__":
    main()
