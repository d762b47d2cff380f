"""Where the time of a serving run goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch gemma3-1b --full --batch 2 --prompt-len 4096 --gen 32 [--trace out.json]
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch falcon-mamba-7b --full --batch 2 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch zamba2-2.7b --full --batch 2 --prompt-len 2080 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch gemma3-1b --full --batch 2 --prompt-len 4096 --gen 32 --spec-gamma 4
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch whisper-medium --full --batch 4 --prompt-len 416 --gen 32

Takes the flags of ``repro_torch.launch.serve`` (``--spec-gamma``,
``--spec-draft-layers`` and ``--prefix-cache`` included) and needs a CUDA
device.
Builds the model and prompts as the CLI does, warms the engine up with one
full request batch, then profiles two windows under ``torch.profiler``:
the prefill alone (the same prompts with one new token each: the first
prefill block, the first-token sample and the cache insert) and the whole
request batch (prefill plus ``--gen`` tokens of decode). For each window it
prints the wall time, the time the device was busy (the union of its
kernel, copy and memset intervals), the device time and launches of the
port's flash and scan kernels, of the matrix products (kernels named like a
GEMM) and of everything else, and the kernels that took the most device
time, as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from repro_torch.common.backend import resolve_device
from repro_torch.common.config import get_config
from repro_torch.launch import serve
from repro_torch.launch.profile_train import busy_us, device_intervals

PORT_KERNELS = {"flash": "flash_fwd_kernel", "scan": "ssm_scan_kernel"}
GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "cublas")


def kernel_split(intervals):
    """Device µs (and launches) of the port's kernels, of GEMM-like kernels
    and of the rest."""
    out = {"gemm_us": 0.0, "other_us": 0.0}
    for key in PORT_KERNELS:
        out[f"{key}_us"], out[f"{key}_launches"] = 0.0, 0
    for cat, name, _, dur in intervals:
        low = name.lower()
        port = next((k for k, mark in PORT_KERNELS.items() if mark in name), None)
        if cat == "kernel" and port is not None:
            out[f"{port}_us"] += dur
            out[f"{port}_launches"] += 1
        elif cat == "kernel" and any(m in low for m in GEMM_MARKS):
            out["gemm_us"] += dur
        else:
            out["other_us"] += dur
    return out


def profile_window(fn, trace_path=None):
    """Run ``fn`` under the profiler and summarise the window's device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        intervals = device_intervals(path)
    by_name = defaultdict(float)
    for _, name, _, dur in intervals:
        by_name[name] += dur
    busy = busy_us(intervals) / 1e6
    return {
        "profiled_wall_s": wall,
        "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "kernels": sum(1 for cat, *_ in intervals if cat == "kernel"),
        **kernel_split(intervals),
        "top_kernels_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--trace", default=None)
    own, rest = ap.parse_known_args(argv)
    args = serve.parse_args(rest)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_serve measures the card: run it with --device cuda")
    cfg = get_config(args.arch, smoke=args.smoke)
    params, prompts, extra = serve.build_inputs(cfg, args.batch, args.prompt_len, args.seed,
                                                device)
    engine = serve.build_engine(cfg, params, args)

    def requests(gen):
        return lambda: engine.generate(list(prompts), gen, extra_embeds=extra)

    requests(args.gen)()  # warm-up: cuBLAS handles, the allocator, the kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rep = requests(args.gen)()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {
        "device": torch.cuda.get_device_name(0),
        "arch": args.arch, "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
        "cache_dtype": str(args.cache_dtype),
        "wall_s": wall,
        "prefill_s": max(r["prefill_s"] for r in rep["requests"]),
        "generated_tokens": rep["generated_tokens"],
        "prefill": profile_window(requests(1)),
        "request": profile_window(requests(args.gen), own.trace),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
