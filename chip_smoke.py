#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of every kernel source in src/repro_torch/csrc/;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shape (also with NaN rows) and at a large ragged shape:
     bit-identical (torch.equal),
     with device times (CUDA graph replays timed by CUDA events) beside the
     least time the card could take;
  3. the main path: ``repro_torch.launch.train.run_ehealth`` — paper-cnn,
     organamnist, c-hsgd (k=0.25, b=128), M=10, K=64, α=0.25, 2048 samples,
     P=4, Q=2, 10 rounds — with the launch counters zeroed just before and
     read just after;
  4. the card against the CPU: 2 c-hsgd rounds from the same initial model
     and the same participant draws, per-step losses within rtol 1e-3;
  5. a {"kernels": [...]} summary line, the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from repro_torch.common.backend import resolve_device  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import federation as F  # noqa: E402
from repro_torch.core.baselines import make_runner  # noqa: E402
from repro_torch.core.compression import compress_rows_ref  # noqa: E402
from repro_torch.core.hsgd import exchange, init_state  # noqa: E402
from repro_torch.kernels import build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.compress import fused_compress, stack_rows  # noqa: E402
from repro_torch.launch.train import parse_args, run_ehealth, setup_ehealth  # noqa: E402

# Data-sheet rates, dense, at the full power limit: (memory B/s, fp32 FLOP/s
# outside the tensor cores). Matched on the name nvidia-smi reports.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM
    ("H200", 4.8e12, 67e12),
)
MAIN_ARGV = ["--model", "paper-cnn", "--dataset", "organamnist", "--algorithm", "c-hsgd",
             "--groups", "10", "--devices", "64", "--alpha", "0.25", "--samples", "2048",
             "--p", "4", "--q", "2"]
MAIN_ROUNDS = 10
PARITY_ROUNDS = 2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    raise RuntimeError(f"chip_smoke: no data-sheet rates for card {name!r}")


def device_ms(fn, inner: int = 20, reps: int = 21) -> float:
    """Median device time of one ``fn()`` in ms: ``inner`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events, so the
    host's launch overhead is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def compress_bound_ms(mat, row_len, levels: int, bw: float, flops: float):
    """Least time for one fused compress: bytes (each row's valid prefix read
    once, the whole matrix written once with its padding as 0, k and row_len
    read once) over the memory rate, against operations (per valid element:
    1 max + 16 bisection compares + 1 keep compare, and with quantization 2
    extrema + sub, div, round, mul, add) over the fp32 rate. Returns
    (bound_ms, bound_by)."""
    rows, n = mat.shape
    valid = int(row_len.sum())
    nbytes = valid * 4 + rows * n * 4 + 2 * rows * 4
    ops = valid * (18 + (7 if levels > 1 else 0))
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_compress(name, mat, k_rows, len_rows, levels, bw, flops):
    """Kernel vs plain version on one input: bit-identical, then timed."""
    got = fused_compress(mat, k_rows, levels, len_rows)
    want = compress_rows_ref(mat, k_rows, levels, len_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"{name}: kernel differs from plain (max |diff| {err})")
    nnz = int((got != 0).sum())
    ms = device_ms(lambda: fused_compress(mat, k_rows, levels, len_rows))
    plain_ms = device_ms(lambda: compress_rows_ref(mat, k_rows, levels, len_rows))
    bound, bound_by = compress_bound_ms(mat, len_rows, levels, bw, flops)
    print(f"[kernel] {name}: shape={tuple(mat.shape)} levels={levels} nnz={nnz} "
          f"bit-identical max_abs_err={err} kernel_ms={ms} plain_ms={plain_ms} "
          f"bound_us={bound * 1e3} ({bound_by}) library_ms=null (no single PyTorch "
          f"call computes this function)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by}


def check_nan_rows(mat, k_rows, len_rows, levels):
    """A NaN in a row's valid prefix: the kernel keeps that row's non-NaN
    entries and drops the NaN, bit for bit as the plain version does (the
    row max propagates NaN, so the bisection ends at 0)."""
    bad = mat.clone()
    rows = torch.arange(0, bad.shape[0], 97, device=bad.device)
    bad[rows, 0] = float("nan")
    for lv in sorted({0, levels}):
        got = fused_compress(bad, k_rows, lv, len_rows)
        want = compress_rows_ref(bad, k_rows, lv, len_rows)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"NaN rows, levels={lv}: kernel differs from plain")
        check(bool(torch.isfinite(got).all()), f"NaN rows, levels={lv}: NaN in the output")
        dense = int((got[rows] != 0).sum(dim=1).min())
        print(f"[kernel] NaN rows: {rows.numel()} rows, levels={lv}: bit-identical, "
              f"fewest nonzeros in a NaN row {dense}")


def main_message(device):
    """The uncompressed θ0+ζ1+ζ2 message of one exchange of the main path,
    stacked as the compression kernel receives it."""
    args = parse_args(MAIN_ARGV)
    model, fed, train, data, _, _ = setup_ehealth(args, device)
    runner, eff_fed = make_runner(args.algorithm, model, fed, train)
    state = init_state(torch.Generator().manual_seed(args.seed), model, eff_fed, data)
    state = exchange(model, state, data, eff_fed)  # uncompressed
    leaves = tree_leaves({"theta0": state.stale["theta0"], "z1": state.stale["z1"],
                          "z2": state.stale["z2"]})
    mat, k_rows, len_rows, _ = stack_rows(leaves, runner.train.compression_k)
    return mat, k_rows, len_rows, runner.train.quantization_bits


def large_ragged(device, k_frac: float, seed: int = 0):
    """16384 rows cycling through widths 1024/300/129, padded to 1024."""
    widths = torch.tensor([1024, 300, 129], dtype=torch.int32)
    rows = 16384
    len_rows = widths[torch.arange(rows) % 3]
    k_rows = torch.clamp_min(torch.round(len_rows.double() * k_frac), 1).to(torch.int32)
    g = torch.Generator(device=device).manual_seed(seed)
    mat = torch.randn((rows, 1024), generator=g, device=device)
    mat = torch.where(torch.arange(1024, device=device) < len_rows.to(device)[:, None], mat, 0.0)
    return mat.contiguous(), k_rows.to(device), len_rows.to(device)


def same_start_losses(*devices):
    """Per-step losses of PARITY_ROUNDS c-hsgd rounds on each device, all
    from one initial model and one set of participant draws."""
    args = parse_args(MAIN_ARGV)
    gen = torch.Generator().manual_seed(args.seed)
    init = parts = None
    out = []
    for dev in devices:
        model, fed, train, data, w, _ = setup_ehealth(args, dev)
        runner, eff_fed = make_runner(args.algorithm, model, fed, train)
        if init is None:
            init = model.init(gen)
            parts = torch.stack([F.sample_participants(gen, eff_fed)
                                 for _ in range(PARITY_ROUNDS * eff_fed.lam)])
        state = init_state(torch.Generator(), model, eff_fed, data,
                           params=tree_map(lambda t: t.to(dev), init))
        _, losses = runner.run(state, data, w, PARITY_ROUNDS, participants=parts)
        out.append(losses.cpu())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    # -- phase 1: the card, versions, the build ---------------------------
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    print(f"[card] {smi}")
    print(f"[versions] python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} devices={torch.cuda.device_count()}")
    t0 = time.perf_counter()
    seconds = {src.stem: build.build(src.stem) for src in sorted(build.CSRC.glob("*.cu"))}
    print(f"[build] nvcc seconds per source: {seconds}; all: {time.perf_counter() - t0}")
    for src in seconds:
        print(f"[build] {src}: {build.build_log(src).strip()}")

    # -- phase 2: kernel against plain, bit for bit -----------------------
    mat, k_rows, len_rows, levels = main_message(device)
    check(tuple(mat.shape) == (2900, 128), f"main-path message shape {tuple(mat.shape)}")
    check(sorted(set(len_rows.tolist())) == [11, 64, 128], "main-path widths")
    main_cmp = compare_compress("main-path message", mat, k_rows, len_rows, levels, bw, flops)
    max_err = main_cmp["max_abs_err"]
    check_nan_rows(mat, k_rows, len_rows, levels)
    for k_frac in (0.1, 0.25):
        big = large_ragged(device, k_frac)
        for lv in (0, 16, 128):
            res = compare_compress(f"large ragged k={k_frac}", *big, lv, bw, flops)
            max_err = max(max_err, res["max_abs_err"])

    # -- phase 3: the main path -------------------------------------------
    args = parse_args(MAIN_ARGV + ["--device", "cuda", "--rounds", str(MAIN_ROUNDS)])
    reset_launch_counts()
    metrics, losses = run_ehealth(args)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    lam = args.p // args.q
    print(f"[main] launches={counts} steps/s={metrics['steps'] / metrics['wall_s']} "
          f"metrics={json.dumps(metrics)}")
    check(counts.get("fused_compress", 0) == MAIN_ROUNDS * lam,
          f"fused_compress launched {counts.get('fused_compress', 0)} times, "
          f"expected rounds x Λ = {MAIN_ROUNDS * lam}")
    check(all(math.isfinite(float(v)) for v in losses), "non-finite training loss")
    first, last = float(losses[:4].mean()), float(losses[-4:].mean())
    check(last < first, f"loss did not fall: first-4 mean {first}, last-4 mean {last}")
    check(metrics["steps"] == MAIN_ROUNDS * args.p, "step count")

    # -- phase 4: the card against the CPU ---------------------------------
    on_cpu, on_card = same_start_losses(torch.device("cpu"), device)
    rel = float(((on_card - on_cpu).abs() / on_cpu.abs()).max())
    print(f"[parity] cpu={on_cpu.tolist()} cuda={on_card.tolist()} max_rel_diff={rel}")
    check(torch.allclose(on_card, on_cpu, rtol=1e-3, atol=0.0),
          f"card and CPU losses differ beyond rtol 1e-3 (max rel {rel})")

    # -- phase 5: summary ----------------------------------------------------
    kernels = [{
        "name": "fused_compress",
        "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:78",
        "launches": counts["fused_compress"],
        "max_abs_err": max_err,
        "ms": main_cmp["ms"],
        "plain_ms": main_cmp["plain_ms"],
        "bound_ms": main_cmp["bound_ms"],
        "bound_by": main_cmp["bound_by"],
        "library_ms": None,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
