"""One run of one training cell: set-up, the measured window, the traced
rounds, and the check against the plain reference.

Set-up builds the program's C-HSGD round executor
(``LLMRoundRunner(llm_hybrid(cfg, n_tower, remat=False), n_pods=G).round_fn(
P, Q, k, b, collect_stats=False)``), draws the weights and every batch of
the run from the seed on the device, and drives the executor through the
traffic's ``check_rounds`` rounds: the rounds the reference follows, and
the warm-up of every shape the window runs. The window then runs whole
rounds on the drawn batches until ``seconds`` have passed, each ending in a
synchronize. With ``trace``, ``trace_rounds`` more rounds run under the
profiler after the window. The program's state is then freed and the
reference follows the check rounds from the same weights and batches.
"""
from __future__ import annotations

import concurrent.futures
import gc
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from hsgd_bench import check, counts, tokens, trace
from hsgd_bench import weights as W
from hsgd_bench.reference import round as RR

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# data-sheet peaks of the H100 SXM (80GB HBM3), dense, at its full power
# limit: fp32 outside the tensor cores and HBM bandwidth
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}}


def peaks(device_name: str):
    return PEAKS.get(device_name)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_kernels() -> float:
    """Build every CUDA source of the program (a no-op once built)."""
    from repro_torch.kernels.build import CSRC, build
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build, names))
    return time.perf_counter() - t0


def _layout_matches(layout, specs) -> None:
    """The benchmark's layout has the program's leaves, shape for shape."""
    ours = {path: spec[0] for path, spec in W.leaves(layout)}
    theirs = {path: tuple(spec.shape) for path, spec in W.leaves(specs)}
    if ours != theirs:
        diff = sorted(set(ours.items()) ^ set(theirs.items()))
        raise RuntimeError(f"the program's parameters differ from the benchmark's layout: {diff}")


class Program:
    """The program under test, built as the cell's configuration states."""

    def __init__(self, cell: Dict, seed: int, dev):
        from repro_torch.common.config import ModelConfig
        from repro_torch.launch.steps import LLMRoundRunner
        from repro_torch.models.split_model import llm_hybrid
        cfg, tr = cell["config"], cell["traffic"]
        self.layout = cell["reference"].param_layout(cfg["model"], cfg["n_tower"])
        fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}
        model = llm_hybrid(ModelConfig(**fields), n_tower=cfg["n_tower"], remat=False)
        _layout_matches(self.layout, model.specs())
        self.fn = LLMRoundRunner(model, n_pods=tr["pods"]).round_fn(
            tr["P"], tr["Q"], tr["k"], tr["b"], collect_stats=False)
        self.params = W.draw(self.layout, seed, tr["pods"], dev)
        self.lr, self.seed = tr["lr"], seed

    def round(self, batch):
        self.params, losses = self.fn(self.params, batch, self.lr)
        return losses

    def check_rounds(self, batches):
        """([each round's step losses], {round: {(pod, leaf): ‖Δ‖}}) of the first rounds."""
        losses, norms = [], {}
        for r, batch in enumerate(batches, 1):
            losses.append(self.round(batch).float().cpu().tolist())
            if r in (1, len(batches)):
                norms[r] = W.change_norms(self.params, self.layout, self.seed)
        return losses, norms


def reference_rounds(cell: Dict, seed: int, batches, dev, tf32: bool = False, fault=None):
    """The reference's (losses, norms) over ``batches``, from the seed's
    weights; ``tf32`` computes its fp32 products in TF32 (the control);
    ``fault(pods, batch) -> batch`` plants a fault before each round."""
    cfg, tr, model = cell["config"], cell["traffic"], cell["reference"]
    layout = model.param_layout(cfg["model"], cfg["n_tower"])
    params = W.draw(layout, seed, tr["pods"], dev)
    pods = [RR.tree_map(lambda x, g=g: x[g], params) for g in range(tr["pods"])]
    eta = float(np.float32(tr["lr"]))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        losses, norms = [], {}
        for r, batch in enumerate(batches, 1):
            if fault is not None:
                batch = fault(pods, batch)
            out = RR.run_round(model, cfg["model"], pods, batch, eta, tr["P"], tr["Q"], tr["k"],
                               tr["b"])
            losses.append(out.float().cpu().tolist())
            if r in (1, len(batches)):
                norms[r] = W.change_norms(params, layout, seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return losses, norms


def _window(prog: Program, pool, seconds: float, dev, log):
    n, t0, ends = 0, time.perf_counter(), []
    while True:
        prog.round(pool[n % len(pool)])
        _sync(dev)
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            log(f"window: {n} rounds, each ending at (s) {ends}")
            return n, ends[-1]


def _traced(cell: Dict, prog: Program, pool, window_rounds: int, window_s: float, card, dev,
            log):
    """(per-layer metrics, breakdown, {busy_s, window_s}) of ``trace_rounds``
    rounds profiled after the window: once with the device's activity alone,
    which the metrics read, once with the host's too, for the breakdown's
    idle attribution."""
    cfg, tr, model = cell["config"], cell["traffic"], cell["reference"]
    n = tr["trace_rounds"]
    rounds_fn = lambda: [prog.round(pool[i % len(pool)]) for i in range(n)]
    traced = trace.profile(rounds_fn, lambda: _sync(dev), host=False)
    with_host = trace.profile(rounds_fn, lambda: _sync(dev))
    if not traced["device"]:
        log("the device-only trace holds no device activity: reading the full trace")
        traced = with_host
    for m in cell["per_layer"]:
        patterns = getattr(m["module"], "PATTERNS", ())
        if patterns:
            names = sorted({d["name"][:80] for d in trace.kernels(traced, patterns)})
            log(f"kernels {m['name']} reads: {names}")
    log(f"traced rounds: device alone {traced['window_us'] / 1e6} s, with the host "
        f"{with_host['window_us'] / 1e6} s")
    ctx = {"traced": traced, "rounds": n, "steps": n * tr["P"],
           "exchanges": n * (tr["P"] // tr["Q"]), "window_rounds": window_rounds,
           "window_s": window_s, "peaks": card,
           "round_flops": counts.round_flops(model, cfg["model"], tr, cfg["n_tower"]),
           "exchange_bytes": counts.exchange_bytes(cfg["model"], tr, prog.layout),
           "round_scan_bytes": counts.round_scan_bytes(model, cfg["model"], tr, cfg["n_tower"])}
    metrics = {}
    for m in cell["per_layer"]:
        value = m["module"].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = {"busy_s": traced["busy_us"] / 1e6, "window_s": traced["window_us"] / 1e6}
    return metrics, trace.breakdown(with_host), busy


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run(cell: Dict, seed: int, seconds: float, trace_on: bool, dev, t_start: float,
        log=print) -> Dict:
    """One run; returns the result line's object. ``t_start`` is the
    process's start on the host clock (``time.perf_counter``)."""
    from repro_torch.common.backend import resolve_device
    cfg, tr = cell["config"], cell["traffic"]
    resolve_device(dev.type)  # the program's own device set-up: TF32 off
    parts = {"import_s": time.perf_counter() - t_start}
    if dev.type == "cuda":
        torch.cuda.init()
        parts["compile_s"] = _build_kernels()
    t = time.perf_counter()
    prog = Program(cell, seed, dev)
    R = tr["check_rounds"]
    batches = tokens.rounds(tr, cfg["model"]["vocab_size"], seed, R + tr["pool_rounds"], dev)
    check_batches, pool = batches[:R], batches[R:]
    _sync(dev)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog_losses, prog_norms = prog.check_rounds(check_batches)
    _sync(dev)
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    rounds, window_s = _window(prog, pool, seconds, dev, log)
    samples = rounds * tr["P"] * tr["pods"] * tr["batch"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name, "count": 1,
              "memory_peak_bytes": peak}
    values = {"train_samples_per_s": samples / window_s, "peak_device_gib": peak / 2 ** 30,
              "setup_s": setup_s}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell["end_to_end"]}
    breakdown = None
    if trace_on:
        metrics, breakdown, busy = _traced(cell, prog, pool, rounds, window_s, peaks(name), dev,
                                           log)
        device.update(busy)
    del prog, batches, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_losses, ref_norms = reference_rounds(cell, seed, check_batches, dev)
    values = check.numbers(prog_losses, ref_losses, prog_norms, ref_norms, tr["Q"])
    ok, checks = check.verdict(values, cell["limits"])
    log(f"reference: {time.perf_counter() - t:.3f} s")
    log(f"not compared: {({k: v for k, v in values.items() if k not in checks})}")
    log(f"losses program {prog_losses}\nlosses reference {ref_losses}")
    log(f"set-up parts (s): {parts}")
    for c in checks.values():
        c["value"] = _finite(c["value"])
    result = {"correct": ok, "attempted": samples, "failed": 0, "metrics": metrics,
              "device": device, "setup_parts": parts}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
