"""The readings a cell's correctness limits are set from, in one process.

  python3 hsgd_bench/readings.py --workload <cell> --seeds 1 2 ... [--control-seeds 3]

For each seed: the program's check rounds against the reference's (the
lower readings); for the first ``--control-seeds`` seeds also the control,
the reference computed with TF32 products where the configuration states
fp32 with TF32 off, and each fault a training cell can have, planted in the
reference put in the program's place (the upper readings):

  * ``half_batch``: every local step's loss and gradients over half the
    batch, the mean taken over the rest;
  * ``uncompressed``: the exchange sends its message without compression;
  * ``stale_message``: the second exchange of a round is left out, the
    first interval's message reused;
  * ``token``: one token of the first round's feed altered.

A state left unchanged reads 1 by the update and change gaps and needs no
run. One JSON line a seed on standard output, with the leaves the
reference moves least in the first round. Needs a CUDA device.
"""
import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from hsgd_bench import check, harness, spec, tokens  # noqa: E402
from hsgd_bench.reference import round as RR  # noqa: E402


def fault_runs(cell, seed, batches, dev):
    """{fault: (losses, norms)} of the reference with each fault planted."""
    out, tr = {}, cell["traffic"]
    step = RR.local_step

    def half_step(model, cfg, pod, stale, batch, eta):
        h = batch["y"].shape[0] // 2
        stale = {"theta0": stale["theta0"], "z1": stale["z1"][:h], "z2": stale["z2"][:h]}
        return step(model, cfg, pod, stale, {k: v[:h] for k, v in batch.items()}, eta)

    with mock.patch.object(RR, "local_step", half_step):
        out["half_batch"] = harness.reference_rounds(cell, seed, batches, dev)
    with mock.patch.object(RR, "compress_leaf", lambda x, k, b: x.clone()):
        out["uncompressed"] = harness.reference_rounds(cell, seed, batches, dev)
    exch, lam, last = RR.exchange, tr["P"] // tr["Q"], {"calls": 0}

    def first_only(model, cfg, pod, batch, k, b):
        # a round calls the exchange Λ times a pod in turn: keep the first
        if last["calls"] % lam == 0:
            last["msg"] = exch(model, cfg, pod, batch, k, b)
        last["calls"] += 1
        return last["msg"]

    with mock.patch.object(RR, "exchange", first_only):
        out["stale_message"] = harness.reference_rounds(cell, seed, batches, dev)
    last.clear()
    altered = [dict(b) for b in batches]
    x1 = altered[0]["x1"].clone()
    x1[0, 0, 0, 0] = (x1[0, 0, 0, 0] + 1) % cell["config"]["model"]["vocab_size"]
    altered[0]["x1"] = x1
    out["token"] = harness.reference_rounds(cell, seed, altered, dev)
    return out


def smallest_leaves(prog_norms, ref_norms, n: int = 8):
    """The ``n`` leaves the reference moves least in the first round:
    [pod, leaf, ‖Δ_ref‖ / median leaf's, that leaf's gap as ``update_gap``
    reads it]."""
    first = min(ref_norms)
    ref, prog = ref_norms[first], prog_norms[first]
    med = statistics.median(ref.values())
    rows = sorted(ref.items(), key=lambda kv: kv[1])[:n]
    return [[pod, "/".join(path), r / med, abs(prog[(pod, path)] - r) / max(r, med)]
            for (pod, path), r in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, spec.benchmark(ROOT), ROOT)
    dev = torch.device("cuda", 0)
    from repro_torch.common.backend import resolve_device
    resolve_device("cuda")
    tr = cell["traffic"]
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        prog = harness.Program(cell, seed, dev)
        # drawn as a run draws them, check rounds and pool together
        batches = tokens.rounds(tr, cell["config"]["model"]["vocab_size"], seed,
                                tr["check_rounds"] + tr["pool_rounds"], dev)[:tr["check_rounds"]]
        p = prog.check_rounds(batches)
        t_prog = time.perf_counter() - t0
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = harness.reference_rounds(cell, seed, batches, dev)
        line = {"seed": seed, "program": check.numbers(p[0], ref[0], p[1], ref[1], tr["Q"]),
                "program_s": t_prog, "reference_s": time.perf_counter() - t0,
                "losses": {"program": p[0], "reference": ref[0]},
                "smallest_leaves": smallest_leaves(p[1], ref[1])}
        if i < args.control_seeds:
            ctl = harness.reference_rounds(cell, seed, batches, dev, tf32=True)
            line["control_tf32"] = check.numbers(ctl[0], ref[0], ctl[1], ref[1], tr["Q"])
            line["losses"]["control_tf32"] = ctl[0]
            for name, got in fault_runs(cell, seed, batches, dev).items():
                line[name] = check.numbers(got[0], ref[0], got[1], ref[1], tr["Q"])
                line["losses"][name] = got[0]
        line["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(line), flush=True)
        del batches, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
