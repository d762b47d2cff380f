"""Profiled rounds and what the device did in them.

``profile(fn, sync)`` runs ``fn`` (whole rounds, ending in ``sync``) under
``torch.profiler`` and keeps, from its Chrome trace, every kernel, copy and
memset the device ran and, with ``host``, the host's activity. The trace
file is written to the temporary directory and deleted. Metrics find their
kernels by the names the program's sources give them.

A traced run profiles its rounds twice: the device's activity alone, which
every per-layer metric reads (tracing every host call would slow a
launch-bound host and so idle the device more), then host and device, for
what the host was doing in each idle gap of the ``breakdown``.

``busy_us`` is the length of the union of the device intervals (the
interval arithmetic of ``launch/profile_train.py``), over the traced
window: the host clock from the profiler's start to the synchronize.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def busy_us(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


def _read(path: str) -> Dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [{"cat": e["cat"], "name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"])}
              for e in events if e.get("cat") in DEVICE_CATS]
    host = [(float(e["ts"]), float(e["dur"]), e["name"]) for e in events
            if e.get("cat") in HOST_CATS]
    return {"device": device, "host": host}


def profile(fn: Callable[[], None], sync: Callable[[], None], host: bool = True) -> Dict:
    """Trace ``fn`` and ``sync`` after it; returns {device, host, window_us,
    busy_us}. ``host=False`` traces the device's activity alone, which costs
    the host far less than tracing its every call."""
    acts = []
    if host or not torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_us = (time.perf_counter() - t0) * 1e6
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out = _read(path)
    finally:
        os.unlink(path)
    out["window_us"] = window_us
    out["busy_us"] = busy_us([(d["ts"], d["dur"]) for d in out["device"]])
    return out


def gaps(device: List[Dict]) -> List[Tuple[float, float]]:
    """(start µs, length µs) of every stretch between device intervals."""
    out, end = [], None
    for ts, dur in sorted((d["ts"], d["dur"]) for d in device):
        if end is not None and ts > end:
            out.append((end, ts - end))
        end = ts + dur if end is None else max(end, ts + dur)
    return out


def breakdown(traced: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle time between
    them by what the host was doing when each gap began (the innermost host
    event open then), each summed by name, in seconds."""
    by_op = defaultdict(float)
    for d in traced["device"]:
        by_op[d["name"]] += d["dur"] / 1e6
    host = sorted(traced["host"])
    by_host = defaultdict(float)
    stack, j = [], 0  # open host events in start order: (end, name)
    for g0, glen in gaps(traced["device"]):
        # sweep: the latest-starting host event still open at g0 is the innermost
        while j < len(host) and host[j][0] <= g0:
            ts, dur, name = host[j]
            while stack and stack[-1][0] < ts:
                stack.pop()
            stack.append((ts + dur, name))
            j += 1
        while stack and stack[-1][0] < g0:
            stack.pop()
        by_host[stack[-1][1] if stack else "host: between traced calls"] += glen / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def kernels(traced: Dict, patterns) -> List[Dict]:
    """The kernels whose name holds one of ``patterns``."""
    return [d for d in traced["device"] if d["cat"] == "kernel"
            and any(p in d["name"] for p in patterns)]
