"""Device time of a call on the card, and the least time the card could take.

``device_ms`` is the yardstick that ``chip_smoke.py`` and
``launch/profile_compress.py`` time kernels, their plain versions and the
library calls with (``event_median_ms`` where a launch's host cost belongs
in the time). ``card_rates`` gives a card's data-sheet rates and
``compress_bound_ms`` the compress kernels' bound at them. The timers need
a CUDA device.
"""
from __future__ import annotations

import statistics

import torch


def device_ms(fn, inner: int = 20, reps: int = 21) -> float:
    """Median device time of one ``fn()`` in ms: ``inner`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events, so the
    host's launch overhead is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def event_median_ms(fn, n: int = 21) -> float:
    """Median of ``n`` launches of ``fn`` timed by CUDA events, each its own
    pair, after one warm-up call drained."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Data-sheet rates, dense, at the full power limit: (memory B/s, fp32 FLOP/s
# outside the tensor cores). Matched on the name nvidia-smi reports.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM
    ("H200", 4.8e12, 67e12),
)


def card_rates(name: str):
    """(memory B/s, fp32 FLOP/s) of the card named ``name``."""
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


def compress_bound_ms(mat, row_len, levels: int, bw: float, flops: float, dp: bool = False):
    """Least time for one fused compress: bytes (each row's valid prefix read
    once, and with DP as much again of noise; the whole matrix written once
    with its padding as 0; k and row_len read once) over the memory rate,
    against operations (per valid element: 1 max + 16 bisection compares +
    1 keep compare; with quantization 2 extrema + sub, div, round, mul, add;
    with DP the square and sum of the norm and the scale, noise product and
    add) over the fp32 rate. Returns (bound_ms, bound_by)."""
    rows, n = mat.shape
    valid = int(row_len.sum())
    nbytes = valid * 4 * (2 if dp else 1) + rows * n * 4 + 2 * rows * 4
    ops = valid * (18 + (7 if levels > 1 else 0) + (5 if dp else 0))
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
