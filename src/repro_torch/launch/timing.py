"""Device time of a call on the card, with the host's launch cost left out.

``device_ms`` is the yardstick that ``chip_smoke.py`` and
``launch/profile_compress.py`` time kernels, their plain versions and the
library calls with. Needs a CUDA device.
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
