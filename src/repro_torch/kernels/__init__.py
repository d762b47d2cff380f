"""Hand-written CUDA kernels of the port, with their PyTorch wrappers.

``launch_counts`` holds, per kernel wrapper, how many times it launched its
kernel on the card; a run can zero it with ``reset_launch_counts`` and read
it afterwards to show which kernels its path went through.
"""
from __future__ import annotations

from collections import Counter

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
