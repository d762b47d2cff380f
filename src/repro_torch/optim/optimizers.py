"""Optimizers. The paper's algorithm is plain SGD (HSGD = hybrid SGD) with a
learning rate halved every T0 iterations (§VII-A3)."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np


def halving_schedule(base_lr: float, halve_every: int) -> Callable[[int], float]:
    """Paper §VII-A3: initial η decays halved per T0 iterations.

    Returns step -> η, rounded to fp32 as the reference's schedule is."""

    def lr(step: int) -> float:
        if halve_every <= 0:
            return float(np.float32(base_lr))
        return float(np.float32(base_lr) * np.float32(0.5) ** np.float32(math.floor(step / halve_every)))

    return lr
