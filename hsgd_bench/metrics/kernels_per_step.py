"""Kernels the device ran in the profiled rounds, per local step."""
LAYER = "round loop: launch/steps.py LLMRoundRunner"
UNIT = "count"
MOVES = "train_samples_per_s"


def read(ctx):
    n = sum(1 for d in ctx["traced"]["device"] if d["cat"] == "kernel")
    return n / ctx["steps"] if n else None
