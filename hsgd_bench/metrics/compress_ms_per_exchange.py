"""Device time of the compress kernels (csrc/compress.cu, found by the names
that source gives them) per exchange, in the profiled rounds; exchanges
from the traffic's cadence (P / Q a round)."""
from hsgd_bench.trace import kernels

LAYER = "exchange: launch/steps.py make_exchange_step, kernels/compress.py compress_pytree"
UNIT = "ms"
MOVES = "train_samples_per_s"
PATTERNS = ("compress_rows_kernel", "compress_rows_dp_kernel", "compress_group_kernel")


def read(ctx):
    found = kernels(ctx["traced"], PATTERNS)
    return sum(d["dur"] for d in found) / 1e3 / ctx["exchanges"] if found else None
