"""Share of the compress kernels' bound: every element of each exchange's
message {θ0 of every pod, ζ1, ζ2} read once and written once at the card's
memory rate, over the device time of the kernels csrc/compress.cu names."""
from hsgd_bench.trace import kernels

LAYER = "kernel: csrc/compress.cu"
UNIT = "%"
MOVES = "train_samples_per_s"
PATTERNS = ("compress_rows_kernel", "compress_rows_dp_kernel", "compress_group_kernel")


def read(ctx):
    found = kernels(ctx["traced"], PATTERNS)
    if not found or ctx["peaks"] is None:
        return None
    least_s = ctx["exchange_bytes"] * ctx["exchanges"] / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / (sum(d["dur"] for d in found) / 1e6)
