"""Share of the scan kernels' bound (csrc/ssm_scan.cu, forward and
backward): the bytes every scan of the profiled rounds must read and write
over the real tokens, at the card's memory rate, over the device time of
the kernels that source names."""
from hsgd_bench.trace import kernels

LAYER = "kernel: csrc/ssm_scan.cu"
UNIT = "%"
MOVES = "train_samples_per_s"
PATTERNS = ("ssm_scan_kernel", "ssm_scan_bwd_kernel")


def read(ctx):
    found = kernels(ctx["traced"], PATTERNS)
    if not found or ctx["peaks"] is None:
        return None
    least_s = ctx["round_scan_bytes"] * ctx["rounds"] / ctx["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / (sum(d["dur"] for d in found) / 1e6)
