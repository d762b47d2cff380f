"""Device time of the exchange, the program's ``hsgd.exchange`` span (both
towers' forwards, the message stacked into rows, compressed and sliced
back), per exchange, in the rounds the harness profiles first, with the
device's activity alone: the first ``ctx["rounds"]`` entries of the
program's ``repro_torch.common.spans.rounds()``, each span timed by CUDA
events while the profiler traced. The exchanges are the span's count in
those entries. None where the program records no such span."""
LAYER = "exchange: launch/steps.py make_exchange_step, kernels/compress.py compress_pytree"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPAN = "hsgd.exchange"


def read(ctx):
    if not ctx["traced"]["device"]:
        return None
    try:
        from repro_torch.common import spans
    except ImportError:  # a program without spans
        return None
    row = spans.summed(spans.rounds()[:ctx["rounds"]]).get(SPAN)
    if row is None or row["device_ms"] is None:
        return None
    return row["device_ms"] / row["count"]
