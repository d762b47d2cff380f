"""Device time of the Mamba-1 chunk body's discretization, a = exp(dt·A)
and b = (dt·x)·B and its gradient: the program's ``mamba1.discretize``
spans (around each chunk's forward in the layer's loop, and inside the
route's backward) summed, per local step, in the rounds the harness
profiles first, with the device's activity alone: the first
``ctx["rounds"]`` entries of the program's
``repro_torch.common.spans.rounds()``, each span timed by CUDA events while
the profiler traced. The local steps are those entries' rounds times the
steps a round (P). None where the program records no such span."""
LAYER = "model step: launch/steps.py hybrid_grads over models/ssm.py and models/transformer.py"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPAN = "mamba1.discretize"


def read(ctx):
    if not ctx["traced"]["device"]:
        return None
    try:
        from repro_torch.common import spans
    except ImportError:  # a program without spans
        return None
    entries = spans.rounds()[:ctx["rounds"]]
    row = spans.summed(entries).get(SPAN)
    if row is None or row["device_ms"] is None:
        return None
    return row["device_ms"] / (len(entries) * ctx["steps"] / ctx["rounds"])
