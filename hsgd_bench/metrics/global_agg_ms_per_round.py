"""Device time of the global aggregation, the program's ``hsgd.global_agg``
span (eq. (2) across the pods), per round, in the rounds the harness
profiles first, with the device's activity alone: the first
``ctx["rounds"]`` entries of the program's
``repro_torch.common.spans.rounds()``, each span timed by CUDA events while
the profiler traced. The rounds are those entries. None where the program
records no such span."""
LAYER = "round loop: launch/steps.py LLMRoundRunner"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPAN = "hsgd.global_agg"


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
    return row["device_ms"] / len(entries)
