"""The whole step's share of the card's fp32 peak: the model FLOPs of the
window's rounds (``counts.round_flops``: every product eqs. (5)-(7) and the
exchange need, once) over the untraced window's time and the data-sheet
fp32 rate (TF32 is off)."""
LAYER = "model step: launch/steps.py hybrid_grads over models/ssm.py and models/transformer.py"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx["peaks"] is None:
        return None
    rate = ctx["round_flops"] * ctx["window_rounds"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["fp32_flops"]
