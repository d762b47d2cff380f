"""The numbers that decide ``correct``: the program's first rounds against
the plain reference's, from the same weights and batches.

A run's set-up drives the program through its first rounds with the
window's own executor and feed; the reference follows the same rounds.
Compared, each against its limit (``limits/<cell>.json``):

  * ``loss_gap``: the largest |L - L_ref| / |L_ref| over the first exchange
    interval's Q local steps' losses (the hospital's, averaged over the
    pods). Later steps' losses amplify rounding where one step moves the
    loss far (zamba2-2.7b at 64 tokens: an interval's second step starts
    near 0.5 from about 10.8, and the gap grows about tenfold a step after
    it); the changes below cover those steps;
  * ``update_gap``: the first round's change of every leaf of every pod
    (θ after it minus θ before: η times the gradients the round applied),
    by the worst leaf: | ‖Δ‖ - ‖Δ_ref‖ | / max(‖Δ_ref‖, median leaf's ‖Δ_ref‖);
  * ``change_gap``: the same for the change after the last of those rounds.

Every leaf counts: under plain SGD a leaf the reference moves little moves
by η times its gradient, not by round-off, and the median in the
denominator keeps its gap to the scale of the step.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NUMBERS = ("loss_gap", "update_gap", "change_gap")


def loss_gap(prog: List[List[float]], ref: List[List[float]], steps: int) -> float:
    """Over the first round's first ``steps`` steps; a non-finite loss anywhere fails."""
    if len(prog) != len(ref) or not all(math.isfinite(x) for r in prog for x in r):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog[0][:steps], ref[0][:steps]))


def leaf_gap(prog: Dict, ref: Dict) -> float:
    """The worst leaf's gap of two {leaf: ‖Δ‖} maps."""
    med = statistics.median(ref.values())
    worst = 0.0
    for key, r in ref.items():
        p = prog.get(key, math.nan)
        gap = abs(p - r) / max(r, med) if math.isfinite(p) else math.inf
        worst = max(worst, gap)
    return worst


def numbers(prog_losses, ref_losses, prog_norms, ref_norms, steps: int) -> Dict[str, float]:
    """The compared numbers, the loss over the first ``steps`` steps."""
    first, last = min(ref_norms), max(ref_norms)
    return {"loss_gap": loss_gap(prog_losses, ref_losses, steps),
            "update_gap": leaf_gap(prog_norms[first], ref_norms[first]),
            "change_gap": leaf_gap(prog_norms[last], ref_norms[last])}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    checks = {name: {"value": values[name], "limit": limits[name]} for name in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
