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
  * ``change_gap_median``: the change after the last of those rounds, each
    leaf's gap as above, the median over every (pod, leaf).

Every leaf counts: under plain SGD a leaf the reference moves little moves
by η times its gradient, not by round-off, and the median in the
denominator keeps its gap to the scale of the step.

The change after the last round is taken at the median leaf, not the worst:
from the second round on, both sides compress a θ0 that differs by
rounding, and an entry that lies on a top-k threshold or a quantization
level is sent as a different value by each. One such entry can move a small
leaf by far more than rounding does: falcon-mamba-7b-16L at seed 1437289552
reads 3.0e-4 at the device tower's conv bias, and 1.8e-6 with the exchange
uncompressed; at seed 1650694476 top-k alone reads 5.9e-4 there and top-k
with quantization 5.4e-6. The median leaf reads 9.1e-7 at the first seed
and under 1e-8 at fourteen others. The worst leaf's gap of that change,
``change_gap_worst``, is still computed and printed, and not compared.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NUMBERS = ("loss_gap", "update_gap", "change_gap_median")


def loss_gap(prog: List[List[float]], ref: List[List[float]], steps: int) -> float:
    """Over the first round's first ``steps`` steps; a non-finite loss anywhere fails."""
    if len(prog) != len(ref) or not all(math.isfinite(x) for r in prog for x in r):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog[0][:steps], ref[0][:steps]))


def leaf_gaps(prog: Dict, ref: Dict) -> List[float]:
    """Each leaf's gap of two {leaf: ‖Δ‖} maps; a leaf missing or not finite reads inf."""
    med = statistics.median(ref.values())
    gaps = []
    for key, r in ref.items():
        p = prog.get(key, math.nan)
        gaps.append(abs(p - r) / max(r, med) if math.isfinite(p) else math.inf)
    return gaps


def leaf_gap(prog: Dict, ref: Dict) -> float:
    """The worst leaf's gap of two {leaf: ‖Δ‖} maps."""
    return max(leaf_gaps(prog, ref))


def numbers(prog_losses, ref_losses, prog_norms, ref_norms, steps: int) -> Dict[str, float]:
    """The compared numbers, the loss over the first ``steps`` steps, and
    ``change_gap_worst``, which is printed and not compared."""
    first, last = min(ref_norms), max(ref_norms)
    change = leaf_gaps(prog_norms[last], ref_norms[last])
    median = statistics.median(change) if all(map(math.isfinite, change)) else math.inf
    return {"loss_gap": loss_gap(prog_losses, ref_losses, steps),
            "update_gap": leaf_gap(prog_norms[first], ref_norms[first]),
            "change_gap_median": median,
            "change_gap_worst": max(change)}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    checks = {name: {"value": values[name], "limit": limits[name]} for name in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
