"""The token stream of a training traffic mix, drawn from the seed on the device.

The drift stream of the LLM-scale hybrid runs (the copy of
``data/synthetic.py::token_stream``, drawn with torch instead of numpy):
each input token is uniform over the vocabulary, and the target is the next
input token, or with probability ``p_drift`` the current one shifted by a
uniform offset below ``drift``, so a model can learn something. A round
takes one batch per exchange interval and pod: leaves [Λ, G, B, ...], the
hospital's tower reading the first half of every sequence and the device's
the second.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from hsgd_bench.weights import unit_seed

TOKEN_STREAM = 1


def rounds(traffic: Dict, vocab: int, seed: int, n_rounds: int, device) -> List[Dict]:
    """``n_rounds`` rounds of batches {x1, x2, y} (int32), drawn in three calls."""
    lam, G, B, S = traffic["P"] // traffic["Q"], traffic["pods"], traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device).manual_seed(unit_seed(seed, 0, TOKEN_STREAM))
    lead = (n_rounds, lam, G, B)
    base = torch.randint(0, vocab, lead + (S + 1,), generator=gen, device=device)
    shift = torch.randint(0, traffic["drift"], lead + (S,), generator=gen, device=device)
    drifts = torch.rand(lead + (S,), generator=gen, device=device) < traffic["p_drift"]
    inp = base[..., :-1]
    tgt = torch.where(drifts, (inp + shift) % vocab, base[..., 1:])
    s1 = S // 2
    out = {"x1": inp[..., :s1], "x2": inp[..., s1:], "y": tgt}
    out = {k: v.to(torch.int32).contiguous() for k, v in out.items()}
    return [{k: v[r] for k, v in out.items()} for r in range(n_rounds)]
