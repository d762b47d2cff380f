"""The paper's LSTM model for MIMIC-III / ESR: hospital & device LSTM towers
over their vertical feature slices; final hidden states are the intermediate
results ζ consumed by the combined classifier.

The cell keeps the reference's layout (separate ``wx``/``wh``, one bias,
gates stacked i, f, g, o, forget gate ``sigmoid(f + 1.0)``), which is not
``nn.LSTM``'s.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L


def lstm_specs(d_in: int, d_hidden: int) -> Dict[str, L.Spec]:
    # gates: i, f, g, o stacked
    return {
        "wx": L.Spec((d_in, 4 * d_hidden), (None, None)),
        "wh": L.Spec((d_hidden, 4 * d_hidden), (None, None)),
        "b": L.Spec((4 * d_hidden,), (None,), "zeros"),
    }


def lstm_forward(params, x):
    """x: [B, T, F] -> last hidden state [B, H]."""
    B, T = x.shape[:2]
    wh = params["wh"].to(x.dtype)
    H = wh.shape[0]
    # einsum, as the reference writes it: a size-1 feature axis (ESR's
    # [B, T, 1] slices against a [T, 4H] wx) broadcasts over wx's rows
    xg = torch.einsum("btf,fk->btk", x, params["wx"].to(x.dtype)) + params["b"].to(x.dtype)
    h = c = x.new_zeros((B, H))
    for t in range(T):
        gates = xg[:, t] + torch.matmul(h, wh)
        i, f, g, o = torch.split(gates, H, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h


def tower_specs(d_in: int, d_hidden: int = 64, embed_dim: int = 64) -> Dict:
    return {
        "lstm": lstm_specs(d_in, d_hidden),
        "proj": L.dense_specs(d_hidden, embed_dim, (None, None)),
    }


def tower_forward(params, x):
    """x: [B, T, F_slice] -> ζ [B, embed]."""
    h = lstm_forward(params["lstm"], x)
    return L.dense(params["proj"], h)
