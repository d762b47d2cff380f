"""The linear recurrence h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, in plain PyTorch.

A loop over t of one multiply and one add, each rounded on its own, with
the textbook adjoint as its backward:

  g_{T-1} = dhs_{T-1},   g_t = dhs_t + a_{t+1} * g_{t+1},
  da_t = g_t * h_{t-1} (summed over the dims ``a`` broadcasts),   db_t = g_t.

``a`` may broadcast against ``b`` (Mamba-2's decay is one scalar a head), so
the decay is never materialised at the state's size. Only ``a`` and the
states are kept for the backward.
"""
from __future__ import annotations

import torch


class Recurrence(torch.autograd.Function):
    """hs [B, T, ...] from a (broadcastable to b) and b [B, T, ...]."""

    @staticmethod
    def forward(ctx, a, b):
        h, hs = torch.zeros_like(b[:, 0]), []
        for a_t, b_t in zip(a.unbind(1), b.unbind(1)):
            h = a_t * h + b_t
            hs.append(h)
        hs = torch.stack(hs, 1)
        ctx.save_for_backward(a, hs)
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        a, hs = ctx.saved_tensors
        a_ts, h_ts, d_ts = a.unbind(1), hs.unbind(1), d_hs.unbind(1)
        summed = tuple(i for i, (n, m) in enumerate(zip(hs[:, 0].shape, a[:, 0].shape))
                       if m == 1 and n != 1)
        carry = torch.zeros_like(h_ts[0])
        da, db = [None] * len(h_ts), [None] * len(h_ts)
        for t in range(len(h_ts) - 1, -1, -1):
            g = d_ts[t] + carry
            db[t] = g
            if t:
                prod = g * h_ts[t - 1]
                da[t] = prod.sum(dim=summed, keepdim=True) if summed else prod
            carry = a_ts[t] * g
        da[0] = torch.zeros_like(a_ts[0])
        return torch.stack(da, 1), torch.stack(db, 1)


def recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return Recurrence.apply(a, b)
