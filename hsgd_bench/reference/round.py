"""One C-HSGD round of the hybrid split (Algorithm 1 at pod scale), plain.

A round over G pods (each a hospital-device pair holding {θ0, θ1, θ2}):

  1. global aggregation, eq. (2): every leaf becomes the mean over the pods;
  2. Λ = P / Q exchange intervals. Each opens with the exchange: the towers'
     outputs ζ1 = h1(θ1, x1) and ζ2 = h2(θ2, x2) on the interval's batch and
     a snapshot of θ0, every leaf compressed row by row (top-k, b levels);
  3. then Q local steps on that batch, eqs. (5)–(7): the hospital's loss
     with its fresh ζ1 and the stale ζ2, differentiated in θ0 and θ1; the
     device's loss with the stale θ0 and ζ1, differentiated in θ2; then
     θ <- θ - η ∇ for all three at once.

The loss a step reports is the hospital's, averaged over the pods. Pods
are independent between aggregations, so they are run one after another.
``model`` is the cell's reference module (``reference/model.py`` states
its contract), which gives the towers and the loss.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List

import torch

from hsgd_bench.reference.compress import compress_leaf


def leaves(tree, prefix=()):
    """(path, leaf) of every leaf of a nested dict, in sorted key order."""
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (key,))
        else:
            yield prefix + (key,), v


def tree_map(fn, tree):
    return {k: (tree_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def global_aggregation(pods: List[Dict]) -> None:
    """Eq. (2) with equal weights, written into every pod's tensors."""
    with torch.no_grad():
        for items in zip(*(list(leaves(p)) for p in pods)):
            mean = items[0][1]
            for _, x in items[1:]:
                mean = mean + x
            mean = mean / float(len(pods))
            for _, x in items:
                x.copy_(mean)


def exchange(model: ModuleType, cfg: Dict, pod: Dict, batch: Dict, k_frac: float,
             levels: int) -> Dict:
    """The compressed message {θ0, ζ1, ζ2} of one pod."""
    with torch.no_grad():
        z1 = model.tower(cfg, pod["theta1"], batch["x1"])
        z2 = model.tower(cfg, pod["theta2"], batch["x2"])
        return {"theta0": tree_map(lambda x: compress_leaf(x, k_frac, levels), pod["theta0"]),
                "z1": compress_leaf(z1, k_frac, levels), "z2": compress_leaf(z2, k_frac, levels)}


def _grads(loss_fn, tree):
    flat = list(leaves(tree))
    xs = [x.detach().requires_grad_() for _, x in flat]
    rebuilt: Dict = {}
    for (path, _), x in zip(flat, xs):
        node = rebuilt
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    with torch.enable_grad():
        value = loss_fn(rebuilt)
        grads = torch.autograd.grad(value, xs)
    return value.detach(), [(path, g) for (path, _), g in zip(flat, grads)]


def local_step(model: ModuleType, cfg: Dict, pod: Dict, stale: Dict, batch: Dict,
               eta: float) -> torch.Tensor:
    """Eqs. (5)–(7) for one pod; returns the hospital's loss."""
    def hospital(t):
        return model.loss(cfg, t["theta0"], model.tower(cfg, t["theta1"], batch["x1"]),
                          stale["z2"], batch["y"])

    def device(t):
        return model.loss(cfg, stale["theta0"], stale["z1"],
                          model.tower(cfg, t["theta2"], batch["x2"]), batch["y"])

    value, g01 = _grads(hospital, {"theta0": pod["theta0"], "theta1": pod["theta1"]})
    _, g2 = _grads(device, {"theta2": pod["theta2"]})
    with torch.no_grad():
        for path, g in g01 + g2:
            node = pod
            for key in path[:-1]:
                node = node[key]
            node[path[-1]].sub_(eta * g)
    return value


def run_round(model: ModuleType, cfg: Dict, pods: List[Dict], batches: Dict, eta: float,
              P: int, Q: int, k_frac: float, levels: int) -> torch.Tensor:
    """One round on ``pods`` (updated in place); ``batches`` leaves lead with
    [Λ, G]. Returns the [P] pod-mean hospital losses."""
    global_aggregation(pods)
    losses = torch.zeros(len(pods), P, device=batches["y"].device)
    for g, pod in enumerate(pods):
        for i in range(P // Q):
            batch = {name: x[i, g] for name, x in batches.items()}
            stale = exchange(model, cfg, pod, batch, k_frac, levels)
            for q in range(Q):
                losses[g, i * Q + q] = local_step(model, cfg, pod, stale, batch, eta)
            del stale
    return losses.mean(dim=0)
