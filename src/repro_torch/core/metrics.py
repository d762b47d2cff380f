"""Evaluation metrics used by the paper: loss, accuracy, AUC of ROC,
precision, recall, F1 (macro, one-vs-rest for multi-class), and the
smoothed loss curve and steps-to-target of the adaptive benchmarks.

The forward runs on the device of the parameters; the statistics are the
reference's numpy code.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.models.split_model import HybridModel


def evaluate_global(model: HybridModel, params, x1, x2, y, batch: int = 512) -> Dict[str, float]:
    """Full-dataset metrics for a global model {theta0, theta1, theta2}.

    x1, x2, y: host (numpy) arrays, moved to the params' device batch by
    batch."""
    device = tree_leaves(params)[0].device
    n = len(y)
    scores = []
    with torch.no_grad():
        for i in range(0, n, batch):
            a = torch.as_tensor(np.asarray(x1[i: i + batch]), device=device)
            b = torch.as_tensor(np.asarray(x2[i: i + batch]), device=device)
            z1 = model.h1(params["theta1"], a)
            z2 = model.h2(params["theta2"], b)
            scores.append(model.predict(params["theta0"], z1, z2).cpu().numpy())
    logits = np.concatenate(scores)
    y = np.asarray(y)
    logp = logits - _logsumexp(logits)
    loss = float(-np.mean(logp[np.arange(n), y]))
    pred = np.argmax(logits, axis=-1)
    acc = float(np.mean(pred == y))
    out = {"loss": loss, "accuracy": acc}
    out.update(precision_recall_f1(y, pred, logits.shape[-1]))
    out["auc_roc"] = auc_roc_ovr(y, _softmax(logits))
    return out


def smoothed_losses(losses, window: int = 4) -> np.ndarray:
    """Trailing-mean smoothing of a per-step loss curve (window clamped to
    the prefix length at the start, so output[i] averages steps max(0, i-w+1)..i)."""
    losses = np.asarray(losses, np.float64)
    w = max(1, int(window))
    c = np.cumsum(np.concatenate([[0.0], losses]))
    idx = np.arange(1, len(losses) + 1)
    lo = np.maximum(idx - w, 0)
    return (c[idx] - c[lo]) / (idx - lo)


def steps_to_target(losses, target: float, window: int = 4):
    """First step index whose smoothed loss reaches ``target``; None if never."""
    sm = smoothed_losses(losses, window)
    hits = np.flatnonzero(sm <= target)
    return int(hits[0]) if len(hits) else None


def _logsumexp(x):
    m = np.max(x, axis=-1, keepdims=True)
    return m + np.log(np.sum(np.exp(x - m), axis=-1, keepdims=True))


def _softmax(x):
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def precision_recall_f1(y_true, y_pred, n_classes: int) -> Dict[str, float]:
    """Macro precision/recall/F1. Macro-F1 is the MEAN OF PER-CLASS F1 scores
    (f1_c = 2·tp/(2·tp + fp + fn), over classes present in y_true or y_pred)."""
    precs, recs, f1s = [], [], []
    for c in range(n_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        if tp + fp > 0:
            precs.append(tp / (tp + fp))
        if tp + fn > 0:
            recs.append(tp / (tp + fn))
        if tp + fp + fn > 0:
            f1s.append(2.0 * tp / (2.0 * tp + fp + fn))
    p = float(np.mean(precs)) if precs else 0.0
    r = float(np.mean(recs)) if recs else 0.0
    f1 = float(np.mean(f1s)) if f1s else 0.0
    return {"precision": p, "recall": r, "f1": f1}


def auc_roc_ovr(y_true, probs) -> float:
    """Macro one-vs-rest AUC via the rank-statistic (Mann-Whitney) identity."""
    aucs = []
    for c in range(probs.shape[-1]):
        pos = probs[y_true == c, c]
        neg = probs[y_true != c, c]
        if len(pos) == 0 or len(neg) == 0:
            continue
        ranks = _rankdata(np.concatenate([pos, neg]))
        r_pos = np.sum(ranks[: len(pos)])
        auc = (r_pos - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg))
        aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.5


def _rankdata(a):
    order = np.argsort(a, kind="mergesort")
    ranks = np.empty(len(a), float)
    sorted_a = a[order]
    # average ranks for ties
    i = 0
    rank = 1
    while i < len(a):
        j = i
        while j + 1 < len(a) and sorted_a[j + 1] == sorted_a[i]:
            j += 1
        avg = (rank + rank + (j - i)) / 2.0
        ranks[order[i : j + 1]] = avg
        rank += j - i + 1
        i = j + 1
    return ranks
