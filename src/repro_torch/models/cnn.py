"""The paper's CNN model (Fig. 10): hospital-side + device-side conv towers
(no FC) whose outputs (intermediate results ζ) feed a combined model.

Layouts follow the reference: activations are NHWC and conv weights HWIO,
so parameter trees move between the two packages without a permutation.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def conv_specs(k: int, c_in: int, c_out: int, name_scale=None) -> Dict[str, L.Spec]:
    return {
        "w": L.Spec((k, k, c_in, c_out), (None, None, None, None), "normal", name_scale),
        "b": L.Spec((c_out,), (None,), "zeros"),
    }


def conv2d(params, x, stride: int = 1):
    """SAME conv as im2col + GEMM: pad, k·k shifted slices concatenated on
    the channel axis, one matmul. x: [B, H, W, C] NHWC, w: [k, k, C, O]
    HWIO. The formulation batches cleanly under ``torch.func.vmap`` over
    groups and devices. Only the stride-1 odd-k case the paper models use is
    supported (the reference sends the others to ``lax.conv``)."""
    w = params["w"].to(x.dtype)
    k, _, c_in, c_out = w.shape
    if stride != 1 or k % 2 == 0:
        raise ValueError(f"conv2d supports stride 1 and odd kernels, got stride={stride} k={k}")
    B, H, W, _ = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    patches = torch.cat(
        [xp[:, i:i + H, j:j + W, :] for i in range(k) for j in range(k)], dim=-1)
    y = torch.matmul(patches, w.reshape(k * k * c_in, c_out))
    return y + params["b"].to(x.dtype)


def max_pool_2x2(x):
    """2x2/2 VALID max pool as crop + reshape + max (NHWC)."""
    b, h, w, c = x.shape
    return x[:, : h // 2 * 2, : w // 2 * 2, :].reshape(
        b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def tower_specs(in_rows: int, width: int = 28, channels: Tuple[int, ...] = (16, 32), embed_dim: int = 64):
    s: Dict = {}
    c_prev = 1
    for i, c in enumerate(channels):
        s[f"conv{i}"] = conv_specs(3, c_prev, c)
        c_prev = c
    rows, cols = in_rows, width
    for _ in channels:
        rows, cols = max(1, rows // 2), max(1, cols // 2)
    s["proj"] = L.dense_specs(rows * cols * c_prev, embed_dim, (None, None))
    return s


def tower_forward(params, x_flat, in_rows: int, width: int = 28, n_conv: int = 2):
    """x_flat: [B, in_rows*width] pixel slice -> ζ [B, embed].

    The flatten before ``proj`` is in (H, W, C) order, as the reference's."""
    B = x_flat.shape[0]
    x = x_flat.reshape(B, in_rows, width, 1)
    for i in range(n_conv):
        x = torch.relu(conv2d(params[f"conv{i}"], x))
        x = max_pool_2x2(x)
    x = x.reshape(B, -1)
    return L.dense(params["proj"], x)


def combined_specs(embed_dim: int, n_classes: int, hidden: int = 128):
    return {
        "fc1": L.dense_specs(2 * embed_dim, hidden, (None, None)),
        "fc1_b": L.Spec((hidden,), (None,), "zeros"),
        "fc2": L.dense_specs(hidden, n_classes, (None, None)),
        "fc2_b": L.Spec((n_classes,), (None,), "zeros"),
    }


def combined_forward(params, z1, z2):
    x = torch.cat([z1, z2], dim=-1)
    x = torch.relu(L.dense(params["fc1"], x) + params["fc1_b"].to(x.dtype))
    return L.dense(params["fc2"], x) + params["fc2_b"].to(x.dtype)


def classification_loss(logits, labels):
    """Mean cross-entropy, computed in fp32 whatever the logits' dtype.

    As the reference's ``jnp.take_along_axis``, a negative label counts from
    the end and one outside [-C, C) reads NaN (a label gathered from past a
    group's data holds ``federation.gather_batch``'s fill value)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    C = logp.shape[-1]
    lab = labels.long()[:, None]
    lab = torch.where(lab < 0, lab + C, lab)
    ll = torch.gather(logp, -1, lab.clamp(0, C - 1))
    return -torch.mean(torch.where((lab >= 0) & (lab < C), ll, float("nan"))[:, 0])
