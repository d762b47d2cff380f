"""Fused top-k sparsify + b-level quantize (C-HSGD §VII-A1) on the card.

``fused_compress`` launches the hand-written CUDA kernels in
``csrc/compress.cu``: without DP the port of the TPU kernel
``repro/kernels/compress.py::_fused_compress_call`` (``_compress_kernel``),
counted under ``launch_counts["fused_compress"]``; with DP (``dp_noise``
given) the port of ``_fused_compress_dp_call`` (``_compress_dp_kernel``),
which clips each row and adds Gaussian noise first, counted under
``launch_counts["fused_compress_dp"]``. One read and one write per message
row; both kernels are bit-identical to the plain version
``core/compression.py::compress_rows_ref``.

``compress_rows`` routes by the tensor's device alone: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel. There is no switch and no
fallback: what the kernel does not take raises.

``compress_pytree`` groups the rows of a message tree by the kernel body
they need (``row_groups``): every row of at most ``NARROW_WIDTH`` floats in
one matrix, padded to the widest of them, with a per-row valid length;
each wider width in a matrix of its own, unpadded. Each group is one
launch: a paper model's whole exchange message (θ0 + ζ1 + ζ2, rows of at
most 128 floats) is one, an LLM's message one per width past
``NARROW_WIDTH``. Where padding the narrow rows to the widest of them
would add more than ``NARROW_PAD_BYTES`` and more floats than they hold
(whisper-medium's 64-wide attention rows beside its 1024-wide ones: 14 GB
a pod for 2.4 GB of values), each narrow width gets a matrix of its own
too, so no matrix is much larger than the message. The DP
noise rows are drawn on the device from the caller's generator, group by
group, or handed in.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.core.compression import compress_rows_ref, dp_scalar
from repro_torch.kernels import launch_counts
from repro_torch.kernels.build import load

# Rows of at most this many floats share one matrix (the register bodies);
# each wider width gets one of its own.
NARROW_WIDTH = 1024
# ...unless padding them to the widest of them would add more than this many
# bytes of fp32 and more floats than they hold; then each narrow width gets
# one of its own. Two pods' messages: whisper-medium's 64-wide rows would
# pad to 1024 with 27 GB for 4.9 GB of values (split); falcon-mamba-7b's
# 16-wide rows pad to 288 with fewer floats than they hold at any depth
# (0.29 GB for 0.32 GB at 16 layers, 1.1 for 1.3 at 64: one launch);
# the other LLMs' narrow rows share one width. The floor keeps a small
# message (a paper model's, any smoke width's) in one launch whatever its
# padding.
NARROW_PAD_BYTES = 1 << 30
# The kernels index a row's columns with int, stepping by up to a block.
MAX_ROW_WIDTH = 2 ** 31 - 1 - 256


def _per_row(v, rows: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, device=device).to(torch.int32).reshape(-1)
    if t.numel() == 1:
        return t.expand(rows).contiguous()
    if t.numel() != rows:
        raise ValueError(f"per-row operand has {t.numel()} entries for {rows} rows")
    return t.contiguous()


def _check_matrix(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_compress runs on CUDA tensors, got {name} on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_compress takes float32, got {name} of {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"fused_compress takes a contiguous [rows, n] {name}, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")


def fused_compress(
    x: torch.Tensor,
    k: Union[int, torch.Tensor],
    levels: int = 0,
    row_len: Optional[torch.Tensor] = None,
    dp_clip=None,
    dp_sigma=None,
    dp_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The CUDA kernel: x [rows, n] fp32 contiguous on the card -> same.

    k: scalar or per-row keep count (k >= n is a per-row no-op). levels <= 1
    disables quantization. row_len: optional per-row valid length.
    dp_noise: [rows, n] fp32 standard normals on the card; given, the DP
    kernel clips each row to ``dp_clip`` and adds ``dp_sigma·dp_clip·noise``
    first (clip and σ: floats or one-element tensors, best on the card).
    """
    _check_matrix("x", x)
    if dp_noise is not None:
        _check_matrix("dp_noise", dp_noise)
        if dp_noise.shape != x.shape or dp_noise.device != x.device:
            raise ValueError(f"dp_noise {tuple(dp_noise.shape)} on {dp_noise.device} does "
                             f"not match x {tuple(x.shape)} on {x.device}")
        clip = dp_scalar("dp_clip", dp_clip, x.device).contiguous()
        sigma = dp_scalar("dp_sigma", dp_sigma, x.device).contiguous()
    rows, n = x.shape
    if n > MAX_ROW_WIDTH or rows >= 2 ** 31:
        raise ValueError(f"a [{rows}, {n}] matrix is past the kernels' int indexing")
    k_arr = _per_row(k, rows, x.device)
    len_arr = _per_row(n if row_len is None else row_len, rows, x.device)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = load("compress")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if dp_noise is None:
            fn, counter = "compress_rows_f32", "fused_compress"
            err = lib.compress_rows_f32(
                x.data_ptr(), k_arr.data_ptr(), len_arr.data_ptr(), out.data_ptr(),
                rows, n, int(levels), stream)
        else:
            fn, counter = "compress_rows_dp_f32", "fused_compress_dp"
            err = lib.compress_rows_dp_f32(
                x.data_ptr(), k_arr.data_ptr(), len_arr.data_ptr(), dp_noise.data_ptr(),
                clip.data_ptr(), sigma.data_ptr(), out.data_ptr(), rows, n, int(levels), stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: {lib.cuda_error_string(err).decode()}")
    launch_counts[counter] += 1
    return out


def compress_rows(
    x: torch.Tensor,
    k: Union[int, torch.Tensor],
    levels: int = 0,
    row_len: Optional[torch.Tensor] = None,
    dp_clip=None,
    dp_sigma=None,
    dp_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Router: the plain version for a CPU tensor, the kernel otherwise."""
    if x.device.type == "cpu":
        return compress_rows_ref(x, k, levels, row_len, dp_clip, dp_sigma, dp_noise)
    return fused_compress(x, k, levels, row_len, dp_clip, dp_sigma, dp_noise)


def stack_rows(leaves, k_frac: float):
    """Message leaves as one fp32 row matrix, each leaf viewed as rows of
    its trailing axis and padded to the widest: (matrix, per-row k, per-row
    valid length, rows per leaf). Per-leaf k is ``max(1, round(k_frac *
    width))`` when 0 < k_frac < 1, else the full width."""
    do_topk = 0.0 < k_frac < 1.0
    widths = [leaf_width(leaf) for leaf in leaves]
    n_max = max(widths)
    mats = []
    for leaf, n in zip(leaves, widths):
        m = leaf.float().reshape(-1, n)
        mats.append(F.pad(m, (0, n_max - n)) if n < n_max else m)
    counts = [m.shape[0] for m in mats]
    ks = [max(1, int(round(k_frac * n))) if do_topk else n for n in widths]
    device = leaves[0].device
    k_rows = torch.from_numpy(np.repeat(np.asarray(ks, np.int32), counts)).to(device)
    len_rows = torch.from_numpy(np.repeat(np.asarray(widths, np.int32), counts)).to(device)
    return torch.cat(mats, dim=0), k_rows, len_rows, counts


def leaf_width(leaf) -> int:
    """The width of a leaf's rows: its trailing axis (1 for a scalar)."""
    return int(leaf.shape[-1]) if leaf.dim() else 1


def row_groups(leaves):
    """The message's leaves grouped by the kernel body their rows need, as
    lists of leaf indices: the leaves of width <= ``NARROW_WIDTH`` in one
    group (padded to the widest of them by ``stack_rows``), then one group
    for each wider width, in increasing width. No leaf is padded past
    ``NARROW_WIDTH``; if the narrow group's padding would take more than
    ``NARROW_PAD_BYTES`` and more floats than its values, its leaves are
    grouped by width too."""
    widths = [leaf_width(leaf) for leaf in leaves]

    def by_width(members):
        return [[i for i in members if widths[i] == w]
                for w in sorted({widths[i] for i in members})]

    narrow = [i for i, n in enumerate(widths) if n <= NARROW_WIDTH]
    wide = by_width([i for i, n in enumerate(widths) if n > NARROW_WIDTH])
    if not narrow:
        return wide
    n_max = max(widths[i] for i in narrow)
    pad = sum(leaves[i].numel() // widths[i] * (n_max - widths[i]) for i in narrow)
    split = 4 * pad > NARROW_PAD_BYTES and pad > sum(leaves[i].numel() for i in narrow)
    return (by_width(narrow) if split else [narrow]) + wide


def compress_pytree(tree, k_frac: float, levels: int = 0, dp_clip=None, dp_sigma=None,
                    dp_noise=None, dp_generator: Optional[torch.Generator] = None):
    """Compress every leaf of a message tree, one launch per row group.

    The leaves are grouped by ``row_groups`` and each group stacked by
    ``stack_rows``; the per-row valid length keeps the result identical to
    compressing each leaf separately. Groups are stacked and compressed one
    after the other, so one group's input matrix lives at a time.

    DP: with ``dp_noise`` (standard normals shaped like the stacked group:
    one tensor for a one-group message, else a sequence of one per group)
    or ``dp_generator`` (a generator on the tree's device, from which that
    noise is drawn with ``torch.randn``, group by group), every row goes
    through the fused clip + noise stage with clip ``dp_clip`` and
    multiplier ``dp_sigma``.
    """
    dp = dp_noise is not None or dp_generator is not None
    if not (0.0 < k_frac < 1.0) and not (levels and levels > 1) and not dp:
        return tree
    leaves, treedef = tree_flatten(tree)
    groups = row_groups(leaves)
    if dp_noise is not None:
        dp_noise = [dp_noise] if isinstance(dp_noise, torch.Tensor) else list(dp_noise)
        if len(dp_noise) != len(groups):
            raise ValueError(f"dp_noise holds {len(dp_noise)} matrices for the message's "
                             f"{len(groups)} row groups")
    new_leaves = [None] * len(leaves)
    for gi, members in enumerate(groups):
        mat, k_rows, len_rows, counts = stack_rows([leaves[i] for i in members], k_frac)
        noise = None
        if dp_noise is not None:
            noise = dp_noise[gi].to(device=mat.device, dtype=torch.float32).contiguous()
            if noise.shape != mat.shape:
                raise ValueError(f"dp_noise {tuple(noise.shape)} does not match row group {gi} "
                                 f"{tuple(mat.shape)}")
        elif dp:
            noise = torch.randn(mat.shape, generator=dp_generator, device=mat.device)
        out = compress_rows(mat, k_rows, levels, len_rows, dp_clip, dp_sigma, noise)
        del mat, noise
        off = 0
        for i, r in zip(members, counts):
            leaf = leaves[i]
            new_leaves[i] = out[off:off + r, :leaf_width(leaf)].reshape(leaf.shape).to(leaf.dtype)
            off += r
    return tree_unflatten(treedef, new_leaves)
