"""The edge-case matrix that the compress kernels are held to.

``edge_case_rows`` (at each width in ``EDGE_WIDTHS``) builds the rows and
``same_values`` is the comparison; ``chip_smoke.py`` and the card tests of
``kernels/compress.py`` hold both kernels to the plain version
``core/compression.py::compress_rows_ref`` with them.
"""
from __future__ import annotations

import torch

# Row widths of the edge-case matrix: every register bucket of the CUDA
# kernel (1 to 32 values a lane), non-multiples of 32, the first and last
# width of each bucket of the group body past 1024 (one warp a row up to
# 1280, one CTA a row up to 32768, clusters of 2, 4 and 8 CTAs up to 262144
# floats; odd widths, whose rows are not 16-byte aligned, among them),
# widths an older body ended at (58112, 58113, 65536), and the wide body
# past the cluster's reach (262145).
EDGE_WIDTHS = (1, 31, 33, 64, 100, 128, 255, 300, 512, 1000, 1024, 1025, 1280, 1281, 4000,
               32768, 32769, 58112, 58113, 65536, 65537, 131072, 131073, 262144, 262145)


def edge_case_rows(n: int, seed: int = 0):
    """(x [rows, n] fp32, k, row_len) on the CPU: one row per edge case the
    kernel must hold bit-identical to the plain version, each row's padding
    past row_len filled with NaN or 1e30 (never read as data). Cases: dense
    and half-length rows, k = 0, k < 0, k = len, k > len, len = 0, integer
    values with many tied magnitudes, a five-value row, all-zero rows (k = 1
    and k = 0), ±inf (k = 1 and k = len/4), a NaN (k = 2 and k = 0),
    subnormals, values near the fp32 maximum (lo + hi overflows to inf in
    the bisection), signed zeros, and rows with no finite value, as a
    diverged model's message holds them: all NaN, all +inf, all -inf,
    alternating ±inf, NaN mixed with ±inf."""
    g = torch.Generator().manual_seed(seed * 7919 + n)
    base = lambda: torch.randn(n, generator=g)
    half, quarter = max(1, n // 2), max(1, n // 4)
    inf_row = base()
    inf_row[::7], inf_row[3::11] = float("inf"), -float("inf")
    nan_row = base()
    nan_row[n // 3] = float("nan")
    zeros = torch.zeros(n)
    zeros[::2] = -0.0
    zeros[::5] = base()[::5]
    inf = float("inf")
    signed_inf = torch.full((n,), inf)
    signed_inf[1::2] = -inf
    nonfinite = torch.full((n,), float("nan"))
    nonfinite[::3], nonfinite[1::5] = inf, -inf
    cases = [(base(), n, quarter), (base(), half, max(1, half // 3)), (base(), n, 0),
             (base(), n, -3), (base(), n, n), (base(), n, n + 5), (base(), 0, 1),
             (torch.round(base() * 3), n, quarter),
             (torch.randint(-2, 3, (n,), generator=g).float(), n, half),
             (torch.zeros(n), n, 1), (torch.zeros(n), n, 0),
             (inf_row, n, 1), (inf_row, n, quarter), (nan_row, n, 2), (nan_row, n, 0),
             (base() * 1e-40, n, quarter), (base() * 1e38, n, quarter), (zeros, n, n),
             (torch.full((n,), float("nan")), n, quarter), (torch.full((n,), inf), n, quarter),
             (torch.full((n,), -inf), n, 1), (signed_inf, n, half), (nonfinite, n, quarter)]
    x = torch.empty((len(cases), n))
    x[0::2], x[1::2] = float("nan"), 1e30
    for r, (vals, ln, _) in enumerate(cases):
        x[r, :ln] = vals[:ln]
    k = torch.tensor([c[2] for c in cases], dtype=torch.int32)
    row_len = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    return x, k, row_len


def same_values(got: torch.Tensor, want: torch.Tensor) -> bool:
    """torch.equal, with NaN allowed where both hold NaN (quantizing a row
    whose survivors include ±inf gives NaN in both versions, and NaN is
    never equal to itself)."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want)))
