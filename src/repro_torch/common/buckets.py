"""Power-of-two bucket helpers (``repro/common/buckets.py``).

The adaptive controller snaps its intervals to powers of two, which keeps
the per-(P, Q) cache of round executors bounded.
"""
from __future__ import annotations


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << max(int(n).bit_length() - 1, 0)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
