"""Integer/bit helpers used for FFT sizing (``neojax.core.bits``).

Plain Python ints: all sizing happens on the host.
"""

from __future__ import annotations

__all__ = ["bit_ceil", "is_pow2", "idiv"]


def bit_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def idiv(x: int, y: int) -> int:
    """Ceiling integer division (reference ``neo::idiv``)."""
    return (x + y - 1) // y
