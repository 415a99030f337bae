"""Integer/bit helpers used for FFT sizing (``neojax.core.bits``).

Plain Python ints: all sizing happens on the host.
"""

from __future__ import annotations

__all__ = ["bit_ceil", "bit_log2", "is_pow2", "next_order", "idiv", "ipow"]


def bit_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bit_log2(n: int) -> int:
    """floor(log2(n)) for n >= 1."""
    if n < 1:
        raise ValueError(f"bit_log2 requires n >= 1, got {n}")
    return n.bit_length() - 1


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def next_order(size: int) -> int:
    """FFT order (log2 of transform size) that fits ``size`` samples.

    Matches the reference's ``fft::next_order``: log2(bit_ceil(size)).
    """
    return bit_log2(bit_ceil(size))


def idiv(x: int, y: int) -> int:
    """Ceiling integer division (reference ``neo::idiv``)."""
    return (x + y - 1) // y


def ipow(base: int, exponent: int) -> int:
    """Integer power (reference ``math/ipow.hpp``)."""
    result = 1
    for _ in range(exponent):
        result *= base
    return result
