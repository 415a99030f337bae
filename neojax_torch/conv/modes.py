"""Convolution mode/method vocabulary (``neojax.conv.modes``).

Counterpart of ``src/neo/convolution/mode.hpp:11-28`` and
``method.hpp:8-17``. Like the reference, only ``full`` has a defined output
size; ``valid``/``same`` exist in the enum but raise when used (the
reference's Python binding throws "unsupported convolution mode",
``extra/python/src/main.cpp:196-198``).
"""

from __future__ import annotations

import enum

__all__ = ["Mode", "Method", "output_size"]


class Mode(enum.Enum):
    FULL = "full"
    VALID = "valid"
    SAME = "same"


class Method(enum.Enum):
    AUTOMATIC = "auto"
    DIRECT = "direct"
    FFT = "fft"
    OLA = "ola"
    OLS = "ols"
    UPOLA = "upola"
    UPOLS = "upols"


def output_size(mode: Mode, signal: int, patch: int) -> int:
    if mode == Mode.FULL:
        return signal + patch - 1
    raise ValueError(f"unsupported convolution mode: {mode}")
