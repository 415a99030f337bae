"""User-facing real transforms with numpy norm handling (``neojax.fft.api``).

Mirrors the reference's plan API semantics (``src/neo/fft/rfft.hpp:18-38``):
norm in {"backward", "ortho", "forward"} with numpy conventions. The
transforms run on ``torch.fft`` (pocketfft on the CPU, cuFFT on CUDA); the
JAX package's MXU DFT-matmul backend has no counterpart here.
"""

from __future__ import annotations

import torch

__all__ = ["rfft", "irfft"]

_NORMS = ("backward", "ortho", "forward")


def _check_norm(norm):
    if norm is not None and norm not in _NORMS:
        raise ValueError(f"unknown norm: {norm!r}")


def rfft(x, n: int | None = None, axis: int = -1, norm: str = "backward") -> torch.Tensor:
    """Real [..., n] -> complex [..., n//2+1] (input zero-padded or trimmed to n)."""
    _check_norm(norm)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return torch.fft.rfft(x, n=n, dim=axis, norm=norm)


def irfft(x, n: int | None = None, axis: int = -1, norm: str = "backward") -> torch.Tensor:
    """Complex [..., n//2+1] -> real [..., n] (default n = 2*(bins-1))."""
    _check_norm(norm)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return torch.fft.irfft(x, n=n, dim=axis, norm=norm)
