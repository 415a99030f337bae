"""User-facing transforms fft/ifft/rfft/irfft with numpy norm handling
(``neojax.fft.api``).

Mirrors the reference's plan API semantics (``src/neo/fft/fft.hpp:39-51``,
``rfft.hpp:18-38``): norm in {"backward", "ortho", "forward"} with numpy
conventions. Two backends, as in the JAX package:

  - ``"xla"`` (and ``"auto"``): ``torch.fft`` — cuFFT on the card,
    pocketfft on the CPU — any size;
  - ``"matmul"``: the DFT as a float32 product against dense matrices
    (``fft.matmul_backend``, IEEE float32 whatever the caller's TF32
    flags), up to ``_MATMUL_MAX_SIZE``; above it a power of two goes
    through the four-step recursion of such products
    (``fft.four_step``), any other size to ``torch.fft``.

The default backend is process-global and settable via ``set_backend``.
Each transform runs where its input tensor lies; host input (numpy,
lists) goes to ``device`` (None: the card, ``core.device.as_tensor``).
"""

from __future__ import annotations

import torch

from neojax_torch.core.bits import is_pow2
from neojax_torch.core.device import as_tensor
from neojax_torch.fft import four_step, matmul_backend

__all__ = [
    "set_backend",
    "get_backend",
    "fft",
    "ifft",
    "rfft",
    "irfft",
]

_BACKEND = "auto"
_MATMUL_MAX_SIZE = 8192
_NORMS = ("backward", "ortho", "forward")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in ("auto", "xla", "matmul"):
        raise ValueError(f"unknown fft backend: {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def _route(backend, n: int, x: torch.Tensor, axis: int) -> str:
    """``"matmul"`` (dense DFT products), ``"fourstep"`` (the four-step
    recursion of them, a power of two above ``_MATMUL_MAX_SIZE``) or
    ``"torch"`` (``torch.fft``; also any transform over another axis), as
    ``neojax.fft.api._resolve_backend`` routes the JAX package's."""
    b = backend or _BACKEND
    if b not in ("auto", "xla", "matmul"):
        raise ValueError(f"unknown fft backend: {b!r}")
    if b != "matmul" or axis not in (-1, x.ndim - 1):
        return "torch"
    if n > _MATMUL_MAX_SIZE:
        return "fourstep" if is_pow2(n) else "torch"
    return "matmul"


def _check_norm(norm):
    if norm is not None and norm not in _NORMS:
        raise ValueError(f"unknown norm: {norm!r}")


def _pad_or_trim(x: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    length = x.shape[axis]
    if length == n:
        return x
    if length > n:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n - length
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _split(x: torch.Tensor):
    xr = x.real.to(torch.float32) if x.is_complex() else x.to(torch.float32)
    xi = x.imag.to(torch.float32) if x.is_complex() else torch.zeros_like(xr)
    return xr, xi


def fft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None,
        device=None) -> torch.Tensor:
    _check_norm(norm)
    x = as_tensor(x, device)
    n = int(n if n is not None else x.shape[axis])
    x = _pad_or_trim(x, n, axis)
    route = _route(backend, n, x, axis)
    if route == "fourstep":
        out = torch.complex(*four_step.fft_split_large(*_split(x), n))
    elif route == "matmul":
        out = torch.complex(*matmul_backend.fft_split(*_split(x), n))
    else:
        out = torch.fft.fft(x, dim=axis)
    return _apply_norm(out, n, norm, forward=True)


def ifft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None,
         device=None) -> torch.Tensor:
    _check_norm(norm)
    x = as_tensor(x, device)
    n = int(n if n is not None else x.shape[axis])
    x = _pad_or_trim(x, n, axis)
    route = _route(backend, n, x, axis)
    if route != "torch":
        split = four_step.fft_split_large if route == "fourstep" else matmul_backend.fft_split
        re, im = split(*_split(x), n, inverse=True)
        out = torch.complex(re / n, im / n)
    else:
        out = torch.fft.ifft(x, dim=axis)
    return _apply_norm(out, n, norm, forward=False)


def rfft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None,
         device=None) -> torch.Tensor:
    """Real [..., n] -> complex [..., n//2+1] (input zero-padded or trimmed to n)."""
    _check_norm(norm)
    x = as_tensor(x, device)
    n = int(n if n is not None else x.shape[axis])
    x = _pad_or_trim(x, n, axis)
    route = _route(backend, n, x, axis)
    if route == "fourstep":
        out = torch.complex(*four_step.rfft_split_large(x, n))
    elif route == "matmul" and n % 2 == 0:
        out = matmul_backend.rfft(x, n)
    else:
        out = torch.fft.rfft(x, dim=axis)
    return _apply_norm(out, n, norm, forward=True)


def irfft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None,
          device=None) -> torch.Tensor:
    """Complex [..., n//2+1] -> real [..., n] (default n = 2*(bins-1))."""
    _check_norm(norm)
    x = as_tensor(x, device)
    n = int(n if n is not None else 2 * (x.shape[axis] - 1))
    x = _pad_or_trim(x, n // 2 + 1, axis)
    route = _route(backend, n, x, axis)
    if route == "fourstep":
        out = four_step.irfft_split_large(*_split(x), n)
    elif route == "matmul" and n % 2 == 0:
        out = matmul_backend.irfft(torch.complex(*_split(x)), n)  # real bins too, as numpy takes them
    else:
        out = torch.fft.irfft(x, n=n, dim=axis)
    return _apply_norm(out, n, norm, forward=False)


def _apply_norm(out: torch.Tensor, n: int, norm: str, forward: bool) -> torch.Tensor:
    # Backends return backward-normalized results (the inverse includes 1/n).
    if norm in (None, "backward"):
        return out
    if norm == "ortho":
        return out * (1.0 / (n**0.5)) if forward else out * (n**0.5)
    return out * (1.0 / n) if forward else out * n


def require_pow2(n: int) -> None:
    """Raise like the reference binding on non-power-of-two sizes
    (``extra/python/src/main.cpp:137-139``)."""
    if not is_pow2(n):
        raise ValueError(f"unsupported size: {n}")
