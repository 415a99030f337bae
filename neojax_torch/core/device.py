"""Where the entry points run: on the card unless the caller asks for the CPU.

The port's hot paths are CUDA kernels; the CPU route (each kernel's plain
version) exists for tests and for callers who ask for it by name. So an
entry point given no ``device`` resolves to ``cuda`` and raises, never
falls back, when there is no card.

Also the one place that pins float32 products to IEEE float32
(:func:`ieee_float32`): the JAX package's ``Precision.HIGHEST`` products
are true float32, and TF32 (10-bit mantissa) would lose the split
storage's 90 dB class and the reference's 1e-5 parity bound.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "as_tensor", "as_tensors", "ieee_float32"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Raises RuntimeError when ``device`` is None and no CUDA card is
    visible: the port does not run its kernels' plain versions unless the
    caller passes ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: neojax_torch runs on the card by default; pass "
            'device="cpu" to run the kernels\' plain PyTorch versions on the CPU'
        )
    return torch.device("cuda")


def as_tensor(x, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; anything else (numpy, lists, scalars) lands on
    ``resolve_device(device)``, so host data goes to the card by default.
    The one input rule of the array functions (``fft.api``, ``core.units``
    and the ``convolve`` surface), as for a torch op."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype) if device is not None or dtype is not None else x
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def as_tensors(*xs, device=None, dtype: torch.dtype | None = None) -> tuple:
    """Several operands by :func:`as_tensor`'s rule, where host data follows
    the first tensor operand's device when ``device`` is None (as a torch op
    takes a Python scalar beside a tensor); with no tensor operand, host
    data goes to ``resolve_device(device)``."""
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(as_tensor(x, device, dtype) for x in xs)


def _read(obj, name):
    """A TF32 flag's value, or None where this torch lacks it or refuses to
    read it (the legacy getters raise once a caller mixed the two APIs)."""
    try:
        return getattr(obj, name)
    except (AttributeError, RuntimeError):
        return None


def _precision_flags():
    """(legacy matmul precision, legacy cuDNN allow_tf32, new matmul
    fp32_precision, new cuDNN conv fp32_precision): each None if absent."""
    cudnn_conv = getattr(torch.backends.cudnn, "conv", None)
    try:
        legacy_mm = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy_mm = None
    return (legacy_mm, _read(torch.backends.cudnn, "allow_tf32"),
            _read(torch.backends.cuda.matmul, "fp32_precision"),
            _read(cudnn_conv, "fp32_precision") if cudnn_conv is not None else None)


def _set_flags(legacy_mm, legacy_cudnn, new_mm, new_conv) -> None:
    # The legacy setters write both flag sets, the new ones only their own:
    # legacy first, so a caller's mix of the two comes back as it was.
    if legacy_mm is not None:
        torch.set_float32_matmul_precision(legacy_mm)
    if legacy_cudnn is not None:
        torch.backends.cudnn.allow_tf32 = legacy_cudnn
    if new_mm is not None:
        torch.backends.cuda.matmul.fp32_precision = new_mm
    if new_conv is not None:
        torch.backends.cudnn.conv.fp32_precision = new_conv


@contextlib.contextmanager
def ieee_float32():
    """Run float32 matmuls (cuBLAS) and convolutions (cuDNN) in IEEE float32
    whatever the caller set (``torch.set_float32_matmul_precision``,
    ``allow_tf32``, ``fp32_precision``); the caller's flags are restored
    on exit. The port's float32 products (the ``"matmul"`` DFT backend,
    ``direct_convolve``, the chunked engine's split product) run inside it.
    Process-global, like the flags themselves."""
    saved = _precision_flags()
    _set_flags("highest", False, "ieee" if saved[2] is not None else None,
               "ieee" if saved[3] is not None else None)
    try:
        yield
    finally:
        _set_flags(*saved)
