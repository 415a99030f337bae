"""Elementwise linear-algebra ops, including the complex MAC
(``neojax.ops.elementwise``).

Counterpart of the reference algorithm layer (``src/neo/algorithm/add.hpp``,
``multiply.hpp``, ``scale.hpp``) and the batched complex ``multiply_add``
(``src/neo/algorithm/multiply_add.hpp:28-69,280-368``) that the FDL engine
spends its time in; the engines' own partition MACs are the CUDA kernels of
``neojax_torch.kernels``. Host operands follow a tensor operand's device,
or go to ``device`` (None: the card; ``core.device.as_tensors``).
"""

from __future__ import annotations

from neojax_torch.core.device import as_tensor, as_tensors

__all__ = ["add", "multiply", "scale", "multiply_add", "split_multiply_add"]


def add(x, y, device=None):
    x, y = as_tensors(x, y, device=device)
    return x + y


def multiply(x, y, device=None):
    x, y = as_tensors(x, y, device=device)
    return x * y


def scale(factor, x, device=None):
    return as_tensor(x, device) * factor


def multiply_add(x, y, z, device=None):
    """x * y + z (elementwise; complex or real)."""
    x, y, z = as_tensors(x, y, z, device=device)
    return x * y + z


def split_multiply_add(x_re, x_im, y_re, y_im, z_re, z_im):
    """Split-complex MAC: returns (re, im) of x*y + z.

    ``out_re = xr*yr - xi*yi + zr``; ``out_im = xr*yi + xi*yr + zi`` —
    the exact kernel of ``multiply_add.hpp:28-69``.
    """
    return (
        x_re * y_re - x_im * y_im + z_re,
        x_re * y_im + x_im * y_re + z_im,
    )
