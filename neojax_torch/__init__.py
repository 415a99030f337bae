"""neojax_torch — the partitioned-convolution engine of ``neojax`` on PyTorch
and CUDA (NVIDIA Hopper).

The JAX package ``neojax`` is the reference; this package keeps its module
names, its config dataclass and the keys and shapes of its params/state
dicts, so the two can be held against each other on the same inputs
(``neojax_torch.convert`` carries params and state across). Plain tensor
code is PyTorch; every hot kernel of the per-block convolver and the
nested engine is a CUDA C++ kernel written for ``sm_90a``
(``neojax_torch/csrc``), built with nvcc at first use. On CPU tensors each
kernel wrapper runs its plain PyTorch version instead.

The top-level namespace mirrors ``neojax``'s (the reference's Python
surface, ``extra/python/src/neo/__init__.py``): ``convolve``,
``amplitude_to_db``, ``a_weighting``, ``fast_log2``/``fast_log10`` and the
``fft`` submodule.

This package never imports ``jax``.
"""

from __future__ import annotations

import torch

from neojax_torch import conv, core, fft, io, ops
from neojax_torch.core.device import as_tensor
from neojax_torch.core.units import a_weighting, amplitude_to_db, fast_log2, fast_log10

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "a_weighting",
    "amplitude_to_db",
    "fast_log2",
    "fast_log10",
    "convolve",
    "conv",
    "core",
    "fft",
    "io",
    "ops",
]


def convolve(in1, in2, mode: str = "full", method: str = "auto", device=None) -> torch.Tensor:
    """Convolve two 1-D arrays on ``device`` (None: where a tensor input
    lies, host input on the card, ``core.device.as_tensor``), with the
    reference ``neo.convolve`` semantics: only mode='full'. Methods mirror
    the reference's enum (``method.hpp:8-17``): 'auto'/'direct', 'fft', and
    the streaming engines 'ols', 'ola', 'upols', 'upola'."""
    if mode != "full":
        raise ValueError("unsupported convolution mode")
    in1 = as_tensor(in1, device)
    in2 = as_tensor(in2, device)
    if in1.ndim != 1 or in2.ndim != 1:
        raise ValueError("unsupported dimension: in1 and in2 must be 1-D")
    if method == "fft":
        return conv.fft_convolve(in1, in2)
    if method in ("ols", "ola", "upols", "upola"):
        from neojax_torch.conv.streaming import streaming_convolve

        return streaming_convolve(in1, in2, method)
    return conv.direct_convolve(in1, in2)
