"""neojax_torch — the partitioned-convolution engine of ``neojax`` on PyTorch
and CUDA (NVIDIA Hopper).

The JAX package ``neojax`` is the reference; this package keeps its module
names, its config dataclass and the keys and shapes of its params/state
dicts, so the two can be held against each other on the same inputs
(``neojax_torch.convert`` carries params and state across). Plain tensor
code is PyTorch; every hot kernel of the per-block convolver is a CUDA C++
kernel written for ``sm_90a`` (``neojax_torch/csrc``), built with nvcc at
first use. On CPU tensors each kernel wrapper runs its plain PyTorch
version instead.

This package never imports ``jax``.
"""

from neojax_torch import conv, core, fft, ops

__all__ = ["conv", "core", "fft", "ops"]
