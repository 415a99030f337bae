"""One-shot convolution through the streaming engines (method routing;
``neojax.conv.streaming``).

The reference's ``method`` enum (``method.hpp:8-17``) includes the
streaming engines; this module lets the high-level ``convolve`` route
through them (OLS/OLA single-filter streaming, UPOLS/UPOLA partitioned)
and still produce a plain full convolution.

OLS/OLA loop over the blocks in Python (the JAX package scans them);
UPOLS/UPOLA stream through the port's :class:`~neojax_torch.conv.Convolver`
(on the card: split storage, so B3 for blocks up to 1024 under UPOLS and
the per-block kernels otherwise).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch.conv.convolver import Convolver
from neojax_torch.conv.overlap import OverlapAdd, OverlapSave, stream_blocks, unstream_blocks
from neojax_torch.conv.partition import uniform_partition
from neojax_torch.core.bits import bit_ceil
from neojax_torch.core.device import as_tensor

__all__ = ["streaming_convolve"]


def _ols_ola_convolve(signal: torch.Tensor, patch: torch.Tensor, scheme: str, block_size):
    n = signal.shape[-1]
    l = patch.shape[-1]
    if block_size is None:
        block_size = min(max(bit_ceil(l), 256), 4096)
    proc = (OverlapSave if scheme == "ols" else OverlapAdd)(block_size, l)
    h_spec = np.fft.rfft(patch.cpu().numpy(), n=proc.transform_size).astype(np.complex64)
    h_spec = torch.from_numpy(h_spec).to(signal.device)

    total = n + l - 1
    pad_to = -(-total // block_size) * block_size
    sig = F.pad(signal.to(torch.float32)[None], (0, pad_to - n))  # [1, T]
    blocks, length = stream_blocks(sig, block_size)
    state = proc.init_state(1, device=signal.device)
    outs = []
    for blk in blocks:
        state, out = proc.step(state, blk, lambda s: s * h_spec)
        outs.append(out)
    return unstream_blocks(torch.stack(outs), length)[0, :total]


def _partitioned_convolve(signal: torch.Tensor, patch: torch.Tensor, scheme: str, block_size):
    n = signal.shape[-1]
    l = patch.shape[-1]
    if block_size is None:
        block_size = min(max(bit_ceil(l // 16 + 1), 128), 4096)
    parts = uniform_partition(patch.to(torch.float32), block_size)
    c = Convolver(scheme, device=signal.device)
    c.filter(parts)
    total = n + l - 1
    sig = F.pad(signal.to(torch.float32), (0, -(-total // block_size) * block_size - n))
    return c.process(sig[None])[0, :total]


def streaming_convolve(in1, in2, method: str, block_size: int | None = None,
                       device=None) -> torch.Tensor:
    """Full 1-D convolution via a streaming engine ('ols'|'ola'|'upols'|'upola'),
    on ``device`` (None: where a tensor input lies, host input on the card,
    ``core.device.as_tensor``)."""
    in1 = as_tensor(in1, device)
    in2 = as_tensor(in2, device)
    if method in ("ols", "ola"):
        return _ols_ola_convolve(in1, in2, method, block_size)
    if method in ("upols", "upola"):
        return _partitioned_convolve(in1, in2, method, block_size)
    raise ValueError(f"unknown streaming method: {method!r}")
