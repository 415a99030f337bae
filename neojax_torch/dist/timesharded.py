"""Time-sharded (sequence-parallel) streaming convolution
(``neojax.dist.timesharded``).

The block stream itself splits over a mesh "time" axis: rank d processes
the m consecutive blocks ``[d*m, (d+1)*m)`` and receives its predecessor's
boundary state through one :func:`~neojax_torch.dist.mesh.ppermute`: the
halo of the P input blocks before its shard (rank 0 receives zeros, a
fresh stream start). This is the halo pattern of ring attention applied
to OLS streaming (``overlap_save.hpp:37-55``, ``overlap_add.hpp:216-220``).

Why a halo suffices: the state entering block k is a function of the
previous P blocks of input alone (the FDL holds the last P frame spectra,
the OLS window tail the last block). So each rank rebuilds it with a
warmup — one batched forward transform of the P-1 warmup frames plus one
ring assembly, the quantization vectorised over frames; UPOLA adds one
full ``step`` on the last halo block for its overlap tail — and then
streams its shard through the per-block engine (``conv.process``: B3 on
the card).

``neojax`` keeps a sequential ``insert_only_step`` scan for its four-step
transform sizes (N >= 4096), whose transforms are not batch-shaped. The
port's streaming engines transform on cuFFT at every size (its four-step
route is ``fft.api``'s ``"matmul"`` backend alone), so the batched warmup
serves every N.

Where the stream runs the fused kernels (B3 for UPOLS, B2 for UPOLA), the
warmup is ``conv.convolver.warm_ring``: their own stage kernels over the
warmup frames, so the ring holds the rows the stream itself would have
written. Elsewhere it is one batched transform of the per-block path
(``torch.fft`` or the packed product), which rounds apart from the
one-block transforms of the stream. Either way the output agrees with one
``process`` call to rounding; whether bit for bit depends on the card's
transform kernel splitting its sums alike for a window and for a block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neojax_torch.conv import convolver as cv
from neojax_torch.dist.mesh import Mesh, ppermute
from neojax_torch.fft import api as fft_api
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.ops.quantize import int_max_for

__all__ = ["timesharded_process"]


def _batch_spectra(config: cv.PartitionedConfig, frames: torch.Tensor):
    """Forward transforms of [m, C, N] warmup frames in one batched call, by
    the per-block path's own transform: complex [m, C, K] (dense), packed
    (re, im) [m, C, B], or (re, im) [m, C, K]."""
    n, k = config.transform_size, config.num_bins
    if config.storage == "dense":
        return fft_api.rfft(frames, n=n)[..., :k]
    if config.use_packed:
        return mb.rfft_packed_split(frames, n)
    spec = fft_api.rfft(frames, n=n)[..., :k]
    return spec.real, spec.imag


def _assemble_ring(config: cv.PartitionedConfig, state: dict, spectra) -> dict:
    """Place m batch-transformed spectra into ring slots 0..m-1 (ring
    layout) or newest-first slots (shift layout), in place: the state m
    sequential ``insert_only_step`` pushes would leave."""
    state = dict(state)
    ring = config.layout == "ring"
    if config.storage == "dense":
        m = spectra.shape[0]
        state["fdl"][:m] = (spectra if ring else spectra.flip(0)).to(state["fdl"].dtype)
    else:
        spec_re, spec_im = spectra
        m = spec_re.shape[0]
        rows = torch.stack([spec_re, spec_im]).to(torch.float32)  # [2, m, C, L]
        if not ring:
            rows = rows.flip(1)
        fdl = state["fdl"]
        if isinstance(fdl, tuple):
            planes, scales = fdl
            mx = int_max_for(planes.dtype)
            peak = torch.amax(torch.abs(rows), dim=(0, 3))  # [m, C]
            scale = torch.where(peak > 0, peak, torch.ones_like(peak))[..., None]  # [m, C, 1]
            planes[:, :m] = torch.clamp(torch.round(rows / scale[None] * mx), -mx, mx).to(planes.dtype)
            scales[:m] = scale
        else:
            fdl[:, :m] = rows.to(fdl.dtype)
        if config.use_packed:
            pair = torch.stack([spec_re[:, :, 0], spec_im[:, :, 0]], dim=-1)  # [m, C, 2]
            state["dcny"][:m] = pair if ring else pair.flip(0)
    if ring:
        state["pos"] = m % config.num_partitions
    return state


def _warmup(config: cv.PartitionedConfig, params: dict, halo: torch.Tensor) -> dict:
    """The convolver state entering this rank's shard, from the halo
    [C, P*B]: the P input blocks before it (zeros on rank 0, a fresh
    stream start)."""
    p, b = config.num_partitions, config.block_size
    c = halo.shape[0]
    blocks = halo.reshape(c, p, b).transpose(0, 1)  # [P, C, B]
    state = cv.init_state(config, halo.device)
    if config.scheme == "upols":
        # the tail seeds the window; frames for blocks 1..P-1
        state["tail"] = blocks[-1].clone()
        frames = torch.cat([blocks[:-1], blocks[1:]], dim=-1)  # [P-1, C, 2B]
    else:
        # zero-padded single blocks 0..P-2, then one full step on block P-1
        frames = F.pad(blocks[:-1], (0, config.transform_size - b))
    if cv._use_fused(config, params) and config.layout == "ring":
        state = cv.warm_ring(config, state, blocks)
    else:
        state = _assemble_ring(config, state, _batch_spectra(config, frames))
    if config.scheme == "upola":
        state, _ = cv.step(config, params, state, blocks[-1])
    return state


def timesharded_process(config: cv.PartitionedConfig, params: dict, signal, mesh: Mesh,
                        axis_name: str = "time"):
    """Stream ``signal`` [C, T] (or [T]; host or tensor) with the block
    axis split over ``axis_name``.

    Requires T = nb*B with nb divisible by the axis size, and at least P
    blocks a rank (so the halo comes from the immediate predecessor).
    ``params`` are the per-block engine's (``conv.filter_params``),
    whole on every rank. Returns this rank's time slice of the output,
    ``[C, m*B]`` with samples ``[d*m*B, (d+1)*m*B)`` for index d.
    """
    signal = signal if isinstance(signal, torch.Tensor) else torch.as_tensor(signal)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    d = mesh.shape[axis_name]
    b, p = config.block_size, config.num_partitions
    c, t = signal.shape
    if t % (b * d):
        raise ValueError(f"signal length {t} not divisible into {d} x block {b}")
    m = t // (b * d)
    if m < p:
        raise ValueError(
            f"{m} blocks/device < {p} partitions: halo would span multiple "
            "predecessors; use fewer devices or a longer signal"
        )
    sig = mesh.place(signal, (None, axis_name), (c, t), torch.float32)
    params = {k: v.to(mesh.device) for k, v in params.items()}
    halo = ppermute(sig[:, -p * b:], mesh, axis_name, [(i, i + 1) for i in range(d - 1)])
    _, out = cv.process(config, params, _warmup(config, params, halo), sig)
    return out[0] if squeeze else out
