"""Partition-sharded streaming pipeline with a ring spectrum hand-off
(``neojax.dist.pipeline``).

The distributed form of the FDL: the partition axis of the delay line and
the filter splits over the mesh "part" axis, channels over "ch". Part rank
d owns the contiguous partitions ``[d*L, (d+1)*L)`` (L = P/D), a window of
the IR's history. Per streamed block:

  1. every rank computes the block spectrum (``fft.matmul_backend.
     rfft_split``; the same on every part rank);
  2. part rank 0 inserts the fresh spectrum; rank d > 0 inserts the one
     rank d-1 handed it on the previous block (each hand-off ages the
     spectrum by exactly one block, the age at which it enters the next
     rank's partition range);
  3. the local MAC over the L local partitions through B1
     (``kernels.fdl_mac``, the int dequant scale ``[L, C]`` fused in), then
     :func:`~neojax_torch.dist.mesh.psum` over "part";
  4. the oldest local spectrum (and its scale) goes to the next part rank
     in one cyclic :func:`~neojax_torch.dist.mesh.ppermute` — the ring
     hand-off that plays the role of the reference's modular ``fdl_index``
     schedule (``fdl_index.hpp:24-36``);
  5. the inverse transform, the same on every part rank.

Storage: "dense" (complex64, plain tensor ops: B1 is split-plane only),
"split"/"bf16", or "int8"/"int16" with a per-channel dynamic scale that
rides the hand-off with its spectrum.

State is ``neojax``'s layout — newest-first (shift) FDL, the pending
``incoming`` row and its ``inc_scale`` — so ``convert`` carries it by a
plain slice. Within a call the FDL is a ring written at a falling position
(no per-block shift of the whole delay line); the call ends by rolling it
back to newest-first. The filter is stored twice over
(``[2, 2L, C', K]`` planes) so the filter aligned to the ring is a
contiguous slice, which B1 needs.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv.convolver import PartitionedConfig
from neojax_torch.conv.overlap import stream_blocks, unstream_blocks
from neojax_torch.dist.mesh import Mesh, ppermute, psum
from neojax_torch.dist.sharded import place_signal
from neojax_torch.fft import api as fft_api
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.kernels.fdl_mac import fdl_mac

__all__ = ["PipelineConvolver"]


class PipelineConvolver:
    """Partition+channel sharded streaming convolver (UPOLS schedule)."""

    def __init__(self, config: PartitionedConfig, mesh: Mesh):
        if config.storage not in ("dense", "split", "bf16", "int8", "int16"):
            raise NotImplementedError(f"unknown storage: {config.storage!r}")
        self.config = config
        self.mesh = mesh
        self.d_part = mesh.shape["part"]
        self.d_ch = mesh.shape.get("ch", 1)
        if config.num_partitions % self.d_part:
            raise ValueError(
                f"num_partitions {config.num_partitions} not divisible by mesh part={self.d_part}"
            )
        if config.channels % self.d_ch:
            raise ValueError(f"channels {config.channels} not divisible by mesh ch={self.d_ch}")
        self._split = config.storage != "dense"
        self._quant = config.storage in ("int8", "int16")
        self._dtype = fdl_lib.STORAGE_DTYPES[config.storage]
        self._ell = config.num_partitions // self.d_part
        self._c = config.channels // self.d_ch

    # -- state ------------------------------------------------------------

    def _specs(self) -> dict:
        ring = (None, "part", "ch", None) if self._split else ("part", "ch", None)
        return {"tail": ("ch", None), "fdl": ring, "incoming": ring,
                "scales": ("part", "ch", None), "inc_scale": ("part", "ch", None)}

    def init_state(self) -> dict:
        """This rank's zero state on its device: ``fdl`` [2, L, C/Dc, K]
        (dense: complex [L, C/Dc, K]), ``incoming`` one row of that,
        ``tail`` [C/Dc, B], and for int storage ``scales`` [L, C/Dc, 1] and
        ``inc_scale`` [1, C/Dc, 1] of ones — part rank d's block of
        ``neojax``'s global state."""
        cfg, dev = self.config, self.mesh.device
        shape = (self._ell, self._c, cfg.num_bins)
        inc = (1, self._c, cfg.num_bins)
        if self._split:
            shape, inc = (2,) + shape, (2,) + inc
        state = {
            "tail": torch.zeros((self._c, cfg.block_size), dtype=torch.float32, device=dev),
            "fdl": torch.zeros(shape, dtype=self._dtype, device=dev),
            "incoming": torch.zeros(inc, dtype=self._dtype, device=dev),
        }
        if self._quant:
            state["scales"] = torch.ones((self._ell, self._c, 1), dtype=torch.float32, device=dev)
            state["inc_scale"] = torch.ones((1, self._c, 1), dtype=torch.float32, device=dev)
        return state

    def _shard_state(self, state: dict) -> dict:
        cfg = self.config
        p, c, k, d = cfg.num_partitions, cfg.channels, cfg.num_bins, self.d_part
        lead = (2,) if self._split else ()
        shapes = {"tail": (c, cfg.block_size), "fdl": lead + (p, c, k), "incoming": lead + (d, c, k),
                  "scales": (p, c, 1), "inc_scale": (d, c, 1)}
        specs = self._specs()
        return {key: self.mesh.place(val, specs[key], shapes[key]) for key, val in state.items()}

    # -- public -----------------------------------------------------------

    def shard_filter(self, filt) -> torch.Tensor:
        """Filter [P, C|1, K] complex (host or tensor) -> this rank's
        partitions ``[d*L, (d+1)*L)`` (and channels, for a per-channel
        filter), twice over along the partition axis, on its device:
        f32 planes [2, 2L, C', K] for the split-plane storages, complex
        [2L, C', K] for dense. A shared filter keeps C' = 1."""
        cfg = self.config
        filt = filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt)
        filt = filt.astype(np.complex64)
        shared = filt.shape[1] == 1
        spec = ("part", None if shared else "ch", None)
        local = self.mesh.place(filt, spec, (cfg.num_partitions, filt.shape[1], cfg.num_bins))
        local = torch.cat([local, local], dim=0)
        if self._split:
            return torch.stack([local.real, local.imag]).contiguous()
        return local.contiguous()

    def process(self, filt, state, signal):
        """Stream ``signal`` ([C, T], host or tensor). ``state`` is this
        rank's (from :meth:`init_state` or an earlier call) or ``neojax``'s
        global layout (cut here). Returns (this rank's state, its output
        [C/Dc, T] — channels ``[j*C/Dc, (j+1)*C/Dc)`` for "ch" index j,
        the same on every part rank)."""
        cfg = self.config
        mesh = self.mesh
        b, n, ell = cfg.block_size, cfg.transform_size, self._ell
        first = mesh.coords["part"] == 0
        perm = [(i, (i + 1) % self.d_part) for i in range(self.d_part)]
        state = self._shard_state(state)
        blocks, length = stream_blocks(place_signal(signal, cfg.channels, mesh), b)

        tail, fdl, inc = state["tail"], state["fdl"], state["incoming"]
        scl, incs = state.get("scales"), state.get("inc_scale")
        w = 0  # ring slot of age 0; slot i holds age (i - w) mod L
        outs = []
        for block in blocks:
            frame = torch.cat([tail, block], dim=-1)
            w = (w - 1) % ell
            rows = slice(ell - w, 2 * ell - w)  # filt[(i - w) mod L] for slot i
            if self._split:
                spec = torch.stack(mb.rfft_split(frame, n))  # [2, C, K]
                if self._quant:
                    q, my_scale = fdl_lib._quantize(spec, self._dtype)
                    fdl[:, w] = q if first else inc[:, 0]
                    scl[w] = my_scale if first else incs[0]
                else:
                    fdl[:, w] = spec.to(self._dtype) if first else inc[:, 0]
                acc_re, acc_im = fdl_mac(fdl, filt[0, rows], filt[1, rows],
                                         scl[..., 0] if self._quant else None)
                acc = psum(torch.stack([acc_re, acc_im]), mesh, "part")
                old = (w - 1) % ell
                if self._quant:
                    row, row_scale = ppermute((fdl[:, old], scl[old]), mesh, "part", perm)
                    incs = row_scale[None]
                else:
                    row = ppermute(fdl[:, old], mesh, "part", perm)
                inc = row[:, None]
                y = mb.irfft_split(acc[0], acc[1], n)
            else:
                spec = fft_api.rfft(frame, n=n)
                fdl[w] = spec if first else inc[0]
                acc = psum(torch.sum(fdl * filt[rows], dim=0), mesh, "part")
                inc = ppermute(fdl[(w - 1) % ell], mesh, "part", perm)[None]
                y = fft_api.irfft(acc, n=n)
            outs.append(y[..., b:])
            tail = block

        # back to newest-first: slot j holds age j
        dim = 1 if self._split else 0
        fdl.copy_(torch.roll(fdl, -w, dims=dim))
        new_state = {"tail": tail.clone(), "fdl": fdl, "incoming": inc.contiguous()}
        if self._quant:
            scl.copy_(torch.roll(scl, -w, dims=0))
            new_state["scales"] = scl
            new_state["inc_scale"] = incs.contiguous()
        out = unstream_blocks(torch.stack(outs), length) if outs else blocks.new_zeros((self._c, 0))
        return new_state, out
