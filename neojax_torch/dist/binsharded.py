"""Bin-sharded streaming convolution: model-parallel over the spectrum
width (``neojax.dist.binsharded``).

Frequency bins are independent in the FDL MAC
(``multiply_add.hpp:280-301``), so the delay line, the filter and the MAC
split over the mesh axis "bin", and everything but one sum is local,
because the DFT as a product distributes over its contraction:

  - forward: each rank computes only its bin columns of the real DFT,
    ``frame @ C[:, k_shard]`` — no spectrum is ever whole;
  - the ring insert at ``pos`` and the partition MAC (B1,
    ``kernels.fdl_mac``, on the ring-rotated slice of the tile-reversed
    local filter) are elementwise in k: local;
  - inverse: a contraction over k, so each rank computes a partial
    time-domain block from its bins, ``acc_re @ A + acc_im @ B``, and one
    :func:`~neojax_torch.dist.mesh.psum` over "bin" reassembles it — one
    [C/Dc, 2B] f32 block per step, independent of P and K.

Composes with channel sharding ("ch"). The odd bin count K = B + 1 is
zero-padded to ``k_pad``, a multiple of the "bin" size (514 at B = 512 over
two ranks: 257 lanes a shard, which B1 runs one lane a thread): padded bins
carry zero filter weight and zero inverse rows, so results are exact.

Quantized storages keep one dynamic scale per (partition, channel, bin
shard), ``scl`` [P, C, D]: each rank quantizes its slice against its own
per-channel peak and dequantizes inside the MAC — no collective rides the
quantization. A run is therefore comparable with ``neojax`` only at the
same "bin" size.
"""

from __future__ import annotations

import numpy as np
import torch

from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv.convolver import PartitionedConfig, _np_tile_reverse
from neojax_torch.conv.overlap import stream_blocks, unstream_blocks
from neojax_torch.core.device import ieee_float32
from neojax_torch.dist.mesh import Mesh, psum
from neojax_torch.dist.sharded import place_signal
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.kernels.fdl_mac import fdl_mac

__all__ = ["BinShardedConvolver"]


class BinShardedConvolver:
    """UPOLS streaming convolver sharded over ("bin", "ch") mesh axes."""

    def __init__(self, config: PartitionedConfig, mesh: Mesh):
        if config.storage == "dense":
            raise NotImplementedError(
                "bin sharding is split-plane only (complex64 never touches "
                "a device); use split/bf16/int16/int8"
            )
        if "bin" not in mesh.shape:
            raise ValueError('mesh must have a "bin" axis')
        self.config = config
        self.mesh = mesh
        self.d_bin = mesh.shape["bin"]
        self.d_ch = mesh.shape.get("ch", 1)
        if config.channels % self.d_ch:
            raise ValueError(f"channels {config.channels} not divisible by mesh ch={self.d_ch}")
        k = config.num_bins
        self.k_pad = -(-k // self.d_bin) * self.d_bin
        self._quant = config.storage in ("int8", "int16")
        self._dtype = fdl_lib.STORAGE_DTYPES[config.storage]
        self._c = config.channels // self.d_ch
        self._kl = self.k_pad // self.d_bin
        self._mats = None

    def _local_mats(self):
        """This rank's bin columns of the padded forward matrices [N, K_l]
        and rows of the inverse ones [K_l, N], f32 on its device."""
        if self._mats is None:
            n, k, kp = self.config.transform_size, self.config.num_bins, self.k_pad
            c, s = (m.cpu() for m in mb.rfft_matrices(n, "cpu"))
            a, b = (m.cpu() for m in mb.irfft_matrices(n, "cpu"))
            cols = self.mesh.block(("bin",), (kp,))[0]
            pad_c = torch.zeros((n, kp)), torch.zeros((n, kp))
            pad_a = torch.zeros((kp, n)), torch.zeros((kp, n))
            pad_c[0][:, :k], pad_c[1][:, :k], pad_a[0][:k], pad_a[1][:k] = c, s, a, b
            self._mats = tuple(m[:, cols].contiguous().to(self.mesh.device) for m in pad_c) + tuple(
                m[cols].contiguous().to(self.mesh.device) for m in pad_a)
        return self._mats

    def init_state(self) -> dict:
        """This rank's zero state: ``fdl`` [2, P, C/Dc, K_l] of the storage
        dtype, ``tail`` [C/Dc, B], ``pos`` 0 and for int storage ``scl``
        [P, C/Dc, 1] of ones — its block of ``neojax``'s global state."""
        cfg, dev = self.config, self.mesh.device
        p = cfg.num_partitions
        state = {
            "tail": torch.zeros((self._c, cfg.block_size), dtype=torch.float32, device=dev),
            "fdl": torch.zeros((2, p, self._c, self._kl), dtype=self._dtype, device=dev),
            "pos": 0,
        }
        if self._quant:
            state["scl"] = torch.ones((p, self._c, 1), dtype=torch.float32, device=dev)
        return state

    def _shard_state(self, state: dict) -> dict:
        cfg = self.config
        p, c = cfg.num_partitions, cfg.channels
        place = self.mesh.place
        out = {"tail": place(state["tail"], ("ch", None), (c, cfg.block_size)),
               "fdl": place(state["fdl"], (None, None, "ch", "bin"), (2, p, c, self.k_pad)),
               "pos": int(state["pos"])}
        if self._quant:
            out["scl"] = place(state["scl"], (None, "ch", "bin"), (p, c, self.d_bin))
        return out

    def shard_filter(self, filt) -> torch.Tensor:
        """[P, C|1, K] complex (host or tensor; the layout of
        ``PipelineConvolver.shard_filter``'s input) -> this rank's bins (and
        channels, for a per-channel filter) of the tile-reversed, zero-padded
        split planes, [2, 2P, C', K_l] f32 on its device. A shared filter
        keeps C' = 1."""
        cfg = self.config
        filt = filt.detach().cpu().numpy() if isinstance(filt, torch.Tensor) else np.asarray(filt)
        filt = filt.astype(np.complex64)
        p, cf, k = filt.shape
        if k != cfg.num_bins or p != cfg.num_partitions or cf not in (1, cfg.channels):
            raise ValueError(f"filter shape {filt.shape} mismatch")
        pad = np.zeros((p, cf, self.k_pad - k), np.complex64)
        tiled = _np_tile_reverse(np.concatenate([filt, pad], axis=2))  # [2P, C', Kp]
        planes = np.stack([tiled.real, tiled.imag]).astype(np.float32)
        spec = (None, None, "ch" if cf > 1 else None, "bin")
        return self.mesh.place(planes, spec, planes.shape)

    def process(self, filt, state, signal):
        """Stream ``signal`` ([C, T], host or tensor). ``state`` is this
        rank's (:meth:`init_state`, an earlier call) or ``neojax``'s global
        layout (cut here). Returns (this rank's state, its output [C/Dc, T],
        the same on every bin rank)."""
        cfg = self.config
        b, p = cfg.block_size, cfg.num_partitions
        cmat, smat, amat, bmat = self._local_mats()
        state = self._shard_state(state)
        blocks, length = stream_blocks(place_signal(signal, cfg.channels, self.mesh), b)
        tail, fdl, pos, scl = state["tail"], state["fdl"], state["pos"], state.get("scl")
        outs = []
        for block in blocks:
            frame = torch.cat([tail, block], dim=-1)  # [C_l, 2B]
            with ieee_float32():
                spec = torch.stack([frame @ cmat, frame @ smat])  # this rank's bins
            if self._quant:
                fdl[:, pos], scl[pos] = fdl_lib._quantize(spec, self._dtype)
            else:
                fdl[:, pos] = spec.to(self._dtype)
            rows = slice(p - 1 - pos, 2 * p - 1 - pos)
            acc_re, acc_im = fdl_mac(fdl, filt[0, rows], filt[1, rows], scl[..., 0] if self._quant else None)
            with ieee_float32():
                y = acc_re @ amat + acc_im @ bmat  # partial inverse from this rank's bins
            outs.append(psum(y, self.mesh, "bin")[..., b:])
            pos = (pos + 1) % p
            tail = block
        new_state = {"tail": tail.clone(), "fdl": fdl, "pos": pos}
        if self._quant:
            new_state["scl"] = scl
        out = unstream_blocks(torch.stack(outs), length) if outs else blocks.new_zeros((self._c, 0))
        return new_state, out
