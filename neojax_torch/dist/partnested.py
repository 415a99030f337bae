"""Partition-sharded nested (two-level FDL) engine: one big IR over many
ranks (``neojax.dist.partnested``).

The nested engine's meta-FDL ``[2, P2, C, K, 2S]`` lives on one card; past
a few minutes of IR it does not fit. This module splits the
meta-partition axis over the mesh "part" axis (the partition-reduce axis
of ``uniform_partitioned_convolver.hpp:56-59``), composing with "ch":

  - part rank d owns meta-ages ``[d*L, (d+1)*L)`` (L = P2/D) as a local
    ring of L rows;
  - per chunk every rank evicts its oldest row and hands it, with its int
    scale groups, to rank d+1 in one cyclic
    :func:`~neojax_torch.dist.mesh.ppermute` — the row ages by exactly one
    chunk in transit, the age at which it enters the next rank's window;
  - rank 0 inserts the freshly transformed meta row instead;
  - the meta MAC over the L local rows — B5 (``kernels.nested_mac``) on
    the ring-rotated slice ``filt[L-1-pos_l : 2L-1-pos_l]`` of a shared
    filter; plain tensor ops for a per-channel filter, as
    ``conv.nested._meta_mac`` does and for the same reason (B5, like the
    Pallas kernel, takes shared filters) — then one
    :func:`~neojax_torch.dist.mesh.psum` over "part";
  - the transforms and block bookkeeping are the same on every part rank,
    so the gain is the meta-FDL read and, above all, capacity: each rank
    holds 1/D of the meta-FDL.

Params and state are this flavour's own (local rings arrange rows
differently from the single-card ring): ``partnested_filter_params`` /
``partnested_init_state`` build ``neojax``'s global layout, which
:class:`PartShardedNested` cuts to each rank. P2 is padded to a multiple
of the shard count, so a run is comparable with ``neojax`` only at the
same "part" size. Outputs match ``process_nested`` to f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch.conv import nested as nested_lib
from neojax_torch.conv.convolver import PartitionedConfig, _canon_partitions, _host
from neojax_torch.core.device import resolve_device
from neojax_torch.dist.mesh import Mesh, ppermute, psum
from neojax_torch.dist.sharded import place_signal
from neojax_torch.fft import matmul_backend as mb

__all__ = [
    "partnested_filter_params",
    "partnested_init_state",
    "PartShardedNested",
]


def _p2(config: PartitionedConfig, s: int, num_shards: int) -> int:
    """Meta-partitions P2 = ceil(P / S), padded to a multiple of the shards."""
    p2 = -(-config.num_partitions // s)
    return -(-p2 // num_shards) * num_shards


def partnested_filter_params(config: PartitionedConfig, partitions, chunk_blocks: int, num_shards: int,
                             mask=None, device=None) -> dict:
    """Meta-filter params laid out for part-sharding, on ``device`` (None:
    the card): per shard a tile-reversed local slice (so the ring-rotated
    filter is a contiguous slice), stacked so the global
    ``[D * 2L, C', K, 2S]`` splits into ``[2L, C', K, 2S]`` a rank.

    ``partitions``: [P, K], [1, P, K] or [C, P, K] complex spectra.
    """
    device = resolve_device(device)
    filt = _canon_partitions(config, _host(partitions)).astype(np.complex64)
    if mask is not None:
        m = np.asarray(_host(mask), bool)
        if m.ndim == 2:
            m = m[None]
        m = np.moveaxis(m, 0, 1)
        if m.shape[0] < filt.shape[0]:
            m = np.concatenate([m, np.zeros((filt.shape[0] - m.shape[0],) + m.shape[1:], bool)], axis=0)
        filt = np.where(np.broadcast_to(m, filt.shape), filt, 0)

    fre, fim, p2 = nested_lib._meta_fft_filter(np.real(filt), np.imag(filt), chunk_blocks)
    pad = _p2(config, chunk_blocks, num_shards) - p2  # zero meta-partitions
    if pad:
        z = np.zeros((pad,) + fre.shape[1:], fre.dtype)
        fre, fim = np.concatenate([fre, z]), np.concatenate([fim, z])
    ell = fre.shape[0] // num_shards

    def tile(f):  # [P2, C', K, 2S] -> [D * 2L, C', K, 2S]
        out = []
        for d in range(num_shards):
            local = f[d * ell : (d + 1) * ell][::-1]
            out += [local, local]
        return np.ascontiguousarray(np.concatenate(out))

    dtype = torch.bfloat16 if config.storage == "bf16" else torch.float32
    return {key: torch.from_numpy(tile(f)).to(device=device, dtype=dtype)
            for key, f in (("filt_re", fre), ("filt_im", fim))}


def _dims(params: dict, num_shards: int) -> tuple[int, int, int]:
    """(p2, ell, s) from the global tiled filter's shapes."""
    ell = params["filt_re"].shape[0] // (2 * num_shards)
    return ell * num_shards, ell, params["filt_re"].shape[-1] // 2


def partnested_init_state(config: PartitionedConfig, params: dict, num_shards: int, device=None) -> dict:
    """The global zero state (``neojax``'s layout) on ``device`` (None: the
    params' device): ``tail`` [C, B], ``prev`` [2, C, K, S], ``fdl``
    [2, P2, C, K, 2S], ``pos`` 0 and int ``scales`` [P2, C, K, G]."""
    device = params["filt_re"].device if device is None else torch.device(device)
    c, k = config.channels, config.num_bins
    p2, _, s = _dims(params, num_shards)
    state = {
        "tail": torch.zeros((c, config.block_size), dtype=torch.float32, device=device),
        "prev": torch.zeros((2, c, k, s), dtype=nested_lib._prev_dtype(config), device=device),
        "fdl": torch.zeros((2, p2, c, k, 2 * s), dtype=nested_lib._storage_dtype(config), device=device),
        "pos": 0,
    }
    if config.storage in ("int8", "int16"):
        state["scales"] = torch.ones((p2, c, k, nested_lib._quant_groups(config, s)), dtype=torch.float32,
                                     device=device)
    return state


class PartShardedNested:
    """Partition(+channel)-sharded ``process_nested`` over a mesh
    ``("part", "ch")``."""

    def __init__(self, config: PartitionedConfig, mesh: Mesh, chunk_blocks: int):
        self.config = config
        self.mesh = mesh
        self.s = chunk_blocks
        self.d_part = mesh.shape["part"]
        self.d_ch = mesh.shape.get("ch", 1)
        if config.channels % self.d_ch:
            raise ValueError(f"channels {config.channels} not divisible by mesh ch={self.d_ch}")
        self._p2 = _p2(config, chunk_blocks, self.d_part)

    # -- sharding helpers --------------------------------------------------

    def shard_params(self, params: dict) -> dict:
        """This rank's [2L, C'|Cl, K, 2S] slice of the global tiled filter
        (this rank's channels too, for a per-channel filter), on its
        device. Takes this rank's slice as it is."""
        cf = params["filt_re"].shape[1]
        ch = "ch" if cf > 1 else None
        c = self.config.channels if cf > 1 else 1
        shape = (2 * self._p2, c, self.config.num_bins, 2 * self.s)
        return {key: self.mesh.place(val, ("part", ch), shape) for key, val in params.items()}

    def shard_state(self, state: dict) -> dict:
        """This rank's state: its channels, and its L rows of ``fdl`` and
        ``scales``; ``pos`` (chunks streamed) stays an int."""
        cfg, s, p2 = self.config, self.s, self._p2
        c, k = cfg.channels, cfg.num_bins
        place = self.mesh.place
        out = {"tail": place(state["tail"], ("ch", None), (c, cfg.block_size)),
               "prev": place(state["prev"], (None, "ch"), (2, c, k, s)),
               "fdl": place(state["fdl"], (None, "part", "ch"), (2, p2, c, k, 2 * s)),
               "pos": int(state["pos"])}
        if "scales" in state:
            g = state["scales"].shape[-1]
            out["scales"] = place(state["scales"], ("part", "ch"), (p2, c, k, g))
        return out

    # -- the sharded chunk pipeline ----------------------------------------

    def process(self, params, state, signal):
        """Stream ``signal`` ([C, T], host or tensor; T padded to a multiple
        of S*B, the output trimmed). ``params``/``state`` are global (cut
        here) or this rank's. Returns (this rank's state, its output
        [C/Dc, T], the same on every part rank)."""
        cfg, s, mesh = self.config, self.s, self.mesh
        b, n = cfg.block_size, cfg.transform_size
        fwd_prec, inv_prec = nested_lib._fft_precisions(cfg)
        params = self.shard_params(params)
        state = self.shard_state(state)
        ell = state["fdl"].shape[1]
        first = mesh.coords["part"] == 0
        perm = [(i, (i + 1) % self.d_part) for i in range(self.d_part)]
        if params["filt_re"].shape[1] == 1:
            mac_params = params  # tile-reversed: B5 on the rotated slice
        else:  # untiled [L, Cl, K, 2S] (ages 0..L-1) for the per-channel route
            mac_params = {key: val[:ell].flip(0) for key, val in params.items()}

        signal = place_signal(signal, cfg.channels, mesh)
        c, t_len = signal.shape
        num_chunks = -(-t_len // (s * b))
        chunks = F.pad(signal, (0, num_chunks * s * b - t_len)).reshape(c, num_chunks, s, b)

        tail, prev, fdl, pos = state["tail"], state["prev"], state["fdl"], state["pos"]
        scales = state.get("scales")
        outs = []
        for i in range(num_chunks):
            chunk = chunks[:, i].transpose(0, 1)  # [S, C, B]
            if cfg.scheme == "upols":
                frames = torch.cat([torch.cat([tail[None], chunk[:-1]], dim=0), chunk], dim=-1)
                new_tail = chunk[-1]
            else:
                frames = F.pad(chunk, (0, n - b))
            sre, sim = mb.rfft_split(mb.round_operand(frames, fwd_prec), n)  # [S, C, K]
            cur = torch.stack([sre.permute(1, 2, 0), sim.permute(1, 2, 0)]).to(prev.dtype)  # [2, C, K, S]

            # ring hand-off: the oldest local row goes to the next part rank;
            # rank 0 inserts the fresh meta row, rank d > 0 the received one
            pos_l = pos % ell
            evict = (fdl[:, pos_l], scales[pos_l]) if scales is not None else (fdl[:, pos_l],)
            recv = ppermute(evict, mesh, "part", perm)
            if first:
                xre, xim = mb.meta_fft(mb.round_operand(torch.cat([prev[0], cur[0]], dim=-1), fwd_prec),
                                       mb.round_operand(torch.cat([prev[1], cur[1]], dim=-1), fwd_prec))
                nested_lib._meta_push(fdl, scales, pos_l, xre, xim)
            else:
                fdl[:, pos_l] = recv[0]
                if scales is not None:
                    scales[pos_l] = recv[1]
            acc_re, acc_im = nested_lib._meta_mac(cfg, mac_params, fdl, scales, pos_l)
            acc = psum(torch.stack([acc_re, acc_im]), mesh, "part")

            yre, yim = mb.meta_ifft_tail(mb.round_operand(acc[0], fwd_prec), mb.round_operand(acc[1], fwd_prec))
            y = mb.irfft_split(mb.round_operand(yre.permute(2, 0, 1), inv_prec),
                               mb.round_operand(yim.permute(2, 0, 1), inv_prec), n)  # [S, C, 2B]
            if cfg.scheme == "upols":
                out = y[..., b:]
            else:
                out = y[..., :b] + torch.cat([tail[None], y[:-1, :, b:]], dim=0)
                new_tail = y[-1, :, b:]
            outs.append(out)
            tail = new_tail.to(torch.float32).clone()
            prev = cur
            pos += 1

        new_state = {"tail": tail, "prev": prev, "fdl": fdl, "pos": pos}
        if scales is not None:
            new_state["scales"] = scales
        if num_chunks:
            out = torch.stack(outs).permute(2, 0, 1, 3).reshape(c, num_chunks * s * b)[:, :t_len]
        else:
            out = signal[:, :0]
        return new_state, out
