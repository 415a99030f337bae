"""Uniformly-partitioned FDL convolvers (UPOLS / UPOLA) on PyTorch and CUDA.

Port of ``neojax.conv.convolver``, the counterpart of the reference's
``src/neo/convolution/uniform_partitioned_convolver.hpp:14-66`` and its
aliases (``dense_convolver.hpp:20-39``, ``sparse_convolver.hpp:16-21``):

  config  (static)  : block size, partitions, channels, scheme, storage
  params  (dict)    : partitioned filter spectra (+ sparsity mask)
  state   (dict)    : {frame/overlap tail, FDL (+ scales), dcny, pos}

The dicts have the JAX package's keys and shapes (``neojax_torch.convert``
carries them across), except that the ring position ``state["pos"]`` is a
Python int, so no kernel launch waits on a device-to-host copy, and the
shared fused filter is one ``filt_rim [2P, 1, 2B]`` copy (the TPU's eight
pre-shifted ``filt_rim8`` copies were a Mosaic alignment workaround).

Per block (UPOLS): frame = [previous block | new block] (2B samples) ->
rfft -> push into the FDL -> MAC over partitions against the filter ->
irfft -> last B samples. UPOLA: frame = zero-padded block, output = first
B samples + carried overlap.

``step`` and ``process`` **update the FDL ring, its scales and ``dcny`` in
place** (the tensors of the state passed in are the tensors of the state
returned) — the PyTorch replacement for XLA's buffer donation. The plain
CPU route does the same, so the two routes can stand in for each other.

Routes. On a packed split-plane ring with block <= 1024 and the kernel MAC
(the default), ``process`` runs the whole UPOLS stream through
``kernels.fused_stream`` (B3) and ``step`` runs ``kernels.fused_block_step``
(B2); otherwise ``step`` transforms on ``torch.fft`` and reduces through
``kernels.fdl_mac`` (B1) or, with ``mac_backend="xla"`` (or ``"torch"``), plain tensor
ops. Each kernel wrapper launches its CUDA kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors.

Sparse filters (a sparsity mask, the ``sparse_*`` aliases): the dropped
bins are zeroed and ``filter_params`` tabulates the active tiles of every
ring rotation, as neojax does (``sp_*`` params, ``kernels.sparse_mac``).
B2/B3 then visit only the active partition chunks (and lane prefixes), and
the unfused MAC runs B4 (``kernels.sparse_fdl_mac``) over the active
(k-tile, p-chunk) pairs instead of B1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch import trace
from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv.overlap import stream_blocks, unstream_blocks
from neojax_torch.conv.sparse import sparsity_mask
from neojax_torch.core.device import as_signal, resolve_device
from neojax_torch.fft import api as fft_api
from neojax_torch.fft import matmul_backend
from neojax_torch.kernels.fdl_mac import choose_chunks, fdl_mac
from neojax_torch.kernels.fused_step import (
    MATRIX_DTYPES,
    MAX_BLOCK,
    WINDOW,
    fused_block_step,
    fused_chunk_rows,
    fused_stream,
    quantize_rows,
    ring_writeback,
    tap_tile_table,
    window_forward,
)
from neojax_torch.kernels.sparse_mac import (
    build_chunk_schedule,
    build_sparse_schedule,
    lane_widths,
    sparse_fdl_mac,
    tile_live_table,
)

__all__ = [
    "PartitionedConfig",
    "filter_params",
    "init_state",
    "insert_only_step",
    "step",
    "process",
    "Convolver",
    "make_convolver",
    "upols_convolver",
    "upola_convolver",
    "upola_convolver_v2",
    "split_upols_convolver",
    "split_upola_convolver",
    "sparse_upols_convolver",
    "sparse_upola_convolver",
]



# mac_backend -> whether the kernel route runs (the JAX package's spellings
# first, then the port's own)
_MAC_ROUTES = {"auto": True, "pallas": True, "xla": False, "kernel": True, "torch": False}


@dataclasses.dataclass(frozen=True)
class PartitionedConfig:
    block_size: int
    num_partitions: int
    channels: int
    scheme: str = "upols"  # "upols" | "upola"
    storage: str = "dense"  # "dense" | "split" | "bf16" | "int16" | "int8"
    # ``fft.api`` backend ("xla", "matmul", "auto"; None: the process
    # default) of the transforms that have a choice: the dense storage's and
    # the non-packed split layout's. The packed layout has one route (the
    # kernels, or ``torch.fft`` around the plain MAC) and ignores it.
    fft_backend: str | None = None
    # "ring": ring buffer + write position (one-row insert, contiguous
    # rotated-filter slice). "shift": newest-first shift layout.
    layout: str = "ring"
    # Partition MAC engine of the split-plane storages, in the JAX
    # package's spelling: "auto" and "pallas" take the kernel route (B1,
    # ``kernels.fdl_mac``, whose wrapper runs its plain version on CPU
    # tensors), "xla" plain float32 tensor ops (``conv.fdl.fdl_mac_split``).
    # "kernel" and "torch" are the port's own names of the two routes.
    mac_backend: str = "auto"
    # Fused per-block kernels (B2/B3). None = auto: on for packed ring
    # layouts with block <= 1024 and the kernel MAC.
    fused: bool | None = None
    # Packed-512 spectrum layout (B lanes: Nyquist.re in the im-plane's DC
    # lane, exact DC/Nyquist history in the ``dcny`` side-carry). None =
    # auto (on for ring-layout split-plane storages with even block size).
    packed: bool | None = None

    @property
    def transform_size(self) -> int:
        return 2 * self.block_size

    @property
    def num_bins(self) -> int:
        return self.block_size + 1

    @property
    def use_packed(self) -> bool:
        if self.packed is not None:
            return self.packed
        return self.storage != "dense" and self.layout == "ring" and self.block_size % 2 == 0

    def __post_init__(self):
        if self.scheme not in ("upols", "upola"):
            raise ValueError(f"unknown scheme: {self.scheme!r}")
        if self.storage not in fdl_lib.STORAGE_DTYPES:
            raise ValueError(f"unknown storage: {self.storage!r}")
        if self.layout not in ("ring", "shift"):
            raise ValueError(f"unknown layout: {self.layout!r}")
        if self.mac_backend not in _MAC_ROUTES:
            raise ValueError(f"unknown mac_backend: {self.mac_backend!r}")
        if self.packed and (self.storage == "dense" or self.layout != "ring" or self.block_size % 2):
            raise ValueError(
                "packed layout requires a split-plane storage, ring layout "
                "and an even block size"
            )
        if self.fused and not self.use_packed:
            raise ValueError("fused=True requires the packed ring layout")
        if self.fused and self.block_size > MAX_BLOCK:
            raise ValueError(f"fused=True requires block_size <= {MAX_BLOCK}")


def _canon_partitions(config: PartitionedConfig, partitions: np.ndarray) -> np.ndarray:
    """[P,K] / [C,P,K] / [1,P,K] -> [P, C', K] with C' in {1, channels}."""
    if partitions.ndim == 2:
        partitions = partitions[None]
    if partitions.ndim != 3:
        raise ValueError(f"filter partitions must be rank 2 or 3, got {partitions.ndim}")
    c = partitions.shape[0]
    if c not in (1, config.channels):
        raise ValueError(
            f"filter has {c} channels, config expects 1 (shared) or {config.channels}"
        )
    if partitions.shape[1] != config.num_partitions or partitions.shape[2] != config.num_bins:
        raise ValueError(
            f"filter shape {partitions.shape[1:]} != "
            f"({config.num_partitions}, {config.num_bins})"
        )
    return np.moveaxis(partitions, 0, 1)  # [P, C', K]


def _np_tile_reverse(filt: np.ndarray) -> np.ndarray:
    rev = filt[::-1]
    return np.concatenate([rev, rev], axis=0)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def filter_params(config: PartitionedConfig, partitions, sparsity: Any = None,
                  device=None) -> dict:
    """Build filter params from partitioned spectra ([C|1, P, K] complex).

    Filter preparation runs host-side in numpy; only the final tensors move
    to ``device``. ``sparsity``: optional predicate ``(row, col, value) ->
    bool`` or a boolean keep-mask broadcastable to the filter; dropped bins
    are zeroed and the mask is kept as ``params["mask"]``. Ring configs of a
    split-plane storage also get the tile schedules of
    :func:`_schedule_params` (neojax's ``sp_*`` keys). ``device`` None
    means the card (``core.device.resolve_device``).
    """
    device = resolve_device(device)
    filt = _canon_partitions(config, _host(partitions)).astype(np.complex64)

    mask = None
    if sparsity is not None:
        if callable(sparsity):
            per_channel = np.moveaxis(filt, 1, 0)  # [C', P, K]
            mask = np.moveaxis(sparsity_mask(per_channel, sparsity), 0, 1)
        else:
            # Channel-first like the filter input ([P,K] or [C|1,P,K]);
            # missing (zero-padded) partitions are padded with False.
            mask = _host(sparsity).astype(bool)
            if mask.ndim == 2:
                mask = mask[None]
            mask = np.moveaxis(mask, 0, 1)
            if mask.shape[0] < filt.shape[0]:
                pad = np.zeros((filt.shape[0] - mask.shape[0],) + mask.shape[1:], bool)
                mask = np.concatenate([mask, pad], axis=0)
            mask = np.broadcast_to(mask, filt.shape).copy()
        filt = np.where(mask, filt, 0).astype(np.complex64)

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype).contiguous()

    params = {}
    ring = config.layout == "ring"
    if config.storage == "dense":
        params["filt"] = put(_np_tile_reverse(filt) if ring else filt)
    elif config.use_packed:
        # Packed-512 layout: lanes 0..B-1 = bins 0..B-1, the im-plane's
        # lane 0 holding Nyquist.re; the DC/Nyquist reals also ride a
        # [2P, C', 2] side filter for the exact lane-0 fixup.
        b = config.block_size
        fr = np.real(filt[:, :, :b]).astype(np.float32)
        fi = np.imag(filt[:, :, :b]).astype(np.float32)
        fi[:, :, 0] = np.real(filt[:, :, b])
        fdcny = np.stack([np.real(filt[:, :, 0]), np.real(filt[:, :, b])], axis=-1).astype(np.float32)
        params["filt_re"] = put(_np_tile_reverse(fr))
        params["filt_im"] = put(_np_tile_reverse(fi))
        params["filt_dcny"] = put(_np_tile_reverse(fdcny))
        # Lane-packed re|im planes for the fused kernels, storage-matched
        # dtype (bf16 for the bf16/int8 storages, f32 for split/int16).
        rim = np.concatenate([_np_tile_reverse(fr), _np_tile_reverse(fi)], axis=-1)  # [2P, C', 2B]
        params["filt_rim"] = put(rim, MATRIX_DTYPES[fdl_lib.STORAGE_DTYPES[config.storage]])
    else:
        fr = np.real(filt).astype(np.float32)
        fi = np.imag(filt).astype(np.float32)
        if ring:
            fr = _np_tile_reverse(fr)
            fi = _np_tile_reverse(fi)
        params["filt_re"] = put(fr)
        params["filt_im"] = put(fi)
    if mask is not None:
        params["mask"] = put(mask)
        params.update(_schedule_params(config, mask, device))
    return params


def _schedule_params(config: PartitionedConfig, mask: np.ndarray, device=None) -> dict:
    """The sparse schedules of a [P, C', K] keep-mask, with neojax's keys
    and geometry (``neojax/conv/convolver.py:233-270``), so the tables
    equal neojax's, and the port's own tables (:func:`port_tables`):

    - ring configs of a split-plane storage: B4's (k-tile, p-chunk) tables
      ``sp_k_idx``/``sp_p_idx``/``sp_flags`` int32 [P, L] and the lane mask
      ``sp_lane`` bool [K] (K = B packed, B + 1 otherwise), at
      ``choose_chunks``' geometry;
    - packed configs also: B2's chunk tables ``sp_c_idx`` (chunk | width
      code << 16) and ``sp_c_flags``, at ``fused_chunk_rows``' geometry.

    The geometry depends on the channel count, so a Convolver rebuilds
    these when it binds a mono filter to more channels.
    """
    if config.storage == "dense" or config.layout != "ring":
        return {}

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    sdt = fdl_lib.STORAGE_DTYPES[config.storage]
    p = mask.shape[0]
    k_sched, k_tile, pc = _tile_geometry(config, p)
    sched = build_sparse_schedule(mask[:, :, :k_sched], pc, k_tile)
    out = {
        "sp_k_idx": put(sched["k_idx"], torch.int32),
        "sp_p_idx": put(sched["p_idx"], torch.int32),
        "sp_flags": put(sched["flags"], torch.int32),
        "sp_lane": put(sched["lane_mask"], torch.bool),
    }
    if config.use_packed:
        pcf = fused_chunk_rows(sdt, p, config.channels, config.block_size)
        csched = build_chunk_schedule(mask, pcf, lanes=config.block_size)
        # every width code must be one the kernels decode (B >> code)
        assert int(np.max(csched["c_idx"] >> 16)) < len(lane_widths(config.block_size))
        out["sp_c_idx"] = put(csched["c_idx"], torch.int32)
        out["sp_c_flags"] = put(csched["flags"], torch.int32)
    out.update(port_tables(config, out, mask))
    return out


# the keys of :func:`port_tables`
PORT_TABLES = ("tile_live", "tap_tiles")


def port_tables(config: PartitionedConfig, tables: dict, mask: np.ndarray) -> dict:
    """A masked filter's tables that only this package keeps (not neojax
    keys), on the device of its ``sp_*`` schedule ``tables`` (``{}``
    without them): B4's ``tile_live`` uint8 [P, P / pc, NK] of ``sp_k_idx``
    / ``sp_p_idx`` / ``sp_flags``, and, beside B2's chunk tables, B3's
    ``tap_tiles`` uint8 [P, B / 8] of the [P, C', K] or [P, K] keep-mask
    ``mask`` (``kernels.fused_step.tap_tile_table``). Every entry point
    that builds or carries params takes them from here."""
    if "sp_k_idx" not in tables:
        return {}
    k_idx = tables["sp_k_idx"]
    p = k_idx.shape[0]
    k, k_tile, pc = _tile_geometry(config, p)
    out = {"tile_live": tile_live_table(k_idx, tables["sp_p_idx"], tables["sp_flags"], p // pc, -(-k // k_tile))}
    if "sp_c_idx" in tables:
        tiles = tap_tile_table(mask, config.block_size)
        out["tap_tiles"] = torch.from_numpy(tiles.astype(np.uint8)).to(k_idx.device)
    return out


def _tile_geometry(config: PartitionedConfig, p: int) -> tuple[int, int, int]:
    """(K, k_tile, p_chunk) of B4's tables: ``choose_chunks`` at the ring's
    lanes (B packed, B + 1 otherwise)."""
    k = config.block_size if config.use_packed else config.num_bins
    k_tile, pc = choose_chunks(fdl_lib.STORAGE_DTYPES[config.storage], p, config.channels, k)
    return k, k_tile, pc


def init_state(config: PartitionedConfig, device=None) -> dict:
    """Zero stream state on ``device`` (None: the card)."""
    device = resolve_device(device)
    state = {
        "tail": torch.zeros((config.channels, config.block_size), dtype=torch.float32, device=device),
    }
    if config.use_packed:
        state["fdl"], state["dcny"] = fdl_lib.fdl_packed_init(
            config.storage, config.num_partitions, config.channels, config.block_size, device
        )
    else:
        state["fdl"] = fdl_lib.fdl_init(
            config.storage, config.num_partitions, config.channels, config.num_bins, device
        )
    if config.layout == "ring":
        state["pos"] = 0
    return state


def _kernel_route(config: PartitionedConfig) -> bool:
    """Whether ``mac_backend`` asks for the kernel route: the one reading of
    its spellings, which the nested and hybrid engines ask too."""
    return _MAC_ROUTES[config.mac_backend]


def _use_kernel_mac(config: PartitionedConfig) -> bool:
    return config.storage != "dense" and _kernel_route(config)


def _use_fused(config: PartitionedConfig, params: dict) -> bool:
    if "sp_k_idx" in params and "sp_c_idx" not in params:
        return False  # masked non-packed ring configs run B4 per block
    if config.fused is not None:
        return config.fused
    return (
        config.use_packed
        and config.layout == "ring"
        and config.block_size <= MAX_BLOCK
        and _use_kernel_mac(config)
    )


def _frame(config: PartitionedConfig, state: dict, block: torch.Tensor) -> torch.Tensor:
    """The transform-size frame of one block (UPOLS sliding window / UPOLA
    zero-padding, ``overlap_save.hpp:90-95`` / ``overlap_add.hpp:214``)."""
    b = config.block_size
    if block.shape[-1] != b:
        raise ValueError(f"block size {block.shape[-1]} != configured {b}")
    block = block.to(torch.float32)
    if config.scheme == "upols":
        return torch.cat([state["tail"], block], dim=-1)  # [C, 2B]
    return F.pad(block, (0, config.transform_size - b))


def _spectrum_and_push(config: PartitionedConfig, state: dict, frame: torch.Tensor):
    """rfft the frame and insert the spectrum into the FDL (in place).

    Returns (state_update, spectrum): a dict of the changed state entries,
    and a complex tensor (dense storage) or an (re, im) tuple.
    """
    n = config.transform_size
    k = config.num_bins
    ring = config.layout == "ring"
    pos = state.get("pos")

    if config.storage == "dense":
        spec = fft_api.rfft(frame, n=n, backend=config.fft_backend)[..., :k]
        if ring:
            new_fdl = fdl_lib.fdl_ring_push_dense(state["fdl"], spec, pos)
        else:
            new_fdl = fdl_lib.fdl_push_dense(state["fdl"], spec)
        return {"fdl": new_fdl}, spec

    if config.use_packed:
        spec_re, spec_im = matmul_backend.rfft_packed_split(frame, n)
        new_fdl, new_dcny = fdl_lib.fdl_packed_push(state["fdl"], state["dcny"], spec_re, spec_im, pos)
        return {"fdl": new_fdl, "dcny": new_dcny}, (spec_re, spec_im)

    spec = fft_api.rfft(frame, n=n, backend=config.fft_backend)[..., :k]
    spec_re, spec_im = spec.real, spec.imag
    if ring:
        new_fdl = fdl_lib.fdl_ring_push_split(state["fdl"], spec_re, spec_im, pos)
    else:
        new_fdl = fdl_lib.fdl_push_split(state["fdl"], spec_re, spec_im)
    return {"fdl": new_fdl}, (spec_re, spec_im)


def _advance(config: PartitionedConfig, state: dict, update: dict, new_tail) -> dict:
    new_state = dict(state)
    new_state.update(update)
    new_state["tail"] = new_tail.to(torch.float32).clone()
    if config.layout == "ring":
        new_state["pos"] = (state["pos"] + 1) % config.num_partitions
    return new_state


def insert_only_step(config: PartitionedConfig, state: dict, block: torch.Tensor) -> dict:
    """Advance the FDL/tail state by one block WITHOUT the MAC + irfft (the
    warmup primitive of the time-sharded pipeline). The FDL is written in
    place; state after N insert-only steps equals N full steps'."""
    frame = _frame(config, state, block)
    update, _ = _spectrum_and_push(config, state, frame)
    tail = block if config.scheme == "upols" else state["tail"]
    return _advance(config, state, update, tail)


def warm_ring(config: PartitionedConfig, state: dict, blocks: torch.Tensor) -> dict:
    """The fused route's ring after P-1 ``insert_only_step`` pushes, in one
    batched pass: the warmup frames of ``blocks`` [P, C, B] transformed,
    quantized and written to ring slots 0..P-2 by B3's/B2's own stage
    kernels (UPOLS: the hop-B frames ``[block j-1 | block j]`` and B3's
    matrix; UPOLA: the zero-padded blocks 0..P-2 and B2's matrix, taken as
    the even frames of a zero-interleaved signal), with ``dcny`` from the
    same float64 frame sums (:func:`_frame_sums`) as ``_dcfix_sequence`` /
    ``_fused_step``. So the ring holds the rows the stream itself would
    have written. The UPOLS tail and the UPOLA overlap are the caller's."""
    p, b, n = config.num_partitions, config.block_size, config.transform_size
    c = blocks.shape[1]
    planes, scales = state["fdl"] if isinstance(state["fdl"], tuple) else (state["fdl"], None)
    mdt = MATRIX_DTYPES[planes.dtype]
    if config.scheme == "upols":
        x = blocks.permute(1, 0, 2).reshape(c, p * b)  # frame j = [block j-1 | block j]
        cs, _ = matmul_backend.packed_stream_mats(n, mdt, blocks.device)
        frames, hop = p - 1, 1
        bs, na = _frame_sums(blocks)
        pairs = torch.stack([bs[:-1] + bs[1:], na[:-1] + na[1:]], dim=-1)
    else:
        padded = F.pad(blocks[:-1], (0, b))  # [P-1, C, N]
        x = padded.permute(1, 0, 2).reshape(c, 2 * (p - 1) * b)  # the even frames are the blocks
        cs, _ = matmul_backend.packed_mats(n, mdt, blocks.device)
        frames, hop = 2 * (p - 1) - 1, 2
        pairs = torch.stack(_frame_sums(padded), dim=-1)
    for i0 in range(0, frames, WINDOW):
        wc = min(WINDOW, frames - i0)
        spec = window_forward(x, cs, i0, wc)[(-i0) % hop :: hop].contiguous()
        rows, scl = quantize_rows(spec, planes.dtype)
        ring_writeback(rows, scl, planes, None if scales is None else scales[..., 0], -(-i0 // hop))
    state = dict(state)
    state["dcny"][: p - 1] = pairs.to(torch.float32)
    state["pos"] = (p - 1) % p
    return state


def _frame_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, alternating-sign sum) of ``x`` over its last axis, in float64:
    a frame's DC and Nyquist bins (the packed forward matrix's lane-0
    columns are all-ones / alternating sign). Each caller adds them in its
    own order (block sums pairwise for UPOLS frames, whole frames for UPOLA
    and B2), the order ``dcny`` and ``dcfix`` are held to."""
    f64 = x.to(torch.float64)
    alt = torch.ones(x.shape[-1], dtype=torch.float64, device=x.device)
    alt[1::2] = -1.0
    return f64.sum(-1), (f64 * alt).sum(-1)


def _fused_step(config: PartitionedConfig, params: dict, state: dict, frame: torch.Tensor):
    """One block through the fused kernel B2 (packed ring layout).

    The kernel owns rfft + quantize + ring insert + MAC + irfft; this
    wrapper updates the exact DC/Nyquist side-carry (two frame sums: the
    packed forward matrix's lane-0 columns are all-ones / alternating sign)
    and reduces it against the rotated side filter, in float64, for the
    kernel's lane-0 overwrite. A sparse filter's chunk tables go to the
    kernel whole; it reads row ``pos``.
    """
    n = config.transform_size
    p = config.num_partitions
    pos = state["pos"]

    with trace.span("conv.dcny"):
        pair = torch.stack(_frame_sums(frame), dim=-1)
        dcny = state["dcny"]
        dcny[pos] = pair.to(torch.float32)
        filt_dcny = fdl_lib.rotated_filter(params["filt_dcny"], pos, p)
        dcfix = fdl_lib.dcny_mac(dcny, filt_dcny).T.contiguous()  # [2, C]

    fdl = state["fdl"]
    planes, scales = fdl if isinstance(fdl, tuple) else (fdl, None)
    cs, ab = matmul_backend.packed_mats(n, MATRIX_DTYPES[planes.dtype], frame.device)
    res = fused_block_step(
        frame.contiguous(), planes, params["filt_rim"], pos, dcfix, cs, ab,
        None if scales is None else scales[..., 0], _chunk_sched(params),
    )
    return res[0], {"fdl": fdl, "dcny": dcny}


def _chunk_sched(params: dict):
    """The fused kernels' ``sched``: the full chunk tables, or None."""
    if "sp_c_idx" not in params:
        return None
    return params["sp_c_idx"], params["sp_c_flags"]


def _split_mac(config: PartitionedConfig, params: dict, new_fdl, pos):
    """The split-plane partition MAC-reduce of one block: rotated filter
    slice + the B1 kernel, B4 over a sparse filter's tile schedule, or
    plain tensor ops (``mac_backend="xla"``). Returns (acc_re, acc_im)."""
    p = config.num_partitions
    if config.layout == "ring":
        filt_re = fdl_lib.rotated_filter(params["filt_re"], pos, p)
        filt_im = fdl_lib.rotated_filter(params["filt_im"], pos, p)
    else:
        filt_re = params["filt_re"]
        filt_im = params["filt_im"]
    if not _use_kernel_mac(config):
        return fdl_lib.fdl_mac_split(new_fdl, filt_re, filt_im)
    planes, scales = new_fdl if isinstance(new_fdl, tuple) else (new_fdl, None)
    scl = None if scales is None else scales[..., 0]
    if config.layout == "ring" and "sp_k_idx" in params:
        _, k_tile, pc = _tile_geometry(config, p)
        acc_re, acc_im = sparse_fdl_mac(
            planes, filt_re, filt_im, pos, params["sp_k_idx"], params["sp_p_idx"],
            params["sp_flags"], scl, p_chunk=pc, k_tile=k_tile, live=params.get("tile_live"),
        )
        # as neojax: zero the lanes of tiles no rotation visits
        lane = params["sp_lane"]
        return torch.where(lane, acc_re, 0.0), torch.where(lane, acc_im, 0.0)
    return fdl_mac(planes, filt_re, filt_im, scl)


def step(config: PartitionedConfig, params: dict, state: dict, block: torch.Tensor):
    """One streaming block: [C, B] in -> (new_state, [C, B] out).

    The FDL ring, its scales and ``dcny`` are updated IN PLACE: the state
    passed in shares them with the state returned, so keep using the
    returned one."""
    with trace.span("conv.step"):
        b = config.block_size
        n = config.transform_size
        p = config.num_partitions
        ring = config.layout == "ring"
        pos = state.get("pos")

        frame = _frame(config, state, block)
        new_tail = block if config.scheme == "upols" else None

        if _use_fused(config, params):
            y, update = _fused_step(config, params, state, frame)
        else:
            update, _ = _spectrum_and_push(config, state, frame)
            new_fdl = update["fdl"]
            if config.storage == "dense":
                filt = fdl_lib.rotated_filter(params["filt"], pos, p) if ring else params["filt"]
                acc = fdl_lib.fdl_mac_dense(new_fdl, filt)
                y = fft_api.irfft(acc, n=n, backend=config.fft_backend)
            else:
                acc_re, acc_im = _split_mac(config, params, new_fdl, pos)
                if config.use_packed:
                    # Overwrite the lane-0 complex product with the exact
                    # DC/Nyquist real MACs from the f32 side-carry.
                    filt_dcny = fdl_lib.rotated_filter(params["filt_dcny"], pos, p)
                    acc_dcny = fdl_lib.dcny_mac(update["dcny"], filt_dcny)  # [C, 2]
                    acc_re[:, 0] = acc_dcny[:, 0]
                    acc_im[:, 0] = acc_dcny[:, 1]
                    y = matmul_backend.irfft_packed_split(acc_re, acc_im, n)
                else:
                    y = fft_api.irfft(torch.complex(acc_re, acc_im), n=n, backend=config.fft_backend)

        if config.scheme == "upols":
            out = y[..., b:]
        else:
            out = y[..., :b] + state["tail"]
            new_tail = y[..., b:]
        return _advance(config, state, update, new_tail), out.to(torch.float32)


def _dcfix_sequence(config: PartitionedConfig, params: dict, dcny: torch.Tensor, pos0: int,
                    sigpad: torch.Tensor):
    """Per-block exact DC/Nyquist accumulators for a whole UPOLS stream.

    The side-carry MAC ``dcfix_i = sum_a F[a] * pair_{i-a}`` is a 1-D
    correlation of the per-block (dc, ny) frame sums with the side filter;
    ``pair_{j<0}`` come from the incoming ring. Computed in float64 (no
    TF32 path) and cast to f32. Writes the last pairs into ``dcny`` in
    place. Returns (dcfix_all [nb, 2, C] f32, dcny).
    """
    with trace.span("conv.dcfix"):
        b = config.block_size
        # the alternating-sign Nyquist trick continues the first half's
        # pattern into the second — even B only (a packed-layout precondition)
        assert b % 2 == 0, "fused stream requires an even block size"
        p = config.num_partitions
        c = sigpad.shape[0]
        nb = sigpad.shape[1] // b - 1
        dev = sigpad.device

        bs, na = _frame_sums(sigpad.reshape(c, nb + 1, b))  # [C, nb+1]
        dc = bs[:, :-1] + bs[:, 1:]  # frame i = [block i | block i+1]
        ny = na[:, :-1] + na[:, 1:]
        pairs = torch.stack([dc.T, ny.T], dim=-1).to(torch.float32)  # [nb, C, 2]

        tidx = torch.remainder(pos0 + 1 + torch.arange(p - 1, device=dev), p)
        seq = torch.cat([dcny[tidx], pairs], dim=0).to(torch.float64)  # [P-1+nb, C, 2]
        # the tiled side filter's first P rows are the REVERSED filter: exactly
        # the cross-correlation kernel of sum_a F[a] * seq[i-a]
        ker = params["filt_dcny"][:p].to(torch.float64).expand(p, c, 2)
        lhs = seq.permute(1, 2, 0).reshape(1, c * 2, p - 1 + nb)
        rhs = ker.permute(1, 2, 0).reshape(c * 2, 1, p)
        fix = F.conv1d(lhs, rhs, groups=c * 2)  # [1, 2C, nb]
        dcfix_all = fix.reshape(c, 2, nb).permute(2, 1, 0).to(torch.float32).contiguous()

        tail_n = min(p, nb)
        idxs = torch.remainder(pos0 + nb - tail_n + torch.arange(tail_n, device=dev), p)
        dcny[idxs] = pairs[nb - tail_n :]
        return dcfix_all, dcny


def _process_fused_stream(config: PartitionedConfig, params: dict, state: dict,
                          signal: torch.Tensor):
    """Whole-stream fused path: ONE launch of B3 for the entire UPOLS scan
    (with a sparse filter's tap-tile table)."""
    b = config.block_size
    p = config.num_partitions
    n = config.transform_size
    length = signal.shape[-1]
    nb = -(-length // b)
    pos0 = state["pos"]

    sig = F.pad(signal, (0, nb * b - length))
    sigpad = torch.cat([state["tail"], sig], dim=-1).contiguous()
    dcfix_all, dcny = _dcfix_sequence(config, params, state["dcny"], pos0, sigpad)

    fdl = state["fdl"]
    planes, scales = fdl if isinstance(fdl, tuple) else (fdl, None)
    cs, abt = matmul_backend.packed_stream_mats(n, MATRIX_DTYPES[planes.dtype], signal.device)
    res = fused_stream(
        sigpad, planes, params["filt_rim"], pos0, dcfix_all, cs, abt,
        None if scales is None else scales[..., 0], tiles=params.get("tap_tiles"),
    )

    new_state = dict(state)
    new_state.update(tail=sig[:, -b:].clone(), fdl=fdl, dcny=dcny, pos=(pos0 + nb) % p)
    return new_state, res[0][:, :length]


def process(config: PartitionedConfig, params: dict, state: dict, signal: torch.Tensor):
    """Stream a whole signal [C, T] (or [T]) through the convolver.

    ``signal`` may be host data (numpy), which is copied to the state's
    device, or a tensor there. Returns (new_state, out); the FDL ring, its
    scales and ``dcny`` are updated in place."""
    signal = as_signal(signal, state["tail"].device)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]

    if (
        config.scheme == "upols"
        and config.layout == "ring"
        and signal.shape[-1] > 0
        and _use_fused(config, params)
    ):
        state, out = _process_fused_stream(config, params, state, signal)
    else:
        blocks, length = stream_blocks(signal, config.block_size)
        outs = []
        for blk in blocks:
            state, y = step(config, params, state, blk)
            outs.append(y)
        if outs:
            out = unstream_blocks(torch.stack(outs), length)
        else:
            out = signal[..., :0]
    return state, (out[0] if squeeze else out)


class Convolver:
    """Stateful wrapper mirroring the reference's ergonomics
    (``convolver.filter(partitions); convolver(block)``) over the
    functional core, on one ``device`` (None: the card; ``"cpu"`` runs the
    kernels' plain versions)."""

    def __init__(
        self,
        scheme: str = "upols",
        storage: str | None = None,
        fft_backend: str | None = None,
        sparsity: Any = None,
        require_sparsity: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        if storage is None:
            # complex64 is the CPU convenience; the split (planar re/im
            # float) storage is the kernels' native layout.
            storage = "dense" if self.device.type == "cpu" else "split"
        self._scheme = scheme
        self._storage = storage
        self._fft_backend = fft_backend
        # Sparse-convolver semantics (``sparse_convolver.hpp:16-21``): the
        # sparse aliases REQUIRE a sparsity predicate or mask in filter().
        self._default_sparsity = sparsity
        self._require_sparsity = require_sparsity
        self.config: PartitionedConfig | None = None
        self.params: dict | None = None
        self.state: dict | None = None

    def filter(self, partitions, sparsity: Any = None, pad_partitions: int | None = None) -> None:
        """Install a partitioned filter ([P, K] or [C|1, P, K] spectra).

        ``pad_partitions``: partition count (>= P) to zero-pad the ring to;
        None = auto, which pads deep IRs to a multiple of 32 and short ones
        to a multiple of 8 (938 -> 960 at the 10 s / 48 kHz / block 512
        config), keeping state shapes equal to the JAX package's. The extra
        slots carry zero-weighted spectra, so results are exact.
        """
        with trace.span("conv.filter"):
            if sparsity is None:
                sparsity = self._default_sparsity
            if sparsity is None and self._require_sparsity:
                raise ValueError(
                    "this is a sparse convolver (sparse_upols/upola_convolver, "
                    "sparse_convolver.hpp:16-21): pass a sparsity predicate "
                    "(row, col, value) -> bool or a boolean keep-mask, either "
                    "to filter(partitions, sparsity=...) or at construction"
                )
            partitions = _host(partitions)
            if partitions.ndim == 2:
                partitions = partitions[None]
            p_in = partitions.shape[1]
            if pad_partitions is None:
                mult = 32 if p_in > 32 else 8 if p_in > 8 else 1
                p_pad = -(-p_in // mult) * mult
            else:
                if pad_partitions < p_in:
                    raise ValueError(f"pad_partitions={pad_partitions} < filter partitions {p_in}")
                p_pad = pad_partitions
            if p_pad != p_in:
                zeros = np.zeros((partitions.shape[0], p_pad - p_in, partitions.shape[2]), partitions.dtype)
                partitions = np.concatenate([partitions, zeros], axis=1)
            channels, p, bins = partitions.shape
            self._filter_channels = channels
            self.config = PartitionedConfig(
                block_size=bins - 1,
                num_partitions=p,
                channels=channels,
                scheme=self._scheme,
                storage=self._storage,
                fft_backend=self._fft_backend,
            )
            self.params = filter_params(self.config, partitions, sparsity=sparsity, device=self.device)
            self.reset()

    def reset(self) -> None:
        if self.config is None:
            raise RuntimeError("call filter() first")
        self.state = init_state(self.config, self.device)
        self._streamed = False
        self._in_fifo: torch.Tensor | None = None
        self._out_fifo: torch.Tensor | None = None
        self.latency = 0

    def _bind_channels(self, channels: int) -> None:
        """Late channel binding: a shared (mono) filter serves any channel
        count (``DenseConvolution.cpp:151-154``)."""
        if self.config.channels == channels:
            return
        if self._filter_channels != 1:
            raise ValueError(
                f"signal has {channels} channels but filter has {self._filter_channels}"
            )
        if self._streamed:
            raise RuntimeError("cannot change channel count mid-stream; reset() first")
        with trace.span("conv.bind"):
            self.config = dataclasses.replace(self.config, channels=channels)
            self.state = init_state(self.config, self.device)
            if "mask" in self.params:
                # the schedules' chunk geometry depends on the channel count
                self.params.update(_schedule_params(self.config, _host(self.params["mask"]), self.device))

    def _as_signal(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _step(self, block: torch.Tensor) -> torch.Tensor:
        self.state, out = step(self.config, self.params, self.state, block)
        self._streamed = True
        return out

    def __call__(self, block):
        """Stream one chunk of ANY length >= 0 (the reference upola_v2 /
        ConstantOverlapAdd contract, ``overlap_add_convolver.hpp:72-135``):
        returns exactly as many samples as given. Exact-block chunks with
        nothing buffered take the direct path (zero added latency, equal
        to ``process``); any other chunking engages a re-blocking FIFO on
        the device with a fixed stream latency of block_size-1 silence
        samples (``self.latency``)."""
        with trace.span("conv.call"):
            if self.config is None:
                raise RuntimeError("call filter() first")
            block = self._as_signal(block)
            squeeze = block.ndim == 1
            if squeeze:
                block = block[None]
            self._bind_channels(block.shape[0])
            b = self.config.block_size
            buffered = self._in_fifo is not None and self._in_fifo.shape[-1] > 0
            if block.shape[-1] == b and not buffered:
                out = self._step(block)
            else:
                out = self._reblocked(block)
            return out[0] if squeeze else out

    def _reblocked(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("conv.fifo"):
            b = self.config.block_size
            c = self.config.channels
            if self._in_fifo is None:
                # Fixed latency of B-1 samples, pre-filled as silence: at most
                # B-1 input samples wait unprocessed, so the output never
                # underruns however calls are chunked
                # (ConstantOverlapAdd.hpp:89-199, getLatencyInSamples).
                self.latency = b - 1
                self._in_fifo = torch.zeros((c, 0), dtype=torch.float32, device=self.device)
                self._out_fifo = torch.zeros((c, self.latency), dtype=torch.float32, device=self.device)
            fifo = torch.cat([self._in_fifo, x], dim=-1)
            n_blocks = fifo.shape[-1] // b
            outs = [self._out_fifo]
            for i in range(n_blocks):
                outs.append(self._step(fifo[:, i * b : (i + 1) * b]))
            self._in_fifo = fifo[:, n_blocks * b :].clone()
            pending = torch.cat(outs, dim=-1)
            want = x.shape[-1]
            self._out_fifo = pending[:, want:].clone()
            return pending[:, :want]

    def flush(self) -> torch.Tensor:
        """Drain the re-blocking FIFO: zero-pad any pending partial block,
        process it, and return the ``self.latency`` samples still owed — so
        cat(all __call__ returns, flush()) == zeros(latency) ++
        ``process(signal)``."""
        if self.config is None:
            raise RuntimeError("call filter() first")
        c = self.config.channels
        if self._in_fifo is None:
            return torch.zeros((c, 0), dtype=torch.float32, device=self.device)
        b = self.config.block_size
        pending = self._in_fifo.shape[-1]
        if pending:
            block = F.pad(self._in_fifo, (0, b - pending))
            self._in_fifo = self._in_fifo[:, :0]
            self._out_fifo = torch.cat([self._out_fifo, self._step(block)], dim=-1)
        out = self._out_fifo[:, : self.latency]
        self._out_fifo = self._out_fifo[:, self.latency :].clone()
        return out

    def process(self, signal) -> torch.Tensor:
        with trace.span("conv.process"):
            if self.config is None:
                raise RuntimeError("call filter() first")
            signal = self._as_signal(signal)
            self._bind_channels(signal.shape[0] if signal.ndim > 1 else 1)
            self.state, out = process(self.config, self.params, self.state, signal)
            self._streamed = True
            return out


def make_convolver(scheme: str = "upols", storage: str | None = None, **kw) -> Convolver:
    return Convolver(scheme=scheme, storage=storage, **kw)


# Aliases mirroring the reference convolver family
# (``dense_convolver.hpp:20-39``, ``sparse_convolver.hpp:16-21``).
def upols_convolver(device=None) -> Convolver:
    return Convolver("upols", device=device)


def upola_convolver(device=None) -> Convolver:
    return Convolver("upola", device=device)


def upola_convolver_v2(device=None) -> Convolver:
    # The reference's v2 reschedules the tail-partition sum for arbitrary
    # input lengths (``overlap_add_convolver.hpp:21-137``); block for block
    # its output is identical, so v2 shares this implementation.
    return Convolver("upola", device=device)


def split_upols_convolver(device=None) -> Convolver:
    return Convolver("upols", "split", device=device)


def split_upola_convolver(device=None) -> Convolver:
    return Convolver("upola", "split", device=device)


def sparse_upols_convolver(sparsity: Any = None, device=None, storage: str | None = None) -> Convolver:
    """UPOLS over a sparse (predicate-thinned) filter: a sparsity predicate
    ``(row, col, value) -> bool`` (or boolean keep-mask, e.g.
    ``conv.perceptual_mask``) must be supplied, here or later to
    ``filter(..., sparsity=)`` (``sparse_filter.hpp:25-38``). Dropped bins
    are zeroed in the filter, and the kernels skip the tiles they empty.
    ``storage`` as :class:`Convolver`'s (None: by device)."""
    return Convolver("upols", storage, sparsity=sparsity, require_sparsity=True, device=device)


def sparse_upola_convolver(sparsity: Any = None, device=None, storage: str | None = None) -> Convolver:
    """UPOLA twin of :func:`sparse_upols_convolver` (``sparse_convolver.hpp:21``)."""
    return Convolver("upola", storage, sparsity=sparsity, require_sparsity=True, device=device)
