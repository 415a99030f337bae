"""Hybrid (two-stage) convolution on PyTorch and CUDA: the real-time engine
for long IRs. Port of ``neojax.conv.hybrid``.

The filter is split where real-time engines split it (Gardner-style
two-stage scheduling):

  head — partitions j in [0, S): a per-block FDL ring over S partitions,
         evaluated every block;
  tail — partitions j >= S: the nested engine (``conv.nested``), whose
         meta-partitions depend only on completed chunks, so the whole
         tail contribution to chunk m+1 is computed once, at the end of
         chunk m, and handed to the head as S precomputed spectrum frames.

Latency is one block; the output equals the uniform UPOLS schedule (head
sum + tail sum = full partition sum).

Two heads, as in the JAX package:

- the **fused head** (split, int16, int8 with an even block <= 1024 and
  the kernel MAC): one B3 launch (``kernels.fused_stream``) per chunk of
  S blocks, the precomputed tail frames entering through its ``acc_add``
  seed and their exact DC/Nyquist through ``dcfix_all``;
- the **unfused head** (bf16, ``mac_backend="xla"``, or params without
  ``head_packed``): per block rfft -> ring insert -> S-partition MAC (B1,
  ``kernels.fdl_mac``, or plain tensor ops) -> + tail frame -> irfft.

The tail runs B5 (``kernels.nested_mac``) once per chunk. int8 keeps its
head ring at int16 (``_head_storage``): the head is a few percent of the
delay line but carries much of a decaying IR's energy.

Dict keys and shapes are the JAX package's; ring positions and
``HybridStream``'s block phase ``r`` are Python ints. ``process_hybrid``
and ``HybridStream`` **write the head ring, the meta ring, their scales and
the head's DC/Nyquist side-carry in place**.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch.conv import convolver as cv
from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv import nested as nested_lib
from neojax_torch.conv.convolver import PartitionedConfig, _canon_partitions, _host
from neojax_torch.core.device import as_signal, resolve_device
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.kernels.fdl_mac import fdl_mac
from neojax_torch.kernels.fused_step import MATRIX_DTYPES, MAX_BLOCK, fused_stream
from neojax_torch.kernels.meta_push import meta_push
from neojax_torch.ops.quantize import int_max_for

__all__ = [
    "hybrid_filter_params",
    "hybrid_init_state",
    "process_hybrid",
    "HybridStream",
]


def _fft_precisions(config: PartitionedConfig) -> tuple[str, str]:
    """The hybrid's transform precision policy
    (``neojax.conv.hybrid._fft_precisions``): split/dense at HIGH, the
    other storages as the nested engine. Both are float32 FFTs here."""
    if config.storage in ("split", "dense"):
        return ("high", "high")
    return nested_lib._fft_precisions(config)


def _head_storage(config: PartitionedConfig) -> str:
    """Per-stage storage: int8 keeps its head ring at int16."""
    if config.storage == "dense":
        return "split"
    if config.storage == "int8":
        return "int16"
    return config.storage


def _has_packed_head(config: PartitionedConfig) -> bool:
    """The storages and block sizes the fused head serves (bf16 stays on
    the unfused head, as in the JAX package)."""
    return (config.storage in ("split", "int16", "int8") and config.block_size % 2 == 0
            and config.block_size <= MAX_BLOCK)


def _use_fused_head(config: PartitionedConfig) -> bool:
    """The head runs through B3: a CUDA tensor launches the kernel, a CPU
    tensor runs its plain version. ``mac_backend="xla"`` (or ``"torch"``)
    keeps the unfused head with plain tensor ops."""
    return _has_packed_head(config) and cv._kernel_route(config)


def hybrid_filter_params(config: PartitionedConfig, partitions, chunk_blocks: int, mask=None,
                         device=None) -> dict:
    """Split the partitioned filter into head (< S) and tail (>= S) params.

    ``partitions``: [P, K], [1, P, K] or [C, P, K] complex spectra.
    ``chunk_blocks`` (S): head depth = tail scheduling period. ``device``
    None means the card.
    """
    device = resolve_device(device)
    s = chunk_blocks
    filt = _canon_partitions(config, _host(partitions)).astype(np.complex64)
    p = filt.shape[0]
    if mask is not None:
        m = np.asarray(_host(mask), bool)
        if m.ndim == 2:
            m = m[None]
        m = np.moveaxis(m, 0, 1)
        if m.shape[0] < p:
            m = np.concatenate([m, np.zeros((p - m.shape[0],) + m.shape[1:], bool)], axis=0)
        filt = np.where(np.broadcast_to(m, filt.shape), filt, 0)

    if p >= s:
        head = filt[:s]
    else:
        head = np.concatenate([filt, np.zeros((s - p,) + filt.shape[1:], filt.dtype)], axis=0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    hr, hi = np.real(head), np.imag(head)
    params: dict = {
        # ring layout, tile-reversed filter
        "head_re": put(np.concatenate([hr[::-1], hr[::-1]], axis=0)),
        "head_im": put(np.concatenate([hi[::-1], hi[::-1]], axis=0)),
    }
    if _has_packed_head(config):
        # The fused head's packed params through the convolver's own
        # builder, over exactly S partitions: the chunk's spectra are read
        # back from a ring that holds one chunk (no padding of P beyond S).
        head_cfg = dataclasses.replace(
            config, num_partitions=s, layout="ring", mac_backend="kernel", packed=True,
            fused=True, storage=_head_storage(config),
        )
        params["head_packed"] = cv.filter_params(head_cfg, np.moveaxis(head, 1, 0), device=device)
    if p > s:
        # meta-partition q' covers original j in [S(q'+1), S(q'+2))
        tail_config = dataclasses.replace(config, num_partitions=p - s)
        params["tail"] = nested_lib.nested_filter_params(
            tail_config, np.moveaxis(filt[s:], 0, 1), s, device=device
        )
    return params


def _meta_state(config: PartitionedConfig, tail_params: dict, s: int, device) -> dict:
    """The tail's state: the nested meta ring (+ pos/scales), the previous
    chunk's spectra and the precomputed tail frames."""
    p2t, s_t, _ = nested_lib._static_dims(tail_params)
    ring = nested_lib._meta_ring(config, p2t, s_t, device)
    c, k = config.channels, config.num_bins
    state = {"meta_fdl": ring["fdl"], "meta_pos": 0}
    if "scales" in ring:
        state["meta_scales"] = ring["scales"]
    state["prev_spec"] = torch.zeros((2, c, k, s), dtype=nested_lib._prev_dtype(config),
                                     device=device)
    state["tail_frames"] = torch.zeros((2, c, k, s), dtype=torch.float32, device=device)
    return state


def hybrid_init_state(config: PartitionedConfig, params: dict, device=None) -> dict:
    if device is None:
        device = params["head_re"].device
    c = config.channels
    s = params["head_re"].shape[0] // 2
    state = {
        "btail": torch.zeros((c, config.block_size), dtype=torch.float32, device=device),
        "head_pos": 0,
    }
    if _use_fused_head(config) and "head_packed" in params:
        state["head_fdl"], state["head_dcny"] = fdl_lib.fdl_packed_init(
            _head_storage(config), s, c, config.block_size, device
        )
    else:
        state["head_fdl"] = fdl_lib.fdl_init(_head_storage(config), s, c, config.num_bins, device)
    if "tail" in params:
        state.update(_meta_state(config, params["tail"], s, device))
    return state


def _head_block(config: PartitionedConfig, params: dict, hfdl, hpos: int, btail: torch.Tensor,
                block: torch.Tensor, tail_frame):
    """One unfused head block: rfft -> head-ring insert (in place) ->
    S-partition MAC (B1, or plain tensor ops with ``mac_backend="xla"``)
    -> + the precomputed tail frame [2, C, K] -> irfft.

    Returns (out [C, B], spec_re, spec_im [C, K])."""
    b = config.block_size
    n = config.transform_size
    fwd_prec, inv_prec = _fft_precisions(config)
    s = params["head_re"].shape[0] // 2

    frame = torch.cat([btail, block], dim=-1)  # [C, 2B] (upols)
    sre, sim = mb.rfft_split(mb.round_operand(frame, fwd_prec), n)
    hfdl = fdl_lib.fdl_ring_push_split(hfdl, sre, sim, hpos)
    fr = fdl_lib.rotated_filter(params["head_re"], hpos, s)
    fi = fdl_lib.rotated_filter(params["head_im"], hpos, s)
    if cv._kernel_route(config):
        planes, scales = hfdl if isinstance(hfdl, tuple) else (hfdl, None)
        acc_re, acc_im = fdl_mac(planes, fr, fi, None if scales is None else scales[..., 0])
    else:
        acc_re, acc_im = fdl_lib.fdl_mac_split(hfdl, fr, fi)
    if tail_frame is not None:
        acc_re = acc_re + tail_frame[0]
        acc_im = acc_im + tail_frame[1]
    y = mb.irfft_split(mb.round_operand(acc_re, inv_prec), mb.round_operand(acc_im, inv_prec), n)
    return y[..., b:], sre, sim


def _fused_head_chunk(config: PartitionedConfig, hp: dict, btail, hfdl, hdcny, hpos: int,
                      tail_frames, chunk: torch.Tensor):
    """One chunk's S head blocks through ONE B3 launch; the chunk-rate tail
    sum rides its ``acc_add`` seed. ``chunk`` is [C, S, B].

    Returns (out [C, S*B], cur [2, C, K, S] or None, new btail). The head
    ring, its scales and ``hdcny`` are written in place; after S inserts
    into the S-row ring the write position is back where it started."""
    b = config.block_size
    n = config.transform_size
    k = config.num_bins
    c, s = chunk.shape[:2]
    head_cfg = dataclasses.replace(config, num_partitions=s, storage=_head_storage(config))

    sig_c = chunk.reshape(c, s * b)
    sigpad = torch.cat([btail, sig_c], dim=-1).contiguous()
    dcfix_all, hdcny = cv._dcfix_sequence(head_cfg, hp, hdcny, hpos, sigpad)
    acc_add = None
    if tail_frames is not None:
        tf = tail_frames
        # the tail frames' exact DC/Nyquist join the lane-0 fixup, which the
        # kernel applies after the MAC; the seed's lane 0 is overwritten
        dcfix_all = dcfix_all + torch.stack([tf[0, :, 0, :].T, tf[0, :, k - 1, :].T], dim=1)
        acc_add = tf[:, :, :b, :].permute(3, 0, 1, 2).contiguous()  # [S, 2, C, B]

    planes, scales = hfdl if isinstance(hfdl, tuple) else (hfdl, None)
    cs, abt = mb.packed_stream_mats(n, MATRIX_DTYPES[planes.dtype], sigpad.device)
    out_c = fused_stream(sigpad, planes, hp["filt_rim"], hpos, dcfix_all, cs, abt,
                         None if scales is None else scales[..., 0], acc_add=acc_add)[0]

    cur = None
    if tail_frames is not None:
        # This chunk's S block spectra, read back from the head ring (depth
        # S: after S inserts it holds exactly this chunk), with the exact
        # f32 DC/Nyquist from the side-carry.
        order = torch.remainder(hpos + torch.arange(s, device=sigpad.device), s)
        pr = planes[:, order].float()  # [2, S, C, B]
        if scales is not None:
            sc = scales[order, :, 0]  # [S, C]
            pr = pr * (sc * (1.0 / int_max_for(planes.dtype)))[None, :, :, None]
        dc_ny = hdcny[order]  # [S, C, 2]
        re, im = pr[0].clone(), pr[1].clone()
        re[..., 0] = dc_ny[..., 0]
        im[..., 0] = 0.0
        re_full = torch.cat([re, dc_ny[..., 1:]], dim=-1)  # [S, C, K]
        im_full = torch.cat([im, torch.zeros_like(im[..., :1])], dim=-1)
        cur = torch.stack([re_full.permute(1, 2, 0), im_full.permute(1, 2, 0)])  # [2, C, K, S]
    return out_c, cur, sig_c[:, -b:].clone()


def _tail_chunk(config: PartitionedConfig, tail_params: dict, mstate: dict,
                cur: torch.Tensor) -> dict:
    """The chunk-rate tail refresh: meta-FFT of [previous | this] chunk's
    spectra, meta-ring insert (in place), the meta MAC (B5 for a shared
    filter) and the inverse meta-FFT -> the next chunk's S tail frames.
    Returns the updated tail entries of the state."""
    fwd_prec, _ = _fft_precisions(config)
    prev = mstate["prev_spec"]
    cur_p = cur.to(prev.dtype, copy=True)
    xre, xim = mb.meta_fft(mb.round_operand(torch.cat([prev[0], cur_p[0]], dim=-1), fwd_prec),
                           mb.round_operand(torch.cat([prev[1], cur_p[1]], dim=-1), fwd_prec))
    fdl, scales, pos = mstate["meta_fdl"], mstate.get("meta_scales"), mstate["meta_pos"]
    meta_push(fdl, scales, pos, xre, xim)
    # Tail meta-filter index q' multiplies the window q'+1 chunks old: the
    # newest ring entry is the window just inserted, and the next chunk
    # needs ages 0..P2t-1 against F[0..].
    acc_re, acc_im = nested_lib._meta_mac(config, tail_params, fdl, scales, pos)
    yre, yim = mb.meta_ifft_tail(mb.round_operand(acc_re, fwd_prec),
                                 mb.round_operand(acc_im, fwd_prec))
    p2t = fdl.shape[1]
    new = dict(mstate)
    new.update(meta_pos=(pos + 1) % p2t, prev_spec=cur_p, tail_frames=torch.stack([yre, yim]))
    return new


_TAIL_KEYS = ("meta_fdl", "meta_pos", "meta_scales", "prev_spec", "tail_frames")


def process_hybrid(config: PartitionedConfig, params: dict, state: dict, signal: torch.Tensor):
    """Stream [C, T] (or [T]) with per-block (B-sample) latency.

    T is padded to a multiple of S*B (output trimmed; the returned state
    reflects the padded stream). ``signal`` may be host data, copied to the
    state's device. Returns (new_state, out); rings, scales and the
    DC/Nyquist side-carry are updated in place.
    """
    b = config.block_size
    s = params["head_re"].shape[0] // 2
    has_tail = "tail" in params

    signal = as_signal(signal, state["btail"].device)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    c, t_len = signal.shape
    num_chunks = -(-t_len // (s * b))
    padded = F.pad(signal, (0, num_chunks * s * b - t_len))
    chunks = padded.reshape(c, num_chunks, s, b)

    fused_head = _use_fused_head(config) and "head_packed" in params and "head_dcny" in state
    btail, hfdl, hpos = state["btail"], state["head_fdl"], state["head_pos"]
    mstate = {key: state[key] for key in _TAIL_KEYS if key in state}
    outs = []
    for i in range(num_chunks):
        chunk = chunks[:, i]  # [C, S, B]
        tail_frames = mstate["tail_frames"] if has_tail else None
        if fused_head:
            out_c, cur, btail = _fused_head_chunk(config, params["head_packed"], btail, hfdl,
                                                  state["head_dcny"], hpos, tail_frames, chunk)
        else:
            blocks_out, specs = [], []
            for r in range(s):
                block = chunk[:, r]
                out, sre, sim = _head_block(
                    config, params, hfdl, hpos, btail, block,
                    None if tail_frames is None else tail_frames[..., r],
                )
                blocks_out.append(out)
                specs.append(torch.stack([sre, sim]))
                btail = block
                hpos = (hpos + 1) % s
            out_c = torch.cat(blocks_out, dim=-1)
            cur = torch.stack(specs, dim=-1) if has_tail else None  # [2, C, K, S]
        if has_tail:
            mstate = _tail_chunk(config, params["tail"], mstate, cur)
        outs.append(out_c)

    new_state = dict(state)
    new_state.update(btail=btail.clone(), head_fdl=hfdl, head_pos=hpos, **mstate)
    out = torch.cat(outs, dim=-1)[:, :t_len] if outs else signal[:, :0]
    return new_state, (out[0] if squeeze else out)


class HybridStream:
    """Per-BLOCK real-time driver of the hybrid engine (the plugin's
    processBlock contract, ``ConstantOverlapAdd.hpp:89-199``).

    ``__call__(block)`` runs one unfused head block (rfft, head-ring
    insert, S-partition MAC through B1, + the precomputed tail frame,
    irfft); every S-th call also runs the tail refresh (meta-FFT, B5 meta
    MAC, inverse), scheduled at the chunk boundary. Output is block for
    block equal to ``process_hybrid`` with the unfused head; latency is one
    block. UPOLS only. ``reset()`` is the only supported restart: it keeps
    the host-side chunk phase in step with the state.
    """

    def __init__(self, config: PartitionedConfig, params: dict, device=None):
        if config.scheme != "upols":
            raise NotImplementedError("HybridStream is UPOLS-only")
        self.config = config
        self.params = params
        self.device = torch.device(device) if device is not None else params["head_re"].device
        self.s = params["head_re"].shape[0] // 2
        self.has_tail = "tail" in params
        self.reset()

    def reset(self) -> None:
        """Return to a fresh-stream state (the ONLY supported restart)."""
        self.state = self.init_state()
        self._r = 0

    def init_state(self) -> dict:
        cfg = self.config
        c, k, s = cfg.channels, cfg.num_bins, self.s
        # per-block stepping uses the unfused head ring: the fused kernel
        # is a multi-block construct
        state = {
            "btail": torch.zeros((c, cfg.block_size), dtype=torch.float32, device=self.device),
            "head_pos": 0,
            "head_fdl": fdl_lib.fdl_init(_head_storage(cfg), s, c, k, self.device),
            "r": 0,
        }
        if self.has_tail:
            state.update(_meta_state(cfg, self.params["tail"], s, self.device))
            state["chunk_spec"] = torch.zeros((2, c, k, s), dtype=torch.float32, device=self.device)
        return state

    def _block_step(self, state: dict, block: torch.Tensor):
        r = state["r"]
        out, sre, sim = _head_block(
            self.config, self.params, state["head_fdl"], state["head_pos"], state["btail"], block,
            state["tail_frames"][..., r] if self.has_tail else None,
        )
        new_state = dict(state)
        new_state["btail"] = block.clone()
        new_state["head_pos"] = (state["head_pos"] + 1) % self.s
        new_state["r"] = r + 1
        if self.has_tail:
            new_state["chunk_spec"][0, :, :, r] = sre  # in place
            new_state["chunk_spec"][1, :, :, r] = sim
        return new_state, out

    def _tail_step(self, state: dict) -> dict:
        """Chunk-boundary tail refresh: ``process_hybrid``'s tail step on
        the spectra this chunk's callbacks collected."""
        new_state = dict(state)
        new_state.update(_tail_chunk(
            self.config, self.params["tail"], {key: state[key] for key in _TAIL_KEYS if key in state},
            state["chunk_spec"],
        ))
        new_state["r"] = 0
        return new_state

    def __call__(self, block):
        """One block [C, B] in, one block out. The chunk phase is tracked
        host-side: a callback never waits on a device-to-host copy."""
        block = torch.as_tensor(block, dtype=torch.float32, device=self.device)
        self.state, out = self._block_step(self.state, block)
        self._r += 1
        if self._r == self.s:
            self._r = 0
            if self.has_tail:
                self.state = self._tail_step(self.state)
            else:
                self.state["r"] = 0
        return out
