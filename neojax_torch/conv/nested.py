"""Nested (two-level) FDL convolution on PyTorch and CUDA: the large-IR
throughput engine. Port of ``neojax.conv.nested``.

Per bin, the partition sum ``acc[s, k] = sum_j filt[j, k] * spec[s - j, k]``
is itself a streaming convolution along the frame axis, so UPOLS is
applied again one level up ("meta"). Per chunk of S blocks:

  - block rfft of the S frames -> S spectra [S, C, K]
  - meta window = [previous S spectra | new S spectra] (length 2S)
  - C2C meta-FFT along the frame axis
  - insert into the meta-FDL ring of P2 = ceil(P / S) meta-partitions
    (int8/int16: quantized with one dynamic scale per G meta-bins)
  - complex MAC against the meta-filter over P2 (kernel B5 for a shared
    filter), inverse meta-FFT, keep the last S frames (OLS)
  - block irfft -> S output blocks

Output equals the per-block UPOLS/UPOLA schedule, with a latency of S
blocks. Layouts and dict keys are the JAX package's: meta-FDL
``[2, P2, C, K, 2S]`` (plane 0 re, 1 im), meta-filter ``[P2, C', K, 2S]``
per plane (a shared filter is stored tile-reversed, ``[2 P2, 1, K, 2S]``,
so the ring-rotated filter is a contiguous slice). ``state["pos"]`` is a
Python int.

``process_nested`` **writes the meta ring and its scales in place** (the
state passed in shares them with the state returned); ``tail`` and
``prev`` are replaced. No ``jit``: the chunk loop is a Python loop, each
step a few batched tensor ops and one kernel launch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neojax_torch.conv import fdl as fdl_lib
from neojax_torch.conv.convolver import PartitionedConfig, _canon_partitions, _host
from neojax_torch.core.device import as_signal, resolve_device
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.kernels.nested_mac import nested_mac
from neojax_torch.ops.quantize import int_max_for

__all__ = [
    "nested_filter_params",
    "nested_init_state",
    "process_nested",
]


def _meta_fft_filter(plane_re: np.ndarray, plane_im: np.ndarray, s: int):
    """[P, C', K] split filter partitions -> meta spectra [P2, C', K, 2S]
    (re, im float32; computed in float64) and P2. Partitions are padded to
    a multiple of S with zeros (exact)."""
    p, c, k = plane_re.shape
    p2 = -(-p // s)
    filt = np.zeros((p2 * s, c, k), np.complex128)
    filt[:p] = plane_re.astype(np.float64) + 1j * plane_im.astype(np.float64)
    # [P2, S, C', K] -> [P2, C', K, S] -> zero-padded to 2S frames -> FFT
    frames = np.moveaxis(filt.reshape(p2, s, c, k), 1, -1)
    spec = np.fft.fft(frames, n=2 * s, axis=-1)
    return spec.real.astype(np.float32), spec.imag.astype(np.float32), p2


def nested_filter_params(config: PartitionedConfig, partitions, chunk_blocks: int,
                         mask=None, device=None) -> dict:
    """Build meta-FDL filter params (host-side numpy; the tensors land on
    ``device``).

    Shared ([1, P, K] / [P, K]) or per-channel ([C, P, K]) filters.
    ``mask``: optional boolean keep-mask ([P, K] or [C|1, P, K]); dropped
    bins are zeroed. The bf16 storage keeps a bf16 filter, as the JAX
    package does. ``device`` None means the card.
    """
    device = resolve_device(device)
    filt = _canon_partitions(config, _host(partitions)).astype(np.complex64)
    if mask is not None:
        m = np.asarray(_host(mask), bool)
        if m.ndim == 2:
            m = m[None]
        m = np.moveaxis(m, 0, 1)  # [P, C', K]
        if m.shape[0] < filt.shape[0]:
            pad = np.zeros((filt.shape[0] - m.shape[0],) + m.shape[1:], bool)
            m = np.concatenate([m, pad], axis=0)
        filt = np.where(np.broadcast_to(m, filt.shape), filt, 0)

    fre, fim, _ = _meta_fft_filter(np.real(filt), np.imag(filt), chunk_blocks)
    if fre.shape[1] == 1:
        # tile-reversed, so the rotated filter is a contiguous slice
        fre = np.concatenate([fre[::-1], fre[::-1]], axis=0)
        fim = np.concatenate([fim[::-1], fim[::-1]], axis=0)
    dtype = torch.bfloat16 if config.storage == "bf16" else torch.float32

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return {"filt_re": put(fre), "filt_im": put(fim)}


# Quantized meta-FDL scale granularity (``neojax.conv.nested._QUANT_GROUPS``):
# one dynamic scale per GROUP of meta-bins. int8 runs G = 64 (a 2S = 256 row
# has four groups), which is what brings it into its 46 dB class; int16
# runs G = 1, one scale per row.
_QUANT_GROUPS = {"int8": 64, "int16": 1}


def _quant_groups(config: PartitionedConfig, s: int) -> int:
    g = min(_QUANT_GROUPS.get(config.storage, 1), 2 * s)
    while (2 * s) % g:
        g -= 1
    return g


def _storage_dtype(config: PartitionedConfig) -> torch.dtype:
    if config.storage == "dense":  # the CPU convenience: split planes anyway
        return torch.float32
    return fdl_lib.STORAGE_DTYPES[config.storage]


def _fft_precisions(config: PartitionedConfig) -> tuple[str, str]:
    """(forward, inverse) transform precision (``mb.PRECISIONS``).

    int8/int16 run HIGH transforms (``neojax.conv.nested._fft_precisions``:
    DEFAULT would drown int16's storage floor and cost int8 its class);
    the others follow the chunked policy (``neojax.conv.chunked``): bf16 at
    DEFAULT (the bf16 rung rounds its transform operands to bf16), split
    and dense at HIGHEST. On the card HIGH and HIGHEST are both float32
    FFTs."""
    if config.storage in ("int8", "int16"):
        return ("high", "high")
    if config.storage == "bf16":
        return ("default", "default")
    return ("highest", "highest")


def _use_nested_kernel(config: PartitionedConfig) -> bool:
    """B5 runs the shared-filter meta MAC unless the plain tensor-op route
    is asked for (``mac_backend="torch"``, the JAX package's ``"xla"``)."""
    return config.mac_backend == "kernel"


def _static_dims(params: dict) -> tuple[int, int, bool]:
    """(p2, s, shared) from the filter's shapes."""
    filt = params["filt_re"]
    shared = filt.shape[1] == 1
    p2 = filt.shape[0] // 2 if shared else filt.shape[0]
    s = filt.shape[-1] // 2
    return p2, s, shared


def _meta_ring(config: PartitionedConfig, p2: int, s: int, device) -> dict:
    """A fresh meta ring: {"fdl": [2, P2, C, K, 2S] (+ "scales"
    [P2, C, K, G] of ones for int storage)}."""
    c, k = config.channels, config.num_bins
    ring = {"fdl": torch.zeros((2, p2, c, k, 2 * s), dtype=_storage_dtype(config), device=device)}
    if config.storage in ("int8", "int16"):
        ring["scales"] = torch.ones((p2, c, k, _quant_groups(config, s)), dtype=torch.float32,
                                    device=device)
    return ring


def _prev_dtype(config: PartitionedConfig) -> torch.dtype:
    return torch.bfloat16 if config.storage == "bf16" else torch.float32


def nested_init_state(config: PartitionedConfig, params: dict, device=None) -> dict:
    if device is None:
        device = params["filt_re"].device
    p2, s, _ = _static_dims(params)
    ring = _meta_ring(config, p2, s, device)
    state = {
        "tail": torch.zeros((config.channels, config.block_size), dtype=torch.float32, device=device),
        "prev": torch.zeros((2, config.channels, config.num_bins, s), dtype=_prev_dtype(config),
                            device=device),
        "fdl": ring["fdl"],
        "pos": 0,
    }
    if "scales" in ring:
        # per-(partition, channel, bin, meta-bin group) dynamic dequant scale
        state["scales"] = ring["scales"]
    return state


def _meta_push(fdl: torch.Tensor, scales, pos: int, xre: torch.Tensor, xim: torch.Tensor) -> None:
    """Write one meta row ([C, K, 2S] re/im, f32) at ring slot ``pos``, in
    place. Int storage quantizes each (c, k, group) at its dynamic peak
    scale: ``rint(x / scale * int_max)`` (half to even, as ``jnp.round``),
    clamped."""
    row = torch.stack([xre, xim])  # [2, C, K, L]
    if scales is None:
        fdl[:, pos] = row.to(fdl.dtype)
        return
    imax = int_max_for(fdl.dtype)
    _, c, k, l = row.shape
    g = scales.shape[-1]
    grp = row.reshape(2, c, k, g, l // g)
    peak = torch.amax(torch.abs(grp), dim=(0, 4))  # [C, K, G]
    scale = torch.where(peak > 0, peak, torch.ones_like(peak))
    q = torch.clamp(torch.round(grp / scale[None, :, :, :, None] * imax), -imax, imax)
    fdl[:, pos] = q.reshape(2, c, k, l).to(fdl.dtype)
    scales[pos] = scale


def _meta_mac(config: PartitionedConfig, params: dict, fdl: torch.Tensor, scales, pos: int):
    """The meta-partition MAC of ring slot ``pos``'s rotation. Returns
    (acc_re, acc_im) [C, K, 2S] f32.

    A shared filter runs B5 (``kernels.nested_mac``) on the rotated filter
    view, or plain tensor ops with ``mac_backend="torch"``. A per-channel
    filter gathers the ring by age and sums in plain tensor ops: that is
    the JAX package's own route for it (its Pallas kernel takes shared
    filters only), not a fallback.
    """
    p2, _, shared = _static_dims(params)
    if shared:
        fre = params["filt_re"][p2 - 1 - pos : 2 * p2 - 1 - pos, 0]  # contiguous [P2, K, L]
        fim = params["filt_im"][p2 - 1 - pos : 2 * p2 - 1 - pos, 0]
        if _use_nested_kernel(config):
            return nested_mac(fdl, scales, fre.float(), fim.float())
        xr, xi = fdl[0].float(), fdl[1].float()
        fr, fi = fre.float()[:, None], fim.float()[:, None]
        dq = scales
    else:
        ages = torch.remainder(pos - torch.arange(p2, device=fdl.device), p2)
        xr, xi = fdl[0][ages].float(), fdl[1][ages].float()
        fr, fi = params["filt_re"].float(), params["filt_im"].float()
        dq = None if scales is None else scales[ages]
    if dq is not None:
        l, g = xr.shape[-1], dq.shape[-1]
        dq = (dq * (1.0 / int_max_for(fdl.dtype))).repeat_interleave(l // g, dim=-1)
        xr = xr * dq
        xi = xi * dq
    return torch.sum(xr * fr - xi * fi, dim=0), torch.sum(xr * fi + xi * fr, dim=0)


def process_nested(config: PartitionedConfig, params: dict, state: dict, signal: torch.Tensor,
                   chunk_blocks: int | None = None):
    """Process [C, T] (or [T]) through the nested-FDL path, S blocks a step.

    T is padded up to a multiple of S*B (output trimmed; the returned state
    reflects the padded stream). ``signal`` may be host data, copied to the
    state's device. Returns (new_state, out); the meta ring and its scales
    are updated in place.
    """
    b = config.block_size
    n = config.transform_size
    p2, s, _ = _static_dims(params)
    if chunk_blocks is not None and chunk_blocks != s:
        raise ValueError(f"chunk_blocks {chunk_blocks} != filter params' {s}")
    fwd_prec, inv_prec = _fft_precisions(config)

    signal = as_signal(signal, state["tail"].device)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    c, t_len = signal.shape
    num_chunks = -(-t_len // (s * b))
    padded = F.pad(signal, (0, num_chunks * s * b - t_len))
    chunks = padded.reshape(c, num_chunks, s, b)

    tail, prev, fdl, pos = state["tail"], state["prev"], state["fdl"], state["pos"]
    scales = state.get("scales")
    outs = []
    for i in range(num_chunks):
        chunk = chunks[:, i].transpose(0, 1)  # [S, C, B]
        if config.scheme == "upols":
            prev_blocks = torch.cat([tail[None], chunk[:-1]], dim=0)
            frames = torch.cat([prev_blocks, chunk], dim=-1)  # [S, C, 2B]
            new_tail = chunk[-1]
        else:
            frames = F.pad(chunk, (0, n - b))

        sre, sim = mb.rfft_split(mb.round_operand(frames, fwd_prec), n)  # [S, C, K]
        cur = torch.stack([sre.permute(1, 2, 0), sim.permute(1, 2, 0)]).to(prev.dtype)  # [2, C, K, S]

        # meta OLS window (2S frames) and the C2C meta-FFT along it
        xre, xim = mb.meta_fft(mb.round_operand(torch.cat([prev[0], cur[0]], dim=-1), fwd_prec),
                               mb.round_operand(torch.cat([prev[1], cur[1]], dim=-1), fwd_prec))
        _meta_push(fdl, scales, pos, xre, xim)
        acc_re, acc_im = _meta_mac(config, params, fdl, scales, pos)

        # inverse meta-FFT (tail frames), then the block irfft
        yre, yim = mb.meta_ifft_tail(mb.round_operand(acc_re, fwd_prec),
                                     mb.round_operand(acc_im, fwd_prec))  # [C, K, S]
        y = mb.irfft_split(mb.round_operand(yre.permute(2, 0, 1), inv_prec),
                           mb.round_operand(yim.permute(2, 0, 1), inv_prec), n)  # [S, C, 2B]

        if config.scheme == "upols":
            out = y[..., b:]
        else:
            prev_tails = torch.cat([tail[None], y[:-1, :, b:]], dim=0)
            out = y[..., :b] + prev_tails
            new_tail = y[-1, :, b:]
        outs.append(out)
        tail = new_tail.to(torch.float32).clone()
        prev = cur
        pos = (pos + 1) % p2

    new_state = dict(state)
    new_state.update(tail=tail, prev=prev, fdl=fdl, pos=pos)
    if num_chunks:
        out = torch.stack(outs).permute(2, 0, 1, 3).reshape(c, num_chunks * s * b)[:, :t_len]
    else:
        out = signal[:, :0]
    return new_state, (out[0] if squeeze else out)
