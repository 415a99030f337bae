"""The fused per-block pipeline, B2 (one block) and B3 (a whole UPOLS
stream), in ``csrc/fused_step.cu``.

Replaces ``neojax/kernels/fused_step.py`` · ``fused_block_step`` (Pallas
body ``_mk_kernel``) and ``fused_stream`` (body ``_mk_stream_kernel``). Per
block, for each channel:

    packed forward DFT (GEMV against ``cs``)  ->  [quantize +] ring-row
    insert at ``pos``  ->  rotated-filter MAC over P (the new row with its
    new scale; B3 may seed the sum from ``acc_add``)  ->  lane-0
    DC/Nyquist overwrite from ``dcfix``  ->  packed inverse DFT (GEMV
    against ``ab`` / the tail-half ``abt``)

Layout contract (as the JAX package's): packed-512 spectra, B = N/2 lanes,
re-plane lane 0 = DC.re, im-plane lane 0 = Nyquist.re; the filter arrives
lane-packed re|im ``filt_rim [2P, C', 2B]`` (tiled-reversed, C' in {1, C});
storage-matched matrix/filter dtype — bf16 for the bf16/int8 storages, f32
for split/int16 — with the frame (forward) and the accumulator (inverse)
rounded to that dtype first.

Design (H100). Channels are independent for the whole stream: the scale is
per channel, ``dcfix`` is per channel and the filter is read-only. So ONE
CTA owns ONE channel — for B3 over all nb blocks — and the CTA that writes
a ring row is the only one that ever reads it (after ``__syncthreads()``):
no grid-wide sync and no cross-CTA hazards. The ring is updated in place.

What bounds it: per block each CTA reads its channel's slice of the ring
(2*P*B storage elements: 3.9 MB split at P=960, B=512) and the rotated
filter (2*P*2B matrix-dtype elements, shared across channels through L2),
plus the DFT matrices (4 MB f32 forward + 2-4 MB inverse) from L2. Known
costs for later work: B3 fills only C = 64 of the 132 SMs at the headline
config, and every CTA re-reads the DFT matrices from L2 every block;
batching the channels into one tensor-core product removes the latter.

Sparse filters (``sched=``): the chunk schedule of
``kernels.sparse_mac.build_chunk_schedule`` — the FULL ``[P, L]`` int32
tables ``(c_idx, flags)`` from the params, on the ring's device. The
kernels read the row of the current position themselves (B2 row ``pos``,
B3 row ``(pos0 + i) % P``) and sum only its flag-1 chunks of
:func:`fused_chunk_rows` rows, each over its first ``B >> code`` lanes
(the width code in bits 16+). The TPU kernels take pre-paired ``[nb, 2, L]``
rows and ``[nb, 1, 2]`` counts instead: those only feed their lookahead
prefetch into SMEM, which these kernels do not have. Masked filter bins are
zero, so the skipped products are exact zeros.

The plain PyTorch versions (:func:`fused_block_step_reference`,
:func:`fused_stream_reference`, float64 products with operands rounded where
the kernel rounds them) run for CPU tensors; on CUDA tensors the wrappers
launch the kernel or raise. Both routes update the ring (and scales) in
place, so they can stand in for each other.
"""

from __future__ import annotations

import torch

from neojax_torch.kernels import _build
from neojax_torch.kernels.fdl_mac import STORAGE_CODES
from neojax_torch.kernels.sparse_mac import lane_widths

__all__ = [
    "MATRIX_DTYPES",
    "MAX_BLOCK",
    "fused_chunk_rows",
    "fused_block_step",
    "fused_block_step_reference",
    "fused_stream",
    "fused_stream_reference",
]

# storage dtype -> transform-matrix / fused-filter dtype
MATRIX_DTYPES = {
    torch.float32: torch.float32,
    torch.bfloat16: torch.bfloat16,
    torch.int16: torch.float32,
    torch.int8: torch.bfloat16,
}
_INT_MAX = {torch.int8: 127.0, torch.int16: 32767.0}
MAX_BLOCK = 1024  # the kernels' static shared-memory bound (kMaxB in csrc)

# Bytes per partition chunk of the chunk schedule, as neojax sizes its TPU
# DMA chunks (``neojax.kernels.fused_step._CHUNK_TARGET``), so both packages
# build the same tables. A module constant, so a test can shrink it in both.
_CHUNK_TARGET = 1024 * 1024


def fused_chunk_rows(dtype: torch.dtype, p: int, c: int, b: int) -> int:
    """Partition rows per schedule chunk (``neojax``'s ``fused_chunk_rows``):
    about ``_CHUNK_TARGET`` bytes of ring, an exact divisor of P,
    preferring multiples of 8."""
    bytes_per_row = 2 * c * b * dtype.itemsize
    cap = max(1, min(p, _CHUNK_TARGET // max(1, bytes_per_row)))
    if p % 8 == 0:
        cap = max(cap, 8)
        for d in range(cap - cap % 8, 7, -8):
            if p % d == 0:
                return d
    for d in range(cap, 0, -1):
        if p % d == 0:
            return d
    return 1


def _check_ring(fdl, filt_rim, scales, c: int):
    if fdl.ndim != 4 or fdl.shape[0] != 2 or fdl.shape[2] != c:
        raise ValueError(f"fdl must be [2, P, {c}, B], got {tuple(fdl.shape)}")
    if fdl.dtype not in STORAGE_CODES:
        raise TypeError(f"unsupported fdl dtype {fdl.dtype}")
    _, p, _, b = fdl.shape
    if b % 2 or b > MAX_BLOCK:
        raise ValueError(f"block size must be even and <= {MAX_BLOCK}, got {b}")
    mdt = MATRIX_DTYPES[fdl.dtype]
    if filt_rim.dtype != mdt:
        raise TypeError(f"filt_rim must be {mdt} for {fdl.dtype} storage, got {filt_rim.dtype}")
    if (filt_rim.ndim != 3 or filt_rim.shape[0] != 2 * p or filt_rim.shape[1] not in (1, c)
            or filt_rim.shape[2] != 2 * b):
        raise ValueError(f"filt_rim must be [{2 * p}, 1|{c}, {2 * b}], got {tuple(filt_rim.shape)}")
    quant = fdl.dtype in _INT_MAX
    if quant != (scales is not None):
        raise ValueError("scales [P, C] are required for int storage and only for it")
    if quant and (scales.dtype != torch.float32 or tuple(scales.shape) != (p, c)):
        raise ValueError(f"scales must be float32 [{p}, {c}], got {scales.dtype} {tuple(scales.shape)}")
    return p, b, mdt


def _check_common(tensors, name):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"all {name} operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _check_sched(sched, fdl):
    """Validate ``sched = (c_idx, flags)`` against the ring; returns the C
    entry points' (c_idx, flags, L, pc, n_codes), null pointers without a
    schedule."""
    _, p, c, b = fdl.shape
    widths = lane_widths(b)
    # the kernels compute a code's width as B >> code
    assert all(wd == b >> code for code, wd in enumerate(widths))
    if sched is None:
        return 0, 0, 0, 0, len(widths)
    c_idx, flags = sched
    for name, t in (("c_idx", c_idx), ("flags", flags)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.ndim != 2 or t.shape[0] != p:
            raise ValueError(f"sched {name} must be an int32 [{p}, L] tensor")
        if t.device != fdl.device or not t.is_contiguous():
            raise ValueError(f"sched {name} must be contiguous and on the ring's device")
    if c_idx.shape != flags.shape:
        raise ValueError("sched c_idx and flags shapes differ")
    pc = fused_chunk_rows(fdl.dtype, p, c, b)
    if c_idx.device.type == "cpu" and int((c_idx >> 16).max()) >= len(widths):
        raise ValueError(f"sched holds a width code outside lane_widths({b}) = {widths}")
    return c_idx.data_ptr(), flags.data_ptr(), c_idx.shape[1], pc, len(widths)


def _sched_live(sched, pos, p, b, pc):
    """[P, B] bool: the (row, lane) pairs that row ``pos`` of the chunk
    schedule sums (the plain versions' form of the kernels' loop)."""
    n_codes = len(lane_widths(b))
    live = torch.zeros((p, b), dtype=torch.bool)
    for v, fl in zip(sched[0][pos].tolist(), sched[1][pos].tolist()):
        if fl == 1:
            code = v >> 16
            cj = v & 0xFFFF
            live[cj * pc : (cj + 1) * pc, : b >> code if code < n_codes else b] = True
    return live


def _block_reference(frame, fdl, scales, rim, pos, dcfix, fwd, inv, seed=None, sched=None):
    """One block of the fused pipeline in plain PyTorch. fwd [N, 2B] and
    inv [2B, n_out] in the matrix dtype; ``seed`` [2, C, B] f32 starts the
    MAC sum (B3's ``acc_add``); ``sched`` (c_idx, flags) limits the MAC to
    row ``pos``'s chunks and lanes; updates fdl/scales row ``pos``."""
    p, b = fdl.shape[1], fdl.shape[3]
    spec = (frame.to(fwd.dtype).double() @ fwd.double()).to(torch.float32)  # [C, 2B]
    spec = torch.stack([spec[:, :b], spec[:, b:]])  # [2, C, B]
    if scales is not None:
        m = _INT_MAX[fdl.dtype]
        peak = torch.amax(torch.abs(spec), dim=(0, 2))
        scale = torch.where(peak > 0, peak, torch.ones_like(peak))
        q = torch.clamp(torch.round(spec / scale[None, :, None] * m), -m, m)
        fdl[:, pos] = q.to(fdl.dtype)
        scales[pos] = scale
    else:
        fdl[:, pos] = spec.to(fdl.dtype)

    rot = rim[p - 1 - pos : 2 * p - 1 - pos].double()  # [P, C', 2B]
    x = fdl.double()
    if scales is not None:
        x = x * (scales * (1.0 / _INT_MAX[fdl.dtype])).double()[None, :, :, None]
    fr, fi = rot[..., :b], rot[..., b:]
    if sched is not None:
        live = _sched_live(sched, pos, p, b, fused_chunk_rows(fdl.dtype, p, fdl.shape[2], b))
        live = live.to(rot.device)[:, None, :]
        fr = torch.where(live, fr, 0.0)
        fi = torch.where(live, fi, 0.0)
    acc_re = torch.sum(x[0] * fr - x[1] * fi, dim=0)
    acc_im = torch.sum(x[0] * fi + x[1] * fr, dim=0)
    if seed is not None:
        acc_re = acc_re + seed[0].double()
        acc_im = acc_im + seed[1].double()
    acc_re[:, 0] = dcfix[0].double()
    acc_im[:, 0] = dcfix[1].double()
    accp = torch.cat([acc_re, acc_im], dim=-1).to(torch.float32).to(inv.dtype)
    return (accp.double() @ inv.double()).to(torch.float32)


def fused_block_step_reference(frame, fdl, filt_rim, pos, dcfix, cs, ab, scales=None, sched=None):
    """Plain PyTorch B2; same contract as :func:`fused_block_step`."""
    b = fdl.shape[3]
    fwd = torch.cat([cs[0], cs[1]], dim=-1)  # [N, 2B]
    inv = ab.reshape(2 * b, -1)  # [2B, N]
    y = _block_reference(frame, fdl, scales, filt_rim, int(pos), dcfix, fwd, inv, sched=sched)
    return (y, fdl) if scales is None else (y, fdl, scales)


def fused_block_step(frame, fdl, filt_rim, pos, dcfix, cs, ab, scales=None, sched=None):
    """One fused streaming block step over the packed-layout ring FDL.

    frame   : [C, N] f32 (UPOLS sliding window / UPOLA zero-padded block)
    fdl     : [2, P, C, B] storage dtype, ring layout — row ``pos`` is
              written IN PLACE
    filt_rim: [2P, C', 2B] lane-packed re|im tiled-reversed filter, C' in
              {1, C}, matrix dtype (``MATRIX_DTYPES``)
    pos     : int ring write position
    dcfix   : [2, C] f32 exact DC/Nyquist accumulator values
    cs      : [2, N, B] forward packed-DFT matrices (cos | sin)
    ab      : [2, B, N] inverse packed-DFT matrices (1/N folded)
    scales  : [P, C] f32 (int8/int16 storages only) — row ``pos`` written
              in place
    sched   : optional chunk schedule ``(c_idx, flags)``, the full [P, L]
              int32 tables (module docstring); the kernel reads row ``pos``

    Returns (y [C, N] f32, fdl) or (y, fdl, scales).
    """
    if frame.ndim != 2 or frame.dtype != torch.float32:
        raise ValueError(f"frame must be float32 [C, N], got {frame.dtype} {tuple(frame.shape)}")
    c, n = frame.shape
    p, b, mdt = _check_ring(fdl, filt_rim, scales, c)
    pos = int(pos)
    if n != 2 * b or not 0 <= pos < p:
        raise ValueError(f"frame length {n} != 2B = {2 * b}, or pos {pos} outside [0, {p})")
    if cs.dtype != mdt or ab.dtype != mdt or tuple(cs.shape) != (2, n, b) or tuple(ab.shape) != (2, b, n):
        raise ValueError(f"cs/ab must be {mdt} [2, {n}, {b}] / [2, {b}, {n}]")
    if dcfix.dtype != torch.float32 or tuple(dcfix.shape) != (2, c):
        raise ValueError(f"dcfix must be float32 [2, {c}]")
    tensors = [frame, fdl, filt_rim, dcfix, cs, ab] + ([] if scales is None else [scales])
    _check_common(tensors, "fused_block_step")
    sc, sf, l_max, pc, n_codes = _check_sched(sched, fdl)
    if frame.device.type == "cpu":
        return fused_block_step_reference(frame, fdl, filt_rim, pos, dcfix, cs, ab, scales, sched)
    y = torch.empty((c, n), dtype=torch.float32, device=frame.device)
    code = _build.load().neo_fused_block_step(
        STORAGE_CODES[fdl.dtype], frame.data_ptr(), fdl.data_ptr(), filt_rim.data_ptr(),
        0 if scales is None else scales.data_ptr(), dcfix.data_ptr(),
        cs.data_ptr(), ab.data_ptr(), y.data_ptr(), sc, sf,
        p, c, b, filt_rim.shape[1], pos, l_max, pc, n_codes, _build.stream_of(frame),
    )
    _build.check(code, "fused_block_step")
    fused_block_step.launches += 1
    fused_block_step.sched_launches += sched is not None
    return (y, fdl) if scales is None else (y, fdl, scales)


fused_block_step.launches = 0
fused_block_step.sched_launches = 0


def fused_stream_reference(sigpad, fdl, filt_rim, pos0, dcfix_all, cs, abt, scales=None,
                           sched=None, acc_add=None):
    """Plain PyTorch B3 (a Python loop over blocks); same contract as
    :func:`fused_stream`."""
    c = sigpad.shape[0]
    p, b = fdl.shape[1], fdl.shape[3]
    nb = sigpad.shape[1] // b - 1
    out = torch.empty((c, nb * b), dtype=torch.float32, device=sigpad.device)
    for i in range(nb):
        frame = sigpad[:, i * b : i * b + 2 * b]
        pos = (int(pos0) + i) % p
        out[:, i * b : (i + 1) * b] = _block_reference(
            frame, fdl, scales, filt_rim, pos, dcfix_all[i], cs, abt,
            None if acc_add is None else acc_add[i], sched,
        )
    return (out, fdl) if scales is None else (out, fdl, scales)


def fused_stream(sigpad, fdl, filt_rim, pos0, dcfix_all, cs, abt, scales=None,
                 sched=None, acc_add=None):
    """Stream nb UPOLS blocks through ONE launch.

    sigpad   : [C, (nb+1)*B] f32 — [previous tail | signal]
    fdl      : [2, P, C, B] storage dtype, ring layout — updated IN PLACE
    filt_rim : as :func:`fused_block_step`
    pos0     : int ring write position of the FIRST block
    dcfix_all: [nb, 2, C] f32 per-block exact DC/Nyquist accumulators
               (``conv.convolver._dcfix_sequence``)
    cs       : [N, 2B] forward packed-DFT matrix, cos|sin lane-packed
    abt      : [2B, B] inverse matrix, last-B columns only (tail half)
    scales   : [P, C] f32 (int8/int16) — updated IN PLACE
    sched    : optional chunk schedule ``(c_idx, flags)``, the full [P, L]
               int32 tables (module docstring); block i reads row
               ``(pos0 + i) % P``
    acc_add  : optional [nb, 2, C, B] f32 per-block accumulator SEED
               (packed lanes; the MAC adds onto it, and the ``dcfix``
               overwrite of lane 0 comes after, so lane 0 of the seed is
               ignored). The hybrid engine's chunk-rate tail sum enters
               its per-block head through it (linearity of the sum).

    Returns (out [C, nb*B] f32, fdl) or (out, fdl, scales).
    """
    if sigpad.ndim != 2 or sigpad.dtype != torch.float32:
        raise ValueError(f"sigpad must be float32 [C, (nb+1)*B], got {sigpad.dtype} {tuple(sigpad.shape)}")
    c = sigpad.shape[0]
    p, b, mdt = _check_ring(fdl, filt_rim, scales, c)
    if sigpad.shape[1] % b or sigpad.shape[1] < 2 * b:
        raise ValueError(f"sigpad length {sigpad.shape[1]} is not (nb+1)*B with nb >= 1")
    nb = sigpad.shape[1] // b - 1
    n = 2 * b
    if cs.dtype != mdt or abt.dtype != mdt or tuple(cs.shape) != (n, 2 * b) or tuple(abt.shape) != (2 * b, b):
        raise ValueError(f"cs/abt must be {mdt} [{n}, {2 * b}] / [{2 * b}, {b}]")
    if dcfix_all.dtype != torch.float32 or tuple(dcfix_all.shape) != (nb, 2, c):
        raise ValueError(f"dcfix_all must be float32 [{nb}, 2, {c}]")
    if acc_add is not None and (acc_add.dtype != torch.float32
                                or tuple(acc_add.shape) != (nb, 2, c, b)):
        raise ValueError(f"acc_add must be float32 [{nb}, 2, {c}, {b}]")
    pos0 = int(pos0) % p
    tensors = [sigpad, fdl, filt_rim, dcfix_all, cs, abt] + [
        t for t in (scales, acc_add) if t is not None
    ]
    _check_common(tensors, "fused_stream")
    sc, sf, l_max, pc, n_codes = _check_sched(sched, fdl)
    if sigpad.device.type == "cpu":
        return fused_stream_reference(sigpad, fdl, filt_rim, pos0, dcfix_all, cs, abt, scales,
                                      sched, acc_add)
    out = torch.empty((c, nb * b), dtype=torch.float32, device=sigpad.device)
    code = _build.load().neo_fused_stream(
        STORAGE_CODES[fdl.dtype], sigpad.data_ptr(), fdl.data_ptr(), filt_rim.data_ptr(),
        0 if scales is None else scales.data_ptr(), dcfix_all.data_ptr(),
        0 if acc_add is None else acc_add.data_ptr(),
        cs.data_ptr(), abt.data_ptr(), out.data_ptr(), sc, sf,
        p, c, b, filt_rim.shape[1], nb, pos0, l_max, pc, n_codes, _build.stream_of(sigpad),
    )
    _build.check(code, "fused_stream")
    fused_stream.launches += 1
    fused_stream.sched_launches += sched is not None
    return (out, fdl) if scales is None else (out, fdl, scales)


fused_stream.launches = 0
fused_stream.sched_launches = 0
