"""Measurement probes T1 and T2 (``csrc/probes.cu``): B1's ring read and
B3's partial pipelines, each beside its plain PyTorch version.

T1 :func:`probe_ring_read` replaces ``tools/roofline_cal.py`` · ``dma_only``
(Pallas body ``_stripped``): B1's read of the ring with the compute
stripped, on B1's grid and thread-per-lane mapping, so that its time is
B1's read time. It loads every element of both planes:

    out0[c, k] = sum_j fdl[0, j*pc, c, k] * fr[j*pc, k]      (j < P / pc)
    out1[c, k] = the sum of every other loaded element of (c, k)

``out0`` is the TPU probe's function at ``choose_chunks``' geometry; ``out1``
keeps every load alive and checkable. Storages: split (f32) and bf16.

T2 :func:`probe_stream` replaces ``tools/fused_probe.py`` · ``run_empty``
(body ``k_empty``) and ``run_tf`` (body ``k_tf``): B3's grid (one CTA per
channel over nb blocks) running B3's own stage code
(``csrc/fused_block.cuh``) up to a point:

    "empty"       : out = 0
    "win_fwd"     : window + forward packed DFT, out = spec[:B] + spec[B:]
    "win_fwd_inv" : window + forward DFT, the spectrum rounded to the
                    matrix dtype, then B3's tail-half inverse DFT

on B3's matrix layout (``cs [N, 2B]``, ``abt [2B, B]``, f32 or bf16; the
frame is rounded to the matrix dtype first, as in B3).

On CPU tensors the wrappers run the plain versions (float64 products,
operands rounded where the kernels round them); on CUDA tensors they launch
the kernel or raise. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from neojax_torch.kernels import _build
from neojax_torch.kernels.fdl_mac import STORAGE_CODES
from neojax_torch.kernels.fused_step import MAX_BLOCK

__all__ = [
    "PROBE_MODES",
    "probe_ring_read",
    "probe_ring_read_reference",
    "probe_stream",
    "probe_stream_reference",
]

PROBE_MODES = {"empty": 0, "win_fwd": 1, "win_fwd_inv": 2}
_RING_DTYPES = (torch.float32, torch.bfloat16)


def _check_ring_read(fdl, fr, pc):
    if fdl.ndim != 4 or fdl.shape[0] != 2:
        raise ValueError(f"fdl must be [2, P, C, K], got {tuple(fdl.shape)}")
    if fdl.dtype not in _RING_DTYPES:
        raise TypeError(f"probe_ring_read takes f32 or bf16 rings, got {fdl.dtype}")
    _, p, _, k = fdl.shape
    if fr.dtype != torch.float32 or tuple(fr.shape) != (p, k):
        raise ValueError(f"fr must be float32 [{p}, {k}], got {fr.dtype} {tuple(fr.shape)}")
    if pc < 1 or p % pc:
        raise ValueError(f"pc = {pc} must divide P = {p}")
    if fr.device != fdl.device or not (fdl.is_contiguous() and fr.is_contiguous()):
        raise ValueError("fdl and fr must be contiguous and on one device")


def probe_ring_read_reference(fdl, fr, pc: int):
    """Plain T1 in float64: (out0, out1) [C, K] f32."""
    x = fdl.double()
    heads = x[0, ::pc]  # [P/pc, C, K]
    out0 = torch.sum(heads * fr[::pc].double()[:, None, :], dim=0)
    out1 = torch.sum(x, dim=(0, 1)) - torch.sum(heads, dim=0)
    return out0.float(), out1.float()


def probe_ring_read(fdl, fr, pc: int):
    """T1: read the whole ring [2, P, C, K] on B1's grid.

    fdl : [2, P, C, K] f32 or bf16
    fr  : [P, K] f32 (a rotated filter plane; only the chunk heads are read)
    pc  : rows a chunk (``fdl_mac.choose_chunks``), dividing P
    returns (out0, out1), each [C, K] f32 (module docstring)
    """
    pc = int(pc)
    _check_ring_read(fdl, fr, pc)
    if fdl.device.type == "cpu":
        return probe_ring_read_reference(fdl, fr, pc)
    if fdl.device.type != "cuda":
        raise ValueError(f"probe_ring_read: unsupported device {fdl.device}")
    _, p, c, k = fdl.shape
    out0 = torch.empty((c, k), dtype=torch.float32, device=fdl.device)
    out1 = torch.empty((c, k), dtype=torch.float32, device=fdl.device)
    code = _build.load().neo_probe_ring_read(
        STORAGE_CODES[fdl.dtype], fdl.data_ptr(), fr.data_ptr(), out0.data_ptr(), out1.data_ptr(),
        p, c, k, pc, _build.stream_of(fdl),
    )
    _build.check(code, "probe_ring_read")
    probe_ring_read.launches += 1
    return out0, out1


probe_ring_read.launches = 0


def _check_stream(sigpad, cs, abt, mode):
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {sorted(PROBE_MODES)}, got {mode!r}")
    if sigpad.ndim != 2 or sigpad.dtype != torch.float32:
        raise ValueError(f"sigpad must be float32 [C, (nb+1)*B], got {sigpad.dtype} {tuple(sigpad.shape)}")
    if cs.ndim != 2 or cs.shape[1] != cs.shape[0]:
        raise ValueError(f"cs must be [N, 2B] with N = 2B, got {tuple(cs.shape)}")
    n = cs.shape[0]
    b = n // 2
    if n % 2 or b > MAX_BLOCK:
        raise ValueError(f"block size must be even and <= {MAX_BLOCK}, got N = {n}")
    if cs.dtype not in _RING_DTYPES or abt.dtype != cs.dtype or tuple(abt.shape) != (2 * b, b):
        raise ValueError(f"cs/abt must be f32 or bf16 [{n}, {2 * b}] / [{2 * b}, {b}] of one dtype")
    if sigpad.shape[1] % b or sigpad.shape[1] < 2 * b:
        raise ValueError(f"sigpad length {sigpad.shape[1]} is not (nb+1)*B with nb >= 1")
    tensors = (sigpad, cs, abt)
    if any(t.device != sigpad.device for t in tensors) or not all(t.is_contiguous() for t in tensors):
        raise ValueError("probe_stream operands must be contiguous and on one device")
    return b, sigpad.shape[1] // b - 1


def probe_stream_reference(sigpad, cs, abt, mode: str):
    """Plain T2, all blocks at once: out [C, nb*B] f32."""
    b, nb = _check_stream(sigpad, cs, abt, mode)
    c = sigpad.shape[0]
    if mode == "empty":
        return torch.zeros((c, nb * b), dtype=torch.float32, device=sigpad.device)
    frames = sigpad.unfold(1, 2 * b, b)[:, :nb]  # [C, nb, N]
    spec = (frames.to(cs.dtype).double() @ cs.double()).float()  # [C, nb, 2B]
    if mode == "win_fwd":
        out = spec[..., :b] + spec[..., b:]
    else:
        out = (spec.to(abt.dtype).double() @ abt.double()).float()
    return out.reshape(c, nb * b)


def probe_stream(sigpad, cs, abt, mode: str):
    """T2: B3's grid and stage code, cut after the given stage.

    sigpad : [C, (nb+1)*B] f32 — [previous tail | signal], as B3's
    cs     : [N, 2B] forward packed-DFT matrix (f32 or bf16)
    abt    : [2B, B] tail-half inverse, the dtype of ``cs``
    mode   : "empty", "win_fwd" or "win_fwd_inv" (module docstring)
    returns out [C, nb*B] f32
    """
    b, nb = _check_stream(sigpad, cs, abt, mode)
    if sigpad.device.type == "cpu":
        return probe_stream_reference(sigpad, cs, abt, mode)
    if sigpad.device.type != "cuda":
        raise ValueError(f"probe_stream: unsupported device {sigpad.device}")
    c = sigpad.shape[0]
    out = torch.empty((c, nb * b), dtype=torch.float32, device=sigpad.device)
    code = _build.load().neo_probe_stream(
        int(cs.dtype == torch.bfloat16), PROBE_MODES[mode], sigpad.data_ptr(), cs.data_ptr(),
        abt.data_ptr(), out.data_ptr(), c, b, nb, _build.stream_of(sigpad),
    )
    _build.check(code, "probe_stream")
    probe_stream.launches += 1
    return out


probe_stream.launches = 0
