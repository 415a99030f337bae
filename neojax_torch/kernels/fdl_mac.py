"""The FDL complex MAC-reduce, B1 (``csrc/fdl_mac.cu``).

Replaces ``neojax/kernels/fdl_mac.py`` · ``fdl_mac_pallas`` (the Pallas
kernels ``_kernel`` / ``_kernel_quant``). Computes, over split-complex
planes,

    acc[c, k] = sum_p fdl[p, c, k] * filt[p, c', k]          (complex)

with the int8/int16 dequantize ``x * (scale[p, c] * (1 / int_max))`` fused
in and f32 accumulation. The filter planes are already ring-rotated
(``conv.fdl.rotated_filter``), shared ([P, 1, K]) or per channel.

On the H100 the MAC is bound by device-memory bytes: it reads the whole
ring once per block (2*P*C*K storage elements: 252 MB split, 63 MB int8 at
P=960, C=64, K=512) for 8 flops per complex element. It runs on the
partition MAC that B2's ``step_mac`` runs too (``csrc/step_mac.cuh``): a
(lane tile, channel, P split) grid, :func:`step_geometry`'s S splits of the
P slots, and the splits' partial sums added in split order by a second
launch (no atomics: the same bits on every run). A thread owns V = 4 lanes
(one 16-byte load of each f32 filter plane; ring loads of 4 * itemsize
bytes), or V = 1 where K or a pointer's alignment forbids it: measured on
the H100, V = 16 / itemsize (16-byte ring loads) was slower for the
narrower storages, whose threads then were too few. A split sums at
least ``_MIN_SPLIT`` slots, so a ring of fewer than ``2 * _MIN_SPLIT``
slots (the hybrid head's 64) runs as one split, which writes the result
in the one launch and allocates only the result. It needs no
divisibility of P (the Pallas chunk-divides-P rule was a VMEM limit).

:func:`fdl_mac_reference` is the plain PyTorch version (float64 products):
the wrapper runs it for CPU tensors; on CUDA tensors the wrapper launches
the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from neojax_torch.kernels import _build

__all__ = ["fdl_mac", "fdl_mac_reference", "choose_chunks", "mac_geometry", "step_geometry", "STORAGE_CODES"]

# storage dtype -> the C entry points' storage code
STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2, torch.int8: 3}
_INT_MAX = {torch.int8: 127.0, torch.int16: 32767.0}

# The tile geometry of the tile-sparse schedule (``kernels.sparse_mac``),
# as neojax chooses it for its TPU MAC grid, so that both packages build the
# same schedule tables. B1 itself needs no tiling; B4 takes the geometry as
# arguments and works at any.
_K_TILE = 256
_VMEM_BUDGET = 8 * 1024 * 1024

# The partition MAC's grid (csrc/step_mac.cuh), shared by B1, B4 and B2's
# step_mac: CTAs to aim for over (lane tiles, channels, P splits), and the
# threads of a CTA (csrc: kStepThreads).
_STEP_CTAS = 1024
_STEP_LANES = 128
# B1/B4: slots a split sums at the least. A split's partial sums (2*C*K f32)
# then cost at most 1/16 of the ring bytes it reads (int8), and a ring of
# fewer than 128 slots runs in one launch. B1/B4 take as many splits as
# that allows (CTAs aimed at: _MAC_CTAS), so that B4's live slots, which
# crowd into a few splits, run in short loops.
_MIN_SPLIT = 64
_MAC_CTAS = 8 * _STEP_CTAS
_MAC_VEC_BYTES = 4  # V = 16 / 4: one 16-byte load of each f32 filter plane


def choose_chunks(dtype: torch.dtype, p: int, c: int, k: int) -> tuple[int, int]:
    """(k_tile, p_chunk) of ``neojax.kernels.fdl_mac.choose_chunks``: the
    lane tile, and the largest divisor of P whose double-buffered ring
    block fits the VMEM budget."""
    k_tile = min(_K_TILE, k)
    cap = max(1, min(p, _VMEM_BUDGET // max(1, 2 * c * k_tile * dtype.itemsize * 2)))
    pc = 1
    for d in range(cap, 0, -1):
        if p % d == 0:
            pc = d
            break
    return k_tile, pc


@functools.lru_cache(maxsize=256)
def step_geometry(p: int, c: int, k: int, itemsize: int, min_split: int = 1,
                  ctas: int = _STEP_CTAS) -> tuple[int, int, int]:
    """(splits S, slots a split, lanes a thread V) of the partition MAC over
    a ring [2, p, c, k]: V = 16 / itemsize (the element whose 16-byte loads
    set V: B2 its ring's, B1 its f32 filter's) where it divides K, else 1;
    S for about ``ctas`` CTAs, each split at least ``min_split`` slots. S
    depends on the shapes alone, so a result's bits do not depend on the
    pointers' alignment (which may only lower V)."""
    vec = 16 // itemsize
    vec = vec if k % vec == 0 else 1
    lane_tiles = -(-k // (vec * _STEP_LANES))
    s = max(1, min(p // min_split, -(-ctas // (c * lane_tiles))))
    per = -(-p // s)
    return -(-p // per), per, vec


def _aligned(fdl, filt_re, filt_im, vec: int) -> bool:
    """Whether the ring allows ``vec``-element loads and the f32 filter
    planes ``vec``-float loads."""
    return (fdl.data_ptr() % (vec * fdl.element_size()) == 0 and filt_re.data_ptr() % (4 * vec) == 0
            and filt_im.data_ptr() % (4 * vec) == 0)


def mac_geometry(fdl, filt_re, filt_im, k_tile: int | None = None) -> tuple[int, int, int]:
    """(splits S, slots a split, lanes a thread V) of B1/B4 on these
    operands, and of the probe T1 (``probes.ring_read_geometry``):
    :func:`step_geometry` at 4-lane loads, V = 1 where a pointer is not
    aligned to V elements or V does not divide B4's ``k_tile``."""
    _, p, c, k = fdl.shape
    s_n, per, vec = step_geometry(p, c, k, _MAC_VEC_BYTES, _MIN_SPLIT, _MAC_CTAS)
    if vec > 1 and (not _aligned(fdl, filt_re, filt_im, vec) or (k_tile or vec) % vec):
        vec = 1
    return s_n, per, vec


def _launch(name, fdl, filt_re, filt_im, scales, tiles=None):
    """Run the partition MAC on the card; ``tiles`` = (live row [P/pc, nk]
    uint8 pointer, pc, k_tile, nk) for B4. Returns acc [2, C, K] f32. The
    splits' partial sums take one allocation where S > 1 (never on the
    hybrid head's 64-slot ring, which is one split)."""
    _, p, c, k = fdl.shape
    live, pc, k_tile, nk = tiles or (0, 1, 1, 1)
    s_n, per, vec = mac_geometry(fdl, filt_re, filt_im, k_tile if tiles else None)
    acc = torch.empty((2, c, k), dtype=torch.float32, device=fdl.device)
    part = torch.empty((s_n, 2, c, k), dtype=torch.float32, device=fdl.device) if s_n > 1 else None
    code = _build.load().neo_fdl_mac(
        STORAGE_CODES[fdl.dtype], fdl.data_ptr(), filt_re.data_ptr(), filt_im.data_ptr(),
        0 if scales is None else scales.data_ptr(), live, acc.data_ptr(), 0 if part is None else part.data_ptr(),
        p, c, k, filt_re.shape[1], pc, k_tile, nk, s_n, per, vec, _build.stream_of(fdl),
    )
    _build.check(code, name)
    return acc


def _check_args(fdl, filt_re, filt_im, scales):
    if fdl.ndim != 4 or fdl.shape[0] != 2:
        raise ValueError(f"fdl must be [2, P, C, K], got {tuple(fdl.shape)}")
    if fdl.dtype not in STORAGE_CODES:
        raise TypeError(f"unsupported fdl dtype {fdl.dtype}")
    _, p, c, k = fdl.shape
    for name, f in (("filt_re", filt_re), ("filt_im", filt_im)):
        if f.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {f.dtype}")
        if f.ndim != 3 or f.shape[0] != p or f.shape[2] != k or f.shape[1] not in (1, c):
            raise ValueError(f"{name} must be [P, 1|C, K] = [{p}, 1|{c}, {k}], got {tuple(f.shape)}")
    if filt_re.shape != filt_im.shape:
        raise ValueError("filt_re and filt_im shapes differ")
    quant = fdl.dtype in _INT_MAX
    if quant != (scales is not None):
        raise ValueError("scales [P, C] are required for int storage and only for it")
    if quant and (scales.dtype != torch.float32 or tuple(scales.shape) != (p, c)):
        raise ValueError(f"scales must be float32 [{p}, {c}], got {scales.dtype} {tuple(scales.shape)}")
    tensors = [fdl, filt_re, filt_im] + ([scales] if quant else [])
    if any(t.device != fdl.device for t in tensors):
        raise ValueError("all fdl_mac operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fdl_mac operands must be contiguous")


def fdl_mac_reference(fdl, filt_re, filt_im, scales=None):
    """Plain PyTorch B1: float64 products and sum, dequant scale formed in
    f32 as the kernel forms it. Returns (acc_re, acc_im) [C, K] f32."""
    x = fdl.to(torch.float64)
    if scales is not None:
        s = (scales * (1.0 / _INT_MAX[fdl.dtype])).to(torch.float64)  # f32 product
        x = x * s[None, :, :, None]
    fr = filt_re.to(torch.float64)
    fi = filt_im.to(torch.float64)
    xr, xi = x[0], x[1]
    acc_re = torch.sum(xr * fr - xi * fi, dim=0)
    acc_im = torch.sum(xr * fi + xi * fr, dim=0)
    return acc_re.to(torch.float32), acc_im.to(torch.float32)


def fdl_mac(fdl, filt_re, filt_im, scales=None):
    """acc = sum_p fdl[p] * filt[p] in split-complex planes.

    fdl         : [2, P, C, K] f32 / bf16 / int16 / int8
    filt_re/_im : [P, C', K] f32 with C' in {1, C} (already ring-rotated)
    scales      : [P, C] f32 for int storage
    returns     : (acc_re, acc_im), each [C, K] f32
    """
    _check_args(fdl, filt_re, filt_im, scales)
    if fdl.device.type == "cpu":
        return fdl_mac_reference(fdl, filt_re, filt_im, scales)
    if fdl.device.type != "cuda":
        raise ValueError(f"fdl_mac: unsupported device {fdl.device}")
    acc = _launch("fdl_mac", fdl, filt_re, filt_im, scales)
    fdl_mac.launches += 1
    return acc[0], acc[1]


fdl_mac.launches = 0
