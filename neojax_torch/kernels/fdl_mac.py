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
P=960, C=64, K=512) for 8 flops per complex element. The kernel gives each
thread one output lane (coalesced along k), loops over P in registers (no
cross-CTA atomics, no partial sums in memory) and reads the storage dtype
directly, so narrower storages move proportionally fewer bytes. It needs
no divisibility of P (the Pallas chunk-divides-P rule was a VMEM limit).

:func:`fdl_mac_reference` is the plain PyTorch version (float64 products):
the wrapper runs it for CPU tensors; on CUDA tensors the wrapper launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from neojax_torch.kernels import _build

__all__ = ["fdl_mac", "fdl_mac_reference", "choose_chunks", "STORAGE_CODES"]

# storage dtype -> the C entry points' storage code
STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2, torch.int8: 3}
_INT_MAX = {torch.int8: 127.0, torch.int16: 32767.0}

# The tile geometry of the tile-sparse schedule (``kernels.sparse_mac``),
# as neojax chooses it for its TPU MAC grid, so that both packages build the
# same schedule tables. B1 itself needs no tiling; B4 takes the geometry as
# arguments and works at any.
_K_TILE = 256
_VMEM_BUDGET = 8 * 1024 * 1024


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
    _, p, c, k = fdl.shape
    acc_re = torch.empty((c, k), dtype=torch.float32, device=fdl.device)
    acc_im = torch.empty((c, k), dtype=torch.float32, device=fdl.device)
    lib = _build.load()
    code = lib.neo_fdl_mac(
        STORAGE_CODES[fdl.dtype], fdl.data_ptr(), filt_re.data_ptr(), filt_im.data_ptr(),
        0 if scales is None else scales.data_ptr(),
        acc_re.data_ptr(), acc_im.data_ptr(),
        p, c, k, filt_re.shape[1], _build.stream_of(fdl),
    )
    _build.check(code, "fdl_mac")
    fdl_mac.launches += 1
    return acc_re, acc_im


fdl_mac.launches = 0
