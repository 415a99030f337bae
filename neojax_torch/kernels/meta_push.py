"""The nested engine's meta push (``csrc/meta_push.cu``): one meta row into
the meta-FDL ring, in place.

Replaces no Pallas kernel: ``neojax.conv.nested`` inserts the row with
``jnp`` ops inside its jitted chunk step. For each ``(c, k)`` and group of
``L / G`` meta-bins, the int8/int16 storages keep the group's peak as its
scale (1 where the peak is 0) and store ``clamp(rint(x / scale * int_max),
-int_max, int_max)`` (half to even, as ``jnp.round``); f32 and bf16 store
the row as it is, cast. Used by ``conv.nested.process_nested``, the hybrid
engine's chunk-rate tail and ``dist.partnested``'s insert.

:func:`meta_push_reference` is the plain PyTorch version: the wrapper runs
it for CPU tensors; on CUDA tensors the wrapper launches the kernel, which
gives the same bits, or raises. The kernel reads ``xre``/``xim`` through
their strides, so the ``.real``/``.imag`` views of the meta-FFT's complex
output go in as they are, and allocates nothing.
"""

from __future__ import annotations

import torch

from neojax_torch.kernels import _build
from neojax_torch.kernels.fdl_mac import STORAGE_CODES
from neojax_torch.ops.quantize import int_max_for

__all__ = ["meta_push", "meta_push_reference"]

_QUANT = (torch.int8, torch.int16)


def _check_args(fdl, scales, pos, xre, xim):
    if fdl.ndim != 5 or fdl.shape[0] != 2:
        raise ValueError(f"fdl must be [2, P2, C, K, L], got {tuple(fdl.shape)}")
    if fdl.dtype not in STORAGE_CODES:
        raise TypeError(f"unsupported fdl dtype {fdl.dtype}")
    _, p2, c, k, l = fdl.shape
    if not 0 <= pos < p2:
        raise ValueError(f"pos {pos} is not a ring slot of P2 = {p2}")
    for name, x in (("xre", xre), ("xim", xim)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (c, k, l):
            raise ValueError(f"{name} must be [C, K, L] = [{c}, {k}, {l}], got {tuple(x.shape)}")
    if xre.stride() != xim.stride():
        raise ValueError(f"xre and xim must share their strides, got {xre.stride()} and {xim.stride()}")
    quant = fdl.dtype in _QUANT
    if quant != (scales is not None):
        raise ValueError("scales [P2, C, K, G] are required for int storage and only for it")
    if quant:
        g = scales.shape[-1]
        if (scales.dtype != torch.float32 or scales.ndim != 4
                or tuple(scales.shape[:3]) != (p2, c, k) or g < 1 or l % g):
            raise ValueError(
                f"scales must be float32 [{p2}, {c}, {k}, G] with G dividing {l}, "
                f"got {scales.dtype} {tuple(scales.shape)}"
            )
    tensors = [fdl, xre, xim] + ([scales] if quant else [])
    if any(t.device != fdl.device for t in tensors):
        raise ValueError("all meta_push operands must be on one device")
    if not fdl.is_contiguous() or (quant and not scales.is_contiguous()):
        raise ValueError("fdl and scales must be contiguous")


def meta_push_reference(fdl, scales, pos: int, xre, xim) -> None:
    """Plain PyTorch push: write the meta row ([C, K, L] re/im, f32) at ring
    slot ``pos`` of ``fdl`` (and its group scales at ``scales[pos]``), in
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


def meta_push(fdl, scales, pos: int, xre, xim) -> None:
    """Write one meta row into ring slot ``pos``, in place.

    fdl      : [2, P2, C, K, L] f32 / bf16 / int16 / int8 meta-FDL
    scales   : [P2, C, K, G] f32 group scales (int storage), else None
    pos      : the ring slot, 0 <= pos < P2
    xre, xim : [C, K, L] f32, any strides the two share (the meta-FFT's
               ``.real`` / ``.imag`` views)
    """
    _check_args(fdl, scales, pos, xre, xim)
    if fdl.device.type == "cpu":
        meta_push_reference(fdl, scales, pos, xre, xim)
        return
    if fdl.device.type != "cuda":
        raise ValueError(f"meta_push: unsupported device {fdl.device}")
    _, p2, c, k, l = fdl.shape
    code = _build.load().neo_meta_push(
        STORAGE_CODES[fdl.dtype], fdl.data_ptr(), 0 if scales is None else scales.data_ptr(),
        xre.data_ptr(), xim.data_ptr(), *xre.stride(), p2, pos, c, k, l,
        1 if scales is None else scales.shape[-1], _build.stream_of(fdl),
    )
    _build.check(code, "meta_push")
    meta_push.launches += 1


meta_push.launches = 0
