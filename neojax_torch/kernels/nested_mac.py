"""The nested (meta-FDL) partition MAC, B5 (``csrc/nested_mac.cu``).

Replaces ``neojax/kernels/nested_mac.py`` · ``nested_mac_pallas`` (Pallas
body ``_kernel``). Computes, elementwise per (c, k, m) over split-complex
meta planes,

    acc[c, k, m] = sum_p2 dq(x[p2, c, k, m]) * filt[p2, k, m]      (complex)

with ``dq(x) = x * (scale[p2, c, k, m // (L/G)] * (1 / int_max))`` for the
int8/int16 storages (G group scales along the L = 2S meta-bin axis) and
the identity for f32/bf16, and f32 accumulation. The filter is shared by
all channels and already ring-rotated: the nested engine passes the view
``filt[P2-1-pos : 2*P2-1-pos, 0]`` of its tiled filter, which is
contiguous, so no copy is made.

The group-scale expansion is computed exactly (scale times inv_max in
f32). On the TPU the Pallas kernel expands it through an f32
``dot_general`` with no ``precision=``, which Mosaic may run at one bf16
pass; the port follows the interpret-mode result, not that rounding.

:func:`nested_mac_reference` is the plain PyTorch version (float64
products): the wrapper runs it for CPU tensors; on CUDA tensors the wrapper
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from neojax_torch import trace
from neojax_torch.kernels import _build
from neojax_torch.kernels.fdl_mac import STORAGE_CODES

__all__ = ["nested_mac", "nested_mac_reference"]

_INT_MAX = {torch.int8: 127.0, torch.int16: 32767.0}


def _check_args(planes, scales, filt_re, filt_im):
    if planes.ndim != 5 or planes.shape[0] != 2:
        raise ValueError(f"planes must be [2, P2, C, K, L], got {tuple(planes.shape)}")
    if planes.dtype not in STORAGE_CODES:
        raise TypeError(f"unsupported planes dtype {planes.dtype}")
    _, p2, c, k, l = planes.shape
    for name, f in (("filt_re", filt_re), ("filt_im", filt_im)):
        if f.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {f.dtype}")
        if tuple(f.shape) != (p2, k, l):
            raise ValueError(f"{name} must be [P2, K, L] = [{p2}, {k}, {l}], got {tuple(f.shape)}")
    quant = planes.dtype in _INT_MAX
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
    tensors = [planes, filt_re, filt_im] + ([scales] if quant else [])
    if any(t.device != planes.device for t in tensors):
        raise ValueError("all nested_mac operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nested_mac operands must be contiguous")


def nested_mac_reference(planes, scales, filt_re, filt_im):
    """Plain PyTorch B5: float64 products and sum, the dequant scale formed
    in f32 as the kernel forms it. Returns (acc_re, acc_im) [C, K, L] f32."""
    x = planes.to(torch.float64)
    if scales is not None:
        l, g = planes.shape[-1], scales.shape[-1]
        s = (scales * (1.0 / _INT_MAX[planes.dtype])).to(torch.float64)  # f32 product
        x = x * s.repeat_interleave(l // g, dim=-1)[None]
    fr = filt_re.to(torch.float64)[:, None]
    fi = filt_im.to(torch.float64)[:, None]
    xr, xi = x[0], x[1]
    acc_re = torch.sum(xr * fr - xi * fi, dim=0)
    acc_im = torch.sum(xr * fi + xi * fr, dim=0)
    return acc_re.to(torch.float32), acc_im.to(torch.float32)


def nested_mac(planes, scales, filt_re, filt_im):
    """acc = sum_p2 dq(planes[p2]) * filt[p2], elementwise per (c, k, m).

    planes      : [2, P2, C, K, L] f32 / bf16 / int16 / int8 meta-FDL
    scales      : [P2, C, K, G] f32 group scales (int storage), else None
    filt_re/_im : [P2, K, L] f32, shared filter, already ring-rotated
    returns     : (acc_re, acc_im), each [C, K, L] f32
    """
    with trace.span("kernels.nested_mac"):
        _check_args(planes, scales, filt_re, filt_im)
        if planes.device.type == "cpu":
            return nested_mac_reference(planes, scales, filt_re, filt_im)
        if planes.device.type != "cuda":
            raise ValueError(f"nested_mac: unsupported device {planes.device}")
        _, p2, c, k, l = planes.shape
        acc_re = torch.empty((c, k, l), dtype=torch.float32, device=planes.device)
        acc_im = torch.empty((c, k, l), dtype=torch.float32, device=planes.device)
        code = _build.load().neo_nested_mac(
            STORAGE_CODES[planes.dtype], planes.data_ptr(),
            0 if scales is None else scales.data_ptr(),
            filt_re.data_ptr(), filt_im.data_ptr(), acc_re.data_ptr(), acc_im.data_ptr(),
            p2, c, k, l, 1 if scales is None else scales.shape[-1], _build.stream_of(planes),
        )
        _build.check(code, "nested_mac")
        nested_mac.launches += 1
        return acc_re, acc_im


nested_mac.launches = 0
