"""Frequency-delay-line storage and the partition MAC-reduce (``neojax.conv.fdl``).

Counterpart of the reference's FDL machinery: ``fdl_index``
(``src/neo/convolution/fdl_index.hpp:13-36``), ``dense_fdl`` /
``dense_split_fdl`` (``dense_fdl.hpp:14,38``), ``compressed_fdl``
(``compressed_fdl.hpp:17``) and the complex ``multiply_add`` reduction
(``algorithm/multiply_add.hpp:280-368``).

Two layouts, as in the JAX package:

*shift* — the newest spectrum at partition 0; insertion shifts the array.
*ring* (default) — a ring buffer plus a modular write position; the filter
is stored reversed and tiled twice ``[2P, C', K]`` so the rotated filter is
the contiguous slice starting at ``P - 1 - write_pos``.

Storage:
  dense       : complex64  ``[P, C, K]``
  split/bf16  : f32/bf16   ``[2, P, C, K]``  (plane 0 = re, 1 = im)
  int16/int8  : tuple of intN ``[2, P, C, K]`` + f32 scales ``[P, C, 1]``

Unlike the JAX package (pure functions over donated buffers), every push
here **writes the delay line in place** and returns the same tensors: the
ring is the convolver's largest state (252 MB at the headline config), and
an in-place row write is what XLA's buffer donation achieved.

Quantized rows carry a dynamic per-channel scale (max-abs over both planes)
and round half to even (``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

import torch

from neojax_torch.ops.quantize import int_max_for

__all__ = [
    "STORAGE_DTYPES",
    "fdl_init",
    "fdl_push_dense",
    "fdl_push_split",
    "fdl_mac_dense",
    "fdl_mac_split",
    "tile_reverse_filter",
    "rotated_filter",
    "fdl_ring_push_dense",
    "fdl_ring_push_split",
    "fdl_packed_init",
    "fdl_packed_push",
    "dcny_mac",
]

STORAGE_DTYPES = {
    "dense": torch.complex64,
    "split": torch.float32,
    "bf16": torch.bfloat16,
    "int16": torch.int16,
    "int8": torch.int8,
}


def _is_quantized(dtype: torch.dtype) -> bool:
    return dtype in (torch.int8, torch.int16)


def fdl_init(storage: str, num_partitions: int, channels: int, bins: int, device=None):
    dtype = STORAGE_DTYPES[storage]
    if storage == "dense":
        return torch.zeros((num_partitions, channels, bins), dtype=dtype, device=device)
    planes = torch.zeros((2, num_partitions, channels, bins), dtype=dtype, device=device)
    if _is_quantized(dtype):
        scales = torch.ones((num_partitions, channels, 1), dtype=torch.float32, device=device)
        return (planes, scales)
    return planes


def _quantize(spec: torch.Tensor, dtype: torch.dtype):
    """[2, C, K] f32 -> (int planes [2, C, K], scale [C, 1]) at the
    per-channel dynamic scale."""
    m = int_max_for(dtype)
    peak = torch.amax(torch.abs(spec), dim=(0, 2))  # [C]
    scale = torch.where(peak > 0, peak, torch.ones_like(peak))[:, None]  # [C, 1]
    q = torch.clamp(torch.round(spec / scale[None] * m), -m, m).to(dtype)
    return q, scale


def fdl_push_dense(fdl: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """Shift layout: insert spec [C, K] as the newest entry of fdl [P, C, K]
    (in place)."""
    fdl[1:] = fdl[:-1].clone()
    fdl[0] = spec.to(fdl.dtype)
    return fdl


def fdl_push_split(fdl, spec_re: torch.Tensor, spec_im: torch.Tensor):
    """Shift layout: insert (re, im) [C, K] planes into the split FDL (in
    place). Int storage quantizes at a per-channel dynamic scale."""
    spec = torch.stack([spec_re, spec_im]).to(torch.float32)  # [2, C, K]
    if isinstance(fdl, tuple):
        planes, scales = fdl
        q, scale = _quantize(spec, planes.dtype)
        planes[:, 1:] = planes[:, :-1].clone()
        planes[:, 0] = q
        scales[1:] = scales[:-1].clone()
        scales[0] = scale
        return (planes, scales)
    fdl[:, 1:] = fdl[:, :-1].clone()
    fdl[:, 0] = spec.to(fdl.dtype)
    return fdl


def fdl_mac_dense(fdl: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """acc[c,k] = sum_p fdl[p,c,k] * filt[p,c,k] (filt channel dim may be 1)."""
    return torch.sum(fdl * filt, dim=0)


# ----------------------------------------------------------------- ring ops


def tile_reverse_filter(filt: torch.Tensor) -> torch.Tensor:
    """[P, C', K] -> [2P, C', K] reversed+tiled, so that the rotation
    ``filt[(w - i) % P]`` for i in 0..P-1 equals the contiguous window
    ``tiled[P - 1 - w : 2P - 1 - w]``."""
    rev = torch.flip(filt, dims=(0,))
    return torch.cat([rev, rev], dim=0)


def rotated_filter(filt_tiled: torch.Tensor, write_pos: int, num_partitions: int) -> torch.Tensor:
    """Contiguous view of the tiled filter aligned to the ring:
    result[i] = filt[(write_pos - i) mod P]."""
    start = num_partitions - 1 - int(write_pos)
    return filt_tiled[start : start + num_partitions]


def fdl_ring_push_dense(fdl: torch.Tensor, spec: torch.Tensor, write_pos: int) -> torch.Tensor:
    """In-place insert of spec [C, K] at ring slot write_pos."""
    fdl[int(write_pos)] = spec.to(fdl.dtype)
    return fdl


def fdl_ring_push_split(fdl, spec_re: torch.Tensor, spec_im: torch.Tensor, write_pos: int):
    """In-place insert of (re, im) [C, K] planes at ring slot write_pos."""
    pos = int(write_pos)
    spec = torch.stack([spec_re, spec_im]).to(torch.float32)  # [2, C, K]
    if isinstance(fdl, tuple):
        planes, scales = fdl
        q, scale = _quantize(spec, planes.dtype)
        planes[:, pos] = q
        scales[pos] = scale
        return (planes, scales)
    fdl[:, pos] = spec.to(fdl.dtype)
    return fdl


# ------------------------------------------------------- packed-512 layout
#
# B lanes per plane: lane 0 holds DC.re in the re-plane and Nyquist.re in
# the im-plane; the exact DC/Nyquist history rides in an f32 side-carry
# ``dcny [P, C, 2]`` whose real MAC overwrites the lane-0 complex product.


def fdl_packed_init(storage: str, num_partitions: int, channels: int, block: int, device=None):
    """Packed-layout FDL state: (planes-or-(planes,scales), dcny [P,C,2])."""
    if storage == "dense":
        raise ValueError("packed layout is split-plane only")
    fdl = fdl_init(storage, num_partitions, channels, block, device)
    dcny = torch.zeros((num_partitions, channels, 2), dtype=torch.float32, device=device)
    return fdl, dcny


def fdl_packed_push(fdl, dcny: torch.Tensor, spec_re, spec_im, write_pos: int):
    """Ring-insert a packed spectrum ([C, B] planes) + its exact DC/Ny pair
    (both in place)."""
    new_fdl = fdl_ring_push_split(fdl, spec_re, spec_im, write_pos)
    dcny[int(write_pos)] = torch.stack([spec_re[:, 0], spec_im[:, 0]], dim=-1).to(torch.float32)
    return new_fdl, dcny


def dcny_mac(dcny: torch.Tensor, filt_dcny: torch.Tensor) -> torch.Tensor:
    """Exact DC/Nyquist partition reduce: [P, C, 2] x [P, C', 2] -> [C, 2]
    (two real-only bins, plain real MACs), summed in float64."""
    return torch.sum(dcny.double() * filt_dcny.double(), dim=0).to(torch.float32)


def fdl_mac_split(fdl, filt_re: torch.Tensor, filt_im: torch.Tensor):
    """Split-complex MAC-reduce with dequantization, in float32 tensor ops.

    fdl: [2, P, C, K] float planes, or (int planes, scales) tuple.
    filt planes [P, C', K] f32 with C' in {C, 1}.
    Returns (acc_re, acc_im) [C, K] f32.
    """
    if isinstance(fdl, tuple):
        planes, scales = fdl
        m = int_max_for(planes.dtype)
        x = planes.to(torch.float32) * (scales * (1.0 / m))[None]
    else:
        x = fdl.to(torch.float32)
    xr, xi = x[0], x[1]
    acc_re = torch.sum(xr * filt_re - xi * filt_im, dim=0)
    acc_im = torch.sum(xr * filt_im + xi * filt_re, dim=0)
    return acc_re, acc_im
