"""Uniformly partitioned overlap-save convolution, written out plainly.

For partition spectra ``H [C, P, K]`` (K = B + 1 bins of a 2B-point real
FFT; a masked filter has its dropped bins zeroed; ``[P, K]``, one filter
that every channel shares, is ``H_p[c] = H_p`` for every c) and an input
stream of B-sample blocks ``x_j[c]`` (zero before the stream starts),
output block g of channel c is

    X_j[c] = rfft([x_{j-1}[c] | x_j[c]])          (2B points)
    Y_g[c] = sum_{p < P} X_{g-p}[c] * H_p[c]
    y_g[c] = irfft(Y_g[c])[B:]

which, for spectra partitioned from a real IR, is its linear convolution.
Every output block is computed on its own from the input blocks
``g - P .. g``, so nothing of the program's state or tables is used.

``precision``:
  - ``"f64"``: the reference, in float64 throughout;
  - ``"tf32"``: the control for a float32 configuration, the same sum with
    float32 transforms and the spectra and filter rounded to TF32 (a
    10-bit mantissa) before a float32 multiply-accumulate: what a TF32
    tensor-core product in place of the float32 one would give;
  - ``"int4"``: the control for an int8 delay line, the same sum with
    float32 transforms, a float32 filter and the input spectra (the delay
    line) stored as int4: each plane on the grid of 7 steps each way, one
    scale a channel, frame and group of 4 bins, at the group's peak over
    both planes (what a 4-bit ring with dynamic scales, 4 values a scale as
    the nested engine's int8 meta ring has, would hold).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["partition", "round_tf32", "quantize_groups", "output_blocks"]


def partition(ir: np.ndarray, block: int) -> np.ndarray:
    """IR [taps] -> complex64 spectra [P, B + 1], or IRs [C, taps] -> [C, P,
    B + 1]: each B-sample segment zero-padded to 2B and transformed (float32
    input, as a deployment loads its IR)."""
    ir = np.asarray(ir, np.float32)
    lead = ir.shape[:-1]
    p = -(-ir.shape[-1] // block)
    padded = np.zeros(lead + (p * block,), np.float32)
    padded[..., : ir.shape[-1]] = ir
    return np.fft.rfft(padded.reshape(lead + (p, block)), n=2 * block, axis=-1).astype(np.complex64)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties to
    even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _round_complex(z: torch.Tensor) -> torch.Tensor:
    return torch.complex(round_tf32(z.real), round_tf32(z.imag))


def quantize_groups(z: torch.Tensor, bits: int = 4, group: int = 4) -> torch.Tensor:
    """complex [..., K] -> each plane rounded to the symmetric grid of
    ``2**(bits-1) - 1`` steps each way, one scale a group of ``group`` bins
    along the last axis (the last group shorter), at the group's peak over
    both planes."""
    qmax = 2 ** (bits - 1) - 1
    k = z.shape[-1]
    planes = torch.nn.functional.pad(torch.stack([z.real, z.imag]), (0, -k % group))
    grouped = planes.unflatten(-1, (-1, group))  # [2, ..., G, group]
    peak = grouped.abs().amax(dim=-1, keepdim=True).amax(dim=0, keepdim=True)
    scale = torch.where(peak > 0, peak / qmax, torch.ones_like(peak))
    q = (torch.round(grouped / scale).clamp(-qmax, qmax) * scale).flatten(-2)[..., :k]
    return torch.complex(q[0], q[1])


def output_blocks(segment, spectra: np.ndarray, blocks, block: int, precision: str = "f64",
                  device="cpu", channel_chunk: int = 16) -> dict[int, torch.Tensor]:
    """Output blocks ``{g: y_g [C, B] float64 on the host}`` for each g in
    ``blocks``.

    segment : ``segment(g0, g1) -> [C, (g1 - g0) * B]`` input blocks g0 .. g1-1
              as a tensor (any float dtype, any device; zeros for g < 0)
    spectra : [P, B + 1] complex partition spectra (masked bins zeroed),
              shared by every channel, or [C, P, B + 1], channel c's own
    """
    if precision not in ("f64", "tf32", "int4"):
        raise ValueError(f"unknown precision {precision!r}")
    real = torch.float64 if precision == "f64" else torch.float32
    per_channel = spectra.ndim == 3
    p = spectra.shape[-2]
    h = torch.from_numpy(np.ascontiguousarray(spectra)).to(device)
    if precision == "f64":
        h = h.to(torch.complex128)
    else:
        h = h.to(torch.complex64)
        h = _round_complex(h) if precision == "tf32" else h
    h_rev = h.flip(-2)  # row i multiplies frame g - P + 1 + i
    out = {}
    for g in blocks:
        g = int(g)
        seg = segment(g - p, g + 1).to(device=device, dtype=real)  # blocks g-P .. g
        if per_channel and seg.shape[0] != h.shape[0]:
            raise ValueError(f"{h.shape[0]} channels of filter for {seg.shape[0]} of input")
        ys = []
        for c0 in range(0, seg.shape[0], channel_chunk):
            frames = seg[c0 : c0 + channel_chunk].unfold(-1, 2 * block, block)  # [c, P, 2B]: frames g-P+1 .. g
            x = torch.fft.rfft(frames, dim=-1)
            if precision == "tf32":
                x = _round_complex(x)
            elif precision == "int4":
                x = quantize_groups(x)
            if per_channel:
                acc = torch.einsum("cpk,cpk->ck", x, h_rev[c0 : c0 + x.shape[0]])
            else:
                acc = torch.einsum("cpk,pk->ck", x, h_rev)
            ys.append(torch.fft.irfft(acc, n=2 * block, dim=-1)[:, block:])
        out[g] = torch.cat(ys).to(torch.float64).cpu()
    return out
