"""Large-N FFT via the recursive four-step (Bailey) decomposition, as DFT
products (``neojax.fft.four_step``).

For N = N1*N2 the DFT factors into

  1. N1-point DFTs over the n1 axis of the [N1, N2] reshape,
  2. a twiddle multiply by W_N^(n2*k1),
  3. N2-point DFTs over the n2 axis,
  4. an index transpose (output k = k1 + N1*k2).

The leaves are :func:`fft.matmul_backend.fft_split`'s split-complex DFT
products, [batch, R] @ [R, R] in IEEE float32 whatever the caller's TF32
flags (``core.device.ieee_float32``). Factors above the leaf cutoff
recurse, so there is no upper size limit: any power of two that fits in
device memory. This is the ``"matmul"`` backend of ``fft.api`` above
``_MATMUL_MAX_SIZE``; ``torch.fft`` (cuFFT) is the route everywhere
else, the streaming convolver's large blocks included.

Real transforms use the half-size packing (one N/2-point C2C transform
and an O(N) post-twiddle, ``fft.extras.pack_forward_post``), half the
products of a zero-imaginary full transform.

Each function runs where its input tensor lies; host input (numpy,
lists) goes to ``device`` (None: the card, ``core.device.as_tensor``).
Unnormalized forward, normalized inverse at the real transforms, as in
the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from neojax_torch.core.bits import bit_log2
from neojax_torch.core.device import as_tensor, as_tensors
from neojax_torch.fft import matmul_backend

__all__ = [
    "fft_split_large",
    "rfft_split_large",
    "irfft_split_large",
    "rfft_packed_split_large",
    "irfft_packed_split_large",
    "split_n",
]

# Largest leaf DFT evaluated as a dense product (the JAX package's cutoff).
_LEAF = 512


def split_n(n: int) -> tuple[int, int]:
    """Factor pow-2 N into N1*N2, as square as possible (N1 <= N2)."""
    if n & (n - 1):
        raise ValueError(f"four-step FFT requires a power of two, got {n}")
    log = bit_log2(n)
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


@functools.lru_cache(maxsize=16)
def _twiddles_np(n1: int, n2: int):
    # W_N^(n2*k1) over [N2, K1=N1], built in float64 and cast once.
    n = n1 * n2
    ang = -2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n  # [N2, N1]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _twiddles_on(n1: int, n2: int, device: str):
    tc, ts = _twiddles_np(n1, n2)
    return torch.from_numpy(tc).to(device), torch.from_numpy(ts).to(device)


def _twiddles(n1: int, n2: int, inverse: bool, device):
    """[N2, N1] twiddle planes on ``device``, the conjugate for the inverse.
    Cached: callers must not write to them."""
    tc, ts = _twiddles_on(n1, n2, str(device))
    return tc, (-ts if inverse else ts)


def fft_split_large(re, im, n: int, inverse: bool = False, device=None):
    """C2C DFT of size n (pow-2, possibly huge) in split layout over the
    last axis. Unnormalized in both directions (``fft.api`` applies the
    norms). Returns (re, im) float32.

    Decimation: t = n1*N2 + n2, k = k1 + N1*k2 ->
    ``X[k1 + N1 k2] = DFT_n2( W_N^(n2 k1) * DFT_n1(x[., n2])[k1] )[k2]``.
    """
    re, im = as_tensors(re, im, device=device, dtype=torch.float32)
    if n <= _LEAF:
        return matmul_backend.fft_split(re, im, n, inverse=inverse)
    n1, n2 = split_n(n)
    tc, ts = _twiddles(n1, n2, inverse, re.device)
    batch = re.shape[:-1]

    # Step 1: N1-point DFTs over the n1 axis (a transposed view: n1 last).
    xr = re.reshape(*batch, n1, n2).transpose(-1, -2)  # [.., N2, N1]
    xi = im.reshape(*batch, n1, n2).transpose(-1, -2)
    ar, ai = fft_split_large(xr, xi, n1, inverse)  # [.., N2, K1]

    # Step 2: twiddle multiply W_N^(n2*k1).
    br = ar * tc - ai * ts
    bi = ar * ts + ai * tc
    del ar, ai

    # Step 3: N2-point DFTs over the n2 axis.
    cr, ci = fft_split_large(br.transpose(-1, -2), bi.transpose(-1, -2), n2, inverse)  # [.., K1, K2]
    del br, bi

    # Step 4: output index k = k1 + N1*k2 -> flatten [K2, K1].
    return cr.transpose(-1, -2).reshape(*batch, n), ci.transpose(-1, -2).reshape(*batch, n)


def rfft_split_large(x, n: int, device=None):
    """Real [..., n] -> (re, im) [..., n//2+1] for huge pow-2 n, via the
    half-size packed transform (one n/2-point C2C)."""
    from neojax_torch.fft.extras import pack_forward_post

    x = as_tensor(x, device, torch.float32)
    if x.shape[-1] != n:
        x = torch.nn.functional.pad(x[..., :n], (0, max(0, n - x.shape[-1])))
    half = n // 2
    zre, zim = fft_split_large(x[..., 0::2], x[..., 1::2], half)
    return pack_forward_post(zre, zim, half)


def rfft_packed_split_large(x, n: int, device=None):
    """Real [..., n] -> PACKED (re, im) planes, each [..., n//2]: bins
    0..n/2-1 with Nyquist.re in the im-plane's lane 0 (the streaming
    convolver's layout, ``matmul_backend.rfft_packed_split``), through the
    four-step recursion."""
    re, im = rfft_split_large(x, n, device)
    b = n // 2
    return re[..., :b], torch.cat([re[..., b:], im[..., 1:b]], dim=-1)


def irfft_packed_split_large(re, im, n: int, device=None):
    """PACKED (re, im) [..., n//2] -> real [..., n], normalized (1/n).

    Inverse of :func:`rfft_packed_split_large`; lane 0 holds the (DC,
    Nyquist) reals."""
    re, im = as_tensors(re, im, device=device, dtype=torch.float32)
    ny = im[..., :1]
    zero = torch.zeros_like(ny)
    fre = torch.cat([re, ny], dim=-1)
    fim = torch.cat([zero, im[..., 1:], zero], dim=-1)
    return irfft_split_large(fre, fim, n)


def irfft_split_large(re, im, n: int, device=None):
    """(re, im) [..., n//2+1] -> real [..., n], normalized (1/n), via the
    half-size packed inverse."""
    from neojax_torch.fft.extras import pack_inverse_pre

    re, im = as_tensors(re, im, device=device, dtype=torch.float32)
    half = n // 2
    zre, zim = pack_inverse_pre(re, im, half)
    yre, yim = fft_split_large(zre, zim, half, inverse=True)
    out = torch.stack([yre, yim], dim=-1).reshape(yre.shape[:-1] + (n,))
    return out / half
