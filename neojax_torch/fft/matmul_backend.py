"""DFT matrices: the packed ones of the fused kernels, the plain ones of the
``"matmul"`` transform backend, and the split transforms.

The fused per-block kernels (``neojax_torch.kernels.fused_step``) take
the block's forward and inverse real DFT as dense matrices in the *packed*
spectrum layout of ``neojax.fft.matmul_backend``: B = N/2 lanes, lane 0 of
the re-plane holds DC.re and lane 0 of the im-plane holds Nyquist.re (both
imaginary parts vanish for real input). Their plain versions multiply by
these matrices; their CUDA kernels compute the same DFT as FFTs and accept
only these matrices. All matrices are built in float64 numpy and cast to
float32 once per (size, dtype, device).

The engines' transforms outside the kernels run on ``torch.fft`` (cuFFT on
the card, in float32): the packed split layout (:func:`rfft_packed_split`
/ :func:`irfft_packed_split`), the non-packed K = B+1 bin layout of the
nested, hybrid and chunked engines (:func:`rfft_split` /
:func:`irfft_split`, the JAX package's ``rfft_split_cat`` /
``irfft_split_cat``) and the nested engine's meta C2C transforms
(:func:`meta_fft` / :func:`meta_ifft_tail`, which replace the packed GEMMs
of ``neojax.conv.nested._meta_gemm_mats``).

The ``"matmul"`` backend of ``fft.api`` is the DFT as a product against
the non-packed matrices (:func:`rfft_matrices`, :func:`irfft_matrices`,
:func:`fft_matrices`; products :func:`rfft`, :func:`irfft`,
:func:`fft_split`), a float32 ``torch.matmul`` on cuBLAS. TF32 rule: every
float32 product of the port runs inside ``core.device.ieee_float32``, so
it is IEEE float32 (the JAX package's ``Precision.HIGHEST``) whatever the
caller set — TF32's 10-bit mantissa would break the reference's 1e-5
bound.

Precision. The JAX engines pick an MXU precision per transform
(``_fft_precisions``). Here ``HIGHEST`` and ``HIGH`` are float32 FFTs,
and ``DEFAULT`` (the bf16 rung, one bf16 MXU pass) rounds the transform's
operand to bf16 first and computes in float32 (:func:`round_operand`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from neojax_torch.core.device import ieee_float32, resolve_device

__all__ = [
    "rfft_matrices",
    "irfft_matrices",
    "fft_matrices",
    "rfft",
    "irfft",
    "fft_split",
    "packed_mats_np",
    "packed_mats",
    "packed_stream_mats",
    "rfft_packed_matrices",
    "irfft_packed_matrices",
    "rfft_cat_matrices",
    "irfft_cat_matrices",
    "rfft_split_cat",
    "irfft_split_cat",
    "rfft_packed_split",
    "irfft_packed_split",
    "PRECISIONS",
    "round_operand",
    "rfft_split",
    "irfft_split",
    "meta_fft",
    "meta_ifft_tail",
]

# The JAX package's lax.Precision names, lower-cased.
PRECISIONS = ("default", "high", "highest")


def _dft_mats_np(kind: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The non-packed DFT matrix pair in float64 (``neojax.fft.
    matmul_backend._{rfft,irfft,fft}_mats_np``):

    - ``"rfft"``: (cos, sin) [N, N//2+1] of the negative angle;
    - ``"irfft"``: (a, b) [N//2+1, N], x = re @ a + im @ b with 1/N and the
      two-sided weights (1 at DC and, for even N, Nyquist) folded in;
    - ``"fft"``: (cos, sin) [N, N] of the negative angle.
    """
    t = np.arange(n)
    if kind == "irfft":
        k = np.arange(n // 2 + 1)
        ang = 2.0 * np.pi * np.outer(k, t) / n  # [K, N]
        w = np.full((n // 2 + 1, 1), 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        return w * np.cos(ang) / n, -w * np.sin(ang) / n
    k = np.arange(n // 2 + 1 if kind == "rfft" else n)
    ang = -2.0 * np.pi * np.outer(t, k) / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=8)
def _dft_mats_cached(kind: str, n: int, device: str):
    return tuple(_to_device(m, torch.float32, device) for m in _dft_mats_np(kind, n))


def rfft_matrices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [N, N//2+1] float32 on ``device`` (None: the card):
    spec = x @ cos + i x @ sin. Cached: callers must not write to them."""
    return _dft_mats_cached("rfft", n, str(resolve_device(device)))


def irfft_matrices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) [N//2+1, N] float32 on ``device`` (None: the card):
    x = re @ a + im @ b, the normalized inverse. Cached: callers must not
    write to them."""
    return _dft_mats_cached("irfft", n, str(resolve_device(device)))


def fft_matrices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [N, N] float32 on ``device`` (None: the card) of the
    forward C2C DFT. Cached: callers must not write to them."""
    return _dft_mats_cached("fft", n, str(resolve_device(device)))


def _product(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m over x's last axis in IEEE float32."""
    with ieee_float32():
        return torch.matmul(x.to(torch.float32), m)


def rfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Real [..., n] -> complex64 [..., n//2+1] as a DFT product,
    unnormalized forward."""
    c, s = rfft_matrices(n, x.device)
    return torch.complex(_product(x, c), _product(x, s))


def irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """Complex [..., n//2+1] -> real float32 [..., n] as a DFT product,
    normalized (1/n) inverse."""
    a, b = irfft_matrices(n, spec.device)
    return _product(spec.real, a) + _product(spec.imag, b)


def fft_split(re: torch.Tensor, im: torch.Tensor, n: int, inverse: bool = False):
    """C2C DFT over the last axis in split layout, as DFT products;
    unnormalized in both directions. Returns (re, im) float32."""
    c, s = fft_matrices(n, re.device)
    if inverse:  # conjugate twiddles: cos unchanged, sin negated
        return _product(re, c) + _product(im, s), _product(im, c) - _product(re, s)
    return _product(re, c) - _product(im, s), _product(re, s) + _product(im, c)


@functools.lru_cache(maxsize=32)
def _rfft_packed_mats_np(n: int):
    """Forward packed matrices (c, s), each [N, B] float64: spec_re = x @ c,
    spec_im = x @ s, with the im-plane's lane 0 replaced by the Nyquist
    column cos(pi t)."""
    assert n % 2 == 0
    b = n // 2
    k = np.arange(b)
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, k) / n  # [N, B]
    c = np.cos(ang)
    s = np.sin(ang)
    s[:, 0] = np.cos(np.pi * t)
    return c, s


@functools.lru_cache(maxsize=32)
def _irfft_packed_mats_np(n: int):
    """Inverse packed matrices (a, b), each [B, N] float64 with 1/N folded
    in: y = re @ a + im @ b, the im-plane's lane 0 multiplying the Nyquist
    cos row (weight 1)."""
    assert n % 2 == 0
    bb = n // 2
    k = np.arange(bb + 1)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, t) / n  # [B+1, N]
    w = np.full((bb + 1, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    a = w * np.cos(ang) / n
    bm = -w * np.sin(ang) / n
    a2 = a[:bb].copy()
    b2 = bm[:bb].copy()
    b2[0] = a[bb]
    return a2, b2


def rfft_packed_matrices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed forward matrices (c, s), each [N, B] float32 on ``device``
    (None: the card): spec_re = x @ c, spec_im = x @ s, with the im-plane's
    lane 0 the Nyquist column. Cached: callers must not write to them."""
    cs, _ = packed_mats(n, torch.float32, resolve_device(device))
    return cs[0], cs[1]


def irfft_packed_matrices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed inverse matrices (a, b), each [B, N] float32 on ``device``
    (None: the card), 1/N folded in: y = re @ a + im @ b. Cached: callers
    must not write to them."""
    _, ab = packed_mats(n, torch.float32, resolve_device(device))
    return ab[0], ab[1]


def rfft_cat_matrices(n: int, device=None) -> torch.Tensor:
    """[N, 2K] forward matrix, columns [cos | sin]: one product gives the
    lane-packed spectrum [re | im]."""
    return torch.cat(rfft_matrices(n, device), dim=1)


def irfft_cat_matrices(n: int, device=None) -> torch.Tensor:
    """[2K, N] inverse matrix of a lane-packed [re | im] (1/N folded)."""
    return torch.cat(irfft_matrices(n, device), dim=0)


def rfft_split_cat(x: torch.Tensor, n: int):
    """:func:`rfft_split` as one product against :func:`rfft_cat_matrices`.
    Returns (re, im) views of the lane-packed output."""
    sp = _product(x, rfft_cat_matrices(n, x.device))
    k = n // 2 + 1
    return sp[..., :k], sp[..., k:]


def irfft_split_cat(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`irfft_split` (normalized inverse) as one product of the
    lane-packed accumulator against :func:`irfft_cat_matrices`."""
    return _product(torch.cat([re, im], dim=-1), irfft_cat_matrices(n, re.device))


def packed_mats_np(n: int):
    """Host float64 (cs [2, N, B] forward cos|sin, ab [2, B, N] inverse with
    1/N) — the layout ``fused_block_step`` consumes."""
    c, s = _rfft_packed_mats_np(n)
    a, b = _irfft_packed_mats_np(n)
    return np.stack([c, s]), np.stack([a, b])


def _to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    # float64 -> float32 on the host, then the storage dtype (bf16 rounds
    # from the f32 value, as the JAX package's ``astype`` chain does).
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype).contiguous()


@functools.lru_cache(maxsize=16)
def _packed_mats_cached(n: int, dtype: torch.dtype, device: str):
    cs, ab = packed_mats_np(n)
    return _to_device(cs, dtype, device), _to_device(ab, dtype, device)


@functools.lru_cache(maxsize=16)
def _packed_stream_mats_cached(n: int, dtype: torch.dtype, device: str):
    b = n // 2
    c, s = _rfft_packed_mats_np(n)
    a, bm = _irfft_packed_mats_np(n)
    cs = np.concatenate([c, s], axis=-1)  # [N, 2B]
    abt = np.concatenate([a[:, b:], bm[:, b:]], axis=0)  # [2B, B]
    return _to_device(cs, dtype, device), _to_device(abt, dtype, device)


def packed_mats(n: int, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cs [2, N, B], ab [2, B, N]) as ``dtype`` on ``device`` — the matrix
    operands of ``fused_block_step``. Cached: callers must not write to them."""
    return _packed_mats_cached(n, dtype, str(torch.device(device)))


def packed_stream_mats(n: int, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole-stream kernel's matrix ABI (``fused_stream``): ONE
    lane-packed forward matrix ``cs [N, 2B]`` (cos | sin) and ONE row-packed
    tail-half inverse ``abt [2B, B]`` (last-B columns of both planes).
    Cached: callers must not write to them."""
    return _packed_stream_mats_cached(n, dtype, str(torch.device(device)))


def rfft_packed_split(x: torch.Tensor, n: int):
    """Real [..., n] -> packed (re, im), each [..., n//2] float32, on
    ``torch.fft``: bins 0..n/2-1 with Nyquist.re stored in the im-plane's DC
    lane."""
    b = n // 2
    spec = torch.fft.rfft(x.to(torch.float32), n=n, dim=-1)
    re = spec.real[..., :b].contiguous()
    im = spec.imag[..., :b].contiguous()
    im[..., 0] = spec.real[..., b]
    return re, im


def irfft_packed_split(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """Packed (re, im) [..., n//2] -> real [..., n], normalized (1/n)."""
    b = n // 2
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    spec_re = torch.cat([re, im[..., :1]], dim=-1)  # Nyquist.re at bin B
    spec_im = torch.cat(
        [torch.zeros_like(im[..., :1]), im[..., 1:b], torch.zeros_like(im[..., :1])],
        dim=-1,
    )
    return torch.fft.irfft(torch.complex(spec_re, spec_im), n=n, dim=-1)


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A transform operand as float32, rounded to bf16 first for the
    ``"default"`` precision (the bf16 rung's one-pass MXU product)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "default":
        x = x.to(torch.bfloat16)
    return x.to(torch.float32)


def rfft_split(x: torch.Tensor, n: int):
    """Real [..., n] -> (re, im), each [..., n//2 + 1] float32 (strided
    views of one complex result), unnormalized forward
    (``rfft_split_cat``)."""
    spec = torch.fft.rfft(x.to(torch.float32), n=n, dim=-1)
    return spec.real, spec.imag


def irfft_split(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """(re, im) [..., n//2 + 1] -> real [..., n], normalized (1/n)
    (``irfft_split_cat``). The imaginary parts of DC and Nyquist do not
    enter, as in the JAX package's matrix form (its sine rows vanish
    there); they are zeroed so no backend has to ignore them."""
    im = im.to(torch.float32).clone()
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    return torch.fft.irfft(torch.complex(re.to(torch.float32), im), n=n, dim=-1)


def meta_fft(re: torch.Tensor, im: torch.Tensor):
    """Unnormalized forward C2C DFT over the last axis (the nested
    engine's 2S-frame meta window): X[k] = sum_t x[t] exp(-2 pi i t k / 2S).
    Returns (re, im) float32."""
    x = torch.fft.fft(torch.complex(re.to(torch.float32), im.to(torch.float32)), dim=-1)
    return x.real, x.imag


def meta_ifft_tail(re: torch.Tensor, im: torch.Tensor):
    """Normalized inverse C2C DFT over the last axis (length 2S), keeping
    the OLS tail frames [S, 2S). Returns (re, im), each [..., S] float32."""
    y = torch.fft.ifft(torch.complex(re.to(torch.float32), im.to(torch.float32)), dim=-1)
    y = y[..., re.shape[-1] // 2 :]
    return y.real, y.imag
