"""neojax_torch.fft.four_step and the ``"matmul"`` route of ``fft.api``
above 8192, on the CPU, held against neojax.fft.four_step / neojax.fft.api
on the same seeded numpy inputs.

Tolerance: 1e-5 of the output peak. Both packages build the leaf DFT
matrices and the twiddles in float64 and cast them to float32 once; the
JAX package's in-trace twiddles (``matmul_backend._cs_traced``, above
4 KB under ``jit``) match those tables to about 2e-7, so bit equality is
not the contract.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax import fft as jfft
from neojax.fft import four_step as jfs
from neojax_torch import fft as tfft
from neojax_torch.fft import api as tapi
from neojax_torch.fft import four_step as tfs

CPU = "cpu"
_TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _signal(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def test_split_n_cases_and_error():
    assert tfs.split_n(1 << 14) == (128, 128)
    assert tfs.split_n(1 << 15) == (128, 256)
    assert tfs.split_n(1 << 20) == (1024, 1024)
    for e in range(1, 24):
        assert tfs.split_n(1 << e) == jfs.split_n(1 << e)
    for n in (1000, 12000, 3 << 12):
        with pytest.raises(ValueError, match="power of two"):
            tfs.split_n(n)
    assert tfs._LEAF == jfs._LEAF == 512


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << 12, 1 << 14, 1 << 16])
def test_fft_split_large_matches_neojax(rng, n, inverse):
    re, im = _signal(rng, 3, n), _signal(rng, 3, n)
    got = tfs.fft_split_large(torch.from_numpy(re), torch.from_numpy(im), n, inverse=inverse)
    want = jfs.fft_split_large(jnp.asarray(re), jnp.asarray(im), n, inverse=inverse)
    assert all(g.dtype == torch.float32 and g.shape == (3, n) for g in got)
    assert _rel(_c(*got), _c(*want)) < _TOL
    ref = np.fft.ifft(re + 1j * im) * n if inverse else np.fft.fft(re + 1j * im)
    assert _rel(_c(*got), ref) < 1e-4


@pytest.mark.parametrize("n", [1 << 14, 1 << 17])
def test_rfft_irfft_split_large_match_neojax(rng, n):
    x = _signal(rng, 2, n)
    got = tfs.rfft_split_large(torch.from_numpy(x), n)
    want = jfs.rfft_split_large(jnp.asarray(x), n)
    assert got[0].shape == (2, n // 2 + 1)
    assert _rel(_c(*got), _c(*want)) < _TOL
    back = tfs.irfft_split_large(*got, n)
    want_back = jfs.irfft_split_large(jnp.asarray(got[0].numpy()), jnp.asarray(got[1].numpy()), n)
    assert back.shape == (2, n) and _rel(back, want_back) < _TOL
    assert np.abs(back.numpy() - x).max() < 1e-5


@pytest.mark.parametrize("n", [8192, 16384])
def test_packed_pair_matches_neojax(rng, n):
    x = _signal(rng, 2, n)
    got = tfs.rfft_packed_split_large(torch.from_numpy(x), n)
    want = jfs.rfft_packed_split_large(jnp.asarray(x), n)
    assert all(g.shape == (2, n // 2) for g in got)
    peak = np.abs(np.fft.rfft(x)).max()
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() / peak < _TOL
    back = tfs.irfft_packed_split_large(*got, n)
    want_back = jfs.irfft_packed_split_large(*(jnp.asarray(g.numpy()) for g in got), n)
    assert _rel(back, want_back) < _TOL and np.abs(back.numpy() - x).max() < 1e-5


def test_host_input_goes_to_the_device_asked_for(rng, monkeypatch):
    """Host input lands on ``device``; a tensor stays where it lies; host
    input without ``device`` and without a card raises (no CPU fallback)."""
    x = _signal(rng, 1, 1 << 14)
    got = tfs.rfft_split_large(x, 1 << 14, device=CPU)
    assert got[0].device.type == CPU
    want = tfs.rfft_split_large(torch.from_numpy(x), 1 << 14)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfs.fft_split_large(x, x, 1 << 14)


def _api_both(name, x, n):
    got = getattr(tapi, name)(torch.from_numpy(x), n=n, backend="matmul").numpy()
    want = np.asarray(getattr(jfft, name)(jnp.asarray(x), n=n, backend="matmul"))
    return got, want


@pytest.mark.parametrize("n", [16384, 12000])
@pytest.mark.parametrize("name", ["fft", "ifft", "rfft", "irfft"])
def test_api_matmul_backend_above_8192_matches_neojax(rng, name, n):
    """16384: the four-step recursion on both sides; 12000 (not a power of
    two): the plain FFT on both."""
    if name == "irfft":
        x = (rng.standard_normal((2, n // 2 + 1)) + 1j * rng.standard_normal((2, n // 2 + 1))).astype(np.complex64)
    elif name == "ifft":
        x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    else:
        x = _signal(rng, 2, n)
    got, want = _api_both(name, x, n)
    assert got.shape == want.shape
    assert _rel(got, want) < _TOL


@pytest.mark.parametrize("name", ["fft", "ifft", "rfft", "irfft"])
def test_api_takes_four_step_above_8192_only(rng, monkeypatch, name):
    """A spy on the four-step entry points: taken at 16384, not at 8192
    (the dense products) nor at 12000 (``torch.fft``)."""
    taken = []
    for fn in ("fft_split_large", "rfft_split_large", "irfft_split_large"):
        real = getattr(tfs, fn)
        monkeypatch.setattr(tfs, fn, lambda *a, _r=real, _n=fn, **k: taken.append(_n) or _r(*a, **k))
    for n, expect in ((8192, False), (12000, False), (16384, True)):
        taken.clear()
        x = _signal(rng, 1, n)
        out = getattr(tfft, name)(torch.from_numpy(x), n=n, backend="matmul")
        assert bool(taken) == expect, (name, n, taken)
        assert torch.isfinite(out.abs()).all()
    taken.clear()
    getattr(tfft, name)(torch.from_numpy(_signal(rng, 1, 16384)), n=16384, backend="xla")
    assert not taken


@pytest.mark.parametrize("n", [4096, 16384])
def test_api_irfft_takes_real_bins_like_neojax(rng, n):
    """``irfft(backend="matmul")`` of a real spectrum (zero imaginary
    parts), as numpy and ``neojax`` take it, on the dense products and on
    the four-step route."""
    x = _signal(rng, 2, n // 2 + 1)
    got, want = _api_both("irfft", x, n)
    assert _rel(got, want) < _TOL
    assert _rel(got, np.fft.irfft(x, n)) < 1e-4
