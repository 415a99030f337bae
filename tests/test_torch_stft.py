"""neojax_torch.core.windows and neojax_torch.fft.stft against neojax on the
CPU.

Windows are built in float64 on the host by both packages and cast once,
so they agree exactly. The STFT frames, windows and rfft's in float32 in
both (pocketfft here, XLA's FFT there): tolerance rtol 1e-5 against the
spectrum's peak magnitude.
"""

import importlib

import numpy as np
import pytest
import torch

from neojax.core import windows as jwin
from neojax_torch.core import windows as twin
from neojax_torch.fft import stft as tstft

jstft = importlib.import_module("neojax.fft.stft")  # neojax.fft re-exports a function named stft


@pytest.mark.parametrize("name", ["rectangular", "boxcar", "hann", "hamming", "HANN"])
@pytest.mark.parametrize("size", [1, 2, 7, 64])
def test_make_window_matches_neojax(name, size):
    want = np.asarray(jwin.make_window(name, size))
    got = twin.make_window(name, size)
    assert got.dtype == torch.float32 and got.shape == (size,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_window_callable_array_and_errors():
    fn = lambda n: np.linspace(0.0, 1.0, n)  # noqa: E731
    np.testing.assert_array_equal(twin.make_window(fn, 5).numpy(), np.asarray(jwin.make_window(fn, 5)))
    arr = np.arange(4.0)
    np.testing.assert_array_equal(twin.make_window(arr, 4, dtype=torch.float64).numpy(), arr)
    with pytest.raises(ValueError):
        twin.make_window("kaiser", 8)
    with pytest.raises(ValueError):
        twin.make_window(arr, 5)


@pytest.mark.parametrize("signal,frame,overlap", [(100, 16, 8), (64, 64, 0), (1000, 100, 25), (5, 16, 4)])
def test_num_stft_frames_matches_neojax(signal, frame, overlap):
    assert tstft.num_stft_frames(signal, frame, overlap) == jstft.num_stft_frames(signal, frame, overlap)


_OPTIONS = [
    jstft.StftOptions(frame_size=64, transform_size=128, overlap_size=32),
    jstft.StftOptions(frame_size=60, transform_size=100, overlap_size=15, window="hamming"),
    jstft.StftOptions(frame_size=32, transform_size=32, overlap_size=0, window="rectangular"),
    128,
]


@pytest.mark.parametrize("opt", range(len(_OPTIONS)))
@pytest.mark.parametrize("shape", [(2, 777), (500,)])
def test_stft_matches_neojax(rng, opt, shape):
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    jopt = _OPTIONS[opt]
    topt = jopt if isinstance(jopt, int) else tstft.StftOptions(
        jopt.frame_size, jopt.transform_size, jopt.overlap_size, jopt.window)
    want = np.asarray(jstft.stft(x, jopt))
    got = tstft.stft(torch.from_numpy(x), topt)
    assert got.shape == want.shape and got.is_complex()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_stft_errors():
    with pytest.raises(ValueError):
        tstft.stft(np.zeros((2, 2, 8), np.float32), 8)
    with pytest.raises(ValueError):
        tstft.stft(np.zeros(64, np.float32), tstft.StftOptions(16, 16, 16))
    with pytest.raises(ValueError):
        tstft.stft(np.zeros(64, np.float32), tstft.StftOptions(32, 16, 0))
