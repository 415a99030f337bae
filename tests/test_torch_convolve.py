"""neojax_torch's convolve surface on the CPU, held against numpy, the C++
reference's goldens and neojax on the same seeded inputs.

- ``neojax_torch.convolve`` over all seven methods against ``np.convolve``
  in float64 (1e-4 absolute) and against ``neojax.convolve`` (1e-4
  absolute); its errors;
- the goldens of the C++ reference (``tests/goldens``): ``ref_fftconv`` /
  ``ref_directconv`` and ``ref_ols_b64_f33`` / ``ref_ola_b64_f33``, the
  last two reproducing ``stream_overlap`` of
  ``tools/goldens/gen_goldens.cpp:152-174`` (``in_rnoise_1024``,
  ``in_b33``, block 64), at the reference's bound scaled by the golden's
  peak (``tests/test_reference_parity.py``: 1e-5 * max(1, max|golden|));
- the transform goldens ``ref_fft_{16,256,1024}`` (both backends),
  ``ref_rfft_{16,256,1024}`` and ``ref_fft_1024_f64`` (the f64 bound
  1e-9, scaled alike);
- ``OverlapSave`` / ``OverlapAdd`` pass-through (1e-5) and filtering
  (1e-4, ``tests/test_convolution.py:74-110``), ``Mode``/``output_size``;
- ``fft``/``ifft``/``rfft``/``irfft`` on ``"xla"`` and ``"matmul"``
  against numpy and ``neojax.fft`` at all three norms (sqrt(n) * 1e-5 +
  1e-4 absolute, the bound of ``tests/test_fft.py``);
- ``core.units`` against ``neojax.core.units`` (``fast_log2`` /
  ``fast_log10`` bit for bit; the others 1e-5 of the value);
- ``core.device.ieee_float32`` pins IEEE float32 and restores the caller's
  TF32 flags, however they were set.
"""

import os

import numpy as np
import pytest
import torch

import neojax
from neojax import fft as jfft
from neojax.core import units as junits
import neojax_torch
from neojax_torch import conv as tconv
from neojax_torch import fft as tfft
from neojax_torch.core import units as tunits
from neojax_torch.conv.streaming import streaming_convolve
from neojax_torch.core.device import ieee_float32

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
METHODS = ["auto", "direct", "fft", "ols", "ola", "upols", "upola"]


def _load(name):
    return np.load(os.path.join(GOLD, name))


def _scaled_tol(golden, base=1e-5):
    return base * max(1.0, float(np.abs(golden).max()))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,l", [(1000, 33), (300, 700), (2048, 1500)])
def test_convolve_matches_numpy_and_neojax(make_noise, method, n, l):
    a, h = make_noise(n), make_noise(l)
    out = neojax_torch.convolve(a, h, method=method, device="cpu")
    ref = np.convolve(a.astype(np.float64), h.astype(np.float64))
    assert out.shape == (n + l - 1,) and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() < 1e-4
    assert np.abs(out.numpy() - np.asarray(neojax.convolve(a, h, method=method))).max() < 1e-4


def test_convolve_errors(make_noise):
    a = make_noise(16)
    with pytest.raises(ValueError, match="unsupported convolution mode"):
        neojax_torch.convolve(a, a, mode="same", device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        neojax_torch.convolve(a[None], a, device="cpu")
    with pytest.raises(ValueError, match="unknown streaming method"):
        streaming_convolve(a, a, "warp", device="cpu")


def test_direct_convolve_dtypes(make_noise):
    a = make_noise(40) + 1j * make_noise(40)
    h = make_noise(9) - 1j * make_noise(9)
    out = tconv.direct_convolve(a, h, device="cpu").numpy()
    assert np.abs(out - np.convolve(a, h)).max() < 1e-5
    x64 = make_noise(50).astype(np.float64)
    out64 = tconv.direct_convolve(x64, x64[:7], device="cpu")
    assert out64.dtype == torch.float64 and np.abs(out64.numpy() - np.convolve(x64, x64[:7])).max() < 1e-12
    assert tconv.direct_convolve(np.zeros(0, np.float32), x64, device="cpu").shape == (0,)


@pytest.mark.parametrize("method,golden", [("fft", "ref_fftconv.npy"), ("direct", "ref_directconv.npy")])
def test_convolve_goldens(method, golden):
    want = _load(golden)
    out = neojax_torch.convolve(_load("in_a64.npy"), _load("in_b33.npy"), method=method, device="cpu")
    assert np.abs(out.numpy() - want).max() < _scaled_tol(want)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_fft_convolve_golden_both_backends(backend):
    want = _load("ref_fftconv.npy")
    out = tconv.fft_convolve(_load("in_a64.npy"), _load("in_b33.npy"), backend=backend, device="cpu")
    assert np.abs(out.numpy() - want).max() < _scaled_tol(want)


@pytest.mark.parametrize("n", [16, 256, 1024])
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_transform_goldens(n, backend):
    x = _load(f"in_cnoise_{n}.npy").astype(np.complex64)
    want = _load(f"ref_fft_{n}.npy")
    assert np.abs(tfft.fft(x, backend=backend, device="cpu").numpy() - want).max() < _scaled_tol(want)
    xr = _load(f"in_rnoise_{n}.npy").astype(np.float32)
    want = _load(f"ref_rfft_{n}.npy")
    got = tfft.rfft(xr, backend=backend, device="cpu").numpy()
    assert got.shape == want.shape and np.abs(got - want).max() < _scaled_tol(want)


def test_fft_f64_golden():
    want = _load("ref_fft_1024_f64.npy")
    got = tfft.fft(_load("in_cnoise_1024_f64.npy").astype(np.complex128), device="cpu")
    assert got.dtype == torch.complex128 and np.abs(got.numpy() - want).max() < _scaled_tol(want, 1e-9)


@pytest.mark.parametrize("cls,golden", [(tconv.OverlapSave, "ref_ols_b64_f33.npy"),
                                        (tconv.OverlapAdd, "ref_ola_b64_f33.npy")])
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_overlap_goldens(cls, golden, backend):
    """``stream_overlap``: the processor over consecutive 64-sample blocks,
    its spectrum callback multiplying by the zero-padded filter's rfft."""
    x, flt, want = _load("in_rnoise_1024.npy"), _load("in_b33.npy"), _load(golden)
    proc = cls(64, 33, fft_backend=backend)
    fspec = torch.from_numpy(np.fft.rfft(flt, n=proc.transform_size).astype(np.complex64))
    state = proc.init_state(1, device="cpu")
    outs = []
    for off in range(0, x.shape[0] - 63, 64):
        state, out = proc.step(state, torch.from_numpy(x[None, off : off + 64]), lambda s: s * fspec)
        outs.append(out[0])
    got = torch.cat(outs).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < _scaled_tol(want)


@pytest.mark.parametrize("cls", [tconv.OverlapSave, tconv.OverlapAdd])
@pytest.mark.parametrize("block_size", [128, 256, 512])
@pytest.mark.parametrize("filter_size", [8, 17, 127, 1024])
def test_overlap_passthrough(make_noise, cls, block_size, filter_size):
    proc = cls(block_size, filter_size)
    sig = torch.from_numpy(make_noise(1, 4 * block_size))
    blocks, _ = tconv.stream_blocks(sig, block_size)
    state = proc.init_state(1, device="cpu")
    assert state.shape == (1, proc.transform_size - block_size)
    outs = []
    for blk in blocks:
        state, out = proc.step(state, blk, lambda s: s)
        outs.append(out)
    assert (torch.cat(outs, dim=-1) - sig).abs().max() < 1e-5


@pytest.mark.parametrize("cls,jcls", [(tconv.OverlapSave, neojax.conv.OverlapSave),
                                      (tconv.OverlapAdd, neojax.conv.OverlapAdd)])
def test_overlap_convolves(make_noise, cls, jcls):
    b, l = 128, 64
    proc, jproc = cls(b, l), jcls(b, l)
    assert (proc.transform_size, proc.num_bins) == (jproc.transform_size, jproc.num_bins)
    h = make_noise(l)
    h_spec = np.fft.rfft(h, n=proc.transform_size).astype(np.complex64)
    sig = make_noise(1, 8 * b)
    state, jstate = proc.init_state(1, device="cpu"), jproc.init_state(1)
    outs, jouts = [], []
    for i in range(8):
        blk = sig[:, i * b : (i + 1) * b]
        state, out = proc.step(state, torch.from_numpy(blk), lambda s: s * torch.from_numpy(h_spec))
        jstate, jout = jproc.step(jstate, blk, lambda s: s * h_spec)
        outs.append(out.numpy())
        jouts.append(np.asarray(jout))
    got = np.concatenate(outs, axis=-1)[0]
    ref = np.convolve(sig[0].astype(np.float64), h.astype(np.float64))[: got.shape[0]]
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(got - np.concatenate(jouts, axis=-1)[0]).max() < 1e-5


def test_modes():
    assert tconv.output_size(tconv.Mode.FULL, 10, 4) == 13
    for mode in (tconv.Mode.SAME, tconv.Mode.VALID):
        with pytest.raises(ValueError, match="unsupported convolution mode"):
            tconv.output_size(mode, 10, 4)
    assert [m.value for m in tconv.Method] == [m.value for m in neojax.conv.Method]
    assert [m.value for m in tconv.Mode] == [m.value for m in neojax.conv.Mode]


@pytest.mark.parametrize("backend", ["xla", "matmul"])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("n", [16, 256, 1000])
def test_transforms_match_numpy_and_neojax(make_noise, backend, norm, n):
    x = (make_noise(3, n) + 1j * make_noise(3, n)).astype(np.complex64)
    tol = np.sqrt(n) * 1e-5 + 1e-4
    pairs = [
        (tfft.fft(x, norm=norm, backend=backend, device="cpu"), np.fft.fft(x, norm=norm),
         jfft.fft(x, norm=norm, backend=backend)),
        (tfft.ifft(x, norm=norm, backend=backend, device="cpu"), np.fft.ifft(x, norm=norm),
         jfft.ifft(x, norm=norm, backend=backend)),
        (tfft.rfft(x.real, norm=norm, backend=backend, device="cpu"), np.fft.rfft(x.real, norm=norm),
         jfft.rfft(x.real, norm=norm, backend=backend)),
        (tfft.irfft(x[:, : n // 2 + 1], n=n, norm=norm, backend=backend, device="cpu"),
         np.fft.irfft(x[:, : n // 2 + 1], n=n, norm=norm),
         jfft.irfft(x[:, : n // 2 + 1], n=n, norm=norm, backend=backend)),
    ]
    for got, want, jgot in pairs:
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() < tol
        assert np.abs(got.numpy() - np.asarray(jgot)).max() < tol


def test_transform_padding_backend_switch_and_errors(make_noise):
    x = make_noise(100)
    for n in (64, 128):  # trimmed and zero-padded to n
        np.testing.assert_allclose(tfft.rfft(x, n=n, backend="matmul", device="cpu").numpy(),
                                   np.fft.rfft(x, n=n), atol=1e-4)
    assert tfft.get_backend() == "auto"
    try:
        tfft.set_backend("matmul")
        assert tfft.get_backend() == "matmul"
        np.testing.assert_allclose(tfft.fft(x, device="cpu").numpy(), np.fft.fft(x), atol=1e-3)
    finally:
        tfft.set_backend("auto")
    with pytest.raises(ValueError, match="unknown fft backend"):
        tfft.set_backend("fourstep")
    with pytest.raises(ValueError, match="unknown norm"):
        tfft.rfft(x, norm="bogus", device="cpu")


def test_units_match_neojax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(1e-6, 1e6, 4096), -rng.uniform(0, 10, 64), [0.0, 1.0, 2.0]]).astype(np.float32)
    for name in ("fast_log2", "fast_log10"):
        got = getattr(tunits, name)(x, device="cpu").numpy()
        want = np.asarray(getattr(junits, name)(x))
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), name
    assert neojax_torch.fast_log2 is tunits.fast_log2
    for precision in ("accurate", "estimate"):
        got = neojax_torch.amplitude_to_db(x, precision=precision, device="cpu").numpy()
        np.testing.assert_allclose(got, np.asarray(junits.amplitude_to_db(x, precision=precision)), atol=1e-4)
    f = np.linspace(10.0, 20000.0, 200).astype(np.float32)
    np.testing.assert_allclose(neojax_torch.a_weighting(f, device="cpu").numpy(),
                               np.asarray(junits.a_weighting(f)), atol=1e-4)
    np.testing.assert_allclose(tunits.hertz_to_mel(f, device="cpu").numpy(), np.asarray(junits.hertz_to_mel(f)),
                               rtol=1e-5)
    m = np.linspace(0.0, 3000.0, 50).astype(np.float32)
    np.testing.assert_allclose(tunits.mel_to_hertz(m, device="cpu").numpy(), np.asarray(junits.mel_to_hertz(m)),
                               rtol=1e-5)
    for n_mels in (0, 1, 40):
        np.testing.assert_allclose(tunits.mel_frequencies(n_mels, 20.0, 8000.0, device="cpu").numpy(),
                                   np.asarray(junits.mel_frequencies(n_mels, 20.0, 8000.0)), rtol=1e-5)
    np.testing.assert_allclose(tunits.rfftfreq(1024, 1 / 48000, device="cpu").numpy(),
                               np.fft.rfftfreq(1024, 1 / 48000), rtol=1e-6)
    re, im = tunits.polar(torch.tensor([2.0]), torch.tensor([np.pi / 2]))
    assert abs(float(re)) < 1e-6 and abs(float(im) - 2.0) < 1e-6


def _flags():
    return (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision)


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_ieee_float32_pins_and_restores_tf32_flags(api):
    saved = _flags()
    try:
        if api == "legacy":
            torch.set_float32_matmul_precision("high")
            torch.backends.cudnn.allow_tf32 = True
        else:
            torch.backends.cuda.matmul.fp32_precision = "tf32"
            torch.backends.cudnn.conv.fp32_precision = "tf32"
        before = (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision)
        with ieee_float32():
            assert torch.backends.cuda.matmul.fp32_precision == "ieee"
            assert torch.backends.cudnn.conv.fp32_precision == "ieee"
            assert torch.get_float32_matmul_precision() == "highest"
            assert torch.backends.cudnn.allow_tf32 is False
        assert (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision) == before
        if api == "legacy":
            assert torch.get_float32_matmul_precision() == "high" and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_public_surface_mirrors_neojax():
    """``neojax_torch.conv.__all__`` holds every name of ``neojax.conv``'s
    (plus its own ``insert_only_step``); the top level mirrors ``neojax``'s
    apart from ``dist``, ``io`` and ``kernels``."""
    assert set(neojax.conv.__all__) <= set(tconv.__all__)
    assert set(tconv.__all__) - set(neojax.conv.__all__) <= {"insert_only_step", "HybridStream"}
    assert set(neojax.__all__) - {"dist", "io", "kernels"} <= set(neojax_torch.__all__)
    for name in tconv.__all__ + neojax_torch.__all__:
        assert hasattr(tconv if name in tconv.__all__ else neojax_torch, name), name


def test_package_imports_no_jax():
    """No module of neojax_torch imports jax or neojax."""
    import ast
    import pathlib

    root = pathlib.Path(neojax_torch.__file__).parent
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "neojax"), f"{path}: {name}"
