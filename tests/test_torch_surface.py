"""neojax_torch's core, ops and fft surface against neojax on the CPU.

Seeded numpy inputs go through ``neojax`` (``JAX_PLATFORMS=cpu``, x64 on as
``tests/conftest.py`` sets it) and through the port with ``device="cpu"``.
Mirrors ``tests/test_fft.py:78-105`` (Bluestein, ``naive_dft``, ``dct2``),
``tests/test_reference_parity.py:69-95`` (the C++ goldens at 1e-5 x
max|golden|), ``tests/test_extras.py`` (fixed point bit for bit, the split
and packed transforms within 1e-5 of the scale), ``tests/test_ops_units.py``
and ``tests/test_observability.py`` (``assert_finite``, ``checked``,
``x64_parity_error`` < 1e-5).

Tolerances: integer results bit for bit; float32 elementwise results
within 1e-6 relative of ``neojax``'s (both round once per op); transforms
within 1e-5 of the coefficients' peak (the reference's f32 bound scaled by
the coefficient magnitude, as ``test_reference_parity.py`` scales it).
"""

import os

import numpy as np
import pytest
import torch

import neojax
from neojax import conv as jconv
from neojax import core as jcore
from neojax import fft as jfft
from neojax import ops as jops
from neojax.core import fixed_point as jfp
from neojax.fft import extras as jextras
from neojax.ops import debug as jdebug

import neojax_torch
from neojax_torch import conv as tconv
from neojax_torch import core as tcore
from neojax_torch import fft as tfft
from neojax_torch import ops as tops
from neojax_torch.core import fixed_point as tfp
from neojax_torch.fft import extras as textras
from neojax_torch.ops import debug as tdebug

CPU = "cpu"
GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_tol(ref, base=1e-5):
    return base * max(1.0, float(np.abs(ref).max()))


# ------------------------------------------------------------------ bits


def test_bits_match_neojax():
    for n in range(1, 5000):
        assert tcore.bit_log2(n) == jcore.bit_log2(n)
        assert tcore.next_order(n) == jcore.next_order(n)
    for base in range(-3, 6):
        for exp in range(0, 12):
            assert tcore.ipow(base, exp) == jcore.ipow(base, exp)
    with pytest.raises(ValueError):
        tcore.bit_log2(0)


# ------------------------------------------------------------ complexes


def test_split_complex_helpers_match_neojax(make_noise):
    z = (make_noise(3, 40) + 1j * make_noise(3, 40)).astype(np.complex64)
    w = (make_noise(3, 40) + 1j * make_noise(3, 40)).astype(np.complex64)
    sz, sw = tcore.to_split(z, device=CPU), tcore.to_split(w, device=CPU)
    np.testing.assert_array_equal(sz.numpy(), np.asarray(jcore.to_split(z)))
    np.testing.assert_array_equal(tcore.from_split(sz).numpy(), z)
    np.testing.assert_allclose(tcore.split_mul(sz, sw).numpy(), np.asarray(jcore.split_mul(*map(jcore.to_split, (z, w)))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcore.split_mul_add(sz, sw, sz).numpy(),
                               np.asarray(jcore.split_mul_add(*map(jcore.to_split, (z, w, z)))), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcore.split_conj(sz).numpy(), np.asarray(jcore.split_conj(jcore.to_split(z))))
    # a real input has a zero imaginary plane
    np.testing.assert_array_equal(tcore.to_split(z.real, device=CPU).numpy()[1], 0.0)


# ------------------------------------------------------------ fixed point


def _all_pairs(dtype):
    info = np.iinfo(dtype)
    v = np.arange(info.min, info.max + 1, dtype=np.int64)
    a, b = np.meshgrid(v, v, indexing="ij")
    return a.ravel().astype(dtype), b.ravel().astype(dtype)


def _q15_pairs(rng):
    edges = np.array([-32768, -32767, -16384, -1, 0, 1, 16383, 16384, 32766, 32767], np.int16)
    a, b = np.meshgrid(edges, edges, indexing="ij")
    ra = rng.integers(-32768, 32768, 200_000).astype(np.int16)
    rb = rng.integers(-32768, 32768, 200_000).astype(np.int16)
    return np.concatenate([a.ravel(), ra]), np.concatenate([b.ravel(), rb])


@pytest.mark.parametrize("op", ["fixed_add", "fixed_subtract", "fixed_multiply"])
@pytest.mark.parametrize("fmt", ["Q7", "Q15"])
def test_fixed_point_ops_bit_for_bit(rng, op, fmt):
    """Every int8 pair for Q7; the edges and 200 000 random pairs for Q15."""
    a, b = _all_pairs(np.int8) if fmt == "Q7" else _q15_pairs(rng)
    want = np.asarray(getattr(jfp, op)(a, b))
    got = getattr(tfp, op)(a, b, device=CPU).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["Q7", "Q15"])
def test_fixed_point_conversions_bit_for_bit(rng, fmt):
    jf, tf = getattr(jfp, fmt), getattr(tfp, fmt)
    halves = (np.arange(-300, 300) + 0.5) / tf.scale  # ties: both round half to even
    x = np.concatenate([rng.uniform(-1.2, 1.2, 20_000), halves, [-1.0, 1.0, 0.0, -0.0]])
    want = np.asarray(jfp.to_fixed(x, jf))
    got = tfp.to_fixed(x, tf, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tfp.to_float(got).numpy(), np.asarray(jfp.to_float(want)))


def test_fixed_point_semantics(make_noise):
    """``tests/test_extras.py``'s fixed-point cases on the port."""
    x = make_noise(256) * 0.9
    for fmt, tol in [(tfp.Q7, 1 / 127), (tfp.Q15, 1 / 32767)]:
        assert np.abs(tfp.to_float(tfp.to_fixed(x, fmt, device=CPU), fmt).numpy() - x).max() < tol
    a = tfp.to_fixed(np.array([0.9, -0.9, 0.5]), tfp.Q7, device=CPU)
    b = tfp.to_fixed(np.array([0.9, -0.9, 0.25]), tfp.Q7, device=CPU)
    out = tfp.fixed_add(a, b)
    assert int(out[0]) == 127 and int(out[1]) == -128
    assert abs(float(tfp.to_float(out, tfp.Q7)[2]) - 0.75) < 2 / 127
    a = tfp.to_fixed(np.array([0.5, -0.5, 0.25]), tfp.Q15, device=CPU)
    b = tfp.to_fixed(np.array([0.5, 0.5, 0.25]), tfp.Q15, device=CPU)
    assert np.abs(tfp.to_float(tfp.fixed_multiply(a, b)).numpy() - [0.25, -0.25, 0.0625]).max() < 1e-3
    lo = tfp.fixed_subtract(tfp.to_fixed(np.array([-0.9]), device=CPU), tfp.to_fixed(np.array([0.9]), device=CPU))
    assert int(lo[0]) == -32768
    assert repr(tfp.Q7) == repr(jfp.Q7) and repr(tfp.Q15) == repr(jfp.Q15)


# ------------------------------------------------------ elementwise / stats


def test_elementwise_match_neojax(make_noise):
    x, y, z = (make_noise(4, 64) for _ in range(3))
    for name, args in (("add", (x, y)), ("multiply", (x, y)), ("multiply_add", (x, y, z))):
        np.testing.assert_allclose(getattr(tops, name)(*args, device=CPU).numpy(),
                                   np.asarray(getattr(jops, name)(*args)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tops.scale(0.3, x, device=CPU).numpy(), np.asarray(jops.scale(0.3, x)), rtol=1e-6)
    t = [torch.from_numpy(a) for a in (x, y, z, x, y, z)]
    for got, want in zip(tops.split_multiply_add(*t), jops.split_multiply_add(x, y, z, x, y, z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # host operands follow a tensor operand's device
    assert tops.add(torch.from_numpy(x), y).device.type == "cpu"


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_statistics_match_neojax(make_noise, dtype):
    x = make_noise(1000).astype(dtype)
    y = make_noise(1000).astype(dtype)
    if np.iscomplexobj(x):
        x = x + 1j * make_noise(1000)
        y = y + 1j * make_noise(1000)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    for name, args in (("mean", (x,)), ("variance", (x,)), ("standard_deviation", (x,)),
                       ("mean_squared_error", (x, y)), ("root_mean_squared_error", (x, y))):
        got = getattr(tops, name)(*args, device=CPU).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jops, name)(*args)), rtol=tol, atol=tol)
    # population variance (divide by N)
    assert float(tops.variance(x, device=CPU)) == pytest.approx(np.var(x), rel=1e-5)


def test_statistics_semantics(make_noise):
    """``tests/test_ops_units.py::test_stats`` on the port."""
    x = make_noise(1000).astype(np.float64)
    y = make_noise(1000).astype(np.float64)
    assert float(tops.mean(x, device=CPU)) == pytest.approx(np.mean(x), abs=1e-9)
    assert float(tops.variance(x, device=CPU)) == pytest.approx(np.var(x), abs=1e-9)
    assert float(tops.standard_deviation(x, device=CPU)) == pytest.approx(np.std(x), abs=1e-9)
    assert float(tops.mean_squared_error(x, y, device=CPU)) == pytest.approx(np.mean((x - y) ** 2), abs=1e-9)
    assert float(tops.root_mean_squared_error(x, y, device=CPU)) == pytest.approx(
        np.sqrt(np.mean((x - y) ** 2)), abs=1e-9)


def test_compare_match_neojax(make_noise):
    """``tests/test_ops_units.py::test_allclose_tolerances`` on the port, and
    the same verdicts as neojax."""
    x = make_noise(100)
    cases = [(x, x + 5e-6), (x, x + 5e-5), (x.astype(np.float64), x.astype(np.float64) + 5e-10),
             (x.astype(np.float64), x.astype(np.float64) + 5e-9), (x, x[:50]), (x[:0], x[:0])]
    want = [True, False, True, False, False, True]
    for (a, b), w in zip(cases, want):
        assert tops.allclose(a, b, device=CPU) == jops.allclose(a, b) == w
    assert tops.allclose(x, x + 5e-5, tolerance=1e-4, device=CPU)
    assert tops.allmatch(x, x.copy(), device=CPU) and not tops.allmatch(x, x + 1e-7, device=CPU)
    for dt in (np.float32, np.float64, np.complex64, np.complex128, np.int16):
        assert tops.default_tolerance(dt) == jops.default_tolerance(dt)
    for dt, want_tol in ((torch.float32, 1e-5), (torch.float64, 1e-9), (torch.complex128, 1e-9),
                         (torch.bfloat16, 1e-5)):
        assert tops.default_tolerance(dt) == want_tol


def test_normalize_peak_matches_neojax(make_noise):
    x = make_noise(3, 500) * 3.0
    np.testing.assert_allclose(tops.normalize_peak(x, device=CPU).numpy(), np.asarray(jops.normalize_peak(x)),
                               rtol=1e-6)
    assert float(tops.normalize_peak_factor(np.zeros(8, np.float32), device=CPU)) == 1.0
    z = tops.normalize_peak(x, device=CPU).numpy()
    assert np.max(np.abs(z)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_quantize_fixed_bit_for_bit(make_noise, dtype):
    x = np.concatenate([make_noise(4096) * 1.1, [1.0, -1.0, 0.0, 2.0, -2.0],
                        (np.arange(-20, 20) + 0.5) / jops.int_max_for(dtype)]).astype(np.float32)
    want = np.asarray(jops.quantize_fixed(x, dtype))
    got = tops.quantize_fixed(x, dtype, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.dequantize_fixed(got).numpy(), np.asarray(jops.dequantize_fixed(want)))
    inside = np.abs(x) <= 1.0  # the reference's tolerance holds on [-1, 1]
    assert np.max(np.abs(tops.dequantize_fixed(got).numpy() - x)[inside]) < {np.int8: 5e-3, np.int16: 1e-4}[dtype]
    assert tops.int_max_for(dtype) == tops.int_max_for(got.dtype) == jops.int_max_for(dtype)


def test_quantize_bf16_is_a_cast(make_noise):
    x = make_noise(256)
    q = tops.quantize_fixed(x, torch.bfloat16, device=CPU)
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(tops.dequantize_fixed(q).numpy(),
                                  np.asarray(jops.dequantize_fixed(jops.quantize_fixed(x, jnp_bf16()))))


def jnp_bf16():
    import jax.numpy as jnp

    return jnp.bfloat16


# ------------------------------------------------------------------ debug


def test_assert_finite(make_noise):
    tdebug.assert_finite({"a": torch.from_numpy(make_noise(16)), "b": (torch.zeros(2), [np.ones(3)])})
    tdebug.assert_finite({"i": torch.tensor([1, 2])})  # integer leaves are not checked
    with pytest.raises(FloatingPointError, match="leaf 1"):
        tdebug.assert_finite({"b": torch.tensor([1.0, float("nan")]), "a": torch.zeros(1)})
    with pytest.raises(FloatingPointError):
        tdebug.assert_finite(np.array([1.0, np.inf]))
    # the same leaf index as neojax (sorted dict keys)
    with pytest.raises(FloatingPointError, match="leaf 1"):
        jdebug.assert_finite({"b": np.array([1.0, np.nan]), "a": np.zeros(1)})


def test_checked_catches_the_first_nonfinite_op():
    def bad(x):
        y = torch.log(x)  # NaN for negative input
        return torch.nan_to_num(y)  # the return value alone would look finite

    safe = tdebug.checked(bad)
    np.testing.assert_allclose(safe(torch.tensor([1.0, 2.0])).numpy(), np.log([1.0, 2.0]), rtol=1e-6)
    with pytest.raises(FloatingPointError, match="log"):
        safe(torch.tensor([-1.0]))
    # a NaN already in the input is not the function's doing
    assert torch.isnan(tdebug.checked(lambda x: x * 2)(torch.tensor([float("nan")]))).all()


def test_checked_wraps_a_convolver_step(make_noise):
    b = 16
    parts = tconv.uniform_partition(make_noise(3 * b) * 0.2, b)
    cfg = tconv.PartitionedConfig(b, parts.shape[1], channels=1, storage="split")
    params = tconv.filter_params(cfg, parts, device=CPU)
    step = tdebug.checked(lambda s, blk: tconv.step(cfg, params, s, blk))
    state, out = step(tconv.init_state(cfg, device=CPU), torch.from_numpy(make_noise(1, b)))
    assert out.shape == (1, b) and bool(torch.isfinite(out).all())


def test_checked_skips_uninitialized_buffers():
    """``torch.empty`` returns whatever bits its memory held, NaN among
    them; that is not an op turning finite inputs into NaN, so ``checked``
    does not raise on it (memory freed full of NaN is handed out again)."""
    n = 1 << 16
    for _ in range(20):
        x = torch.full((n,), float("nan"))
        del x
        out = tdebug.checked(lambda: torch.empty(n).fill_(1.0))()
        assert bool(torch.all(out == 1.0))


def test_x64_parity_within_reference_bound(make_noise):
    """The f32 partitioned convolver stays within the reference's 1e-5 bound
    of its own f64 evaluation (``tests/test_observability.py``)."""
    b = 64
    parts = tconv.uniform_partition(make_noise(4 * b) * 0.2, b)
    sig = torch.from_numpy(make_noise(1, 8 * b))
    cfg = tconv.PartitionedConfig(b, parts.shape[1], channels=1, storage="dense")
    params = tconv.filter_params(cfg, parts, device=CPU)

    def run(x):
        return tconv.process(cfg, params, tconv.init_state(cfg, device=CPU), x)[1]

    # the convolver computes in float32 whatever its input (as neojax's
    # kernels do), so the promoted run differs by at most the input rounding
    assert tdebug.x64_parity_error(run, sig) < 1e-5

    def poly(x):
        return (x * 1.1) ** 3

    assert tdebug.x64_parity_error(poly, sig) == pytest.approx(
        jdebug.x64_parity_error(poly, np.asarray(sig.numpy())), rel=0.5, abs=1e-7)


# ------------------------------------------------------------ Bluestein


@pytest.mark.parametrize("n", [4, 5, 12, 17, 31, 100, 257])
def test_bluestein_dft_matches_numpy_and_neojax(make_noise, n):
    x = (make_noise(3, n) + 1j * make_noise(3, n)).astype(np.complex64)
    fwd = tfft.dft(x, forward=True, device=CPU)
    assert fwd.dtype == torch.complex64
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.abs(fwd.numpy() - ref).max() < _scaled_tol(ref)
    assert np.abs(fwd.numpy() - np.asarray(jfft.dft(x))).max() < _scaled_tol(ref)
    # unnormalized backward like the reference plan: dft(., False) / n == identity
    bwd = tfft.dft(fwd, forward=False).numpy() / n
    assert np.abs(bwd - x).max() < 1e-5 * max(1.0, n / 16)


def test_bluestein_complex128_and_real_input(make_noise):
    x = (make_noise(33) + 1j * make_noise(33)).astype(np.complex128)
    out = tfft.dft(x, device=CPU)
    assert out.dtype == torch.complex128
    np.testing.assert_allclose(out.numpy(), np.asarray(jfft.dft(x)), rtol=1e-6, atol=1e-6)
    r = make_noise(20)
    np.testing.assert_allclose(tfft.dft(r, device=CPU).numpy(), np.fft.fft(r), atol=_scaled_tol(np.fft.fft(r)))


@pytest.mark.parametrize("n", [4, 16, 64])
def test_naive_dft_oracle(make_noise, n):
    x = (make_noise(n) + 1j * make_noise(n)).astype(np.complex64)
    got = tfft.naive_dft(x, device=CPU).numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - ref).max() < _scaled_tol(ref)
    np.testing.assert_allclose(got, np.asarray(jfft.naive_dft(x)), atol=_scaled_tol(ref))
    back = tfft.naive_dft(got, forward=False, device=CPU).numpy() / n
    assert np.abs(back - x).max() < 1e-5


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_dct2_matches_oracle_and_neojax(make_noise, n, backend):
    from scipy_free_dct import dct2_ref

    x = make_noise(n)
    out = tfft.dct2(x, backend=backend, device=CPU)
    assert out.dtype == torch.float32
    ref = dct2_ref(x.astype(np.float64))
    assert np.abs(out.numpy() - ref).max() < _scaled_tol(ref)
    assert np.abs(out.numpy() - np.asarray(jfft.dct2(x, backend=backend))).max() < _scaled_tol(ref)


def test_dct2_along_an_axis(make_noise):
    x = make_noise(16, 3)
    got = tfft.dct2(x, axis=0, device=CPU).numpy()
    want = np.asarray(jfft.dct2(x, axis=0))
    assert got.shape == (16, 3) and np.abs(got - want).max() < _scaled_tol(want)


# -------------------------------------------------------------- goldens


def _load(name):
    return np.load(os.path.join(GOLD, name))


@pytest.mark.parametrize("n", [17, 100])
def test_bluestein_dft_matches_reference(n):
    x = _load("in_cnoise_1024.npy")[:n]
    golden = _load(f"ref_dft_{n}.npy")
    out = tfft.dft(x.astype(np.complex64), forward=True, device=CPU).numpy()
    assert np.abs(out - golden).max() < _scaled_tol(golden)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_dct2_matches_reference(backend):
    x = _load("in_rnoise_256.npy")[:64]
    golden = _load("ref_dct2_64.npy")
    out = tfft.dct2(x.astype(np.float32), backend=backend, device=CPU).numpy()
    assert np.abs(out - golden).max() < _scaled_tol(golden)


def test_stft_matches_reference():
    sig = _load("in_sig.npy")
    golden = _load("ref_stft_256_128.npy")
    out = tfft.stft(sig, tfft.StftOptions(frame_size=256, transform_size=256, overlap_size=128, window="hann"),
                    device=CPU).numpy()
    assert out.shape == golden.shape
    assert np.abs(out - golden).max() < _scaled_tol(golden)


# ------------------------------------------------------------ fft extras


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_rfft_deinterleave(make_noise, backend):
    x, y = make_noise(2, 256), make_noise(2, 256)
    xf, yf = tfft.rfft_deinterleave(x, y, backend=backend, device=CPU)
    for got, sig in ((xf, x), (yf, y)):
        ref = np.fft.rfft(sig.astype(np.float64))
        assert got.shape == ref.shape and np.abs(got.numpy() - ref).max() < _scaled_tol(ref)
    jx, jy = jfft.rfft_deinterleave(x, y, backend=backend)
    assert np.abs(xf.numpy() - np.asarray(jx)).max() < _scaled_tol(np.asarray(jx))
    assert np.abs(yf.numpy() - np.asarray(jy)).max() < _scaled_tol(np.asarray(jy))


def test_split_fft_roundtrip(make_noise):
    re, im = make_noise(3, 128), make_noise(3, 128)
    fr, fi = tfft.split_fft(re, im, device=CPU)
    ref = np.fft.fft(re.astype(np.float64) + 1j * im)
    assert np.abs(fr.numpy() - ref.real).max() < _scaled_tol(ref)
    assert np.abs(fi.numpy() - ref.imag).max() < _scaled_tol(ref)
    jr, ji = jfft.split_fft(re, im)
    assert np.abs(fr.numpy() - np.asarray(jr)).max() < _scaled_tol(ref)
    assert np.abs(fi.numpy() - np.asarray(ji)).max() < _scaled_tol(ref)
    br, bi = tfft.split_ifft(fr, fi)
    assert np.abs(br.numpy() - re).max() < 1e-5 and np.abs(bi.numpy() - im).max() < 1e-5


@pytest.mark.parametrize("n", [8, 64, 256])
def test_packed_rfft_matches_numpy_and_neojax(make_noise, n):
    x = make_noise(3, n)
    re, im = tfft.packed_rfft(x, device=CPU)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert re.shape == ref.shape
    assert np.abs(re.numpy() - ref.real).max() < _scaled_tol(ref)
    assert np.abs(im.numpy() - ref.imag).max() < _scaled_tol(ref)
    jre, jim = jfft.packed_rfft(x)
    assert np.abs(re.numpy() - np.asarray(jre)).max() < _scaled_tol(ref)
    assert np.abs(im.numpy() - np.asarray(jim)).max() < _scaled_tol(ref)
    back = tfft.packed_irfft(re, im)
    assert back.shape == x.shape and np.abs(back.numpy() - x).max() < 1e-5
    # a short input is zero-padded to n, a long one trimmed
    re2, _ = tfft.packed_rfft(x[:, : n // 2 + 1], n=n, device=CPU)
    jre2, _ = jfft.packed_rfft(x[:, : n // 2 + 1], n=n)
    assert np.abs(re2.numpy() - np.asarray(jre2)).max() < _scaled_tol(ref)


def test_pack_twiddle_stages_match_neojax(make_noise):
    half = 32
    zre, zim = make_noise(2, half), make_noise(2, half)
    got = textras.pack_forward_post(torch.from_numpy(zre), torch.from_numpy(zim), half)
    want = jextras.pack_forward_post(zre, zim, half)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    re, im = make_noise(2, half + 1), make_noise(2, half + 1)
    got = textras.pack_inverse_pre(torch.from_numpy(re), torch.from_numpy(im), half)
    want = jextras.pack_inverse_pre(re, im, half)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_packed_rfft_odd_size_rejected():
    with pytest.raises(ValueError):
        tfft.packed_rfft(np.zeros(7, np.float32), device=CPU)
    with pytest.raises(ValueError):
        jfft.packed_rfft(np.zeros(7, np.float32))


# ------------------------------------------------------------- namespaces


# neojax.io's orbax pair and its counterpart on torch.distributed.checkpoint
_ORBAX = {"save_state_orbax": "save_state_dcp", "load_state_orbax": "load_state_dcp"}


def test_namespaces_export_what_neojax_exports():
    """``fft``, ``core``, ``ops``, ``io`` and ``dist`` export ``neojax``'s
    names (``io``'s orbax pair as its ``torch.distributed.checkpoint``
    counterpart), ``bench`` the weak-scaling sweep. ``four_step`` is a
    submodule of ``fft`` in both packages, and neither exports it from
    ``fft``."""
    import neojax_torch.bench

    assert set(jfft.__all__) <= set(tfft.__all__)
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert set(jops.__all__) <= set(tops.__all__)
    assert {_ORBAX.get(n, n) for n in neojax.io.__all__} <= set(neojax_torch.io.__all__)
    assert set(neojax.dist.__all__) <= set(neojax_torch.dist.__all__)
    assert {"ScalingPoint", "weak_scaling_sweep"} <= set(neojax_torch.bench.__all__)
    assert "four_step" not in tfft.__all__
    for mod in (tfft, tcore, tops, neojax_torch.io, neojax_torch.dist, neojax_torch.bench):
        for name in mod.__all__:
            assert hasattr(mod, name), f"{mod.__name__}.{name}"
    assert set(neojax.__all__) - {"kernels"} <= set(neojax_torch.__all__)


@pytest.mark.parametrize("script", ["chip_smoke.py", "examples/realtime_stream_torch.py",
                                    "examples/perceptual_convolution_torch.py"])
def test_port_scripts_import_no_jax(script):
    """The card smoke and the port's real-time example import neither jax
    nor neojax (the package itself: ``test_torch_convolve.py``)."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "neojax"), f"{script}: {name}"


# ------------------------------------------------------- signature parity

# The JAX-only parameters the port leaves out, by name (ROADMAP §C):
# ``precision=`` of fft.matmul_backend (its products are IEEE float32),
# ``mats=`` (the port caches its matrices per device), ``interpret`` and
# ``shared_filter`` of the kernel wrappers, ``make_mesh(devices=)``.
_JAX_ONLY = {
    "neojax.fft.matmul_backend": {"precision", "mats"},
    "*": {"mats"},
    "neojax.kernels.fused_step": {"interpret", "shared_filter"},
    "neojax.kernels.fdl_mac": {"interpret"},
    "neojax.kernels.sparse_mac": {"interpret"},
    "neojax.kernels.nested_mac": {"interpret"},
    "neojax.dist.mesh": {"devices"},
    "neojax.dist": {"devices"},
}
# names the port does not carry: ``dist.mesh.P`` (jax's PartitionSpec), the
# Pallas entry points (the port's kernels are ``fdl_mac``,
# ``sparse_fdl_mac`` and ``nested_mac``), the TPU-only 8-lane filter
# layout, and the orbax pair (``save_state_dcp``/``load_state_dcp``)
_NOT_PORTED = {"P", "fdl_mac_pallas", "sparse_fdl_mac_pallas", "nested_mac_pallas", "shift8_filter",
               "save_state_orbax", "load_state_orbax"}


def _neojax_modules():
    import pkgutil

    names = ["neojax"] + [m.name for m in pkgutil.walk_packages(neojax.__path__, "neojax.")]
    return sorted(names)


def _public_callables(mod):
    import inspect

    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_") and callable(v) and getattr(v, "__module__", None) == mod.__name__]
    return [n for n in names if callable(getattr(mod, n, None)) and not inspect.ismodule(getattr(mod, n))]


def _param_names(fn):
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    return [p.name for p in params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


@pytest.mark.parametrize("module", _neojax_modules())
def test_signatures_are_a_prefix_of_the_ports(module):
    """Every public callable of a ``neojax`` module exists in the port's
    module of the same path, and its parameter names (less the JAX-only
    ones) are a prefix, in order, of the port's: a call written against
    ``neojax`` binds the same arguments on the port."""
    import importlib

    jm = importlib.import_module(module)
    tm = importlib.import_module(module.replace("neojax", "neojax_torch", 1))
    skip = _JAX_ONLY["*"] | _JAX_ONLY.get(module, set())
    for name in _public_callables(jm):
        if name in _NOT_PORTED:
            continue
        assert hasattr(tm, name), f"{tm.__name__}.{name} missing"
        jp, tp = _param_names(getattr(jm, name)), _param_names(getattr(tm, name))
        if jp is None or tp is None:
            continue
        jp = [p for p in jp if p not in skip]
        assert tp[: len(jp)] == jp, f"{module}.{name}: neojax {jp}, port {tp}"


# ------------------------------------------------------ P5: backend keywords


def _p5_run(cfg_kw, rng, storage="split", nb=6, b=32, p=4, c=2):
    from neojax_torch.conv import convolver as tcv

    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, nb * b)).astype(np.float32))
    cfg = tcv.PartitionedConfig(b, p, c, storage=storage, **cfg_kw)
    prm = tcv.filter_params(cfg, parts, device=CPU)
    _, out = tcv.process(cfg, prm, tcv.init_state(cfg, device=CPU), sig)
    outs = [out]
    st = tcv.init_state(cfg, device=CPU)
    for i in range(nb):  # the per-block route too
        st, y = tcv.step(cfg, prm, st, sig[:, i * b : (i + 1) * b])
        outs.append(y)
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("storage", ["split", "int8"])
@pytest.mark.parametrize("name,port_name", [("auto", "kernel"), ("pallas", "kernel"), ("xla", "torch")])
def test_p5_mac_backend_spellings(storage, name, port_name):
    """``mac_backend`` takes the JAX package's spellings, each bit-equal to
    the port's own name of its route (per block and streamed)."""
    got = _p5_run({"mac_backend": name}, np.random.default_rng(3), storage)
    want = _p5_run({"mac_backend": port_name}, np.random.default_rng(3), storage)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("storage", ["dense", "split"])
@pytest.mark.parametrize("backend", ["xla", "matmul", "auto"])
def test_p5_fft_backend_routes(storage, backend):
    """``PartitionedConfig(fft_backend=)`` in the reference's position (after
    ``storage``) reaches ``fft.api`` where the port has a choice (dense, and
    the non-packed split layout) and agrees with the default route within
    1e-5 of the peak; the packed layout has one route and ignores it."""
    from neojax_torch.conv import convolver as tcv

    cfg = tcv.PartitionedConfig(32, 4, 2, "upols", storage, backend)
    assert cfg.fft_backend == backend and cfg.layout == "ring"
    for packed in ((None, False) if storage == "split" else (None,)):
        got = _p5_run({"fft_backend": backend, "packed": packed}, np.random.default_rng(4), storage)
        want = _p5_run({"packed": packed}, np.random.default_rng(4), storage)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, float(np.abs(w).max())), rtol=0)


def test_p5_convolver_positional_order(rng):
    """``Convolver(scheme, storage, fft_backend, sparsity, require_sparsity)``
    binds as on ``neojax``, ``device`` last; the aliases follow."""
    c = tconv.Convolver("upols", "dense", "matmul", None, False, CPU)
    assert c._fft_backend == "matmul" and c._default_sparsity is None and not c._require_sparsity
    ir = rng.uniform(-1, 1, 96).astype(np.float32) * 0.3
    sig = rng.uniform(-1, 1, (2, 8 * 32)).astype(np.float32)
    c.filter(tconv.uniform_partition(ir, 32, "xla"))
    assert c.config.fft_backend == "matmul"
    out = c.process(sig).numpy()
    ref = np.stack([np.convolve(x, ir)[: sig.shape[1]] for x in sig])
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    j = jconv.Convolver("upols", "dense", "matmul", None, False)
    assert j._fft_backend == "matmul"
    d = tconv.make_convolver("upols", "split", fft_backend="xla", device=CPU)
    assert d._fft_backend == "xla" and d._storage == "split"


def test_p5_uniform_partition_and_stft_backend(make_noise):
    """``uniform_partition(ir, B, backend)`` accepts and ignores its
    backend, as ``neojax`` does; ``stft(x, options, backend)`` takes it
    third and routes it to ``fft.api`` (``device`` after it)."""
    ir = make_noise(2, 200)
    base = tconv.uniform_partition(ir, 64)
    for backend in ("xla", "matmul", None):
        np.testing.assert_array_equal(tconv.uniform_partition(ir, 64, backend), base)
        np.testing.assert_array_equal(tconv.uniform_partition(ir, 64, backend=backend), base)
    x = make_noise(2, 1000)
    opt = tfft.StftOptions(frame_size=128, transform_size=128, overlap_size=64)
    want = np.asarray(jfft.stft(x, opt, "xla"))
    for backend in ("xla", "matmul", "auto"):
        got = tfft.stft(x, opt, backend, CPU).numpy()
        np.testing.assert_allclose(got, want, atol=_scaled_tol(want), rtol=0)
        np.testing.assert_array_equal(tfft.stft(x, opt, backend=backend, device=CPU).numpy(), got)


def test_p5_fused_block_above_max_raises():
    """Departure (ROADMAP §C): ``fused=True`` with a block above the fused
    kernels' 1024 raises on the port; ``neojax`` builds the config."""
    from neojax_torch.conv import convolver as tcv

    with pytest.raises(ValueError):
        tcv.PartitionedConfig(2048, 4, 2, storage="split", fused=True)
    jconv.PartitionedConfig(2048, 4, 2, storage="split", fused=True)
