"""neojax_torch leaves vs neojax and the C++-built goldens: partitioning,
the packed-DFT matrices and transforms, block (un)streaming, impulse
normalization, sparsity masks and the sizing helpers.

Tolerances: matrices 1e-6 absolute (the port builds them in float64, the
reference casts each to float32); float32 transforms 1e-5 of the
coefficient peak (``tests/test_reference_parity.py``'s scaled bound).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax import conv as jconv
from neojax.core import bits as jbits
from neojax.fft import matmul_backend as jmb
from neojax.ops import normalize as jnorm
from neojax_torch import conv as tconv
from neojax_torch.core import bits as tbits
from neojax_torch.fft import api as tfft
from neojax_torch.fft import matmul_backend as tmb
from neojax_torch.ops import normalize as tnorm
from neojax_torch.ops.quantize import int_max_for

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def test_uniform_partition_matches_golden_and_neojax():
    ir = np.load(os.path.join(GOLD, "in_ir.npy"))
    golden = np.load(os.path.join(GOLD, "ref_partition_b128.npy"))
    out = tconv.uniform_partition(ir, 128)
    assert out.shape == golden.shape and out.dtype == np.complex64
    assert np.abs(out - golden).max() < 1e-5 * max(1.0, np.abs(golden).max())
    np.testing.assert_array_equal(out, np.asarray(jconv.uniform_partition(ir, 128)))
    np.testing.assert_array_equal(tconv.uniform_partition(torch.from_numpy(ir), 128), out)
    for length in (1, 127, 128, 129, 1000):
        assert tconv.num_partitions(length, 128) == jconv.num_partitions(length, 128)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_packed_mats_match_neojax(n):
    t_cs, t_ab = tmb.packed_mats_np(n)
    j_cs, j_ab = jmb.packed_mats_np(n)
    assert t_cs.shape == j_cs.shape == (2, n, n // 2)
    assert t_ab.shape == j_ab.shape == (2, n // 2, n)
    np.testing.assert_allclose(t_cs, j_cs, atol=1e-6)
    np.testing.assert_allclose(t_ab, j_ab, atol=1e-6)
    cs2, ab2 = tmb.packed_mats(n, torch.float32, "cpu")
    np.testing.assert_array_equal(cs2.numpy(), t_cs.astype(np.float32))
    np.testing.assert_array_equal(ab2.numpy(), t_ab.astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_stream_mats_match_neojax(dtype):
    n = 64
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    t_cs, t_abt = tmb.packed_stream_mats(n, tdt, "cpu")
    j_cs, j_abt = jmb.packed_stream_mats(n, jdt)
    assert tuple(t_cs.shape) == (n, n) and tuple(t_abt.shape) == (n, n // 2)
    assert t_cs.dtype == tdt
    tol = 1e-6 if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(t_cs.float().numpy(), np.asarray(j_cs.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(t_abt.float().numpy(), np.asarray(j_abt.astype(jnp.float32)), atol=tol)


@pytest.mark.parametrize("n", [16, 128])
def test_packed_split_transforms_match_neojax(rng, n):
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    t_re, t_im = tmb.rfft_packed_split(torch.from_numpy(x), n)
    j_re, j_im = jmb.rfft_packed_split(jnp.asarray(x), n)
    scale = max(1.0, np.abs(np.asarray(j_re)).max(), np.abs(np.asarray(j_im)).max())
    assert np.abs(t_re.numpy() - np.asarray(j_re)).max() < 1e-5 * scale
    assert np.abs(t_im.numpy() - np.asarray(j_im)).max() < 1e-5 * scale

    # inverse of an arbitrary packed spectrum (not only of a real signal)
    re = rng.standard_normal((3, n // 2)).astype(np.float32)
    im = rng.standard_normal((3, n // 2)).astype(np.float32)
    t_y = tmb.irfft_packed_split(torch.from_numpy(re), torch.from_numpy(im), n)
    j_y = jmb.irfft_packed_split(jnp.asarray(re), jnp.asarray(im), n)
    assert np.abs(t_y.numpy() - np.asarray(j_y)).max() < 1e-5
    # round trip
    y = tmb.irfft_packed_split(t_re, t_im, n)
    assert np.abs(y.numpy() - x).max() < 1e-5


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_rfft_irfft_norms(rng, norm):
    x = rng.uniform(-1, 1, (2, 64)).astype(np.float32)
    spec = tfft.rfft(torch.from_numpy(x), norm=norm)
    np.testing.assert_allclose(spec.numpy(), np.fft.rfft(x, norm=norm), rtol=1e-4, atol=1e-5)
    back = tfft.irfft(spec, n=64, norm=norm)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    with pytest.raises(ValueError):
        tfft.rfft(torch.from_numpy(x), norm="bogus")


@pytest.mark.parametrize("t", [1, 96, 100])
def test_stream_unstream_round_trip(rng, t):
    sig = rng.uniform(-1, 1, (3, t)).astype(np.float32)
    t_blocks, t_len = tconv.stream_blocks(torch.from_numpy(sig), 32)
    j_blocks, j_len = jconv.stream_blocks(jnp.asarray(sig), 32)
    assert t_len == j_len == t
    np.testing.assert_array_equal(t_blocks.numpy(), np.asarray(j_blocks))
    np.testing.assert_array_equal(tconv.unstream_blocks(t_blocks, t_len).numpy(), sig)


@pytest.mark.parametrize("shape", [(300,), (3, 200)])
def test_normalize_impulse_matches_neojax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] = 0.0
    t = tnorm.normalize_impulse(x)
    j = jnorm.normalize_impulse(jnp.asarray(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    zero = tnorm.normalize_impulse(torch.zeros(8))
    np.testing.assert_array_equal(zero.numpy(), np.zeros(8))
    with pytest.raises(ValueError):
        tnorm.normalize_impulse(torch.zeros((2, 2, 2)))


def test_sparsity_mask_matches_neojax(rng):
    parts = (rng.standard_normal((2, 4, 9)) + 1j * rng.standard_normal((2, 4, 9))).astype(np.complex64)

    def pred(row, col, value):
        return ((col % 3) != 0) & (np.abs(value) > 0.5) | (row == 0)

    t = tconv.sparsity_mask(parts, pred)
    j = jconv.sparsity_mask(parts, pred)
    assert t.dtype == bool
    np.testing.assert_array_equal(t, np.asarray(j))


def test_bits_and_int_max():
    for n in range(0, 70):
        assert tbits.bit_ceil(n) == jbits.bit_ceil(n)
        assert tbits.is_pow2(n) == jbits.is_pow2(n)
        assert tbits.idiv(n, 7) == jbits.idiv(n, 7)
    assert int_max_for(torch.int8) == 127
    assert int_max_for(torch.int16) == 32767
