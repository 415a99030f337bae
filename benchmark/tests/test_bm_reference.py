"""The plain reference against a direct convolution, dense and masked."""

import numpy as np
import pytest
import torch

from benchmark.reference import upols

B = 16


def _stream(x):
    def segment(g0, g1):
        lo = max(g0, 0)
        seg = torch.from_numpy(x[:, lo * B : g1 * B])
        return torch.nn.functional.pad(seg, ((lo - g0) * B, 0))
    return segment


def _direct(x, ir):
    return np.stack([np.convolve(ch.astype(np.float64), ir.astype(np.float64))[: x.shape[1]] for ch in x])


@pytest.fixture
def case():
    rng = np.random.default_rng(3)
    ir = rng.standard_normal(6 * B - 5).astype(np.float32)
    x = rng.standard_normal((3, 40 * B)).astype(np.float32)
    return ir, x


def test_dense_matches_np_convolve(case):
    ir, x = case
    ys = upols.output_blocks(_stream(x), upols.partition(ir, B), [0, 1, 5, 6, 39], B)
    full = _direct(x, ir)
    for g, y in ys.items():
        np.testing.assert_allclose(y.numpy(), full[:, g * B : (g + 1) * B], atol=2e-6 * np.abs(full).max())


def test_partition_mask_matches_truncated_ir(case):
    """A mask that drops whole partitions is the IR with those segments zeroed."""
    ir, x = case
    spectra = upols.partition(ir, B)
    mask = np.zeros(spectra.shape, bool)
    mask[[0, 2, 5]] = True
    cut = ir.copy().reshape(-1)
    cut = np.pad(cut, (0, spectra.shape[0] * B - cut.size)).reshape(-1, B)
    cut[[1, 3, 4]] = 0
    ys = upols.output_blocks(_stream(x), np.where(mask, spectra, 0), [3, 17, 39], B)
    full = _direct(x, cut.reshape(-1))
    for g, y in ys.items():
        np.testing.assert_allclose(y.numpy(), full[:, g * B : (g + 1) * B], atol=2e-6 * np.abs(full).max())


def test_bin_mask_matches_per_partition_circular_sum(case):
    """A bin mask: each partition's masked spectrum filters its frame
    circularly; the sum of the frames' second halves, in float64."""
    ir, x = case
    spectra = upols.partition(ir, B)
    mask = np.random.default_rng(4).random(spectra.shape) < 0.3
    masked = np.where(mask, spectra, 0)
    xp = np.pad(x.astype(np.float64), ((0, 0), (B * (spectra.shape[0] + 1), 0)))
    off = B * (spectra.shape[0] + 1)
    for g in (2, 9, 39):
        want = np.zeros((x.shape[0], B))
        for p in range(spectra.shape[0]):
            j = g - p
            frame = xp[:, off + (j - 1) * B : off + (j + 1) * B]
            want += np.fft.irfft(np.fft.rfft(frame, axis=-1) * masked[p], n=2 * B, axis=-1)[:, B:]
        got = upols.output_blocks(_stream(x), masked, [g], B)[g].numpy()
        np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())


def test_tf32_rounding():
    t = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265, 0.0, 2.0**-130])
    got = upols.round_tf32(t).tolist()
    assert got[:4] == [1.0, 1.0 + 2**-9, -3.140625, 0.0]
    m = upols.round_tf32(torch.randn(1000)).view(torch.int32)
    assert int((m & 0x1FFF).abs().sum()) == 0


def test_tf32_stand_in_departs_from_f64(case):
    ir, x = case
    spectra = upols.partition(ir, B)
    f64 = upols.output_blocks(_stream(x), spectra, [20], B)[20]
    tf32 = upols.output_blocks(_stream(x), spectra, [20], B, precision="tf32")[20]
    rel = float((tf32 - f64).norm() / f64.norm())
    assert 1e-5 < rel < 1e-2


def test_int4_groups_round_to_seven_steps_of_their_peak():
    z = torch.complex(torch.tensor([[7.0, -3.5, 1.0, 0.2, 0.0, 0.0, 0.0, 0.0, 2.0]]),
                      torch.tensor([[0.0, 0.0, -7.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.2]]))
    q = upols.quantize_groups(z)  # groups of 4 bins: peaks 7, 0 and 2 (the last group one bin)
    assert q.real[0, :8].tolist() == [7.0, -4.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]  # -3.5 to even
    assert q.imag[0, :8].tolist() == [0.0, 0.0, -7.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    assert (float(q.real[0, 8]), float(q.imag[0, 8])) == pytest.approx((2.0, -4 * 2 / 7))


def test_int4_stand_in_departs_from_f64_far_more_than_tf32(case):
    ir, x = case
    spectra = upols.partition(ir, B)
    f64 = upols.output_blocks(_stream(x), spectra, [20], B)[20]
    int4 = upols.output_blocks(_stream(x), spectra, [20], B, precision="int4")[20]
    assert 0.02 < float((int4 - f64).norm() / f64.norm()) < 0.5
