"""The measurement probes' plain versions (the CPU route of
``neojax_torch.kernels.probes``) against numpy formulas built from neojax:

- T1 ``probe_ring_read``: ``out0`` is the TPU probe's function
  (``tools/roofline_cal.py`` ``_stripped``: plane 0's first row of each
  ``choose_chunks`` chunk times the filter's first row of that chunk,
  summed over chunks) at neojax's chunk geometry; ``out1`` the sum of every
  other element. float64 sums here and there: rtol 1e-6 (the f32 output).
- T2 ``probe_stream``: the TPU probe's ``k_tf`` per block (the frame rounded
  to the matrix dtype, times neojax's packed forward matrices; ``sre +
  sim``, or the tail-half inverse of the matrix-dtype-rounded spectrum) and
  ``k_empty``'s zeros. f32 matrices: rtol 1e-5 of the peak (the port casts
  the f64 matrices to f32 once); bf16: 1e-2 (one bf16 rounding of each
  matrix element and of the spectrum).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax.fft import matmul_backend as jmb
from neojax.kernels import fdl_mac as jmac
from neojax_torch.fft import matmul_backend as tmb
from neojax_torch.kernels import fdl_mac as tmac
from neojax_torch.kernels import probes

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _round(x: np.ndarray, dt) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32).astype(_JDT[dt]).astype(jnp.float32), np.float64)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,c,k", [(24, 3, 40), (960, 2, 16), (7, 1, 5)])
def test_ring_read_plain_matches_tpu_probe(rng, dt, p, c, k):
    _, pc = jmac.choose_chunks(_JDT[dt], p, c, k)
    assert tmac.choose_chunks(dt, p, c, k)[1] == pc
    fdl = _round(rng.standard_normal((2, p, c, k)), dt)
    fr = rng.standard_normal((p, k)).astype(np.float32)
    heads = fdl[0, ::pc]
    want0 = np.einsum("jck,jk->ck", heads, fr[::pc].astype(np.float64))
    want1 = fdl.sum(axis=(0, 1)) - heads.sum(axis=0)
    before = probes.probe_ring_read.launches
    out0, out1 = probes.probe_ring_read(torch.from_numpy(fdl).to(dt), torch.from_numpy(fr), pc)
    assert probes.probe_ring_read.launches == before  # the CPU route launches nothing
    assert out0.dtype == out1.dtype == torch.float32 and out0.shape == out1.shape == (c, k)
    np.testing.assert_allclose(out0.numpy(), want0, rtol=1e-6, atol=1e-6 * np.abs(want0).max())
    np.testing.assert_allclose(out1.numpy(), want1, rtol=1e-6, atol=1e-6 * np.abs(want1).max())


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("mode", ["empty", "win_fwd", "win_fwd_inv"])
def test_stream_plain_matches_tpu_probe(rng, dt, tol, mode):
    c, b, nb = 3, 32, 5
    n = 2 * b
    sig = rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)
    cre, cim = (np.asarray(m, np.float64) for m in jmb.rfft_packed_matrices(n))
    ia, ib = (np.asarray(m, np.float64) for m in jmb.irfft_packed_matrices(n))
    cs = _round(np.concatenate([cre, cim], axis=-1), dt)
    abt = _round(np.concatenate([ia[:, b:], ib[:, b:]], axis=0), dt)
    want = np.zeros((c, nb * b))
    if mode != "empty":
        for i in range(nb):
            spec = _round(sig[:, i * b : i * b + n], dt) @ cs
            if mode == "win_fwd":
                y = spec[:, :b] + spec[:, b:]
            else:
                y = _round(spec, dt) @ abt
            want[:, i * b : (i + 1) * b] = y
    tcs, tabt = tmb.packed_stream_mats(n, dt, "cpu")
    before = probes.probe_stream.launches
    got = probes.probe_stream(torch.from_numpy(sig), tcs, tabt, mode)
    assert probes.probe_stream.launches == before
    assert got.dtype == torch.float32 and got.shape == (c, nb * b)
    if mode == "empty":
        assert not got.any()
    else:
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def test_probes_reject_bad_arguments():
    fdl = torch.zeros((2, 8, 2, 16))
    fr = torch.zeros((8, 16))
    with pytest.raises(TypeError):
        probes.probe_ring_read(fdl.to(torch.int8), fr, 4)
    with pytest.raises(ValueError):
        probes.probe_ring_read(fdl, fr, 3)  # pc must divide P
    with pytest.raises(ValueError):
        probes.probe_ring_read(fdl, fr[:4], 4)
    cs, abt = tmb.packed_stream_mats(32, torch.float32, "cpu")
    sig = torch.zeros((2, 3 * 16))
    with pytest.raises(ValueError):
        probes.probe_stream(sig, cs, abt, "mac")
    with pytest.raises(ValueError):
        probes.probe_stream(sig, cs, abt.to(torch.bfloat16), "win_fwd")
    with pytest.raises(ValueError):
        probes.probe_stream(sig[:, :40], cs, abt, "win_fwd")  # not (nb+1)*B
    with pytest.raises(ValueError):
        probes.probe_stream(sig[:, :16], cs, abt, "empty")  # nb = 0
