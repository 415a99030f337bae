"""neojax_torch fused kernels B2/B3 (plain route, CPU) vs neojax's Pallas
``fused_block_step`` / ``fused_stream`` in interpret mode, B3 also with its
``acc_add`` accumulator seed.

The same seeded numpy inputs go to both packages. The JAX shared filter is
the 8-copy ``shift8_filter`` form; the port's is one ``[2P, 1, 2B]`` copy.
The port updates its ring in place, so it gets its own copy of the numpy
inputs: JAX on the CPU may alias a numpy buffer and still be reading it
asynchronously. Tolerance ``_TOL`` is relative to the output peak (as
``tests/test_fused_step.py``); int rings may differ by one LSB where a
spectrum lands on a rounding boundary.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax.fft import matmul_backend as jmb
from neojax.kernels import fused_step as jfs
from neojax_torch.kernels import fused_step as tfs

_TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_STORE = {
    "split": (np.float32, jnp.float32, torch.float32),
    "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
    "int16": (np.int16, jnp.int16, torch.int16),
    "int8": (np.int8, jnp.int8, torch.int8),
}
_INT_MAX = {"int16": 32767, "int8": 127}
B, P, C = 32, 4, 2


def _mat_dtypes(storage):
    if storage in ("bf16", "int8"):
        return jnp.bfloat16, torch.bfloat16
    return jnp.float32, torch.float32


def _inputs(rng, storage, cf):
    """Seeded ring, scales and filter in f32/int numpy."""
    npdt = _STORE[storage][0]
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        ring = rng.integers(-m, m + 1, (2, P, C, B)).astype(npdt)
        scales = rng.uniform(0.5, 4.0, (P, C)).astype(np.float32)
    else:
        ring = rng.standard_normal((2, P, C, B)).astype(np.float32)
        scales = None
    rim = (0.1 * rng.standard_normal((2 * P, cf, 2 * B))).astype(np.float32)
    return ring, scales, rim


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        1e-12, np.abs(np.asarray(b, np.float64)).max()
    )


def _check_ring(storage, t_ring, j_ring, t_scl=None, j_scl=None):
    t_ring = t_ring.to(torch.float32).numpy()
    j_ring = np.asarray(jnp.asarray(j_ring).astype(jnp.float32))
    if storage in _INT_MAX:
        assert np.abs(t_ring - j_ring).max() <= 1
        np.testing.assert_allclose(t_scl, j_scl, rtol=1e-5)
    else:
        assert _rel(t_ring, j_ring) < _TOL[storage]


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("pos", [0, P - 1])
def test_fused_block_step_matches_neojax(rng, storage, shared, pos):
    cf = 1 if shared else C
    jdt, tdt = _STORE[storage][1], _STORE[storage][2]
    jm, tm = _mat_dtypes(storage)
    ring, scales, rim = _inputs(rng, storage, cf)
    frame = rng.uniform(-1, 1, (C, 2 * B)).astype(np.float32)
    dcfix = rng.standard_normal((2, C)).astype(np.float32)
    cs, ab = jmb.packed_mats_np(2 * B)

    j_rim = jfs.shift8_filter(rim[:, 0]) if shared else rim
    j_args = [jnp.asarray(frame), jnp.asarray(ring).astype(jdt), jnp.asarray(j_rim).astype(jm),
              pos, jnp.asarray(dcfix), jnp.asarray(cs).astype(jm), jnp.asarray(ab).astype(jm)]
    t_ring = torch.tensor(ring).to(tdt)  # a copy: the port writes it in place
    t_scl = None if scales is None else torch.from_numpy(scales.copy())
    if scales is None:
        jy, j_ring = jfs.fused_block_step(*j_args, shared_filter=shared, interpret=True)
        j_scl = None
    else:
        jy, j_ring, j_scl = jfs.fused_block_step(
            *j_args, jnp.asarray(scales)[:, None, :], shared_filter=shared, interpret=True
        )
        j_scl = np.asarray(j_scl)[:, 0, :]
    res = tfs.fused_block_step(
        torch.from_numpy(frame), t_ring, torch.from_numpy(rim).to(tm), pos,
        torch.from_numpy(dcfix), torch.from_numpy(cs).to(tm), torch.from_numpy(ab).to(tm), t_scl,
    )
    assert res[1] is t_ring  # the ring is updated in place
    assert _rel(res[0].numpy(), np.asarray(jy)) < _TOL[storage]
    _check_ring(storage, t_ring, j_ring, None if t_scl is None else t_scl.numpy(), j_scl)


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("shared", [True, False])
def test_fused_stream_matches_neojax(rng, storage, shared):
    """Five blocks from pos0 = P-2: the ring wraps mid-stream."""
    cf = 1 if shared else C
    nb, pos0 = 5, P - 2
    jdt, tdt = _STORE[storage][1], _STORE[storage][2]
    jm, tm = _mat_dtypes(storage)
    ring, scales, rim = _inputs(rng, storage, cf)
    sigpad = rng.uniform(-1, 1, (C, (nb + 1) * B)).astype(np.float32)
    dcfix = rng.standard_normal((nb, 2, C)).astype(np.float32)
    j_cs, j_abt = jmb.packed_stream_mats(2 * B, jnp.float32)
    cs, abt = np.array(j_cs), np.array(j_abt)

    j_rim = jfs.shift8_filter(rim[:, 0]) if shared else rim
    j_args = [jnp.asarray(sigpad), jnp.asarray(ring).astype(jdt), jnp.asarray(j_rim).astype(jm),
              pos0, jnp.asarray(dcfix), jnp.asarray(cs).astype(jm), jnp.asarray(abt).astype(jm)]
    t_ring = torch.tensor(ring).to(tdt)  # a copy: the port writes it in place
    t_scl = None if scales is None else torch.from_numpy(scales.copy())
    if scales is None:
        jo, j_ring = jfs.fused_stream(*j_args, shared_filter=shared, interpret=True)
        j_scl = None
    else:
        cpad = 128
        scl_pad = np.pad(scales, ((0, 0), (0, cpad - C)), constant_values=1.0)
        jo, j_ring, j_scl = jfs.fused_stream(
            *j_args, jnp.asarray(scl_pad), shared_filter=shared, interpret=True
        )
        j_scl = np.asarray(j_scl)[:, :C]
    res = tfs.fused_stream(
        torch.from_numpy(sigpad), t_ring, torch.from_numpy(rim).to(tm), pos0,
        torch.from_numpy(dcfix), torch.from_numpy(cs).to(tm), torch.from_numpy(abt).to(tm), t_scl,
    )
    assert res[1] is t_ring
    assert _rel(res[0].numpy(), np.asarray(jo)) < _TOL[storage]
    _check_ring(storage, t_ring, j_ring, None if t_scl is None else t_scl.numpy(), j_scl)


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_fused_stream_acc_add_matches_neojax(rng, storage):
    """B3 with its accumulator seed (the hybrid head's tail sum) against
    neojax's ``fused_stream(acc_add=...)`` in interpret mode; five blocks
    from pos0 = P-2, so the ring wraps. The seed's lane 0 is overwritten
    by ``dcfix`` after the MAC in both."""
    nb, pos0 = 5, P - 2
    jdt, tdt = _STORE[storage][1], _STORE[storage][2]
    jm, tm = _mat_dtypes(storage)
    ring, scales, rim = _inputs(rng, storage, 1)
    sigpad = rng.uniform(-1, 1, (C, (nb + 1) * B)).astype(np.float32)
    dcfix = rng.standard_normal((nb, 2, C)).astype(np.float32)
    acc_add = (5 * rng.standard_normal((nb, 2, C, B))).astype(np.float32)
    j_cs, j_abt = jmb.packed_stream_mats(2 * B, jnp.float32)
    cs, abt = np.array(j_cs), np.array(j_abt)

    j_args = [jnp.asarray(sigpad), jnp.asarray(ring).astype(jdt),
              jnp.asarray(jfs.shift8_filter(rim[:, 0])).astype(jm), pos0, jnp.asarray(dcfix),
              jnp.asarray(cs).astype(jm), jnp.asarray(abt).astype(jm)]
    t_ring = torch.tensor(ring).to(tdt)
    t_scl = None if scales is None else torch.from_numpy(scales.copy())
    j_scl_in = None if scales is None else jnp.asarray(
        np.pad(scales, ((0, 0), (0, 128 - C)), constant_values=1.0))
    res = jfs.fused_stream(*j_args, j_scl_in, None, jnp.asarray(acc_add), shared_filter=True,
                           interpret=True)
    t_res = tfs.fused_stream(
        torch.from_numpy(sigpad), t_ring, torch.from_numpy(rim).to(tm), pos0,
        torch.from_numpy(dcfix), torch.from_numpy(cs).to(tm), torch.from_numpy(abt).to(tm), t_scl,
        acc_add=torch.from_numpy(acc_add),
    )
    assert _rel(t_res[0].numpy(), np.asarray(res[0])) < _TOL[storage]
    _check_ring(storage, t_ring, res[1], None if t_scl is None else t_scl.numpy(),
                None if scales is None else np.asarray(res[2])[:, :C])
    # the seed moves the output: without it the result differs
    plain = tfs.fused_stream_reference(
        torch.from_numpy(sigpad), torch.tensor(ring).to(tdt), torch.from_numpy(rim).to(tm), pos0,
        torch.from_numpy(dcfix), torch.from_numpy(cs).to(tm), torch.from_numpy(abt).to(tm),
        None if scales is None else torch.from_numpy(scales.copy()),
    )[0]
    assert _rel(plain.numpy(), t_res[0].numpy()) > 10 * _TOL[storage]


def test_fused_stream_rejects_unported_inputs():
    ring = torch.zeros((2, P, C, B))
    rim = torch.zeros((2 * P, 1, 2 * B))
    args = (torch.zeros((C, 2 * B)), ring, rim, 0, torch.zeros((1, 2, C)),
            torch.zeros((2 * B, 2 * B)), torch.zeros((2 * B, B)))
    with pytest.raises(ValueError, match="tiles"):  # ported; a uint8 [P, ceil(B / 8)] tap-tile table
        tfs.fused_stream(*args, tiles=np.zeros((P, -(-B // 8)), np.uint8))
    with pytest.raises(ValueError, match="tiles"):
        tfs.fused_stream(*args, tiles=torch.zeros((P - 1, -(-B // 8)), dtype=torch.uint8))
    with pytest.raises(ValueError, match="acc_add"):  # ported; its shape is checked
        tfs.fused_stream(*args, acc_add=torch.zeros((1, 2, C, B + 1)))
    with pytest.raises(TypeError):
        tfs.fused_stream(*args[:2], rim.to(torch.bfloat16), *args[3:])
