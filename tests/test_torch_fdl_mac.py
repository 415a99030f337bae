"""neojax_torch B1 ``fdl_mac`` (plain route, CPU) vs neojax's Pallas
``fdl_mac_pallas`` in interpret mode, for the four storages and both filter
forms, on the same seeded numpy inputs.

Tolerance: the port sums in float64, the Pallas kernel in float32 in
another order, so accumulators agree to float32 rounding of the sum:
2e-6 of the peak accumulator.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax.kernels.fdl_mac import fdl_mac_pallas
from neojax_torch.kernels import fdl_mac as tmac

_TOL = 2e-6
_DT = {
    "split": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "int16": (jnp.int16, torch.int16),
    "int8": (jnp.int8, torch.int8),
}
_INT_MAX = {"int16": 32767, "int8": 127}


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("cf", [1, 3])
def test_fdl_mac_matches_pallas(rng, storage, cf):
    p, c, k = 8, 3, 40  # K not a multiple of the lane tile, P not of 32
    jdt, tdt = _DT[storage]
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        ring = rng.integers(-m, m + 1, (2, p, c, k))
        scales = rng.uniform(0.5, 4.0, (p, c)).astype(np.float32)
    else:
        ring = rng.standard_normal((2, p, c, k)).astype(np.float32)
        scales = None
    fr = rng.standard_normal((p, cf, k)).astype(np.float32)
    fi = rng.standard_normal((p, cf, k)).astype(np.float32)

    j_args = [jnp.asarray(ring).astype(jdt), jnp.asarray(fr), jnp.asarray(fi)]
    if scales is not None:
        j_args.append(jnp.asarray(scales))
    j_re, j_im = fdl_mac_pallas(*j_args, interpret=True)

    t_scl = None if scales is None else torch.from_numpy(scales)
    t_re, t_im = tmac.fdl_mac(
        torch.from_numpy(np.asarray(ring)).to(tdt), torch.from_numpy(fr), torch.from_numpy(fi), t_scl
    )
    assert t_re.shape == (c, k) and t_re.dtype == torch.float32
    peak = max(np.abs(np.asarray(j_re)).max(), np.abs(np.asarray(j_im)).max())
    assert np.abs(t_re.numpy() - np.asarray(j_re)).max() / peak < _TOL
    assert np.abs(t_im.numpy() - np.asarray(j_im)).max() / peak < _TOL


def test_fdl_mac_validates_inputs():
    ring = torch.zeros((2, 4, 2, 8))
    f = torch.zeros((4, 1, 8))
    with pytest.raises(ValueError, match="scales"):
        tmac.fdl_mac(ring.to(torch.int8), f, f)
    with pytest.raises(ValueError, match="filt_re"):
        tmac.fdl_mac(ring, torch.zeros((4, 3, 8)), torch.zeros((4, 3, 8)))
    with pytest.raises(TypeError):
        tmac.fdl_mac(ring.to(torch.float64), f, f)
    with pytest.raises(ValueError, match="contiguous"):
        tmac.fdl_mac(ring.transpose(2, 3), torch.zeros((4, 1, 2)), torch.zeros((4, 1, 2)))


def test_fdl_mac_cpu_route_does_not_count_launches():
    before = tmac.fdl_mac.launches
    ring = torch.zeros((2, 4, 2, 8))
    f = torch.zeros((4, 1, 8))
    tmac.fdl_mac(ring, f, f)
    assert tmac.fdl_mac.launches == before


# ---- the split-P geometry of the card kernel (csrc/step_mac.cuh)


@pytest.mark.parametrize("p,c,k,itemsize", [
    (960, 64, 512, 4), (960, 64, 512, 1), (960, 64, 513, 4), (64, 64, 513, 4), (131, 2, 513, 4),
    (200, 3, 40, 4), (7, 3, 200, 2), (1, 1, 1, 4), (959, 5, 64, 4),
])
def test_mac_geometry_covers_every_slot_once_in_order(p, c, k, itemsize):
    """The shared geometry: every slot in exactly one split, splits in slot
    order (the last may be shorter). B1/B4: ``per`` >= _MIN_SPLIT slots
    unless the ring is one split, V = 4 lanes where it divides K, else 1,
    whatever the ring's itemsize. B2 (ring of ``itemsize`` bytes): V = 16 /
    itemsize where it divides K, else 1."""

    def covered(s_n, per):
        splits = [list(range(s * per, min(p, (s + 1) * per))) for s in range(s_n)]
        return all(splits) and [q for sl in splits for q in sl] == list(range(p))

    s_n, per, vec = tmac.step_geometry(p, c, k, 4, tmac._MIN_SPLIT, tmac._MAC_CTAS)
    assert covered(s_n, per) and (s_n == 1 or per >= tmac._MIN_SPLIT)
    assert vec == (4 if k % 4 == 0 else 1)
    s_n, per, vec = tmac.step_geometry(p, c, k, itemsize)
    assert covered(s_n, per)
    assert vec == (16 // itemsize if k % (16 // itemsize) == 0 else 1)


def test_mac_geometry_at_the_main_path_shapes():
    """The hybrid head's ring [2, 64, 64, 513] is one split (one launch, no
    partial sums); the headline ring [2, 960, 64, 512] splits into 15 of
    64 slots; B2's own geometry is unchanged (16 splits of 60)."""
    assert tmac.step_geometry(64, 64, 513, 4, tmac._MIN_SPLIT, tmac._MAC_CTAS) == (1, 64, 1)
    assert tmac.step_geometry(960, 64, 512, 4, tmac._MIN_SPLIT, tmac._MAC_CTAS) == (15, 64, 4)
    assert tmac.step_geometry(960, 64, 513, 4, tmac._MIN_SPLIT, tmac._MAC_CTAS) == (15, 64, 1)
    assert tmac.step_geometry(960, 64, 512, 4) == (16, 60, 4)
    assert tmac.step_geometry(960, 64, 512, 1) == (16, 60, 16)


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_mac_geometry_falls_back_to_one_lane(storage):
    """V = 1 where K % 4 != 0 or a pointer is not aligned to V elements; the
    split count stays, so the result's bits do not depend on alignment."""
    dt = _DT[storage][1]
    p, c, k = 4, 2, 32
    ring = torch.zeros((2, p, c, k), dtype=dt)
    fr, fi = torch.zeros((p, 1, k)), torch.zeros((p, 1, k))
    aligned = tmac.mac_geometry(ring, fr, fi)
    assert ring.data_ptr() % 64 == 0 and fr.data_ptr() % 64 == 0 and aligned[2] == 4
    odd = [torch.zeros((p, 1, k + 1)) for _ in range(2)]
    assert tmac.mac_geometry(torch.zeros((2, p, c, k + 1), dtype=dt), *odd)[2] == 1
    shifted_f = torch.zeros(p * k + 1)[1:].view(p, 1, k)  # one element past an aligned start
    shifted_r = torch.zeros(2 * p * c * k + 1, dtype=dt)[1:].view(2, p, c, k)
    for args in ((ring, shifted_f, fi), (ring, fr, shifted_f), (shifted_r, fr, fi)):
        got = tmac.mac_geometry(*args)
        assert got[2] == 1 and got[:2] == aligned[:2]
    # B4: a thread's lanes must lie in one k-tile
    assert tmac.mac_geometry(ring, fr, fi, k_tile=32)[2] == 4
    assert tmac.mac_geometry(ring, fr, fi, k_tile=30) == aligned[:2] + (1,)


@pytest.mark.parametrize("storage", ["split", "int16"])
@pytest.mark.parametrize("cf", [1, 2])
def test_fdl_mac_matches_pallas_at_k513_and_a_ragged_split(rng, storage, cf):
    """K = B + 1 = 513 (the non-packed rings and the hybrid head) at P = 131,
    which the card kernel cuts into two splits of 66 and 65 slots."""
    p, c, k = 131, 2, 513
    s_n, per, _ = tmac.step_geometry(p, c, k, 4, tmac._MIN_SPLIT, tmac._MAC_CTAS)
    assert s_n == 2 and p % s_n != 0 and per == 66
    jdt, tdt = _DT[storage]
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        ring = rng.integers(-m, m + 1, (2, p, c, k))
        scales = rng.uniform(0.5, 4.0, (p, c)).astype(np.float32)
    else:
        ring = rng.standard_normal((2, p, c, k)).astype(np.float32)
        scales = None
    fr = rng.standard_normal((p, cf, k)).astype(np.float32)
    fi = rng.standard_normal((p, cf, k)).astype(np.float32)
    j_args = [jnp.asarray(ring).astype(jdt), jnp.asarray(fr), jnp.asarray(fi)]
    if scales is not None:
        j_args.append(jnp.asarray(scales))
    j_re, j_im = fdl_mac_pallas(*j_args, interpret=True)
    t_re, t_im = tmac.fdl_mac(torch.from_numpy(np.asarray(ring)).to(tdt), torch.from_numpy(fr),
                              torch.from_numpy(fi), None if scales is None else torch.from_numpy(scales))
    peak = max(np.abs(np.asarray(j_re)).max(), np.abs(np.asarray(j_im)).max())
    assert np.abs(t_re.numpy() - np.asarray(j_re)).max() / peak < _TOL
    assert np.abs(t_im.numpy() - np.asarray(j_im)).max() / peak < _TOL
