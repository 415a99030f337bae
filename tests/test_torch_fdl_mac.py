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
