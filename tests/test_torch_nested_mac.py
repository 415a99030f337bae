"""neojax_torch's nested meta-FDL MAC, B5 (plain route, CPU), against
neojax's Pallas ``nested_mac_pallas`` in interpret mode.

The same seeded numpy planes, group scales and rotated shared filter go to
both packages, for the four storages and group counts G in {1, 4, 2S}.
Tolerance ``_TOL``: max|port - neojax| / max|neojax|. Both dequantize as
``x * (scale * inv_max)`` in f32; the Pallas kernel accumulates the P2
products in f32, the plain version in float64, so they differ by f32
rounding of a P2-term sum.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax.kernels import nested_mac as jnm
from neojax_torch.kernels import nested_mac as tnm

_TOL = 1e-5
_INT_MAX = {"int16": 32767, "int8": 127}
_DT = {
    "split": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "int16": (jnp.int16, torch.int16),
    "int8": (jnp.int8, torch.int8),
}
P2, C, K, S = 3, 2, 17, 4  # L = 2S = 8 meta-bins; K not a multiple of the k tile


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-12, np.abs(b).max())


def _case(rng, storage, g):
    l = 2 * S
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        planes = rng.integers(-m, m + 1, (2, P2, C, K, l)).astype(np.int32)
        scales = rng.uniform(0.5, 4.0, (P2, C, K, g)).astype(np.float32)
    else:
        planes = rng.standard_normal((2, P2, C, K, l)).astype(np.float32)
        scales = None
    fr = rng.standard_normal((P2, K, l)).astype(np.float32)
    fi = rng.standard_normal((P2, K, l)).astype(np.float32)
    return planes, scales, fr, fi


@pytest.mark.parametrize("storage,g", [
    ("split", None), ("bf16", None),
    ("int16", 1), ("int16", 4), ("int16", 2 * S),
    ("int8", 1), ("int8", 4), ("int8", 2 * S),
])
def test_nested_mac_matches_pallas_interpret(rng, storage, g):
    jdt, tdt = _DT[storage]
    planes, scales, fr, fi = _case(rng, storage, g)
    j_re, j_im = jnm.nested_mac_pallas(
        jnp.asarray(planes).astype(jdt), None if scales is None else jnp.asarray(scales),
        jnp.asarray(fr), jnp.asarray(fi), interpret=True,
    )
    t_planes = torch.from_numpy(planes).to(tdt)
    t_re, t_im = tnm.nested_mac(
        t_planes, None if scales is None else torch.from_numpy(scales),
        torch.from_numpy(fr), torch.from_numpy(fi),
    )
    assert t_re.shape == (C, K, 2 * S) and t_re.dtype == torch.float32
    want = np.concatenate([np.asarray(j_re), np.asarray(j_im)])
    assert _rel(torch.cat([t_re, t_im]).numpy(), want) < _TOL


def test_nested_mac_rejects_bad_operands(rng):
    planes, scales, fr, fi = _case(rng, "int8", 4)
    t_planes = torch.from_numpy(planes).to(torch.int8)
    t_scl = torch.from_numpy(scales)
    t_fr, t_fi = torch.from_numpy(fr), torch.from_numpy(fi)
    with pytest.raises(ValueError, match="scales"):
        tnm.nested_mac(t_planes, None, t_fr, t_fi)
    with pytest.raises(ValueError, match="G dividing"):
        tnm.nested_mac(t_planes, t_scl[..., :3].contiguous(), t_fr, t_fi)
    with pytest.raises(TypeError):
        tnm.nested_mac(t_planes, t_scl, t_fr.double(), t_fi)
    with pytest.raises(ValueError, match="contiguous"):
        tnm.nested_mac(t_planes, t_scl, t_fr.transpose(1, 2).contiguous().transpose(1, 2), t_fi)
    before = tnm.nested_mac.launches
    tnm.nested_mac(t_planes, t_scl, t_fr, t_fi)
    assert tnm.nested_mac.launches == before  # the CPU route launches nothing
