"""neojax_torch.conv.fdl vs neojax.conv.fdl on the same seeded inputs:
ring and shift pushes (every storage), the tiled/rotated filter, the packed
DC/Nyquist side-carry and both MAC-reduces.

Float planes match to float32 rounding (1e-6 of the peak; bf16 planes to
one bf16 ulp); int planes to +-1 LSB (a spectrum value on a rounding
boundary may round either way after an ulp of difference upstream).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax.conv import fdl as jfdl
from neojax_torch.conv import fdl as tfdl

P, C, K = 5, 3, 17
_STORAGES = ["split", "bf16", "int16", "int8"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_planes(storage, t, j):
    t, j = _f32(t), _f32(j)
    if storage in ("int16", "int8"):
        assert np.abs(t - j).max() <= 1
    elif storage == "bf16":
        assert np.abs(t - j).max() <= 2 ** -7 * max(1.0, np.abs(j).max())
    else:
        assert np.abs(t - j).max() <= 1e-6 * max(1.0, np.abs(j).max())


def _seeded_fdl(rng, storage, bins=K):
    """A non-trivial starting delay line in both packages."""
    t = tfdl.fdl_init(storage, P, C, bins)
    base = rng.standard_normal((2, P, C, bins)).astype(np.float32)
    if isinstance(t, tuple):
        m = 127 if storage == "int8" else 32767
        q = rng.integers(-m, m + 1, (2, P, C, bins))
        s = rng.uniform(0.5, 2.0, (P, C, 1)).astype(np.float32)
        t[0].copy_(torch.from_numpy(q))
        t[1].copy_(torch.from_numpy(s))
        j = (jnp.asarray(q).astype(jfdl.STORAGE_DTYPES[storage]), jnp.asarray(s))
    else:
        t.copy_(torch.from_numpy(base))
        j = jnp.asarray(base).astype(jfdl.STORAGE_DTYPES[storage])
    return t, j


def _spec(rng):
    return (10 * rng.standard_normal((2, C, K))).astype(np.float32)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("layout", ["ring", "shift"])
def test_push_split_matches_neojax(rng, storage, layout):
    t, j = _seeded_fdl(rng, storage)
    for w in (0, 3, 4):  # several pushes, ring positions incl. the last slot
        sr, si = _spec(rng)
        if layout == "ring":
            t_new = tfdl.fdl_ring_push_split(t, torch.from_numpy(sr), torch.from_numpy(si), w)
            j = jfdl.fdl_ring_push_split(j, jnp.asarray(sr), jnp.asarray(si), jnp.int32(w))
        else:
            t_new = tfdl.fdl_push_split(t, torch.from_numpy(sr), torch.from_numpy(si))
            j = jfdl.fdl_push_split(j, jnp.asarray(sr), jnp.asarray(si))
        # in place: the same tensors come back
        if isinstance(t, tuple):
            assert t_new[0] is t[0] and t_new[1] is t[1]
        else:
            assert t_new is t
    if isinstance(t, tuple):
        _close_planes(storage, t[0], j[0])
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-6)
    else:
        _close_planes(storage, t, j)


@pytest.mark.parametrize("layout", ["ring", "shift"])
def test_push_dense_matches_neojax(rng, layout):
    t = tfdl.fdl_init("dense", P, C, K)
    j = jfdl.fdl_init("dense", P, C, K)
    for w in (2, 4, 0):
        sr, si = _spec(rng)
        spec = (sr + 1j * si).astype(np.complex64)
        if layout == "ring":
            tfdl.fdl_ring_push_dense(t, torch.from_numpy(spec), w)
            j = jfdl.fdl_ring_push_dense(j, jnp.asarray(spec), jnp.int32(w))
        else:
            tfdl.fdl_push_dense(t, torch.from_numpy(spec))
            j = jfdl.fdl_push_dense(j, jnp.asarray(spec))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_tile_reverse_and_rotation(rng):
    f = rng.standard_normal((P, 2, K)).astype(np.float32)
    t_tiled = tfdl.tile_reverse_filter(torch.from_numpy(f))
    j_tiled = jfdl.tile_reverse_filter(jnp.asarray(f))
    np.testing.assert_array_equal(t_tiled.numpy(), np.asarray(j_tiled))
    for w in range(P):
        t_rot = tfdl.rotated_filter(t_tiled, w, P)
        j_rot = jfdl.rotated_filter(j_tiled, jnp.int32(w), P)
        np.testing.assert_array_equal(t_rot.numpy(), np.asarray(j_rot))
        assert t_rot.is_contiguous()
        for i in range(P):  # result[i] = filt[(w - i) mod P]
            np.testing.assert_array_equal(t_rot[i].numpy(), f[(w - i) % P])


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_packed_push_and_dcny_mac(rng, storage):
    t_fdl, t_dcny = tfdl.fdl_packed_init(storage, P, C, 16)
    j_fdl, j_dcny = jfdl.fdl_packed_init(storage, P, C, 16)
    for w in (1, 2):
        sr, si = (10 * rng.standard_normal((2, C, 16))).astype(np.float32)
        t_fdl, t_dcny = tfdl.fdl_packed_push(t_fdl, t_dcny, torch.from_numpy(sr), torch.from_numpy(si), w)
        j_fdl, j_dcny = jfdl.fdl_packed_push(j_fdl, j_dcny, jnp.asarray(sr), jnp.asarray(si), jnp.int32(w))
    np.testing.assert_array_equal(t_dcny.numpy(), np.asarray(j_dcny))
    t_planes = t_fdl[0] if isinstance(t_fdl, tuple) else t_fdl
    j_planes = j_fdl[0] if isinstance(j_fdl, tuple) else j_fdl
    _close_planes(storage, t_planes, j_planes)

    fd = rng.standard_normal((P, 1, 2)).astype(np.float32)
    t_acc = tfdl.dcny_mac(t_dcny, torch.from_numpy(fd))
    j_acc = jfdl.dcny_mac(j_dcny, jnp.asarray(fd))
    assert t_acc.shape == (C, 2) and t_acc.dtype == torch.float32
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, C])
def test_fdl_mac_split_matches_neojax(rng, storage, cf):
    t, j = _seeded_fdl(rng, storage)
    fr = rng.standard_normal((P, cf, K)).astype(np.float32)
    fi = rng.standard_normal((P, cf, K)).astype(np.float32)
    t_re, t_im = tfdl.fdl_mac_split(t, torch.from_numpy(fr), torch.from_numpy(fi))
    j_re, j_im = jfdl.fdl_mac_split(j, jnp.asarray(fr), jnp.asarray(fi))
    peak = max(np.abs(np.asarray(j_re)).max(), np.abs(np.asarray(j_im)).max())
    assert np.abs(t_re.numpy() - np.asarray(j_re)).max() <= 1e-6 * peak
    assert np.abs(t_im.numpy() - np.asarray(j_im)).max() <= 1e-6 * peak


def test_fdl_mac_dense_matches_neojax(rng):
    x = (rng.standard_normal((P, C, K)) + 1j * rng.standard_normal((P, C, K))).astype(np.complex64)
    f = (rng.standard_normal((P, 1, K)) + 1j * rng.standard_normal((P, 1, K))).astype(np.complex64)
    t_acc = tfdl.fdl_mac_dense(torch.from_numpy(x), torch.from_numpy(f))
    j_acc = jfdl.fdl_mac_dense(jnp.asarray(x), jnp.asarray(f))
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), rtol=1e-5, atol=1e-5)
