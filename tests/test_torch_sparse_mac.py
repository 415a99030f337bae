"""neojax_torch.kernels.sparse_mac against neojax.kernels.sparse_mac: the
host-side schedule builders bit for bit, the tile geometry
(``choose_chunks``, ``fused_chunk_rows``) over a grid of shapes, and B4's
plain version against ``sparse_fdl_mac_pallas`` in interpret mode (as
``tests/test_pallas_kernels.py:96-138`` runs it).

Tolerance of the MAC: max|port - neojax| <= 1e-4 absolute for f32 products
of unit noise over 16 partitions (``tests/test_pallas_kernels.py``'s
bound); bf16 rings are exact in both (the products are f32), so the same
bound holds.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax.conv.sparse import perceptual_mask
from neojax.kernels import fdl_mac as jfm
from neojax.kernels import fused_step as jfs
from neojax.kernels import sparse_mac as jsm
from neojax_torch.kernels import fdl_mac as tfm
from neojax_torch.kernels import fused_step as tfs
from neojax_torch.kernels import sparse_mac as tsm

_DT = {"split": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
       "int16": (jnp.int16, torch.int16), "int8": (jnp.int8, torch.int8)}


def _band_mask(rng, p, k):
    """Partition j keeps bins below a decaying cutoff, plus a sprinkle
    (``tests/test_pallas_kernels.py:_band_mask``)."""
    cut = (k * np.exp(-3.0 * np.arange(p) / p)).astype(int)
    mask = np.arange(k)[None, :] < cut[:, None]
    mask |= rng.random((p, k)) < 0.02
    return mask


def _masks(rng, kind, p, k):
    if kind == "band":
        return _band_mask(rng, p, k)
    if kind == "partitions":  # bench.py's band30: whole leading partitions
        mask = np.zeros((p, k), bool)
        mask[: max(1, int(0.3 * p))] = True
        return mask
    if kind == "perceptual":  # the plugin's A-weighted threshold on a decaying spectrum
        decay = np.exp(-4.0 * np.arange(p) / p)[:, None]
        spec = (rng.standard_normal((p, k)) + 1j * rng.standard_normal((p, k))) * decay
        return perceptual_mask(spec, 48000, -30.0)
    if kind == "lanes":  # low bins everywhere, cutoff falling with p
        mask = np.zeros((p, k), bool)
        for i in range(p):
            mask[i, : max(8, int(k * (1.0 - i / p)))] = True
        return mask
    return rng.random((p, k)) < 0.1


def _same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("b", [64, 128, 256, 384, 512, 640, 1024, 2048])
def test_lane_widths_match_neojax(b):
    assert tsm.lane_widths(b) == jsm.lane_widths(b)
    assert all(w == b >> code for code, w in enumerate(tsm.lane_widths(b)))


@pytest.mark.parametrize("kind", ["band", "partitions", "perceptual", "lanes", "random"])
@pytest.mark.parametrize("cf", [None, 3])
@pytest.mark.parametrize("p,pc,lanes", [(24, 8, None), (32, 8, 256), (32, 4, 256), (16, 16, 512)])
def test_build_chunk_schedule_matches_neojax(rng, kind, cf, p, pc, lanes):
    k = (lanes or 64) + 1
    mask = _masks(rng, kind, p, k)
    if cf is not None:  # [P, C', K]: channels differ, the OR is taken
        mask = np.stack([mask] + [rng.random((p, k)) < 0.01 for _ in range(cf - 1)], axis=1)
    _same(tsm.build_chunk_schedule(mask, pc, lanes=lanes), jsm.build_chunk_schedule(mask, pc, lanes=lanes))


@pytest.mark.parametrize("kind", ["band", "partitions", "perceptual", "lanes", "random"])
@pytest.mark.parametrize("cf", [None, 3])
@pytest.mark.parametrize("p,k,pc,kt", [(24, 260, 4, 128), (16, 130, 4, 128), (32, 512, 32, 256),
                                       (32, 513, 8, 256)])
def test_build_sparse_schedule_matches_neojax(rng, kind, cf, p, k, pc, kt):
    mask = _masks(rng, kind, p, k)
    if cf is not None:
        mask = np.stack([mask] + [rng.random((p, k)) < 0.01 for _ in range(cf - 1)], axis=1)
    _same(tsm.build_sparse_schedule(mask, pc, kt), jsm.build_sparse_schedule(mask, pc, kt))


def test_schedule_builders_reject_what_neojax_rejects():
    mask = np.zeros((8, 65), bool)
    for build in (tsm.build_chunk_schedule, jsm.build_chunk_schedule):
        with pytest.raises(ValueError, match="empty"):
            build(mask, 4)
        with pytest.raises(ValueError, match="multiple"):
            build(mask, 3)
    for build in (tsm.build_sparse_schedule, jsm.build_sparse_schedule):
        with pytest.raises(ValueError, match="empty"):
            build(mask, 4, 64)


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_choose_chunks_matches_neojax(storage):
    jdt, tdt = _DT[storage]
    for p in (1, 7, 24, 37, 64, 96, 960):
        for c in (1, 2, 4, 64, 128):
            for k in (65, 130, 256, 512, 513, 1024):
                assert tfm.choose_chunks(tdt, p, c, k) == jfm.choose_chunks(jdt, p, c, k), (p, c, k)


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_fused_chunk_rows_matches_neojax(storage):
    jdt, tdt = _DT[storage]
    for p in (1, 5, 8, 24, 37, 64, 96, 960):
        for c in (1, 2, 4, 64, 128):
            for b in (32, 64, 256, 512, 1024):
                assert tfs.fused_chunk_rows(tdt, p, c, b) == jfs.fused_chunk_rows(jdt, p, c, b), (p, c, b)


def test_fused_chunk_rows_follows_a_shrunk_target():
    """Tests shrink ``_CHUNK_TARGET`` in both packages at once; the port
    reads its own module constant at call time, as neojax does."""
    saved = (tfs._CHUNK_TARGET, jfs._CHUNK_TARGET)
    try:
        tfs._CHUNK_TARGET = jfs._CHUNK_TARGET = 2 * 4 * 64 * 4 * 8
        got = tfs.fused_chunk_rows(torch.float32, 32, 4, 64)
        assert got == jfs.fused_chunk_rows(jnp.float32, 32, 4, 64) == 8
    finally:
        tfs._CHUNK_TARGET, jfs._CHUNK_TARGET = saved


def _ring(rng, storage, p, c, k):
    if storage in ("int8", "int16"):
        m = 127 if storage == "int8" else 32767
        planes = rng.integers(-m, m + 1, (2, p, c, k)).astype(np.int8 if storage == "int8" else np.int16)
        scales = (rng.uniform(0.5, 4.0, (p, c)) / (m / 127)).astype(np.float32)
        return planes, scales
    planes = rng.uniform(-1, 1, (2, p, c, k)).astype(np.float32)
    if storage == "bf16":  # bf16-representable values, equal in both packages
        planes = np.array(jnp.asarray(planes).astype(jnp.bfloat16).astype(jnp.float32))
    return planes, None


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("k", [130, 512])
@pytest.mark.parametrize("cf", [1, 2])
def test_sparse_mac_plain_matches_pallas_interpret(rng, storage, k, cf):
    """P = 16, C = 2, pc = 4, kt = 128 at positions 0, 3, P-1; lanes of
    never-visited tiles masked by ``lane_mask`` in both."""
    p, c, pc, kt = 16, 2, 4, 128
    jdt, tdt = _DT[storage]
    mask = _band_mask(rng, p, k)
    filt_re = rng.uniform(-1, 1, (p, cf, k)).astype(np.float32) * mask[:, None, :]
    filt_im = rng.uniform(-1, 1, (p, cf, k)).astype(np.float32) * mask[:, None, :]
    sched = jsm.build_sparse_schedule(mask, pc, kt)
    tables = [torch.from_numpy(sched[key]) for key in ("k_idx", "p_idx", "flags")]
    planes, scales = _ring(rng, storage, p, c, k)
    t_planes = torch.from_numpy(planes).to(tdt)
    t_scl = None if scales is None else torch.from_numpy(scales)
    tiled_re = np.concatenate([filt_re[::-1]] * 2, 0)
    tiled_im = np.concatenate([filt_im[::-1]] * 2, 0)
    for pos in (0, 3, p - 1):
        rot_re = np.ascontiguousarray(tiled_re[p - 1 - pos : 2 * p - 1 - pos])
        rot_im = np.ascontiguousarray(tiled_im[p - 1 - pos : 2 * p - 1 - pos])
        j_re, j_im = jsm.sparse_fdl_mac_pallas(
            jnp.asarray(planes).astype(jdt), jnp.asarray(rot_re), jnp.asarray(rot_im), jnp.asarray(pos),
            *(jnp.asarray(sched[key]) for key in ("k_idx", "p_idx", "flags")),
            None if scales is None else jnp.asarray(scales), p_chunk=pc, k_tile=kt, interpret=True,
        )
        t_re, t_im = tsm.sparse_fdl_mac(t_planes, torch.from_numpy(rot_re), torch.from_numpy(rot_im), pos,
                                        *tables, t_scl, p_chunk=pc, k_tile=kt)
        lane = sched["lane_mask"]
        np.testing.assert_allclose(np.where(lane, t_re.numpy(), 0), np.where(lane, np.asarray(j_re), 0),
                                   atol=1e-4)
        np.testing.assert_allclose(np.where(lane, t_im.numpy(), 0), np.where(lane, np.asarray(j_im), 0),
                                   atol=1e-4)
        # lanes of tiles that this row never visits are written 0
        vis = np.zeros(-(-k // kt), bool)
        vis[sched["k_idx"][pos][sched["flags"][pos] == 1]] = True
        dead = ~np.repeat(vis, kt)[:k]
        assert not t_re.numpy()[:, dead].any() and not t_im.numpy()[:, dead].any()


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_sparse_mac_plain_equals_dense_mac_on_masked_filter(rng, storage):
    """Every skipped product is an exact zero: B4 equals B1 on the masked
    filter (float64 sums of the same products, 1e-6 relative)."""
    p, c, k, pc, kt = 24, 3, 260, 4, 128
    mask = _masks(rng, "lanes", p, k)
    sched = tsm.build_sparse_schedule(mask, pc, kt)
    planes, scales = _ring(rng, storage, p, c, k)
    t_planes = torch.from_numpy(planes)
    t_scl = None if scales is None else torch.from_numpy(scales)
    fr = torch.from_numpy(rng.uniform(-1, 1, (p, 1, k)).astype(np.float32) * mask[:, None, :])
    fi = torch.from_numpy(rng.uniform(-1, 1, (p, 1, k)).astype(np.float32) * mask[:, None, :])
    tables = [torch.from_numpy(sched[key]) for key in ("k_idx", "p_idx", "flags")]
    rfr = torch.cat([fr.flip(0)] * 2)
    rfi = torch.cat([fi.flip(0)] * 2)
    for pos in (0, 11, p - 1):
        rr, ri = rfr[p - 1 - pos : 2 * p - 1 - pos], rfi[p - 1 - pos : 2 * p - 1 - pos]
        got = torch.cat(tsm.sparse_fdl_mac(t_planes, rr, ri, pos, *tables, t_scl, p_chunk=pc, k_tile=kt))
        want = torch.cat(tfm.fdl_mac(t_planes, rr, ri, t_scl))
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_sparse_mac_rejects_bad_tables(rng):
    p, c, k = 8, 2, 64
    ring = torch.zeros((2, p, c, k))
    f = torch.zeros((p, 1, k))
    good = [torch.zeros((p, 3), dtype=torch.int32) for _ in range(3)]
    with pytest.raises(ValueError, match="int32"):
        tsm.sparse_fdl_mac(ring, f, f, 0, good[0].long(), good[1], good[2], p_chunk=4, k_tile=64)
    with pytest.raises(ValueError, match="like k_idx"):
        tsm.sparse_fdl_mac(ring, f, f, 0, good[0], good[1][:, :2].contiguous(), good[2], p_chunk=4, k_tile=64)
    with pytest.raises(ValueError, match="pos"):
        tsm.sparse_fdl_mac(ring, f, f, p, *good, p_chunk=4, k_tile=64)
    with pytest.raises(ValueError, match="p_chunk"):
        tsm.sparse_fdl_mac(ring, f, f, 0, *good, p_chunk=3, k_tile=64)
    with pytest.raises(ValueError, match="scales"):
        tsm.sparse_fdl_mac(ring.to(torch.int8), f, f, 0, *good, p_chunk=4, k_tile=64)
    before = tsm.sparse_fdl_mac.launches
    tsm.sparse_fdl_mac(ring, f, f, 0, *good, p_chunk=4, k_tile=64)
    assert tsm.sparse_fdl_mac.launches == before  # the CPU route counts nothing


# ---- the tile-live table the B4 kernel reads


def _live_of_row(k_idx, p_idx, flags, npc, nk):
    """Row ``pos`` of the table, from its schedule row entry by entry."""
    live = np.zeros((npc, nk), np.uint8)
    for kk, cc, fl in zip(k_idx, p_idx, flags):
        if fl == 1:
            live[cc, kk] = 1
    return live


@pytest.mark.parametrize("kind", ["partitions", "lanes"])
@pytest.mark.parametrize("k", [512, 513])
def test_tile_live_table_matches_the_schedule_rows(rng, kind, k):
    """Every row of the table against its schedule row, and against the
    rotated mask itself: (p-chunk j, k-tile t) is live at ``pos`` iff some
    slot of chunk j meets a filter partition with a kept bin in tile t."""
    p, pc, kt = 32, 8, 256
    mask = _masks(rng, kind, p, k)
    sched = tsm.build_sparse_schedule(mask, pc, kt)
    npc, nk = p // pc, -(-k // kt)
    tables = [torch.from_numpy(sched[key]) for key in ("k_idx", "p_idx", "flags")]
    live = tsm.tile_live_table(*tables, npc, nk)
    assert live.dtype == torch.uint8 and tuple(live.shape) == (p, npc, nk)
    padk = np.zeros((p, nk * kt), bool)
    padk[:, :k] = mask
    tiles = padk.reshape(p, nk, kt).any(axis=2)  # [P, NK]
    for pos in range(p):
        want = _live_of_row(sched["k_idx"][pos], sched["p_idx"][pos], sched["flags"][pos], npc, nk)
        np.testing.assert_array_equal(live[pos].numpy(), want, err_msg=f"pos {pos}")
        rot = tiles[[(pos - i) % p for i in range(p)]]  # slot i meets partition (pos - i) mod P
        np.testing.assert_array_equal(want, rot.reshape(npc, pc, nk).any(axis=1).astype(np.uint8))
    # one row alone, as the card derives it when no table is given
    row = tsm.tile_live_table(*(t[5:6] for t in tables), npc, nk)
    assert torch.equal(row[0], live[5])


def test_tile_live_table_rejects_entries_outside_the_geometry():
    k_idx = torch.tensor([[0, 2]], dtype=torch.int32)
    ok = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        tsm.tile_live_table(k_idx, ok, torch.ones((1, 2), dtype=torch.int32), 1, 2)
    with pytest.raises(ValueError, match="live"):
        ring = torch.zeros((2, 8, 2, 64))
        f = torch.zeros((8, 1, 64))
        good = [torch.zeros((8, 3), dtype=torch.int32) for _ in range(3)]
        tsm.sparse_fdl_mac(ring, f, f, 0, *good, p_chunk=4, k_tile=64, live=torch.zeros((8, 2, 2), dtype=torch.uint8))


@pytest.mark.parametrize("storage", ["split", "int8"])
@pytest.mark.parametrize("packed", [True, False])
def test_tile_live_from_converted_params_and_a_rebound_mono_filter(rng, storage, packed):
    """The table derives from the three [P, L] tables alone: params
    converted from neojax (which has no such key) get the table the port's
    own ``filter_params`` builds, and so does a mono filter bound to more
    channels (the tables are rebuilt at the new channel count)."""
    from neojax.conv import convolver as jcv
    from neojax_torch import conv as tconv
    from neojax_torch import convert
    from neojax_torch.conv import convolver as tcv
    import jax

    b, p, c = 64, 32, 4
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    mask = _masks(rng, "lanes", p, b + 1)
    cfg_kw = dict(block_size=b, num_partitions=p, channels=c, storage=storage, packed=packed)
    jparams = jcv.filter_params(jcv.PartitionedConfig(**cfg_kw), parts, sparsity=mask)
    assert "tile_live" not in jparams
    tcfg = tcv.PartitionedConfig(**cfg_kw)
    own = tcv.filter_params(tcfg, parts, sparsity=mask, device="cpu")
    conv_p = convert.params_from_neojax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert own["tile_live"].dtype == torch.uint8 and torch.equal(conv_p["tile_live"], own["tile_live"])
    k = b if packed else b + 1
    kt, pc = tfm.choose_chunks(tcv.fdl_lib.STORAGE_DTYPES[storage], p, c, k)
    assert tuple(own["tile_live"].shape) == (p, p // pc, -(-k // kt))

    mono = tconv.sparse_upols_convolver(sparsity=mask, storage=storage, device="cpu")
    mono.filter(parts)
    assert mono.config.channels == 1
    mono.process(rng.uniform(-1, 1, (c, 2 * b)).astype(np.float32))
    assert mono.config.channels == c
    want = tcv.filter_params(tcv.PartitionedConfig(b, p, c, storage=storage), parts, sparsity=mask, device="cpu")
    assert torch.equal(mono.params["tile_live"], want["tile_live"])
