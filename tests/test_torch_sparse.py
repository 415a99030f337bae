"""The sparse per-block convolver of neojax_torch (CPU, the kernels' plain
route) held against neojax and the C++ golden.

- the perceptual (A-weighted) masks equal neojax's;
- ``filter_params(..., sparsity=)`` builds neojax's ``sp_*`` tables bit for
  bit, for packed and non-packed rings, shared and per-channel filters and
  all four split-plane storages;
- ``process`` with a mask (B3 with the chunk schedule) against neojax's
  ``fused=True`` with Pallas in interpret mode, both packages'
  ``_CHUNK_TARGET`` shrunk alike so that P = 32 splits into 4 chunks and
  rows really skip some; a lane-structured mask at B = 256;
- ``step`` with a mask (B2 with the schedule; B4 with ``fused=False`` and
  ``packed=False``) against neojax's unfused XLA path;
- a Convolver that binds a mono masked filter to more channels rebuilds
  the schedule at the channel count it runs;
- ``ref_sparse_upols_b128`` through the split storage's scheduled route.

Tolerance ``_TOL`` is relative to the output peak, the storage ladder of
``tests/test_fused_step.py``; 1e-5 absolute against the golden.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from neojax.conv import convolver as jcv
from neojax.conv import sparse as jsp
from neojax.kernels import fused_step as jfs
from neojax_torch import conv as tconv
from neojax_torch import convert
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import sparse as tsp
from neojax_torch.kernels import fused_step as tfs

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
_TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_STORAGES = ["split", "bf16", "int16", "int8"]
_SP_KEYS = {"sp_k_idx", "sp_p_idx", "sp_flags", "sp_lane"}


@pytest.fixture
def small_chunks():
    """neojax's fused kernels in interpret mode, and both packages' chunk
    target shrunk alike: every chunk is 8 partition rows."""
    saved = (jfs._CHUNK_TARGET, tfs._CHUNK_TARGET)
    jfs._INTERPRET = True
    jfs._CHUNK_TARGET = tfs._CHUNK_TARGET = 1
    yield
    jfs._INTERPRET = False
    jfs._CHUNK_TARGET, tfs._CHUNK_TARGET = saved
    jax.clear_caches()


def _parts(rng, p, b, cf=1):
    return ((rng.standard_normal((cf, p, b + 1)) + 1j * rng.standard_normal((cf, p, b + 1))) * 0.1
            ).astype(np.complex64)


def _band_mask(p, k, keep=0.3):
    """bench.py's ``sparse30`` row: the first 30 % of the partitions."""
    mask = np.zeros((p, k), bool)
    mask[: int(p * keep)] = True
    return mask


def _lane_mask(p, k):
    """Low bins kept in every partition, the cutoff falling with the
    partition (the perceptual pattern, ``DenseConvolution.cpp:245-250``)."""
    mask = np.zeros((p, k), bool)
    for i in range(p):
        mask[i, : max(8, int(k * (1.0 - i / p)))] = True
    return mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-6, np.abs(b).max())


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("shape", [(12, 65), (3, 12, 65)])
@pytest.mark.parametrize("threshold_db", [-80.0, -30.0, 0.0])
def test_perceptual_mask_matches_neojax(rng, shape, threshold_db):
    decay = np.exp(-np.arange(shape[-2]) / 3.0)[:, None]
    parts = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * decay).astype(np.complex64)
    got = tsp.perceptual_mask(parts, 48000, threshold_db)
    want = jsp.perceptual_mask(parts, 48000, threshold_db)
    assert got.dtype == bool and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert tconv.perceptual_mask is tsp.perceptual_mask


@pytest.mark.parametrize("num_bins,low", [(513, 8), (65, 4), (129, 0)])
def test_perceptual_weights_match_neojax(num_bins, low):
    got = tsp.perceptual_weights(num_bins, 44100, low)
    want = jsp.perceptual_weights(num_bins, 44100, low)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    gain = np.array([0.0, 1e-9, 0.5, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(tsp._np_amplitude_to_db(gain), jsp._np_amplitude_to_db(gain))


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("cf", [1, 4])
def test_filter_params_sp_tables_match_neojax(rng, storage, packed, cf):
    b, p, c = 64, 32, 4
    parts = _parts(rng, p, b, cf)
    mask = _lane_mask(p, b + 1) & (rng.random((cf, p, b + 1)) < 0.9)
    jp = jcv.filter_params(jcv.PartitionedConfig(b, p, c, storage=storage, packed=packed), parts, sparsity=mask)
    tp = tcv.filter_params(tcv.PartitionedConfig(b, p, c, storage=storage, packed=packed), parts, sparsity=mask, device="cpu")
    want_keys = _SP_KEYS | ({"sp_c_idx", "sp_c_flags"} if packed else set())
    assert {key for key in tp if key.startswith("sp_")} == want_keys
    assert {key for key in jp if key.startswith("sp_")} == want_keys
    for key in sorted(want_keys | {"mask"}):
        assert tp[key].dtype == (torch.bool if key in ("sp_lane", "mask") else torch.int32), key
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]), err_msg=key)


def test_dense_storage_and_shift_layout_get_no_schedule(rng):
    parts = _parts(rng, 8, 32)
    mask = _band_mask(8, 33)
    for cfg in (tcv.PartitionedConfig(32, 8, 2), tcv.PartitionedConfig(32, 8, 2, storage="split", layout="shift")):
        params = tcv.filter_params(cfg, parts, sparsity=mask, device="cpu")
        assert "mask" in params and not any(key.startswith("sp_") for key in params)


def _process_both(cfg_kw, parts, mask, sig):
    jcfg = jcv.PartitionedConfig(**cfg_kw)
    tcfg = tcv.PartitionedConfig(**cfg_kw)
    _, jout = jcv.process(jcfg, jcv.filter_params(jcfg, parts, sparsity=mask), jcv.init_state(jcfg),
                          jnp.asarray(sig))
    tparams = tcv.filter_params(tcfg, parts, sparsity=mask, device="cpu")
    _, tout = tcv.process(tcfg, tparams, tcv.init_state(tcfg, device="cpu"), torch.from_numpy(sig))
    return tout.numpy(), np.asarray(jout), tparams


@pytest.mark.parametrize("storage", ["split", "bf16", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
def test_process_masked_matches_neojax_fused(small_chunks, rng, monkeypatch, storage, scheme):
    b, p, c = 64, 32, 4
    parts = _parts(rng, p, b)
    mask = _band_mask(p, b + 1)
    sig = rng.uniform(-1, 1, (c, 40 * b)).astype(np.float32)  # wraps the ring
    calls = []
    for name in ("fused_stream", "fused_block_step"):
        real = getattr(tcv, name)
        monkeypatch.setattr(tcv, name, lambda *a, _r=real, _n=name, **k: calls.append((_n, a[8])) or _r(*a, **k))
    got, want, tparams = _process_both(dict(block_size=b, num_partitions=p, channels=c, scheme=scheme,
                                            storage=storage, fused=True), parts, mask, sig)
    active = (tparams["sp_c_flags"] == 1).sum(1)
    assert tfs.fused_chunk_rows(tcv.fdl_lib.STORAGE_DTYPES[storage], p, c, b) == 8
    assert int(active.min()) < p // 8  # rows really skip chunks
    assert calls and all(sched is not None for _, sched in calls)
    assert {n for n, _ in calls} == {"fused_stream" if scheme == "upols" else "fused_block_step"}
    assert _rel(got, want) < _TOL[storage]


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_process_lane_mask_matches_neojax_fused(small_chunks, rng, storage):
    b, p, c = 256, 24, 2
    assert tcv.lane_widths(b) == [256, 128]
    parts = _parts(rng, p, b)
    mask = _lane_mask(p, b + 1)
    sig = rng.uniform(-1, 1, (c, 30 * b)).astype(np.float32)
    got, want, tparams = _process_both(dict(block_size=b, num_partitions=p, channels=c, storage=storage,
                                            fused=True), parts, mask, sig)
    codes = np.unique(tparams["sp_c_idx"].numpy()[tparams["sp_c_flags"].numpy() == 1] >> 16)
    assert len(codes) > 1  # both lane widths are used
    assert _rel(got, want) < _TOL[storage]


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("packed", [True, False])
def test_step_masked_matches_neojax_unfused(rng, monkeypatch, storage, packed):
    """The unfused step: B4 over the tile schedule (the port) against
    neojax's XLA MAC over the masked filter, block by block; the packed
    K = 512 ring and the non-packed K = 513 one (a ragged last k-tile)."""
    b, p, c = 256, 16, 2
    parts = _parts(rng, p, b, cf=2)
    mask = _lane_mask(p, b + 1) & _band_mask(p, b + 1, keep=0.7)
    sig = rng.uniform(-1, 1, (c, 20 * b)).astype(np.float32)
    calls = []
    real = tcv.sparse_fdl_mac
    monkeypatch.setattr(tcv, "sparse_fdl_mac", lambda *a, **k: calls.append(k) or real(*a, **k))
    kw = dict(block_size=b, num_partitions=p, channels=c, storage=storage, fused=False, packed=packed)
    jcfg, tcfg = jcv.PartitionedConfig(**kw), tcv.PartitionedConfig(**kw)
    jparams = jcv.filter_params(jcfg, parts, sparsity=mask)
    tparams = tcv.filter_params(tcfg, parts, sparsity=mask, device="cpu")
    jstate, tstate = jcv.init_state(jcfg), tcv.init_state(tcfg, device="cpu")
    outs_j, outs_t = [], []
    for i in range(20):
        blk = sig[:, i * b : (i + 1) * b]
        jstate, jy = jcv.step(jcfg, jparams, jstate, jnp.asarray(blk))
        tstate, ty = tcv.step(tcfg, tparams, tstate, torch.from_numpy(blk))
        outs_j.append(np.asarray(jy))
        outs_t.append(ty.numpy())
    assert len(calls) == 20 and calls[0]["k_tile"] == 256
    assert _rel(np.concatenate(outs_t, -1), np.concatenate(outs_j, -1)) < _TOL[storage]
    assert tstate["pos"] == int(jstate["pos"]) == 20 % p


def test_unpacked_masked_ring_is_never_fused(rng):
    cfg = tcv.PartitionedConfig(64, 8, 2, storage="split", packed=False)
    params = tcv.filter_params(cfg, _parts(rng, 8, 64), sparsity=_band_mask(8, 65), device="cpu")
    assert "sp_k_idx" in params and "sp_c_idx" not in params
    assert not tcv._use_fused(cfg, params)
    assert tcv._use_fused(tcv.PartitionedConfig(64, 8, 2, storage="split"), {})


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_convolver_rebuilds_the_schedule_for_its_channels(small_chunks, rng, storage):
    """A mono masked filter bound to 4 channels: the chunk geometry depends
    on the channel count, so the Convolver's tables are those of
    ``filter_params`` at C = 4, and its output equals the functional
    ``process`` at C = 4 (and neojax's)."""
    b, p, c = 64, 32, 4
    parts = _parts(rng, p, b)
    mask = _band_mask(p, b + 1)
    sig = rng.uniform(-1, 1, (c, 12 * b)).astype(np.float32)
    tfs._CHUNK_TARGET = jfs._CHUNK_TARGET = 2 * 1 * b * 4 * 16  # C=1: 16 rows; C=4: 8 rows (f32)
    conv = tconv.sparse_upols_convolver(sparsity=mask, storage=storage, device="cpu")
    conv.filter(parts)
    assert conv.config.channels == 1
    out = conv.process(sig).numpy()
    assert conv.config.channels == c
    want_params = tcv.filter_params(tcv.PartitionedConfig(b, p, c, storage=storage), parts, sparsity=mask, device="cpu")
    for key in ("sp_c_idx", "sp_c_flags", "sp_k_idx", "sp_p_idx", "sp_flags", "sp_lane"):
        assert torch.equal(conv.params[key], want_params[key]), key
    kw = dict(block_size=b, num_partitions=p, channels=c, storage=storage, fused=True)
    got, want, _ = _process_both(kw, parts, mask, sig)
    assert np.array_equal(out, got)
    assert _rel(out, want) < _TOL[storage]


def test_golden_sparse_upols_split():
    """``ref_sparse_upols_b128`` (every third bin dropped) through the split
    storage: B3 with the chunk schedule, within 1e-5 absolute."""
    parts = tconv.uniform_partition(np.load(os.path.join(GOLD, "in_ir.npy")), 128)
    c = tconv.sparse_upols_convolver(sparsity=lambda row, col, value: (col % 3) != 0, storage="split", device="cpu")
    c.filter(parts)
    assert c.config.storage == "split" and "sp_c_idx" in c.params
    out = c.process(np.load(os.path.join(GOLD, "in_sig.npy")).astype(np.float32)).numpy()
    assert np.abs(out - np.load(os.path.join(GOLD, "ref_sparse_upols_b128.npy"))).max() < 1e-5


@pytest.mark.parametrize("storage", ["split", "bf16", "int8"])
def test_convert_continues_a_masked_neojax_stream(small_chunks, rng, storage):
    """neojax's masked params (sp_* included) and its state after k blocks
    carried across mid-stream: the port's tables equal its own, and its
    continuation matches neojax's whole stream."""
    b, p, c, k = 64, 32, 4, 5
    parts = _parts(rng, p, b)
    mask = _band_mask(p, b + 1)
    sig = rng.uniform(-1, 1, (c, 40 * b)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(b, p, c, storage=storage, fused=True)
    jparams = jcv.filter_params(jcfg, parts, sparsity=mask)
    _, full = jcv.process(jcfg, jparams, jcv.init_state(jcfg), jnp.asarray(sig))
    jstate, head = jcv.process(jcfg, jparams, jcv.init_state(jcfg), jnp.asarray(sig[:, : k * b]))

    tcfg = tcv.PartitionedConfig(b, p, c, storage=storage, fused=True)
    tparams = convert.params_from_neojax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    own = tcv.filter_params(tcfg, parts, sparsity=mask, device="cpu")
    assert {key for key in tparams if key.startswith("sp_")} == _SP_KEYS | {"sp_c_idx", "sp_c_flags"}
    for key in own:
        if key.startswith("sp_") or key == "mask":
            assert tparams[key].dtype == own[key].dtype and torch.equal(tparams[key], own[key]), key
    tstate = convert.state_from_neojax(tcfg, jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    tstate, tail = tcv.process(tcfg, tparams, tstate, torch.from_numpy(sig[:, k * b :]))
    got = np.concatenate([np.asarray(head), tail.numpy()], axis=-1)
    assert _rel(got, np.asarray(full)) < _TOL[storage]
    assert tstate["pos"] == 40 % p
