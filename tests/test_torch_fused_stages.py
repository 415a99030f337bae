"""neojax_torch's B2/B3 as stages (plain route, CPU): each stage's plain
version against an independent numpy form of the same step, and the staged
``fused_stream`` / ``fused_block_step`` against the block-by-block oracle
(``fused_stream_reference`` / ``fused_block_step_reference``) and against
neojax's Pallas kernels in interpret mode.

The window is shrunk (``fused_step.WINDOW``) so that a short stream spans
several windows: nb < P, nb = P, nb > P, nb not a multiple of the window
and a window longer than the ring all occur at P = 4..32. The sparse cases
shrink both packages' ``_CHUNK_TARGET`` (as ``tests/test_torch_sparse.py``):
P = 24 and 32 split into 8-row chunks and rows really skip.

Tolerances, relative to the output peak:
- stage against numpy, both float64 sums of the same rounded operands:
  ``_EXACT`` (1e-6; the sums differ only in order), except where the
  result is rounded to bf16 after the sum (a last-bit flip is one bf16
  step, 2**-8 relative: ``_TOL['bf16']``);
- quantized rows and scales agree exactly (the same float32 operations);
- the staged stream against the block oracle and neojax: the storage ladder
  ``_TOL`` of ``tests/test_fused_step.py``; int rings within one LSB where
  a spectrum lands on a rounding boundary, scales to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from neojax.conv import convolver as jcv
from neojax.fft import matmul_backend as jmb
from neojax.kernels import fused_step as jfs
from neojax_torch.conv import convolver as tcv
from neojax_torch.fft import matmul_backend as tmb
from neojax_torch.kernels import fused_step as tfs
from neojax_torch.kernels import sparse_mac as tsm

_TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_EXACT = 1e-6
_DT = {"split": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16, "int8": torch.int8}
_JDT = {"split": jnp.float32, "bf16": jnp.bfloat16, "int16": jnp.int16, "int8": jnp.int8}
_INT_MAX = {"int16": 32767, "int8": 127}
_STORAGES = list(_DT)
C, B = 2, 32


def _mdt(storage):
    return tfs.MATRIX_DTYPES[_DT[storage]]


def _rel(a, b):
    a = np.asarray(torch.as_tensor(a).double() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(torch.as_tensor(b).double() if isinstance(b, torch.Tensor) else b, np.float64)
    return np.abs(a - b).max() / max(1e-12, np.abs(b).max())


def _ring(rng, storage, p, c=C, b=B):
    """Seeded ring and scales (numpy -> torch)."""
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        ring = torch.from_numpy(rng.integers(-m, m + 1, (2, p, c, b))).to(_DT[storage])
        return ring, torch.from_numpy(rng.uniform(0.5, 4.0, (p, c)).astype(np.float32))
    return torch.from_numpy(rng.standard_normal((2, p, c, b)).astype(np.float32)).to(_DT[storage]), None


def _rim(rng, storage, p, cf=1, b=B):
    return torch.from_numpy((0.1 * rng.standard_normal((2 * p, cf, 2 * b))).astype(np.float32)).to(_mdt(storage))


def _deq(ring, scales, storage):
    """float64 numpy [2, P, C, B] of the ring's values, dequantized."""
    x = ring.double().numpy()
    if storage in _INT_MAX:
        x = x * (scales * (1.0 / _INT_MAX[storage])).double().numpy()[None, :, :, None]
    return x


def _same_ring(storage, a, b, sa=None, sb=None):
    if storage in _INT_MAX:
        assert int((a.int() - b.int()).abs().max()) <= 1
        np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=1e-5)
    else:
        assert _rel(a.float(), b.float()) < _TOL[storage]


@pytest.fixture
def small_window(monkeypatch):
    def set_window(w):
        monkeypatch.setattr(tfs, "WINDOW", w)
    return set_window


# ---------------------------------------------------------- the stages


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("layout", ["stream", "step"])
def test_window_forward_matches_blockwise_dft(rng, storage, layout):
    """Frames at hop B rounded to the matrix dtype, times the packed forward
    matrix: B3's cs [N, 2B] and B2's planes [2, N, B]."""
    mdt = _mdt(storage)
    nb, i0, wc = 9, 2, 5
    x = torch.from_numpy(rng.uniform(-1, 1, (C, (nb + 1) * B)).astype(np.float32))
    if layout == "stream":
        mat = tmb.packed_stream_mats(2 * B, mdt, "cpu")[0]
        fwd = mat.double().numpy()
    else:
        mat = tmb.packed_mats(2 * B, mdt, "cpu")[0]
        fwd = np.concatenate([mat[0].double().numpy(), mat[1].double().numpy()], axis=-1)
    got = tfs.window_forward(x, mat, i0, wc)
    xr = x.to(mdt).double().numpy()
    want = np.stack([xr[:, (i0 + i) * B : (i0 + i + 2) * B] @ fwd for i in range(wc)])
    assert got.shape == (wc, C, 2 * B) and got.dtype == torch.float32
    assert _rel(got, want) < _EXACT


@pytest.mark.parametrize("storage", _STORAGES)
def test_window_inverse_matches_blockwise(rng, storage):
    mdt = _mdt(storage)
    wc, i0, nbo = 3, 1, 5
    acc = torch.from_numpy(rng.standard_normal((wc, C, 2 * B)).astype(np.float32))
    abt = tmb.packed_stream_mats(2 * B, mdt, "cpu")[1]
    out = torch.full((C, nbo * B), 7.0)
    tfs.window_inverse(acc, abt, out, i0)
    a = acc.to(mdt).double().numpy()
    for i in range(wc):
        want = a[i] @ abt.double().numpy()
        assert _rel(out[:, (i0 + i) * B : (i0 + i + 1) * B], want) < _EXACT
    untouched = torch.cat([out[:, : i0 * B], out[:, (i0 + wc) * B :]], dim=1)
    assert bool((untouched == 7.0).all())


# ----------------------------------------- the transforms' contract (DFT)


def _packed_rfft(x, b):
    """np.fft.rfft of real frames [..., 2B] in the packed layout, float64:
    re lanes 0..B-1 | im lanes 1..B-1 with the Nyquist real part in im
    lane 0."""
    spec = np.fft.rfft(x, axis=-1)
    im = spec.imag[..., :b].copy()
    im[..., 0] = spec.real[..., b]
    return np.concatenate([spec.real[..., :b], im], axis=-1)


def _packed_irfft(row, b):
    """The real 2B-point inverse (1/N) of packed rows [..., 2B], float64."""
    re, im = row[..., :b], row[..., b:]
    spec = np.concatenate([re + 1j * np.concatenate([np.zeros_like(im[..., :1]), im[..., 1:]], axis=-1),
                           im[..., :1] + 0j], axis=-1)
    return np.fft.irfft(spec, n=2 * b, axis=-1)


@pytest.mark.parametrize("b", [8, 48, 96, 512, 1024])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_transform_plain_versions_are_the_packed_dft(rng, b, mdt):
    """The plain transform stages (the kernels' contract) equal numpy's
    real FFT in float64, packed, for both matrix forms each way: the frames
    rounded to the matrix dtype, then within 1e-6 of the peak for f32
    matrices (their float32 rounding) and ``_TOL['bf16']`` for bf16 ones
    (B = 48, 96: the odd factor 3 the kernels' direct stage takes)."""
    n, c, wc, i0 = 2 * b, 2, 3, 1
    tol = _EXACT if mdt == torch.float32 else _TOL["bf16"]
    x = torch.from_numpy(rng.uniform(-1, 1, (c, (i0 + wc + 1) * b)).astype(np.float32))
    xr = x.to(mdt).double().numpy()
    want = np.stack([_packed_rfft(xr[:, (i0 + i) * b : (i0 + i + 2) * b], b) for i in range(wc)])
    for mat in (tmb.packed_stream_mats(n, mdt, "cpu")[0], tmb.packed_mats(n, mdt, "cpu")[0]):
        assert _rel(tfs.window_forward(x, mat, i0, wc), want) < tol
    acc = torch.from_numpy(rng.standard_normal((wc, c, n)).astype(np.float32))
    full = _packed_irfft(acc.to(mdt).double().numpy(), b)  # [wc, C, N]
    for inv, part in ((tmb.packed_stream_mats(n, mdt, "cpu")[1], full[..., b:]),
                      (tmb.packed_mats(n, mdt, "cpu")[1].reshape(n, n), full)):
        n_out = inv.shape[1]
        out = tfs.window_inverse(acc, inv, torch.zeros((c, (i0 + wc) * n_out)), i0)
        got = out[:, i0 * n_out :].reshape(c, wc, n_out).transpose(0, 1)
        assert _rel(got, part) < tol


@pytest.mark.parametrize("b", [8, 48, 96, 130, 512, 1000, 1024])
def test_fft_twiddle_tables_follow_the_radix_plan(b):
    """``fft_radices`` factors B as the kernels' stages take it, and each
    stage's twiddle table holds W_{Ns R}^{k r} at [(r - 1) Ns + k] after
    the N base twiddles W_N^q (float64 on the host, stored as f32)."""
    n = 2 * b
    m, radices = tfs.fft_radices(b)
    assert m % 2 == 1 and m * int(np.prod(radices)) == b and set(radices) <= {2, 4, 8}
    tw = tfs.twiddles(n, "cpu").double().numpy()
    w = tw[:, 0] + 1j * tw[:, 1]
    np.testing.assert_allclose(w[:n], np.exp(-2j * np.pi * np.arange(n) / n), atol=1e-7)
    off, ns = n, m
    for r in radices:
        k = np.arange(ns)
        for j in range(1, r):
            np.testing.assert_allclose(w[off + (j - 1) * ns + k], np.exp(-2j * np.pi * j * k / (ns * r)), atol=1e-7)
        off, ns = off + (r - 1) * ns, ns * r
    assert off == len(w) and ns == b


def test_fused_kernels_take_only_the_packed_dft(rng):
    """B2 and B3 take the packed DFT matrices only (the kernels compute the
    DFT): the cached tensors, equal copies (compared once), views of their
    memory; any other matrix raises, on the CPU route too."""
    ring, _ = _ring(rng, "split", 4)
    rim = _rim(rng, "split", 4)
    sig = torch.from_numpy(rng.uniform(-1, 1, (C, 6 * B)).astype(np.float32))
    dcfix = torch.zeros((5, 2, C))
    cs, abt = tmb.packed_stream_mats(2 * B, torch.float32, "cpu")
    want = tfs.fused_stream(sig, ring.clone(), rim, 0, dcfix, cs, abt)[0]
    got = tfs.fused_stream(sig, ring.clone(), rim, 0, dcfix, cs.clone(), abt.clone())[0]
    assert torch.equal(got, want)
    for bad_cs, bad_abt in ((cs + 1e-3, abt), (cs, abt * 2), (torch.eye(2 * B), abt),
                            (cs.to(torch.bfloat16).float(), abt)):
        with pytest.raises(ValueError, match="packed DFT"):
            tfs.fused_stream(sig, ring.clone(), rim, 0, dcfix, bad_cs, bad_abt)
    cs_b, ab = tmb.packed_mats(2 * B, torch.float32, "cpu")
    frame = sig[:, : 2 * B].contiguous()
    tfs.fused_block_step(frame, ring.clone(), rim, 1, dcfix[0], cs_b, ab)
    with pytest.raises(ValueError, match="packed DFT"):
        tfs.fused_block_step(frame, ring.clone(), rim, 1, dcfix[0], cs_b, ab.flip(-1).contiguous())
    tfs._check_dft(ab.reshape(2 * B, 2 * B), 2 * B, inverse=True)  # a view of the cached memory


@pytest.mark.parametrize("storage", _STORAGES)
def test_quantize_rows_matches_numpy(rng, storage):
    """Peak scale per (block, channel), ``x / scale * int_max``, rint,
    clamp, in float32; a zero row keeps scale 1."""
    wc = 3
    s = (5 * rng.standard_normal((wc, C, 2 * B))).astype(np.float32)
    s[1, 0] = 0.0
    x, scl = tfs.quantize_rows(torch.from_numpy(s), _DT[storage])
    assert x.shape == (wc, 2, C, B) and x.dtype == _DT[storage]
    planes = s.reshape(wc, C, 2, B).transpose(0, 2, 1, 3)
    if storage in _INT_MAX:
        m = np.float32(_INT_MAX[storage])
        peak = np.abs(s).max(-1)
        scale = np.where(peak > 0, peak, np.float32(1.0)).astype(np.float32)
        q = np.clip(np.rint(planes / scale[:, None, :, None] * m), -m, m)
        np.testing.assert_array_equal(x.numpy(), q.astype(x.numpy().dtype))
        np.testing.assert_array_equal(scl.numpy(), scale)
        assert float(scl[1, 0]) == 1.0
    else:
        assert scl is None
        assert torch.equal(x, torch.from_numpy(np.ascontiguousarray(planes)).to(_DT[storage]))


@pytest.mark.parametrize("wc,p", [(3, 8), (8, 8), (11, 4)])
def test_ring_writeback_last_write_wins(rng, wc, p):
    ring, scales = _ring(rng, "int8", p)
    x = torch.from_numpy(rng.integers(-127, 128, (wc, 2, C, B))).to(torch.int8)
    scl = torch.from_numpy(rng.uniform(1, 2, (wc, C)).astype(np.float32))
    want, want_s = ring.clone(), scales.clone()
    pos_first = p - 2
    for i in range(wc):  # block by block: later blocks overwrite
        want[:, (pos_first + i) % p] = x[i]
        want_s[(pos_first + i) % p] = scl[i]
    tfs.ring_writeback(x, scl, ring, scales, pos_first)
    assert torch.equal(ring, want) and torch.equal(scales, want_s)


def _chunk_sched(rng, storage, p, b, monkeypatch, cf=1):
    """Params of a lane-and-band mask with 8-row chunks (P = 24 / 32)."""
    monkeypatch.setattr(tfs, "_CHUNK_TARGET", 1)
    mask = np.zeros((p, b + 1), bool)
    for i in range(int(0.6 * p)):
        mask[i, : max(8, int((b + 1) * (1.0 - i / p)))] = True
    parts = ((rng.standard_normal((cf, p, b + 1)) + 1j * rng.standard_normal((cf, p, b + 1))) * 0.1
             ).astype(np.complex64)
    params = tcv.filter_params(tcv.PartitionedConfig(b, p, C, storage=storage), parts, sparsity=mask, device="cpu")
    pc = tfs.fused_chunk_rows(_DT[storage], p, C, b)
    assert pc == 8 and int((params["sp_c_flags"] == 1).sum(1).min()) < p // pc
    return params, (params["sp_c_idx"], params["sp_c_flags"]), pc


@pytest.mark.parametrize("p", [24, 32])
def test_sched_widths_match_the_block_oracle_liveness(rng, monkeypatch, p):
    b = 256
    assert tsm.lane_widths(b) == [256, 128]
    _, sched, pc = _chunk_sched(rng, "split", p, b, monkeypatch)
    tab = tfs.sched_widths(sched, b, pc)
    assert tab.shape == (p, p // pc) and tab.dtype == torch.int32
    widths = set()
    for pos in range(p):
        live = tfs._sched_live(sched, pos, p, b, pc).numpy()  # [P, B]
        for j in range(p // pc):
            rows = live[j * pc : (j + 1) * pc]
            assert (rows == rows[:1]).all()  # a chunk's rows share their lanes
            assert int(rows[0].sum()) == int(tab[pos, j])
            widths.add(int(tab[pos, j]))
    assert widths == {0, 128, 256}


def _direct_mac(storage, ring, scales, x, scl, rim, dcfix, pos_first, seed=None, tiles=None):
    """numpy, block by block: insert block i's row at its slot, then the
    rotated-filter MAC over every slot (the TPU kernel's order of events);
    with a tap-tile table, only the lanes of its live (tap, lane tile)
    pairs."""
    p, b = ring.shape[1], ring.shape[3]
    lanes = None if tiles is None else np.repeat(tiles.numpy().astype(bool), 8, axis=1)[:, :b]  # [tap, lane]
    hist = _deq(ring, scales, storage).copy()
    new = x.double().numpy()
    if scl is not None:
        new = new * (scl * (1.0 / _INT_MAX[storage])).double().numpy()[:, None, :, None]
    f = rim.double().numpy()
    out = []
    for i in range(x.shape[0]):
        pos = (pos_first + i) % p
        hist[:, pos] = new[i]
        rot = f[p - 1 - pos : 2 * p - 1 - pos]  # slot q meets row P-1-pos+q
        fr, fi = rot[..., :b], rot[..., b:]
        if lanes is not None:
            live = lanes[(pos - np.arange(p)) % p][:, None, :]  # slot q holds tap (pos - q) % P
            fr, fi = fr * live, fi * live
        re = (hist[0] * fr - hist[1] * fi).sum(0)
        im = (hist[0] * fi + hist[1] * fr).sum(0)
        if seed is not None:
            re, im = re + seed[i, 0].double().numpy(), im + seed[i, 1].double().numpy()
        re[:, 0], im[:, 0] = dcfix[i, 0].numpy(), dcfix[i, 1].numpy()
        out.append(np.concatenate([re, im], -1))
    return np.stack(out)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", ["one", "all"])
@pytest.mark.parametrize("wc,p", [(3, 8), (8, 8), (11, 4), (1, 1), (17, 5), (1, 17), (17, 17)])
@pytest.mark.parametrize("c,b", [(C, B), (1, 24), (3, 48)])
def test_stream_mac_matches_direct_sum(rng, storage, cf, wc, p, c, b):
    """The time-batched MAC (history from the staged rows and the ring as it
    stood) against the block-by-block sum: nb < P, = P and > P, P = 1, one
    block, C = 1 and 3, B with an odd factor, a shared or per-channel
    untiled rim (both halves differ)."""
    cf = 1 if cf == "one" else c
    pos = (p - 3) % p
    ring, scales = _ring(rng, storage, p, c, b)
    rim = _rim(rng, storage, p, cf, b)
    s = torch.from_numpy((3 * rng.standard_normal((wc, c, 2 * b))).astype(np.float32))
    x, scl = tfs.quantize_rows(s, _DT[storage])
    dcfix = torch.from_numpy(rng.standard_normal((wc, 2, c)).astype(np.float32))
    seed = torch.from_numpy(rng.standard_normal((wc, 2, c, b)).astype(np.float32))
    before = ring.clone()
    got = tfs.stream_mac(ring, scales, x, scl, rim, dcfix, pos, seed=seed)
    assert torch.equal(ring, before)  # the MAC only reads the ring
    want = _direct_mac(storage, ring, scales, x, scl, rim, dcfix, pos, seed)
    tol = _TOL["bf16"] if _mdt(storage) == torch.bfloat16 else _EXACT
    assert _rel(got, want) < tol
    assert torch.equal(got, got.to(_mdt(storage)).float())  # rounded to the matrix dtype


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p", [24, 32])
@pytest.mark.parametrize("wc", [1, 10, 17])
@pytest.mark.parametrize("c,cf", [(C, 1), (3, 3), (1, 1)])
def test_stream_mac_sched_matches_direct_sum(rng, monkeypatch, storage, p, wc, c, cf):
    """The MAC with the tap-tile table of the schedule's mask against the
    direct sum over the table's live lanes."""
    b = 256
    params, _, _ = _chunk_sched(rng, storage, p, b, monkeypatch)
    tiles = params["tap_tiles"]  # tap_tile_table of the mask
    assert 0 < int(tiles.sum()) < tiles.numel()
    ring, scales = _ring(rng, storage, p, c, b)
    rim = _rim(rng, storage, p, cf, b)  # unmasked: the table alone must drop the dead terms
    x, scl = tfs.quantize_rows(torch.from_numpy(rng.standard_normal((wc, c, 2 * b)).astype(np.float32)),
                               _DT[storage])
    dcfix = torch.from_numpy(rng.standard_normal((wc, 2, c)).astype(np.float32))
    got = tfs.stream_mac(ring, scales, x, scl, rim, dcfix, 5, tiles=tiles)
    want = _direct_mac(storage, ring, scales, x, scl, rim, dcfix, 5, tiles=tiles)
    tol = _TOL["bf16"] if _mdt(storage) == torch.bfloat16 else _EXACT
    assert _rel(got, want) < tol


_HEADLINE = (960, 64, 512)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("p,c,b,wc", [(*_HEADLINE, 64), (64, 64, 512, 64), (960, 1, 1024, 64),
                                      (960, 65, 1024, 64), (64, 65, 1024, 17), (5, 3, 48, 130)])
def test_stream_mac_geometry_covers_each_term_once(storage, shared, p, c, b, wc):
    """stream_mac's launch geometry at the path's shapes (the headline window,
    the hybrid head at P = 64, B = 1024, C = 1 and 65) and off them: each
    (block, channel, lane) is one thread's, once; the shared bytes fit a
    CTA (227 KB); the filter ring holds a step's taps and those copied
    ahead. A shared filter over more than 4 channels at NC = 4 (the tiles
    kernel's tile for it), else NC = 1."""
    geo = tfs.stream_mac_geometry(p, c, b, wc, _DT[storage], 1 if shared else c, 4 if shared and c > 4 else 1)
    assert geo["nc"] == (4 if shared and c > 4 else 1)
    assert geo["smem"] <= 227 * 1024
    assert geo["slots"] - 32 >= geo["blocks"] + geo["rows"] - 1 + (geo["stages"] - 1) * geo["rows"]
    gx, gy, gz = geo["grid"]
    x, y, z, t, q = np.ix_(np.arange(gx), np.arange(gy), np.arange(gz), np.arange(geo["threads"]),
                           np.arange(geo["nc"]))
    lane = x * geo["lanes"] + t % geo["lanes"]
    chan = y * geo["channels"] + (t // geo["lanes"]) % 4 + 4 * q
    first = z * geo["blocks"] + (t // 32) * geo["blocks_a_thread"]
    count = np.zeros((wc, c, b), np.int64)
    for j in range(geo["blocks_a_thread"]):
        blk, ch, ln = np.broadcast_arrays(first + j, chan, lane)
        keep = (blk < wc) & (ch < c) & (ln < b)
        np.add.at(count, (blk[keep], ch[keep], ln[keep]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p,c,b,wc", [(*_HEADLINE, 64), (64, 64, 512, 64), (960, 1, 1024, 64),
                                      (960, 65, 1024, 64), (64, 65, 1024, 17), (5, 3, 48, 130), (1, 3, 40, 7)])
def test_stream_mac_dense_geometry_covers_each_term_once(storage, p, c, b, wc):
    """The dense route's geometry (stream_mac_dense_kernel): each (block,
    channel, lane) is one thread's, once (a thread: 8 blocks x lanes 2 (t %
    4) + v x channels t // 4 % 8 + 8 h); the shared bytes are the kernel's
    layout and fit a CTA (227 KB); the tap ring holds a step's taps and
    those copied ahead."""
    geo = tfs.stream_mac_dense_geometry(p, c, b, wc, _DT[storage])
    isz, msz = _DT[storage].itemsize, tfs.MATRIX_DTYPES[_DT[storage]].itemsize
    stage = 16 * 2 * 16 * 8 * isz + (16 * 16 * 4 if storage in ("int16", "int8") else 0)
    assert geo["smem"] == 4 * 160 * 8 * msz + 4 * stage <= 227 * 1024
    assert (geo["threads"], geo["lanes"], geo["channels"], geo["blocks"], geo["stages"]) == (256, 8, 16, 64, 4)
    assert geo["slots"] - 32 >= geo["blocks"] + geo["rows"] - 1 + (geo["stages"] - 1) * geo["rows"]
    gx, gy, gz = geo["grid"]
    x, y, z, t, v, h = np.ix_(np.arange(gx), np.arange(gy), np.arange(gz), np.arange(geo["threads"]),
                              np.arange(geo["lanes_a_thread"]), np.arange(geo["channels_a_thread"]))
    lane = x * geo["lanes"] + 2 * (t % 4) + v
    chan = y * geo["channels"] + (t // 4) % 8 + 8 * h
    first = z * geo["blocks"] + (t // 32) * geo["blocks_a_thread"]
    count = np.zeros((wc, c, b), np.int64)
    for j in range(geo["blocks_a_thread"]):
        blk, ch, ln = np.broadcast_arrays(first + j, chan, lane)
        keep = (blk < wc) & (ch < c) & (ln < b)
        np.add.at(count, (blk[keep], ch[keep], ln[keep]), 1)
    assert (count == 1).all()


def test_stream_mac_dense_geometry_rejects_unknown_storages():
    with pytest.raises(ValueError, match="storage"):
        tfs.stream_mac_dense_geometry(4, 2, 8, 1, torch.float64)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, C])
@pytest.mark.parametrize("sched", [False, True])
def test_step_mac_and_reduce_match_direct_sum(rng, monkeypatch, storage, cf, sched):
    """B2's MAC over P splits and its in-order reduction against one sum
    over the slots (the new row already in slot pos)."""
    p, b = 24, 256
    ring, scales = _ring(rng, storage, p, b=b)
    rim = _rim(rng, storage, p, cf, b=b)
    widths, tables, pc = None, None, 1
    if sched:
        _, tables, pc = _chunk_sched(rng, storage, p, b, monkeypatch, cf)
        widths = (tfs.sched_widths(tables, b, pc), pc)
    dcfix = torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
    for pos in (0, 9, p - 1):
        part = tfs.step_mac(ring, scales, rim, pos, widths)
        s_n, per, _ = tfs._step_geometry(ring)
        assert part.shape == (s_n, 2, C, b) and s_n * per >= p
        got = tfs.step_reduce(part, dcfix, _mdt(storage))
        x = _deq(ring, scales, storage)
        rot = rim.double().numpy()[p - 1 - pos : 2 * p - 1 - pos]
        fr, fi = rot[..., :b], rot[..., b:]
        if sched:
            live = tfs._sched_live(tables, pos, p, b, pc).numpy()[:, None, :]
            fr, fi = fr * live, fi * live
        re = (x[0] * fr - x[1] * fi).sum(0)
        im = (x[0] * fi + x[1] * fr).sum(0)
        re[:, 0], im[:, 0] = dcfix[0].numpy(), dcfix[1].numpy()
        tol = _TOL["bf16"] if _mdt(storage) == torch.bfloat16 else 1e-5  # f32 partial sums
        assert _rel(got[0], np.concatenate([re, im], -1)) < tol


def test_stages_count_nothing_on_the_cpu(rng):
    counters = {f.__name__: f.launches for f in tfs.stage_wrappers()}
    ring, _ = _ring(rng, "split", 4)
    sig = torch.from_numpy(rng.uniform(-1, 1, (C, 6 * B)).astype(np.float32))
    cs, abt = tmb.packed_stream_mats(2 * B, torch.float32, "cpu")
    tfs.fused_stream(sig, ring, _rim(rng, "split", 4), 0, torch.zeros((5, 2, C)), cs, abt)
    assert {f.__name__: f.launches for f in tfs.stage_wrappers()} == counters


def test_stages_reject_bad_shapes():
    with pytest.raises(ValueError, match="samples"):
        tfs.window_forward(torch.zeros((C, 3 * B)), torch.zeros((2 * B, 2 * B)), 1, 2)
    with pytest.raises(ValueError):
        tfs.window_inverse(torch.zeros((1, C, 2 * B)), torch.zeros((2 * B, B)), torch.zeros((C, B - 1)), 0)
    with pytest.raises(ValueError, match="pos_first"):
        tfs.ring_writeback(torch.zeros((1, 2, C, B)), None, torch.zeros((2, 4, C, B)), None, 4)
    with pytest.raises(ValueError, match="stream_mac"):
        tfs.stream_mac(torch.zeros((2, 4, C, B)), None, torch.zeros((2, 2, C, B)), None,
                       torch.zeros((8, 1, 2 * B)), torch.zeros((1, 2, C)), 0)
    with pytest.raises(ValueError, match="dcfix"):
        tfs.step_reduce(torch.zeros((3, 2, C, B)), torch.zeros((2, C + 1)), torch.float32)


# ------------------------------------------------------ the whole pipeline


def _stream_inputs(rng, storage, p, nb, cf=1, seed=False):
    ring, scales = _ring(rng, storage, p)
    sig = torch.from_numpy(rng.uniform(-1, 1, (C, (nb + 1) * B)).astype(np.float32))
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, C)).astype(np.float32))
    acc_add = torch.from_numpy((5 * rng.standard_normal((nb, 2, C, B))).astype(np.float32)) if seed else None
    cs, abt = tmb.packed_stream_mats(2 * B, _mdt(storage), "cpu")
    return ring, scales, _rim(rng, storage, p, cf), sig, dcfix, acc_add, cs, abt


_CASES = {  # (P, nb, pos0, window, C', acc_add)
    "nb<P": (8, 5, 6, 64, 1, False),
    "nb=P": (8, 8, 3, 64, 1, False),
    "nb>P": (8, 21, 5, 64, 1, False),
    "ragged_windows": (8, 10, 7, 4, C, False),
    "window>P": (4, 13, 2, 8, 1, True),
    "acc_add_windows": (6, 14, 4, 4, 1, True),
}


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("case", list(_CASES))
def test_staged_stream_matches_block_oracle(rng, small_window, storage, case):
    p, nb, pos0, window, cf, seed = _CASES[case]
    small_window(window)
    ring, scales, rim, sig, dcfix, acc_add, cs, abt = _stream_inputs(rng, storage, p, nb, cf, seed)
    k_ring, p_ring = ring.clone(), ring.clone()
    k_s = None if scales is None else scales.clone()
    p_s = None if scales is None else scales.clone()
    got = tfs.fused_stream(sig, k_ring, rim, pos0, dcfix, cs, abt, k_s, acc_add=acc_add)
    want = tfs.fused_stream_reference(sig, p_ring, rim, pos0, dcfix, cs, abt, p_s, acc_add=acc_add)
    assert got[1] is k_ring
    assert _rel(got[0], want[0]) < _TOL[storage]
    _same_ring(storage, k_ring, p_ring, k_s, p_s)


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("seed", [False, True])
def test_staged_stream_matches_neojax(rng, small_window, storage, seed):
    """Several windows (4 blocks each) over a ring of P = 4 that wraps three
    times, against neojax's Pallas ``fused_stream`` in interpret mode."""
    small_window(4)
    p, nb, pos0 = 4, 11, 3
    ring, scales, rim, sig, dcfix, acc_add, cs, abt = _stream_inputs(rng, storage, p, nb, seed=seed)
    jm = jnp.bfloat16 if _mdt(storage) == torch.bfloat16 else jnp.float32
    j_cs, j_abt = jmb.packed_stream_mats(2 * B, jnp.float32)
    np.testing.assert_allclose(cs.float().numpy(), np.asarray(jnp.asarray(j_cs).astype(jm).astype(jnp.float32)))
    j_args = [jnp.asarray(sig.numpy()), jnp.asarray(ring.float().numpy()).astype(_JDT[storage]),
              jnp.asarray(jfs.shift8_filter(rim.float().numpy()[:, 0])).astype(jm), pos0,
              jnp.asarray(dcfix.numpy()), jnp.asarray(j_cs).astype(jm), jnp.asarray(j_abt).astype(jm)]
    j_scl = None if scales is None else jnp.asarray(np.pad(scales.numpy(), ((0, 0), (0, 128 - C)),
                                                           constant_values=1.0))
    res = jfs.fused_stream(*j_args, j_scl, None, None if acc_add is None else jnp.asarray(acc_add.numpy()),
                           shared_filter=True, interpret=True)
    t_ring = ring.clone()
    t_s = None if scales is None else scales.clone()
    got = tfs.fused_stream(sig, t_ring, rim, pos0, dcfix, cs, abt, t_s, acc_add=acc_add)
    assert _rel(got[0], np.asarray(res[0])) < _TOL[storage]
    j_ring = torch.from_numpy(np.array(jnp.asarray(res[1]).astype(jnp.float32))).to(_DT[storage])
    _same_ring(storage, t_ring, j_ring, t_s,
               None if scales is None else torch.from_numpy(np.asarray(res[2])[:, :C].copy()))


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, C])
def test_staged_block_step_matches_oracle_and_neojax(rng, storage, cf):
    p = 6
    ring, scales = _ring(rng, storage, p)
    rim = _rim(rng, storage, p, cf)
    jm = jnp.bfloat16 if _mdt(storage) == torch.bfloat16 else jnp.float32
    cs_np, ab_np = jmb.packed_mats_np(2 * B)
    cs, ab = (torch.from_numpy(np.asarray(a)).to(_mdt(storage)) for a in (cs_np, ab_np))
    for pos in (0, 4):
        frame = torch.from_numpy(rng.uniform(-1, 1, (C, 2 * B)).astype(np.float32))
        dcfix = torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
        k_ring, p_ring = ring.clone(), ring.clone()
        k_s = None if scales is None else scales.clone()
        p_s = None if scales is None else scales.clone()
        got = tfs.fused_block_step(frame, k_ring, rim, pos, dcfix, cs, ab, k_s)
        want = tfs.fused_block_step_reference(frame, p_ring, rim, pos, dcfix, cs, ab, p_s)
        assert _rel(got[0], want[0]) < _TOL[storage]
        _same_ring(storage, k_ring, p_ring, k_s, p_s)
        j_rim = jfs.shift8_filter(rim.float().numpy()[:, 0]) if cf == 1 else rim.float().numpy()
        j_args = [jnp.asarray(frame.numpy()), jnp.asarray(ring.float().numpy()).astype(_JDT[storage]),
                  jnp.asarray(j_rim).astype(jm), pos, jnp.asarray(dcfix.numpy()),
                  jnp.asarray(cs_np).astype(jm), jnp.asarray(ab_np).astype(jm)]
        if scales is None:
            jy = jfs.fused_block_step(*j_args, shared_filter=cf == 1, interpret=True)[0]
        else:
            jy = jfs.fused_block_step(*j_args, jnp.asarray(scales.numpy())[:, None, :], shared_filter=cf == 1,
                                      interpret=True)[0]
        assert _rel(got[0], np.asarray(jy)) < _TOL[storage]
        ring, scales = k_ring, k_s


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p", [24, 32])
def test_staged_stream_sched_matches_oracle_and_dense(rng, monkeypatch, small_window, storage, p):
    """B3 with the mask's tap-tile table, several windows: against the block
    oracle with the mask's chunk schedule (8-row chunks, two lane widths),
    and equal to the dense staged stream on the masked filter (masked bins
    are zero: every skipped term is an exact 0)."""
    b, nb = 256, 2 * p + 3
    small_window(16)
    params, sched, _ = _chunk_sched(rng, storage, p, b, monkeypatch)
    ring, scales = _ring(rng, storage, p, b=b)
    sig = torch.from_numpy(rng.uniform(-1, 1, (C, (nb + 1) * b)).astype(np.float32))
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, C)).astype(np.float32))
    cs, abt = tmb.packed_stream_mats(2 * b, _mdt(storage), "cpu")
    rings = [ring.clone() for _ in range(3)]
    scl = [None if scales is None else scales.clone() for _ in range(3)]
    rim = params["filt_rim"]
    got = tfs.fused_stream(sig, rings[0], rim, p - 5, dcfix, cs, abt, scl[0], params["tap_tiles"])[0]
    want = tfs.fused_stream_reference(sig, rings[1], rim, p - 5, dcfix, cs, abt, scl[1], sched)[0]
    dense = tfs.fused_stream(sig, rings[2], rim, p - 5, dcfix, cs, abt, scl[2])[0]
    assert _rel(got, want) < _TOL[storage]
    _same_ring(storage, rings[0], rings[1], scl[0], scl[1])
    assert torch.equal(got, dense) and torch.equal(rings[0], rings[2])


@pytest.fixture
def neojax_small_chunks():
    saved = (jfs._CHUNK_TARGET, tfs._CHUNK_TARGET)
    jfs._INTERPRET = True
    jfs._CHUNK_TARGET = tfs._CHUNK_TARGET = 1
    yield
    jfs._INTERPRET = False
    jfs._CHUNK_TARGET, tfs._CHUNK_TARGET = saved
    jax.clear_caches()


@pytest.mark.parametrize("storage", _STORAGES)
def test_staged_sched_process_matches_neojax(rng, neojax_small_chunks, small_window, storage):
    """The masked convolver's ``process`` (B3 with the tap-tile table, in
    windows of 16 blocks) against neojax's fused path with the chunk
    schedule in interpret mode, both packages at 8-row chunks (P = 24)."""
    small_window(8)
    b, p = 64, 24
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    mask = np.zeros((p, b + 1), bool)
    mask[: int(0.3 * p)] = True
    sig = rng.uniform(-1, 1, (C, 30 * b)).astype(np.float32)
    cfg = dict(block_size=b, num_partitions=p, channels=C, storage=storage, fused=True)
    jcfg, tcfg = jcv.PartitionedConfig(**cfg), tcv.PartitionedConfig(**cfg)
    _, jout = jcv.process(jcfg, jcv.filter_params(jcfg, parts, sparsity=mask), jcv.init_state(jcfg),
                          jnp.asarray(sig))
    tparams = tcv.filter_params(tcfg, parts, sparsity=mask, device="cpu")
    assert int((tparams["sp_c_flags"] == 1).sum(1).min()) < p // 8
    _, tout = tcv.process(tcfg, tparams, tcv.init_state(tcfg, device="cpu"), torch.from_numpy(sig))
    assert _rel(tout, np.asarray(jout)) < _TOL[storage]
