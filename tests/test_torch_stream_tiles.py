"""B3's tap-tile table and the scheduled walk it gives ``stream_mac``
(CPU): the table against a brute-force reading of the mask, its place
inside the chunk schedule, the walk's live warps, work items and step
counts against brute force, and the plain MAC with the table against the
direct sum. The kernel itself is held against the dense one on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from neojax_torch import trace
from neojax_torch.conv import convolver as tcv
from neojax_torch.fft import matmul_backend as tmb
from neojax_torch.kernels import fused_step as tfs

_DT = {"split": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16, "int8": torch.int8}
_INT_MAX = {"int16": 32767, "int8": 127}
LANES, MB, BLOCKS, ROWS = 8, 8, 64, 16  # stream_mac_kernel's tile


def _benchmark_mask():
    """The masked benchmark cell's keep-mask [960, 513] (its IR's fixed seed)."""
    from benchmark.lib import inputs, spec

    cfg = spec.load_json(spec.ROOT / "benchmark/configs/ambi64_room10s_perc60_bf16.json")
    return inputs.make_filter(cfg).mask


def _lane_mask(rng, p, k, keep=0.7):
    """Low bins kept in the first partitions, the cutoff falling with the
    partition, a few stray bins further up, and dead partitions."""
    mask = np.zeros((p, k), bool)
    for i in range(int(keep * p)):
        mask[i, : max(3, int(k * (1.0 - i / p) ** 2))] = True
    return mask | (rng.random((p, k)) < 0.01)


def _brute_tiles(mask, b):
    mask = mask.any(axis=1) if mask.ndim == 3 else mask
    p, k = mask.shape
    out = np.zeros((p, -(-b // LANES)), bool)
    for a in range(p):
        for col in range(k):
            if mask[a, col]:
                lane = 0 if col == b else col  # Nyquist rides packed lane 0
                out[a, lane // LANES] = True
    return out


@pytest.mark.parametrize("p,k,cf", [(7, 33, 1), (24, 257, 3), (5, 49, 1), (16, 25, 2)])
def test_tap_tile_table_matches_brute_force(rng, p, k, cf):
    b = k - 1
    mask = rng.random((p, cf, k)) < 0.05
    mask[3, 0, b] = True  # a lone Nyquist bin: lane tile 0 at tap 3
    got = tfs.tap_tile_table(mask if cf > 1 else mask[:, 0], b)
    assert got.dtype == bool and got.shape == (p, -(-b // LANES))
    np.testing.assert_array_equal(got, _brute_tiles(mask, b))
    assert got[3, 0]


def test_tap_tile_table_of_the_benchmark_mask():
    mask = _benchmark_mask()
    got = tfs.tap_tile_table(mask, 512)
    np.testing.assert_array_equal(got, _brute_tiles(mask, 512))
    assert got.shape == (960, 64) and got[:, 0].all()  # the kept low bins: tile 0 at every tap
    assert 0.05 < got.mean() < 0.2  # about a tenth of the (tap, lane tile) pairs


@pytest.mark.parametrize("storage", ["split", "int8"])
@pytest.mark.parametrize("p", [24, 32])
def test_tap_tiles_are_inside_the_chunk_schedule(rng, monkeypatch, storage, p):
    """At every ring position each (tap, lane) the table keeps is summed by
    the chunk schedule's row (``_sched_live``), and the convolver keeps the
    table beside the schedule."""
    monkeypatch.setattr(tfs, "_CHUNK_TARGET", 1)
    b, c = 256, 3
    mask = _lane_mask(rng, p, b + 1)
    parts = (rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))).astype(np.complex64)
    params = tcv.filter_params(tcv.PartitionedConfig(b, p, c, storage=storage), parts, sparsity=mask, device="cpu")
    tiles = params["tap_tiles"]
    assert tiles.dtype == torch.uint8
    np.testing.assert_array_equal(tiles.numpy().astype(bool), tfs.tap_tile_table(mask, b))
    lanes = np.repeat(tiles.numpy().astype(bool), LANES, axis=1)[:, :b]  # [tap, lane]
    pc = tfs.fused_chunk_rows(_DT[storage], p, c, b)
    sched = (params["sp_c_idx"], params["sp_c_flags"])
    for pos in range(p):
        live = tfs._sched_live(sched, pos, p, b, pc).numpy()  # [slot, lane]
        slots = (pos - np.arange(p)) % p  # tap a sits in slot (pos - a) % P
        assert not (lanes & ~live[slots]).any(), pos


def _brute_steps(tiles, s, w, t):
    p = tiles.shape[0]
    c = MB * w + p - 1 - ROWS * s  # u0 - d0
    return any(0 <= c + j - r < p and tiles[c + j - r, t] for j in range(MB) for r in range(ROWS))


@pytest.mark.parametrize("p", [1, 5, 17, 40])
def test_steps_mark_the_warps_that_meet_a_live_tap(rng, p):
    tiles = rng.random((p, 3)) < 0.2
    tiles[-1, 2] = True
    steps = tfs._tile_steps(tiles)
    assert steps.shape == (3, (BLOCKS + p - 2) // ROWS + 1)
    for t in range(3):
        for s in range(steps.shape[1]):
            for w in range(BLOCKS // MB):
                assert bool(steps[t, s] >> w & 1) == _brute_steps(tiles, s, w, t), (t, s, w)


@pytest.mark.parametrize("kind,p,c,b,wc,nc", [
    ("lowbins", 960, 64, 512, 64, 1), ("lowbins", 24, 3, 96, 17, 1), ("lowbins", 5, 37, 48, 130, 1),
    ("lowbins", 40, 1, 8, 64, 1), ("band", 960, 64, 512, 64, 4), ("band", 40, 61, 256, 100, 4),
    ("band", 30, 37, 48, 130, 1)])
def test_work_items_cover_each_lane_channel_and_block_once(rng, kind, p, c, b, wc, nc):
    """Each (lane, channel, block) of the window is one item's, once, at the
    plan's tile (8 lanes x 4 NC channels x 64 blocks): NC = 1 where one lane
    tile is live at every tap and the others at the first taps only (a
    perceptual mask), NC = 4 for a band of partitions unless NC = 1's four
    times as many items still fit one wave; heaviest first; each item's
    step span is its first to last live step."""
    tiles = np.zeros((p, -(-b // LANES)), bool)
    if kind == "band":
        tiles[: p // 3] = True
    else:
        for t in range(tiles.shape[1]):
            tiles[: max(1, p // (1 + 6 * t)), t] = True
        tiles |= rng.random(tiles.shape) < 0.002
    plan = tfs.stream_mac_plan(tiles, c, wc)
    items = plan["items"]
    assert plan["nc"] == nc
    term = 1.0 if nc == 4 else 1.5 / 4
    assert items.dtype == np.int32 and items.flags.c_contiguous and items.shape[1] == 4
    count = np.zeros((wc, c, b), np.int64)
    cost = []
    for t, ct, z, span in items:
        for u in range(z * BLOCKS, min(wc, (z + 1) * BLOCKS)):
            for ch in range(ct * 4 * nc, min(c, (ct + 1) * 4 * nc)):
                count[u, ch, t * LANES : min(b, (t + 1) * LANES)] += 1
        u_n = min(wc, (z + 1) * BLOCKS) - z * BLOCKS
        nsteps = (u_n + p - 2) // ROWS + 1
        on = plan["steps"][t, :nsteps] & ((1 << -(-u_n // MB)) - 1)
        lo, hi = span & 0xFFFF, span >> 16
        if on.any():
            assert on[lo] and on[hi - 1] and not on[:lo].any() and not on[hi:].any()
        else:
            assert lo == hi == 0
        cost.append(sum(bin(int(v)).count("1") for v in on) * term + (hi - lo))  # the cost model
    assert (count == 1).all()
    assert cost == sorted(cost, reverse=True) and tiles[:, items[0, 0]].any()


def _brute_counts(tiles, c, wc):
    """(steps run, steps dense) of a window: a CTA-step runs where a warp
    holding blocks meets a live tap, counted once a lane tile, block tile
    and channel."""
    p, nt = tiles.shape
    run = dense = 0
    for z in range(-(-wc // BLOCKS)):
        u_base, u_end = z * BLOCKS, min(wc, (z + 1) * BLOCKS)
        nsteps = (u_end - 1 - (u_base - (p - 1))) // ROWS + 1
        dense += nsteps * nt * c
        for t in range(nt):
            for s in range(nsteps):
                warps = range(-(-(u_end - u_base) // MB))
                run += c * any(_brute_steps(tiles, s, w, t) for w in warps)
    return run, dense


@pytest.mark.parametrize("p,c,wc", [(24, 3, 64), (17, 5, 23), (9, 2, 130)])
def test_step_counts_match_a_brute_force_count(rng, p, c, wc):
    tiles = rng.random((p, 4)) < 0.15
    plan = tfs.stream_mac_plan(tiles, c, wc, cf=c)
    assert (plan["steps_run"], plan["steps_dense"]) == _brute_counts(tiles, c, wc)
    assert plan["steps_dense"] == tfs._dense_steps(p, c, 4 * LANES, wc)


def _ring(rng, storage, p, c, b):
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        return (torch.from_numpy(rng.integers(-m, m + 1, (2, p, c, b))).to(_DT[storage]),
                torch.from_numpy(rng.uniform(0.5, 4.0, (p, c)).astype(np.float32)))
    return torch.from_numpy(rng.standard_normal((2, p, c, b)).astype(np.float32)).to(_DT[storage]), None


@pytest.mark.parametrize("storage", list(_DT))
@pytest.mark.parametrize("p,wc,c,b,cf", [(24, 10, 3, 96, 1), (17, 30, 2, 40, 2), (5, 3, 1, 24, 1)])
def test_stream_mac_reference_with_tiles(rng, storage, p, wc, c, b, cf):
    """With the table: the direct sum over the rim with the table's dead
    (tap, lane tile) pairs zeroed, on an unmasked untiled rim; on a rim
    masked by the same mask, the result without the table, bit for bit."""
    mdt = tfs.MATRIX_DTYPES[_DT[storage]]
    mask = _lane_mask(rng, p, b + 1)
    tiles = torch.from_numpy(tfs.tap_tile_table(mask, b).astype(np.uint8))
    ring, scales = _ring(rng, storage, p, c, b)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, cf, 2 * b))).astype(np.float32)).to(mdt)
    x, scl = tfs.quantize_rows(torch.from_numpy((3 * rng.standard_normal((wc, c, 2 * b))).astype(np.float32)),
                               _DT[storage])
    dcfix = torch.from_numpy(rng.standard_normal((wc, 2, c)).astype(np.float32))
    seed = torch.from_numpy(rng.standard_normal((wc, 2, c, b)).astype(np.float32))
    pos = p - 2
    got = tfs.stream_mac(ring, scales, x, scl, rim, dcfix, pos, seed, tiles=tiles)
    # the rim with tap a's dead lane tiles zeroed: tap a at rows P-1-a and 2P-1-a
    lanes = np.repeat(tiles.numpy().astype(bool), LANES, axis=1)[:, :b]
    keep = np.concatenate([lanes[::-1], lanes[::-1]])[:, None, :]
    rim_t = torch.from_numpy(np.concatenate([keep, keep], axis=-1)) * rim.float()
    want = tfs.stream_mac_reference(ring, scales, x, scl, rim_t.to(mdt), dcfix, pos, seed)
    assert torch.equal(got, want)
    masked = (rim.float() * torch.from_numpy(np.concatenate([keep, keep], axis=-1))).to(mdt)
    assert torch.equal(tfs.stream_mac(ring, scales, x, scl, masked, dcfix, pos, seed, tiles=tiles),
                       tfs.stream_mac(ring, scales, x, scl, masked, dcfix, pos, seed))


def test_stream_mac_takes_tiles_or_widths():
    ring, x, dcfix = torch.zeros((2, 4, 1, 16)), torch.zeros((2, 2, 1, 16)), torch.zeros((2, 2, 1))
    rim = torch.zeros((8, 1, 32))
    with pytest.raises(ValueError, match="tiles"):
        tfs.stream_mac(ring, None, x, None, rim, dcfix, 0, tiles=torch.zeros((4, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="tiles"):
        tfs.stream_mac(ring, None, x, None, rim, dcfix, 0, widths=(torch.zeros((4, 1), dtype=torch.int32), 4),
                       tiles=torch.zeros((4, 2), dtype=torch.uint8))


@pytest.mark.parametrize("storage", ["split", "bf16"])
def test_masked_process_with_the_table_equals_the_schedule(rng, monkeypatch, storage):
    """The masked convolver's B3 takes the table, in windows TILES_WINDOWS
    times longer; on its masked filter the result equals B3 with the chunk
    schedule's widths and the dense B3."""
    monkeypatch.setattr(tfs, "WINDOW", 8)
    monkeypatch.setattr(tfs, "_CHUNK_TARGET", 1)
    b, p, c, nb = 64, 24, 2, 30
    mask = _lane_mask(rng, p, b + 1)
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    params = tcv.filter_params(tcv.PartitionedConfig(b, p, c, storage=storage), parts, sparsity=mask, device="cpu")
    ring, scales = _ring(rng, storage, p, c, b)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32))
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32))
    cs, abt = tmb.packed_stream_mats(2 * b, tfs.MATRIX_DTYPES[_DT[storage]], "cpu")
    sched = (params["sp_c_idx"], params["sp_c_flags"])
    macs = []  # (wc, tiles given) of each stream_mac call
    mac = tfs.stream_mac
    monkeypatch.setattr(tfs, "stream_mac", lambda *a, **k: macs.append(
        (a[2].shape[0], k.get("tiles", a[10] if len(a) > 10 else None) is not None)) or mac(*a, **k))
    outs = []
    for kw in (dict(sched=sched, tiles=params["tap_tiles"]), dict(sched=sched), {}):
        r = ring.clone()
        outs.append(tfs.fused_stream(sig, r, params["filt_rim"], 5, dcfix, cs, abt, **kw)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    # the table's walk takes windows TILES_WINDOWS times longer: 16, 14 blocks against 8, 8, 8, 6
    assert macs == [(16, True), (14, True)] + [(8, False)] * 3 + [(6, False)] + [(8, False)] * 3 + [(6, False)]


def test_snapshot_carries_the_step_counters():
    from neojax_torch import kernels

    counters = trace.snapshot()["counters"]
    assert counters == kernels.counters()
    assert set(counters) == {"stream_mac.steps_run", "stream_mac.steps_dense"}
