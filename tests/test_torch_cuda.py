"""neojax_torch's CUDA kernels against their plain PyTorch versions, on the
card, at shapes the headline smoke (``chip_smoke.py``) does not cover: odd
P, C and K, per-channel fused filters, the largest fused block (1024), ring
wraps, B1 at the hybrid head's non-packed K = B+1, B5 (the nested meta MAC)
at every storage and group count, B3 with its ``acc_add`` seed, B4 (the
tile-sparse MAC) and B2/B3 with the sparse chunk schedule — each also
against the dense kernel on the same masked filter — and the convolver's
(dense and sparse), nested engine's and hybrid engine's CUDA routes against
their CPU routes.

Marked ``cuda``: every test skips without a CUDA device (decided in the
``cuda`` fixture, never at import). The file imports no JAX, so on a card
without JAX run it apart from ``tests/conftest.py`` (which imports JAX):
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.

Tolerance: ``_TOL``, max|kernel - plain| / max|plain| (the storage ladder of
``tests/test_fused_step.py``); the int rings to one LSB.
"""

import numpy as np
import pytest
import torch

from neojax_torch import conv
from neojax_torch.conv import convolver as cv
from neojax_torch.fft import matmul_backend as mb
from neojax_torch.kernels import fdl_mac as mac
from neojax_torch.kernels import fused_step as fs
from neojax_torch.kernels import nested_mac as nm
from neojax_torch.kernels import sparse_mac as sm

_TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_DT = {"split": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16, "int8": torch.int8}
_INT_MAX = {"int16": 32767, "int8": 127}
_STORAGES = ["split", "bf16", "int16", "int8"]


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _ring(rng, storage, p, c, k, dev):
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        ring = torch.from_numpy(rng.integers(-m, m + 1, (2, p, c, k))).to(dev, _DT[storage])
        scales = torch.from_numpy(rng.uniform(0.5, 4.0, (p, c)).astype(np.float32)).to(dev)
        return ring, scales
    ring = torch.from_numpy(rng.standard_normal((2, p, c, k)).astype(np.float32)).to(dev, _DT[storage])
    return ring, None


def _same_ring(storage, a, b, sa, sb):
    if storage in _INT_MAX:
        assert int((a.int() - b.int()).abs().max()) <= 1
        assert _rel(sa, sb) < 1e-5
    else:
        assert _rel(a.float(), b.float()) < _TOL[storage]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
def test_fdl_mac_kernel_matches_plain(cuda, rng, storage, cf):
    p, c, k = 7, 3, 200  # K not a multiple of the CTA width
    ring, scales = _ring(rng, storage, p, c, k, cuda)
    fr = torch.from_numpy(rng.standard_normal((p, cf, k)).astype(np.float32)).to(cuda)
    fi = torch.from_numpy(rng.standard_normal((p, cf, k)).astype(np.float32)).to(cuda)
    before = mac.fdl_mac.launches
    got = mac.fdl_mac(ring, fr, fi, scales)
    torch.cuda.synchronize()
    assert mac.fdl_mac.launches == before + 1
    want = mac.fdl_mac_reference(ring, fr, fi, scales)
    assert _rel(torch.cat(got), torch.cat(want)) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
@pytest.mark.parametrize("b", [64, 1024])
def test_fused_block_step_kernel_matches_plain(cuda, rng, storage, cf, b):
    p, c = 5, 3
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, cf, 2 * b))).astype(np.float32)).to(cuda, mdt)
    cs, ab = mb.packed_mats(2 * b, mdt, cuda)
    for pos in range(p):
        frame = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * b)).astype(np.float32)).to(cuda)
        dcfix = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32)).to(cuda)
        k_ring, p_ring = ring.clone(), ring.clone()
        k_s = None if scales is None else scales.clone()
        p_s = None if scales is None else scales.clone()
        ky = fs.fused_block_step(frame, k_ring, rim, pos, dcfix, cs, ab, k_s)[0]
        py = fs.fused_block_step_reference(frame, p_ring, rim, pos, dcfix, cs, ab, p_s)[0]
        torch.cuda.synchronize()
        assert _rel(ky, py) < _TOL[storage]
        _same_ring(storage, k_ring, p_ring, k_s, p_s)
        ring, scales = p_ring, p_s


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
def test_fused_stream_kernel_matches_plain(cuda, rng, storage, cf):
    p, c, b, nb, pos0 = 5, 3, 64, 12, 3  # wraps the ring twice
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, cf, 2 * b))).astype(np.float32)).to(cuda, mdt)
    cs, abt = mb.packed_stream_mats(2 * b, mdt, cuda)
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(cuda)
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(cuda)
    k_ring, p_ring = ring.clone(), ring.clone()
    k_s = None if scales is None else scales.clone()
    p_s = None if scales is None else scales.clone()
    ko = fs.fused_stream(sigpad, k_ring, rim, pos0, dcfix, cs, abt, k_s)[0]
    po = fs.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix, cs, abt, p_s)[0]
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, k_ring, p_ring, k_s, p_s)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
def test_fdl_mac_kernel_unpacked_head_bins(cuda, rng, storage):
    """The hybrid's unfused head: P = S partitions, K = B + 1 bins."""
    p, c, k = 16, 3, 65
    ring, scales = _ring(rng, storage, p, c, k, cuda)
    fr = torch.from_numpy(rng.standard_normal((p, 1, k)).astype(np.float32)).to(cuda)
    fi = torch.from_numpy(rng.standard_normal((p, 1, k)).astype(np.float32)).to(cuda)
    got = mac.fdl_mac(ring, fr, fi, scales)
    want = mac.fdl_mac_reference(ring, fr, fi, scales)
    assert _rel(torch.cat(got), torch.cat(want)) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("storage,g", [("split", None), ("bf16", None), ("int16", 1), ("int16", 5),
                                       ("int16", 10), ("int8", 1), ("int8", 5), ("int8", 10)])
def test_nested_mac_kernel_matches_plain(cuda, rng, storage, g):
    p2, c, k, l = 5, 3, 33, 10  # C*K*L not a multiple of the CTA width
    if storage in _INT_MAX:
        m = _INT_MAX[storage]
        planes = torch.from_numpy(rng.integers(-m, m + 1, (2, p2, c, k, l))).to(cuda, _DT[storage])
        scales = torch.from_numpy(rng.uniform(0.5, 4.0, (p2, c, k, g)).astype(np.float32)).to(cuda)
    else:
        planes = torch.from_numpy(rng.standard_normal((2, p2, c, k, l)).astype(np.float32)).to(cuda, _DT[storage])
        scales = None
    tiled = torch.from_numpy(rng.standard_normal((2, 2 * p2, 1, k, l)).astype(np.float32)).to(cuda)
    for pos in (0, p2 - 1):  # the rotated view of a tiled filter, as the engine passes it
        fr = tiled[0, p2 - 1 - pos : 2 * p2 - 1 - pos, 0]
        fi = tiled[1, p2 - 1 - pos : 2 * p2 - 1 - pos, 0]
        before = nm.nested_mac.launches
        got = nm.nested_mac(planes, scales, fr, fi)
        torch.cuda.synchronize()
        assert nm.nested_mac.launches == before + 1
        want = nm.nested_mac_reference(planes, scales, fr, fi)
        assert _rel(torch.cat(got), torch.cat(want)) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
def test_fused_stream_acc_add_matches_plain(cuda, rng, storage):
    p, c, b, nb, pos0 = 6, 3, 64, 8, 4
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, 1, 2 * b))).astype(np.float32)).to(cuda, mdt)
    cs, abt = mb.packed_stream_mats(2 * b, mdt, cuda)
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(cuda)
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(cuda)
    seed = torch.from_numpy((5 * rng.standard_normal((nb, 2, c, b))).astype(np.float32)).to(cuda)
    k_ring, p_ring = ring.clone(), ring.clone()
    k_s = None if scales is None else scales.clone()
    p_s = None if scales is None else scales.clone()
    ko = fs.fused_stream(sigpad, k_ring, rim, pos0, dcfix, cs, abt, k_s, acc_add=seed)[0]
    po = fs.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix, cs, abt, p_s, acc_add=seed)[0]
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, k_ring, p_ring, k_s, p_s)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
def test_nested_and_hybrid_cuda_route_match_cpu_route(cuda, rng, storage):
    from neojax_torch.conv import hybrid as hy
    from neojax_torch.conv import nested as ne

    b, p, c, s = 64, 19, 3, 4
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    sig = rng.uniform(-1, 1, (c, 5 * s * b - 9)).astype(np.float32)
    cfg = cv.PartitionedConfig(b, p, c, storage=storage)
    for build, init, run in ((ne.nested_filter_params, ne.nested_init_state, ne.process_nested),
                             (hy.hybrid_filter_params, hy.hybrid_init_state, hy.process_hybrid)):
        outs = []
        for dev in ("cpu", cuda):
            params = build(cfg, parts, s, device=dev)
            outs.append(run(cfg, params, init(cfg, params), torch.from_numpy(sig).to(dev))[1])
        assert outs[1].device.type == "cuda"
        assert _rel(outs[1], outs[0]) < max(_TOL[storage], 1e-5)
    params = hy.hybrid_filter_params(cfg, parts, s, device=cuda)
    stream = hy.HybridStream(cfg, params)
    unfused = {k: v for k, v in params.items() if k != "head_packed"}
    _, ref = hy.process_hybrid(cfg, unfused, hy.hybrid_init_state(cfg, unfused),
                               torch.from_numpy(sig[:, : 2 * s * b]).to(cuda))
    got = torch.cat([stream(torch.from_numpy(sig[:, i * b : (i + 1) * b]).to(cuda))
                     for i in range(2 * s)], dim=-1)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["split", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("fused", [None, False])
def test_convolver_cuda_route_matches_cpu_route(cuda, rng, storage, scheme, fused):
    b, p, c = 64, 6, 3
    parts = ((rng.standard_normal((c, p, b + 1)) + 1j * rng.standard_normal((c, p, b + 1))) * 0.1
             ).astype(np.complex64)
    sig = rng.uniform(-1, 1, (c, 9 * b + 5)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        cfg = cv.PartitionedConfig(b, p, c, scheme=scheme, storage=storage, fused=fused)
        params = cv.filter_params(cfg, parts, device=dev)
        state, out = cv.process(cfg, params, cv.init_state(cfg, dev), torch.from_numpy(sig).to(dev))
        outs.append(out)
    assert _rel(outs[1], outs[0]) < _TOL[storage]


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    ring = torch.zeros((2, 4, 2, 8), dtype=torch.float64, device=cuda)
    f = torch.zeros((4, 1, 8), device=cuda)
    with pytest.raises(TypeError):
        mac.fdl_mac(ring, f, f)
    with pytest.raises(ValueError, match="one device"):
        mac.fdl_mac(ring.float(), f.cpu(), f)
    c = conv.Convolver(device=cuda)
    assert c._storage == "split"
    planes = torch.zeros((2, 2, 2, 3, 4), dtype=torch.int8, device=cuda)
    f = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(ValueError, match="scales"):
        nm.nested_mac(planes, None, f, f)
    with pytest.raises(ValueError, match="one device"):
        nm.nested_mac(planes.float(), None, f.cpu(), f)


def _lane_band_mask(p, k, keep):
    """The first ``keep`` of the partitions, each with a cutoff falling with
    the partition (chunks and lane widths both skip)."""
    mask = np.zeros((p, k), bool)
    for i in range(int(p * keep)):
        mask[i, : max(8, int(k * (1.0 - i / p)))] = True
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
@pytest.mark.parametrize("k,pc,kt", [(130, 4, 128), (512, 8, 256), (513, 2, 256), (200, 16, 64)])
def test_sparse_fdl_mac_kernel_matches_plain_and_dense(cuda, rng, storage, cf, k, pc, kt):
    """B4 against its plain version, and against B1 on the masked filter
    (every skipped product is an exact zero); lanes of unvisited tiles 0."""
    p, c = 16, 3
    mask = _lane_band_mask(p, k, 0.6)
    sched = sm.build_sparse_schedule(mask, pc, kt)
    tables = [torch.from_numpy(sched[key]).to(cuda) for key in ("k_idx", "p_idx", "flags")]
    ring, scales = _ring(rng, storage, p, c, k, cuda)
    m = torch.from_numpy(mask).to(cuda)[:, None, :]
    fr = torch.from_numpy(rng.standard_normal((p, cf, k)).astype(np.float32)).to(cuda) * m
    fi = torch.from_numpy(rng.standard_normal((p, cf, k)).astype(np.float32)).to(cuda) * m
    tr, ti = torch.cat([fr.flip(0)] * 2), torch.cat([fi.flip(0)] * 2)
    for pos in (0, 5, p - 1):
        rr, ri = tr[p - 1 - pos : 2 * p - 1 - pos], ti[p - 1 - pos : 2 * p - 1 - pos]
        before = sm.sparse_fdl_mac.launches
        got = sm.sparse_fdl_mac(ring, rr, ri, pos, *tables, scales, p_chunk=pc, k_tile=kt)
        torch.cuda.synchronize()
        assert sm.sparse_fdl_mac.launches == before + 1
        want = sm.sparse_fdl_mac_reference(ring, rr, ri, pos, *tables, scales, p_chunk=pc, k_tile=kt)
        assert _rel(torch.cat(got), torch.cat(want)) < 2e-6
        dense = mac.fdl_mac(ring, rr, ri, scales)
        assert torch.equal(torch.cat(got), torch.cat(dense))


def _sparse_fused_inputs(cuda, rng, storage, cf, p, c, b):
    parts = ((rng.standard_normal((cf, p, b + 1)) + 1j * rng.standard_normal((cf, p, b + 1))) * 0.1
             ).astype(np.complex64)
    cfg = cv.PartitionedConfig(b, p, c, storage=storage)
    params = cv.filter_params(cfg, parts, sparsity=_lane_band_mask(p, b + 1, 0.5), device=cuda)
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    return params, ring, scales


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
@pytest.mark.parametrize("p", [24, 20])
def test_fused_block_step_sched_matches_plain_and_dense(cuda, rng, monkeypatch, storage, cf, p):
    """B2 with the chunk schedule (8-row chunks at P = 24, 1-row at P = 20;
    two lane widths at B = 256): within TOL of its plain version, and equal
    to the dense B2 on the same masked filter."""
    monkeypatch.setattr(fs, "_CHUNK_TARGET", 1)
    c, b = 3, 256
    params, ring, scales = _sparse_fused_inputs(cuda, rng, storage, cf, p, c, b)
    sched = (params["sp_c_idx"], params["sp_c_flags"])
    assert int((params["sp_c_flags"] == 1).sum(1).min()) < p // fs.fused_chunk_rows(ring.dtype, p, c, b)
    cs, ab = mb.packed_mats(2 * b, fs.MATRIX_DTYPES[_DT[storage]], cuda)
    for pos in (0, 7, p - 1):
        frame = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * b)).astype(np.float32)).to(cuda)
        dcfix = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32)).to(cuda)
        rings = [ring.clone() for _ in range(3)]
        scl = [None if scales is None else scales.clone() for _ in range(3)]
        before = fs.fused_block_step.sched_launches
        ky = fs.fused_block_step(frame, rings[0], params["filt_rim"], pos, dcfix, cs, ab, scl[0], sched)[0]
        py = fs.fused_block_step_reference(frame, rings[1], params["filt_rim"], pos, dcfix, cs, ab, scl[1],
                                           sched)[0]
        dy = fs.fused_block_step(frame, rings[2], params["filt_rim"], pos, dcfix, cs, ab, scl[2])[0]
        torch.cuda.synchronize()
        assert fs.fused_block_step.sched_launches == before + 1
        assert _rel(ky, py) < _TOL[storage]
        _same_ring(storage, rings[0], rings[1], scl[0], scl[1])
        assert torch.equal(ky, dy) and torch.equal(rings[0], rings[2])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
def test_fused_stream_sched_matches_plain_and_dense(cuda, rng, monkeypatch, storage, cf):
    monkeypatch.setattr(fs, "_CHUNK_TARGET", 1)
    p, c, b, nb, pos0 = 24, 3, 256, 30, 20  # wraps the ring
    params, ring, scales = _sparse_fused_inputs(cuda, rng, storage, cf, p, c, b)
    sched = (params["sp_c_idx"], params["sp_c_flags"])
    cs, abt = mb.packed_stream_mats(2 * b, fs.MATRIX_DTYPES[_DT[storage]], cuda)
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(cuda)
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(cuda)
    rings = [ring.clone() for _ in range(3)]
    scl = [None if scales is None else scales.clone() for _ in range(3)]
    ko = fs.fused_stream(sigpad, rings[0], params["filt_rim"], pos0, dcfix, cs, abt, scl[0], sched)[0]
    po = fs.fused_stream_reference(sigpad, rings[1], params["filt_rim"], pos0, dcfix, cs, abt, scl[1],
                                   sched)[0]
    do = fs.fused_stream(sigpad, rings[2], params["filt_rim"], pos0, dcfix, cs, abt, scl[2])[0]
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, rings[0], rings[1], scl[0], scl[1])
    assert torch.equal(ko, do) and torch.equal(rings[0], rings[2])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("route", ["fused", "call", "unfused", "unpacked"])
def test_sparse_convolver_cuda_route_matches_cpu_route(cuda, rng, monkeypatch, storage, route):
    """The masked convolver on the card against its CPU route: ``process``
    (B3 + schedule), ``__call__``-style steps (B2 + schedule), ``fused=False``
    (B4, K = B) and ``packed=False`` (B4, K = B + 1); each route's sparse
    kernel launches."""
    from neojax_torch import kernels

    monkeypatch.setattr(fs, "_CHUNK_TARGET", 1)
    b, p, c = 64, 24, 3
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    mask = _lane_band_mask(p, b + 1, 0.4)
    sig = rng.uniform(-1, 1, (c, 30 * b)).astype(np.float32)
    kw = {"fused": dict(), "call": dict(), "unfused": dict(fused=False), "unpacked": dict(packed=False)}[route]
    outs = []
    for dev in ("cpu", cuda):
        cfg = cv.PartitionedConfig(b, p, c, storage=storage, **kw)
        params = cv.filter_params(cfg, parts, sparsity=mask, device=dev)
        state = cv.init_state(cfg, dev)
        x = torch.from_numpy(sig).to(dev)
        kernels.reset_launch_counts()
        if route == "call":
            ys = []
            for i in range(30):
                state, y = cv.step(cfg, params, state, x[:, i * b : (i + 1) * b])
                ys.append(y)
            outs.append(torch.cat(ys, dim=-1))
        else:
            outs.append(cv.process(cfg, params, state, x)[1])
    counts = kernels.launch_counts()
    want = {"fused": "fused_stream_sched", "call": "fused_block_step_sched"}.get(route, "sparse_fdl_mac")
    assert counts[want] > 0 and counts["fdl_mac"] == 0
    assert _rel(outs[1], outs[0]) < max(_TOL[storage], 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,c,k", [(24, 3, 200), (960, 2, 512), (5, 1, 7)])
def test_probe_ring_read_kernel_matches_plain(cuda, rng, dt, p, c, k):
    from neojax_torch.kernels import probes

    fdl = torch.from_numpy(rng.standard_normal((2, p, c, k)).astype(np.float32)).to(cuda, dt)
    fr = torch.from_numpy(rng.standard_normal((p, k)).astype(np.float32)).to(cuda)
    _, pc = mac.choose_chunks(dt, p, c, k)
    before = probes.probe_ring_read.launches
    got = probes.probe_ring_read(fdl, fr, pc)
    want = probes.probe_ring_read_reference(fdl, fr, pc)
    torch.cuda.synchronize()
    assert probes.probe_ring_read.launches == before + 1
    for g, w in zip(got, want):
        assert _rel(g, w) < 2e-5  # f32 sums of exact (bf16 or f32) values


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["empty", "win_fwd", "win_fwd_inv"])
@pytest.mark.parametrize("c,b,nb", [(3, 64, 5), (2, 1024, 3)])
def test_probe_stream_kernel_matches_plain(cuda, rng, dt, mode, c, b, nb):
    from neojax_torch.kernels import probes

    sig = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(cuda)
    cs, abt = mb.packed_stream_mats(2 * b, dt, cuda)
    before = probes.probe_stream.launches
    got = probes.probe_stream(sig, cs, abt, mode)
    want = probes.probe_stream_reference(sig, cs, abt, mode)
    torch.cuda.synchronize()
    assert probes.probe_stream.launches == before + 1
    if mode == "empty":
        assert not got.any()
    else:
        assert _rel(got, want) < (_TOL["split"] if dt == torch.float32 else _TOL["bf16"])
