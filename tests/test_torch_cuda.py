"""neojax_torch's CUDA kernels against their plain PyTorch versions, on the
card, at shapes the headline smoke (``chip_smoke.py``) does not cover: odd
P, C and K, per-channel fused filters, the largest fused block (1024), ring
wraps, B1 at the hybrid head's non-packed K = B+1, B1 and B4 split over P
(the ordered reduce, an unaligned filter view), B5 (the nested meta MAC)
at every storage and group count, the nested engine's meta push bit for
bit against its plain version, B3 with its ``acc_add`` seed, B4 (the
tile-sparse MAC) and B2/B3 with the sparse chunk schedule — each also
against the dense kernel on the same masked filter — and the convolver's
(dense and sparse), nested engine's and hybrid engine's CUDA routes against
their CPU routes. Also the float32 products that run outside the kernels
(the chunked engine's split and bf16 products, ``direct_convolve``, the
``"matmul"`` DFT backend) with the caller's TF32 flags forced on, each
against its CPU route or a float64 oracle at a bound TF32 would miss, and
``make_engine``'s four engines and ``convolve``'s seven methods on the
card. Also the fft/core/ops surface on the card (the transforms against
float64 with TF32 on, the fixed-point ops bit for bit against the CPU,
``debug.checked``, host input going to the card), a checkpoint saved and
resumed on the card, the CLI on the card against its ``--device cpu``
run, and ``io.StreamExecutor`` around a card ``HybridStream``.

Marked ``cuda``: every test skips without a CUDA device (decided in the
``cuda`` fixture, never at import). The file imports no JAX, so on a card
without JAX run it apart from ``tests/conftest.py`` (which imports JAX):
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.

Tolerance: ``_TOL``, max|kernel - plain| / max|plain| (the storage ladder of
``tests/test_fused_step.py``); the int rings to one LSB.
"""

import time

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


def _ring_plain(mdt, x, fwd):
    """(x, fwd) of the plain run the ring and its scales are held against.
    With bf16 matrices the transform kernels compute the f32 DFT of the
    bf16-rounded frames, whose twiddles are more exact than the bf16 matrix
    (ROADMAP §C): the ring and scales (the spectrum's peak) then go against
    the plain pipeline on the f32 forward matrix of those rounded frames,
    while the output stays held against the plain version as it is."""
    if mdt != torch.bfloat16:
        return x, fwd
    n = fwd.shape[1]
    mats = mb.packed_mats if fwd.ndim == 3 else mb.packed_stream_mats
    return x.to(torch.bfloat16).float(), mats(n, torch.float32, fwd.device)[0]


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
        r_ring, r_s = ring.clone(), None if scales is None else scales.clone()
        ky = fs.fused_block_step(frame, k_ring, rim, pos, dcfix, cs, ab, k_s)[0]
        py = fs.fused_block_step_reference(frame, p_ring, rim, pos, dcfix, cs, ab, p_s)[0]
        x_r, cs_r = _ring_plain(mdt, frame, cs)
        fs.fused_block_step_reference(x_r, r_ring, rim, pos, dcfix, cs_r, ab, r_s)
        torch.cuda.synchronize()
        assert _rel(ky, py) < _TOL[storage]
        _same_ring(storage, k_ring, r_ring, k_s, r_s)
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
    x_r, cs_r = _ring_plain(mdt, sigpad, cs)
    ko = fs.fused_stream(sigpad, k_ring, rim, pos0, dcfix, cs, abt, k_s)[0]
    po = fs.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix, cs, abt, p_s)[0]
    r_ring, r_s = ring.clone(), None if scales is None else scales.clone()
    fs.fused_stream_reference(x_r, r_ring, rim, pos0, dcfix, cs_r, abt, r_s)
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, k_ring, r_ring, k_s, r_s)


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
    x_r, cs_r = _ring_plain(mdt, sigpad, cs)
    ko = fs.fused_stream(sigpad, k_ring, rim, pos0, dcfix, cs, abt, k_s, acc_add=seed)[0]
    po = fs.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix, cs, abt, p_s, acc_add=seed)[0]
    r_ring, r_s = ring.clone(), None if scales is None else scales.clone()
    fs.fused_stream_reference(x_r, r_ring, rim, pos0, dcfix, cs_r, abt, r_s, acc_add=seed)
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, k_ring, r_ring, k_s, r_s)


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
def test_nested_mac_span_counts_its_launches(cuda, rng, monkeypatch):
    """``kernels.nested_mac`` spans one call a B5 launch, in the nested
    engine (one a chunk, as ``nested.push``) and in the hybrid engine's
    tail; the spans change no output on the card."""
    import contextlib

    from neojax_torch import trace
    from neojax_torch.conv import nested as ne

    b, p, c, s, chunks = 64, 19, 3, 4, 5
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, chunks * s * b)).astype(np.float32)).to(cuda)

    def calls(name):
        return trace.totals().get(name, {"calls": 0})["calls"]

    outs = []
    for engine in ("nested", "hybrid"):
        eng = conv.make_engine(engine, parts, storage="int8", chunk_blocks=s, channels=c, device=cuda)
        spans, pushes, launches = calls("kernels.nested_mac"), calls("nested.push"), nm.nested_mac.launches
        outs.append(eng.process(sig))
        torch.cuda.synchronize()
        got = calls("kernels.nested_mac") - spans
        assert got == nm.nested_mac.launches - launches and got >= chunks
        if engine == "nested":
            assert got == calls("nested.push") - pushes == chunks
    fake = type("NoTrace", (), {"span": staticmethod(lambda name: contextlib.nullcontext())})
    monkeypatch.setattr(ne, "trace", fake)
    monkeypatch.setattr(nm, "trace", fake)
    eng = conv.make_engine("nested", parts, storage="int8", chunk_blocks=s, channels=c, device=cuda)
    assert torch.equal(eng.process(sig), outs[0])


def _meta_row(rng, c, k, l, g, storage):
    """A complex64 [C, K, L] meta row with an all-zero (c, k), one whose
    quotients land on n + 1/2 exactly (x = 4 fl((n + 1/2) / int_max) in
    groups of peak 4) and one a rounding away from its peak (the clamp)."""
    z = (rng.standard_normal((c, k, l)) + 1j * rng.standard_normal((c, k, l))).astype(np.complex64) * 3
    z[0, 0] = 0
    if storage in _INT_MAX:
        steps = (np.arange(l) % 126 + 0.5).astype(np.float32)
        half = (steps / np.float32(_INT_MAX[storage])).astype(np.float32) * np.float32(4)
        half[:: l // g] = 4.0
        z[0, 1] = half - 1j * half
        z[1, 0, ::2] = np.float32(7.0) * (1 + 1j)
        z[1, 0, 1::2] = np.nextafter(np.float32(7.0), np.float32(0)) * (1 - 1j)
    return z


@pytest.mark.cuda
@pytest.mark.parametrize("storage,l,g", [
    ("int8", 256, 64), ("int8", 128, 64), ("int8", 16, 16), ("int8", 10, 5), ("int8", 6, 2),
    ("int16", 256, 1), ("int16", 12, 1), ("int16", 2048, 1), ("int16", 256, 64),
    ("split", 256, None), ("split", 6, None), ("bf16", 256, None), ("bf16", 10, None),
])
@pytest.mark.parametrize("layout", ["complex_views", "planes", "unaligned_views"])
def test_meta_push_kernel_is_bit_equal_to_reference(cuda, rng, storage, l, g, layout):
    """The push kernel writes the reference's bits into the ring slot and
    its scales (W = L/G bins a group: 4 at the cell, 2, 1, 3 and wider than
    a warp or a CTA), from the meta-FFT's .real/.imag views, from two
    contiguous planes, and from views 8 bytes off a 16-byte boundary."""
    from neojax_torch.kernels import meta_push as mp

    p2, c, k = 3, 3, 33  # C*K*G not a multiple of the CTA width
    z = _meta_row(rng, c, k, l + (layout == "unaligned_views"), g, storage)
    zt = torch.from_numpy(z).to(cuda)
    if layout == "unaligned_views":
        zt = zt[..., 1:]
    xre, xim = (zt.real, zt.imag) if layout != "planes" else (zt.real.contiguous(), zt.imag.contiguous())
    fdl = torch.from_numpy(rng.integers(-100, 100, (2, p2, c, k, l))).to(cuda, _DT[storage])
    scales = None if g is None else torch.from_numpy(rng.uniform(1, 2, (p2, c, k, g)).astype(np.float32)).to(cuda)
    want_f, want_s = fdl.clone(), None if scales is None else scales.clone()
    for pos in (0, p2 - 1):
        before = mp.meta_push.launches
        mp.meta_push(fdl, scales, pos, xre, xim)
        torch.cuda.synchronize()
        assert mp.meta_push.launches == before + 1
        mp.meta_push_reference(want_f, want_s, pos, xre, xim)
        assert torch.equal(fdl, want_f)
        assert scales is None or torch.equal(scales, want_s)
    cpu_f, cpu_s = want_f.cpu(), None if want_s is None else want_s.cpu()
    mp.meta_push(cpu_f, cpu_s, 1, xre.cpu(), xim.cpu())  # the CPU reference gives the same bits
    mp.meta_push(fdl, scales, 1, xre, xim)
    assert torch.equal(fdl.cpu(), cpu_f) and (scales is None or torch.equal(scales.cpu(), cpu_s))
    if g is not None:
        assert bool((scales[0, 0, 0] == 1).all()) and int(fdl[:, 0].abs().max()) == _INT_MAX[storage]


@pytest.mark.cuda
def test_meta_push_counts_every_push_and_writes_the_reference_ring(cuda, rng, monkeypatch):
    """``meta_push.launches`` counts one launch a ``nested.push`` span in
    the nested engine and one a tail chunk (a B5 launch) in the hybrid
    engine; after each push of a nested call the ring and scales are those
    the reference push writes from the same meta-FFT output."""
    from neojax_torch import trace
    from neojax_torch.conv import nested as ne
    from neojax_torch.kernels import meta_push as mp

    b, p, c, s, chunks = 64, 19, 3, 4, 5
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, chunks * s * b)).astype(np.float32)).to(cuda)

    def calls(name):
        return trace.totals().get(name, {"calls": 0})["calls"]

    for engine, span in (("nested", "nested.push"), ("hybrid", "kernels.nested_mac")):
        eng = conv.make_engine(engine, parts, storage="int8", chunk_blocks=s, channels=c, device=cuda)
        spans, launches = calls(span), mp.meta_push.launches
        eng.process(sig)
        torch.cuda.synchronize()
        assert mp.meta_push.launches - launches == calls(span) - spans > 0
    checked = []

    def held(fdl, scales, pos, xre, xim):
        ref_f, ref_s = fdl.clone(), scales.clone()
        mp.meta_push_reference(ref_f, ref_s, pos, xre, xim)
        mp.meta_push(fdl, scales, pos, xre, xim)
        checked.append(torch.equal(fdl, ref_f) and torch.equal(scales, ref_s))

    monkeypatch.setattr(ne, "meta_push", held)
    eng = conv.make_engine("nested", parts, storage="int8", chunk_blocks=s, channels=c, device=cuda)
    eng.process(sig)
    assert checked == [True] * chunks


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


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
@pytest.mark.parametrize("k", [512, 513, 40])
def test_fdl_mac_split_p_kernel_matches_plain(cuda, rng, storage, cf, k):
    """P = 200: three P splits (67, 67, 66 slots) added in split order by
    the second launch; a rotated view of a tiled filter, as the convolver
    passes it; the same bits on a second call (no atomics)."""
    p, c = 200, 3
    assert mac.step_geometry(p, c, k, 4, mac._MIN_SPLIT, mac._MAC_CTAS)[:2] == (3, 67)
    ring, scales = _ring(rng, storage, p, c, k, cuda)
    tiled = torch.from_numpy(rng.standard_normal((2, 2 * p, cf, k)).astype(np.float32)).to(cuda)
    for pos in (0, 77):
        fr, fi = tiled[0, p - 1 - pos : 2 * p - 1 - pos], tiled[1, p - 1 - pos : 2 * p - 1 - pos]
        before = mac.fdl_mac.launches
        got = mac.fdl_mac(ring, fr, fi, scales)
        again = mac.fdl_mac(ring, fr, fi, scales)
        torch.cuda.synchronize()
        assert mac.fdl_mac.launches == before + 2
        assert torch.equal(torch.cat(got), torch.cat(again))
        want = mac.fdl_mac_reference(ring, fr, fi, scales)
        assert _rel(torch.cat(got), torch.cat(want)) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
def test_fdl_mac_kernel_unaligned_filter_view(cuda, rng, storage):
    """A filter view 4 bytes past an aligned start takes the one-lane
    loads; V only regroups the lanes, so the bits equal the aligned run's."""
    p, c, k = 130, 3, 64
    ring, scales = _ring(rng, storage, p, c, k, cuda)
    flat = torch.from_numpy(rng.standard_normal(2 * p * k + 1).astype(np.float32)).to(cuda)
    fr, fi = flat[1 : p * k + 1].view(p, 1, k), flat[p * k + 1 :].view(p, 1, k)
    assert fr.data_ptr() % 16 != 0 and mac.mac_geometry(ring, fr, fi)[2] == 1
    got = mac.fdl_mac(ring, fr, fi, scales)
    aligned = mac.fdl_mac(ring, fr.clone(), fi.clone(), scales)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(got), torch.cat(aligned))
    assert _rel(torch.cat(got), torch.cat(mac.fdl_mac_reference(ring, fr, fi, scales))) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("k,kt", [(512, 256), (513, 256), (40, 40)])
def test_sparse_fdl_mac_split_p_equals_dense_on_masked_filter(cuda, rng, storage, k, kt):
    """B4 at P = 200 (three splits, chunks of 8 that straddle them) with
    the tile-live table and without it (derived for the call): within the
    plain version's tolerance, and equal to B1 on the masked filter, max
    abs difference 0.0."""
    p, c, pc = 200, 3, 8
    mask = _lane_band_mask(p, k, 0.6)
    sched = sm.build_sparse_schedule(mask, pc, kt)
    tables = [torch.from_numpy(sched[key]).to(cuda) for key in ("k_idx", "p_idx", "flags")]
    live = sm.tile_live_table(*tables, p // pc, -(-k // kt))
    ring, scales = _ring(rng, storage, p, c, k, cuda)
    m = torch.from_numpy(mask).to(cuda)[:, None, :]
    f = [torch.from_numpy(rng.standard_normal((p, 1, k)).astype(np.float32)).to(cuda) * m for _ in range(2)]
    tr, ti = (torch.cat([x.flip(0)] * 2) for x in f)
    for pos in (0, 100, p - 1):
        rr, ri = tr[p - 1 - pos : 2 * p - 1 - pos], ti[p - 1 - pos : 2 * p - 1 - pos]
        got = sm.sparse_fdl_mac(ring, rr, ri, pos, *tables, scales, p_chunk=pc, k_tile=kt, live=live)
        derived = sm.sparse_fdl_mac(ring, rr, ri, pos, *tables, scales, p_chunk=pc, k_tile=kt)
        dense = mac.fdl_mac(ring, rr, ri, scales)
        want = sm.sparse_fdl_mac_reference(ring, rr, ri, pos, *tables, scales, p_chunk=pc, k_tile=kt)
        torch.cuda.synchronize()
        assert _rel(torch.cat(got), torch.cat(want)) < 2e-6
        assert float((torch.cat(got) - torch.cat(dense)).abs().max()) == 0.0
        assert torch.equal(torch.cat(got), torch.cat(derived))


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
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    cs, ab = mb.packed_mats(2 * b, mdt, cuda)
    for pos in (0, 7, p - 1):
        frame = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * b)).astype(np.float32)).to(cuda)
        dcfix = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32)).to(cuda)
        rings = [ring.clone() for _ in range(4)]
        scl = [None if scales is None else scales.clone() for _ in range(4)]
        before = fs.fused_block_step.sched_launches
        stages_before = _stage_counts()
        ky = fs.fused_block_step(frame, rings[0], params["filt_rim"], pos, dcfix, cs, ab, scl[0], sched)[0]
        stages_after = _stage_counts()
        py = fs.fused_block_step_reference(frame, rings[1], params["filt_rim"], pos, dcfix, cs, ab, scl[1],
                                           sched)[0]
        dy = fs.fused_block_step(frame, rings[2], params["filt_rim"], pos, dcfix, cs, ab, scl[2])[0]
        x_r, cs_r = _ring_plain(mdt, frame, cs)
        fs.fused_block_step_reference(x_r, rings[3], params["filt_rim"], pos, dcfix, cs_r, ab, scl[3], sched)
        torch.cuda.synchronize()
        assert fs.fused_block_step.sched_launches == before + 1
        # the counts the C call made as it launched: every B2 stage and the widths once
        assert {k: stages_after[k] - stages_before[k] for k in stages_after} == {
            "window_forward": 1, "quantize_rows": 1, "ring_writeback": 1, "sched_widths": 1, "step_mac": 1,
            "step_reduce": 1, "window_inverse": 1, "stream_mac": 0}
        assert _rel(ky, py) < _TOL[storage]
        _same_ring(storage, rings[0], rings[3], scl[0], scl[3])
        assert torch.equal(ky, dy) and torch.equal(rings[0], rings[2])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
def test_fused_stream_sched_matches_plain_and_dense(cuda, rng, monkeypatch, storage, cf):
    """B3 with the mask's tap-tile table: within TOL of the block oracle
    with the mask's chunk schedule, and equal to the dense B3 on the same
    masked filter."""
    monkeypatch.setattr(fs, "_CHUNK_TARGET", 1)
    p, c, b, nb, pos0 = 24, 3, 256, 30, 20  # wraps the ring
    params, ring, scales = _sparse_fused_inputs(cuda, rng, storage, cf, p, c, b)
    sched = (params["sp_c_idx"], params["sp_c_flags"])
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    cs, abt = mb.packed_stream_mats(2 * b, mdt, cuda)
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(cuda)
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(cuda)
    rings = [ring.clone() for _ in range(4)]
    scl = [None if scales is None else scales.clone() for _ in range(4)]
    ko = fs.fused_stream(sigpad, rings[0], params["filt_rim"], pos0, dcfix, cs, abt, scl[0], params["tap_tiles"])[0]
    po = fs.fused_stream_reference(sigpad, rings[1], params["filt_rim"], pos0, dcfix, cs, abt, scl[1],
                                   sched)[0]
    do = fs.fused_stream(sigpad, rings[2], params["filt_rim"], pos0, dcfix, cs, abt, scl[2])[0]
    x_r, cs_r = _ring_plain(mdt, sigpad, cs)
    fs.fused_stream_reference(x_r, rings[3], params["filt_rim"], pos0, dcfix, cs_r, abt, scl[3], sched)
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, rings[0], rings[3], scl[0], scl[3])
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
@pytest.mark.parametrize("p,c,k,fr_off", [
    (24, 3, 200, 0), (960, 2, 512, 0), (5, 1, 7, 0),
    (960, 4, 513, 0),   # the non-packed ring: V = 1
    (64, 64, 513, 0),   # the hybrid head's ring: one split, written by the probe itself
    (150, 64, 256, 0),  # chunk heads off the split boundaries (75 slots a split, pc 30 / 50)
    (960, 2, 512, 1),   # a misaligned filter view: V = 1
])
def test_probe_ring_read_kernel_matches_plain(cuda, rng, dt, p, c, k, fr_off):
    """T1 on B1's grid (S splits and the ordered reduce, V = 4 or 1) against
    its float64 plain version."""
    from neojax_torch.kernels import probes

    fdl = torch.from_numpy(rng.standard_normal((2, p, c, k)).astype(np.float32)).to(cuda, dt)
    flat = torch.from_numpy(rng.standard_normal(fr_off + p * k).astype(np.float32)).to(cuda)
    fr = flat[fr_off:].view(p, k)
    _, pc = mac.choose_chunks(dt, p, c, k)
    assert probes.ring_read_geometry(fdl, fr) == mac.mac_geometry(fdl, fr[:, None], fr[:, None])
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
    if dt == torch.bfloat16 and mode != "empty":
        # the transforms compute in f32 with f32 twiddles (ROADMAP §C): T2
        # at its rounding points (frames, spectrum to bf16) on f32 matrices
        cs32, abt32 = mb.packed_stream_mats(2 * b, torch.float32, cuda)
        spec = sig.to(dt).double().unfold(1, 2 * b, b)[:, :nb] @ cs32.double()
        want = (spec[..., :b] + spec[..., b:] if mode == "win_fwd"
                else spec.float().to(dt).double() @ abt32.double()).float().reshape(c, nb * b)
    torch.cuda.synchronize()
    assert probes.probe_stream.launches == before + 1
    if mode == "empty":
        assert not got.any()
    else:
        assert _rel(got, want) < (_TOL["split"] if dt == torch.float32 else _TOL["bf16"])


def _stage_counts():
    return {f.__name__: f.launches for f in fs.stage_wrappers()}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
def test_stage_kernels_match_plain(cuda, rng, monkeypatch, storage, cf):
    """Each stage kernel of B2/B3 against its plain version on the same
    inputs, at a ragged shape (B = 96 lanes, C = 3, a window of 5 blocks)."""
    monkeypatch.setattr(fs, "_CHUNK_TARGET", 1)
    p, c, b, wc, i0 = 24, 3, 96, 5, 2
    dt, mdt = _DT[storage], fs.MATRIX_DTYPES[_DT[storage]]
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, cf, 2 * b))).astype(np.float32)).to(cuda, mdt)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, (i0 + wc + 2) * b)).astype(np.float32)).to(cuda)
    dcfix = torch.from_numpy(rng.standard_normal((wc, 2, c)).astype(np.float32)).to(cuda)
    seed = torch.from_numpy(rng.standard_normal((wc, 2, c, b)).astype(np.float32)).to(cuda)
    mask = _lane_band_mask(p, b + 1, 0.5)
    params = cv.filter_params(cv.PartitionedConfig(b, p, c, storage=storage), np.ones((1, p, b + 1), np.complex64),
                              sparsity=mask, device=cuda)
    sched = (params["sp_c_idx"], params["sp_c_flags"])
    pc = fs.fused_chunk_rows(dt, p, c, b)
    tol = 2e-6 if mdt == torch.float32 else _TOL["bf16"]
    before = _stage_counts()
    for mat in (mb.packed_stream_mats(2 * b, mdt, cuda)[0], mb.packed_mats(2 * b, mdt, cuda)[0]):
        got = fs.window_forward(sig, mat, i0, wc)
        assert _rel(got, fs.window_forward_reference(sig, mat, i0, wc)) < tol
    x, scl = fs.quantize_rows(got, dt)
    px, pscl = fs.quantize_rows_reference(got, dt)
    torch.cuda.synchronize()
    if storage in _INT_MAX:
        assert int((x.int() - px.int()).abs().max()) <= 1 and _rel(scl, pscl) < 1e-6
    else:
        assert torch.equal(x, px)
    tab = fs.sched_widths(sched, b, pc)
    assert torch.equal(tab, fs.sched_widths_reference(sched, b, pc))
    for tiles, widths in ((None, None), (params["tap_tiles"], (tab, pc))):
        acc = fs.stream_mac(ring, scales, x, scl, rim, dcfix, p - 2, seed, tiles)
        want = fs.stream_mac_reference(ring, scales, x, scl, rim, dcfix, p - 2, seed, tiles)
        assert _rel(acc, want) < _TOL[storage]
        part = fs.step_mac(ring, scales, rim, 7, widths)
        assert _rel(part, fs.step_mac_reference(ring, scales, rim, 7, widths)) < 1e-5
        red = fs.step_reduce(part, dcfix[0], mdt)
        assert _rel(red, fs.step_reduce_reference(part, dcfix[0], mdt)) < tol
    abt = mb.packed_stream_mats(2 * b, mdt, cuda)[1]
    out_k = fs.window_inverse(acc, abt, torch.zeros((c, (i0 + wc) * b), device=cuda), i0)
    out_p = fs.window_inverse_reference(acc, abt, torch.zeros((c, (i0 + wc) * b), device=cuda), i0)
    assert _rel(out_k, out_p) < tol
    k_ring, p_ring = ring.clone(), ring.clone()
    k_s = None if scales is None else scales.clone()
    p_s = None if scales is None else scales.clone()
    fs.ring_writeback(x, scl, k_ring, k_s, p - 2)
    fs.ring_writeback_reference(x, scl, p_ring, p_s, p - 2)
    torch.cuda.synchronize()
    assert torch.equal(k_ring, p_ring) and (scales is None or torch.equal(k_s, p_s))
    after = _stage_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "window_forward": 2, "quantize_rows": 1, "sched_widths": 1, "stream_mac": 2, "step_mac": 2,
        "step_reduce": 2, "window_inverse": 1, "ring_writeback": 1}


# stream_mac at the edges of its kernel's tile (8 lanes x 16 channels, 4
# with per-channel filters, x 64 blocks a CTA; history rows in steps of 16):
# P, wc, C, B, pos_first
_MAC_SHAPES = [(1, 7, 3, 48, 0), (5, 64, 1, 8, 3), (16, 16, 65, 48, 15), (17, 63, 3, 512, 9),
               (64, 64, 64, 512, 0), (960, 64, 64, 512, 955), (960, 1, 65, 1024, 500), (17, 7, 64, 1024, 16)]


def _mac_inputs(rng, storage, p, wc, c, b, cf, dev):
    """A ring, the window's staged rows (quantized as B3 stages them), an
    untiled rim (both halves differ), dcfix and a seed."""
    ring, scales = _ring(rng, storage, p, c, b, dev)
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, cf, 2 * b))).astype(np.float32)).to(dev, mdt)
    spec = torch.from_numpy((3 * rng.standard_normal((wc, c, 2 * b))).astype(np.float32)).to(dev)
    x, scl = fs.quantize_rows(spec, _DT[storage])
    dcfix = torch.from_numpy(rng.standard_normal((wc, 2, c)).astype(np.float32)).to(dev)
    seed = torch.from_numpy(rng.standard_normal((wc, 2, c, b)).astype(np.float32)).to(dev)
    return ring, scales, x, scl, rim, dcfix, seed


def _random_tiles(rng, p, b, dev):
    """A tap-tile table uint8 [P, ceil(B / 8)]: about half its (tap, lane
    tile) pairs live, every third tap dead."""
    tiles = rng.random((p, -(-b // 8))) < 0.5
    tiles[::3] = False
    return torch.from_numpy(tiles.astype(np.uint8)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p,wc,c,b,pos", _MAC_SHAPES)
def test_stream_mac_kernel_matches_plain(cuda, rng, storage, p, wc, c, b, pos):
    """The time-batched MAC against its plain version, Cf = 1 and C, with and
    without a seed and a tap-tile table: P below, at and off a history step,
    windows of 1 to 64 blocks, C off the channel tile, B off the lane tile."""
    for cf in sorted({1, c}):
        ring, scales, x, scl, rim, dcfix, seed = _mac_inputs(rng, storage, p, wc, c, b, cf, cuda)
        tiles = _random_tiles(rng, p, b, cuda)
        for sd in (None, seed):
            for tt in (None, tiles):
                before = fs.stream_mac.launches
                got = fs.stream_mac(ring, scales, x, scl, rim, dcfix, pos, sd, tt)
                want = fs.stream_mac_reference(ring, scales, x, scl, rim, dcfix, pos, sd, tt)
                torch.cuda.synchronize()
                assert fs.stream_mac.launches == before + 1
                assert _rel(got, want) < _TOL[storage], (cf, sd is None, tt is None)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p,pos", [(960, 950), (17, 5)])
def test_stream_mac_bits_do_not_depend_on_the_window_or_channels(cuda, rng, storage, p, pos):
    """A block's output bits are the same in a window of 64 as in the window
    split 30 + 34 with the write-back between, and with C = 64 as on the
    first 32 channels alone (Cf = 1; the window wraps the ring)."""
    c, b = 64, 512
    ring, scales, x, scl, rim, dcfix, seed = _mac_inputs(rng, storage, p, 64, c, b, 1, cuda)
    whole = fs.stream_mac(ring, scales, x, scl, rim, dcfix, pos, seed)
    r2, s2 = ring.clone(), None if scales is None else scales.clone()
    parts = []
    for i0, i1 in ((0, 30), (30, 64)):
        sw = None if scl is None else scl[i0:i1]
        parts.append(fs.stream_mac(r2, s2, x[i0:i1], sw, rim, dcfix[i0:i1], (pos + i0) % p, seed[i0:i1]))
        fs.ring_writeback(x[i0:i1], sw, r2, s2, (pos + i0) % p)
    half = fs.stream_mac(ring[:, :, :32].contiguous(), None if scales is None else scales[:, :32].contiguous(),
                         x[:, :, :32].contiguous(), None if scl is None else scl[:, :32].contiguous(), rim,
                         dcfix[:, :, :32].contiguous(), pos, seed[:, :, :32].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(half, whole[:, :32])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("cf", [1, 3])
def test_stream_mac_sched_equals_dense_on_the_masked_filter(cuda, rng, monkeypatch, storage, cf):
    """With the mask's tap-tile table the MAC equals the dense one on the
    masked filter (every skipped term is an exact zero of the dense sum)."""
    monkeypatch.setattr(fs, "_CHUNK_TARGET", 1)
    p, c, b, wc = 24, 3, 256, 64
    params, ring, scales = _sparse_fused_inputs(cuda, rng, storage, cf, p, c, b)
    spec = torch.from_numpy((3 * rng.standard_normal((wc, c, 2 * b))).astype(np.float32)).to(cuda)
    x, scl = fs.quantize_rows(spec, _DT[storage])
    dcfix = torch.from_numpy(rng.standard_normal((wc, 2, c)).astype(np.float32)).to(cuda)
    seed = torch.from_numpy(rng.standard_normal((wc, 2, c, b)).astype(np.float32)).to(cuda)
    for pos in (0, 20):
        got = fs.stream_mac(ring, scales, x, scl, params["filt_rim"], dcfix, pos, seed, params["tap_tiles"])
        dense = fs.stream_mac(ring, scales, x, scl, params["filt_rim"], dcfix, pos, seed)
        torch.cuda.synchronize()
        assert torch.equal(got, dense)


# the dense route at P below, at and off the history step, windows of 1 to
# two block tiles, C and B off the tiles (B = 10: rows copied element by
# element; C <= 4 keeps the kept body): P, wc, C, B, pos_first (0: the rim
# half switches inside a step; P - 5: the window wraps the ring)
_DENSE_SHAPES = [(1, 9, 3, 40, 0), (5, 64, 1, 8, 3), (17, 128, 16, 40, 12), (17, 1, 64, 8, 16),
                 (960, 64, 64, 512, 0), (960, 128, 16, 512, 955), (960, 9, 3, 40, 959), (960, 1, 1, 512, 500),
                 (17, 9, 5, 10, 5), (960, 70, 20, 24, 951)]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p,wc,c,b,pos", _DENSE_SHAPES)
def test_stream_mac_dense_route_equals_the_kept_body(cuda, rng, storage, p, wc, c, b, pos):
    """stream_mac's dense route (a shared filter over more than 4 channels,
    no table: stream_mac_dense_kernel) equals the kept body (stream_mac_cta,
    here through an all-live tap-tile table) bit for bit, and its plain
    version within the storage's tolerance, with and without a seed, on an
    untiled rim (two halves) and a tiled one (the convolver's)."""
    ring, scales, x, scl, rim, dcfix, seed = _mac_inputs(rng, storage, p, wc, c, b, 1, cuda)
    tiles = torch.ones((p, -(-b // 8)), dtype=torch.uint8, device=cuda)
    assert fs.stream_mac_route(1, c, None) == ("dense" if c > 4 else "cta")
    for rim_ in (rim, torch.cat([rim[:p], rim[:p]])):
        for sd in (None, seed):
            before = fs.stream_mac.launches
            got = fs.stream_mac(ring, scales, x, scl, rim_, dcfix, pos, sd)
            kept = fs.stream_mac(ring, scales, x, scl, rim_, dcfix, pos, sd, tiles=tiles)
            assert fs.stream_mac.launches == before + 2
            want = fs.stream_mac_reference(ring, scales, x, scl, rim_, dcfix, pos, sd)
            torch.cuda.synchronize()
            assert torch.equal(got, kept), (sd is None, rim_ is rim)
            assert _rel(got, want) < _TOL[storage], (sd is None, rim_ is rim)


def _room_filter(c, cf, storage, dev, band=False):
    """The masked benchmark cell's filter at P = 960, B = 512: params of the
    octave-room spectra under its perceptual mask (or, ``band``, under the
    mask of its first 30 % of partitions) in ``cf`` channels (the mono
    filter times a gain a channel), and the mask's tap-tile table on
    ``dev``."""
    from benchmark.lib import inputs, spec

    cell = spec.load_json(spec.ROOT / "benchmark/configs/ambi64_room10s_perc60_bf16.json")
    filt = inputs.make_filter(cell)
    mask = filt.mask
    if band:
        mask = np.zeros_like(mask)
        mask[:288] = True
    gains = np.linspace(1.0, 0.5, cf, dtype=np.float32)[:, None, None]
    parts = (np.where(mask, filt.spectra, 0)[None] * gains).astype(np.complex64)
    params = cv.filter_params(cv.PartitionedConfig(512, 960, c, storage=storage), parts, device=dev)
    tiles = torch.from_numpy(fs.tap_tile_table(mask, 512).astype(np.uint8)).to(dev)
    return params, tiles


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("c", [64, 37])
@pytest.mark.parametrize("cf", ["one", "all"])
@pytest.mark.parametrize("mask", ["perceptual", "band30"])
def test_stream_mac_tiles_equal_dense_on_the_masked_filter(cuda, rng, storage, c, cf, mask):
    """The scheduled walk of the tap-tile table (work items, live warps,
    dead taps staged as zeros) equals the dense kernel on the masked filter
    bit for bit: the benchmark's perceptual mask at P = 960 (its plan takes
    NC = 1) and a band of partitions (NC = 4 with a shared filter), a full
    window and a ragged one, ring positions that wrap inside the window, Cf
    = 1 and C, C off the 16-channel tile; and, perceptual, its plain
    version on an unmasked filter."""
    p, b = 960, 512
    params, tiles = _room_filter(c, 1 if cf == "one" else c, storage, cuda, band=mask == "band30")
    rim = params["filt_rim"]
    assert fs._tile_plan(tiles, c, 64, rim.shape[1])[1] == (4 if mask == "band30" and cf == "one" else 1)
    for wc, pos in ((64, 930), (23, 0), (64, 17)):
        ring, scales, x, scl, _, dcfix, seed = _mac_inputs(rng, storage, p, wc, c, b, rim.shape[1], cuda)
        steps = []
        for kw in (dict(tiles=tiles), {}):
            before = (fs.stream_mac.launches, fs.stream_mac.steps_run, fs.stream_mac.steps_dense)
            steps.append(fs.stream_mac(ring, scales, x, scl, rim, dcfix, pos, seed, **kw))
            assert fs.stream_mac.launches == before[0] + 1
            steps.append((fs.stream_mac.steps_run - before[1], fs.stream_mac.steps_dense - before[2]))
        torch.cuda.synchronize()
        assert torch.equal(steps[0], steps[2]), (wc, pos)
        (run, dense), (run_d, dense_d) = steps[1], steps[3]
        assert dense == dense_d == run_d and 0 < run < 0.4 * dense
    if mask == "band30":
        return
    unmasked = (rim.float() + 0.01).to(rim.dtype)  # every tap live
    got = fs.stream_mac(ring, scales, x, scl, unmasked, dcfix, pos, seed, tiles=tiles)
    want = fs.stream_mac_reference(ring, scales, x, scl, unmasked, dcfix, pos, seed, tiles=tiles)
    torch.cuda.synchronize()
    assert _rel(got, want) < _TOL[storage]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["split", "bf16", "int8"])
def test_masked_process_runs_the_tap_tiles(cuda, rng, storage):
    """The masked convolver's ``process`` on the card: B3 with the tap-tile
    table (no ``sched_widths``), within TOL of the block oracle with the
    chunk schedule and equal to the dense B3 on the masked filter, bit for
    bit."""
    from benchmark.lib import inputs, spec
    from neojax_torch import kernels

    c, nb = 8, 150
    cs, abt = mb.packed_stream_mats(1024, fs.MATRIX_DTYPES[_DT[storage]], cuda)
    filt = inputs.make_filter(spec.load_json(spec.ROOT / "benchmark/configs/ambi64_room10s_perc60_bf16.json"))
    conv_ = conv.sparse_upols_convolver(sparsity=filt.mask, storage=storage, device=cuda)
    conv_.filter(filt.spectra[None], pad_partitions=960)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, nb * 512)).astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    out = conv_.process(sig)
    counts = kernels.launch_counts()
    assert counts["fused_stream_sched"] == 1 and counts["sched_widths"] == 0
    assert counts["stream_mac"] == -(-nb // (fs.WINDOW * fs.TILES_WINDOWS))
    steps = kernels.counters()
    assert 0 < steps["stream_mac.steps_run"] < steps["stream_mac.steps_dense"] / 3
    # the same stream through the block oracle and through the dense B3
    prm = conv_.params
    sigpad = torch.cat([torch.zeros((c, 512), device=cuda), sig], dim=-1)
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(cuda)
    outs = []
    for run, kw in ((fs.fused_stream, dict(tiles=prm["tap_tiles"])),
                    (fs.fused_stream_reference, dict(sched=(prm["sp_c_idx"], prm["sp_c_flags"]))),
                    (fs.fused_stream, {})):
        st = cv.init_state(conv_.config, cuda)
        fdl = st["fdl"]
        planes, scales = fdl if isinstance(fdl, tuple) else (fdl, None)
        outs.append(run(sigpad, planes, prm["filt_rim"], 0, dcfix, cs, abt,
                        None if scales is None else scales[..., 0], **kw)[0])
    torch.cuda.synchronize()
    assert out.shape == (c, nb * 512) and torch.isfinite(out).all()
    assert _rel(outs[0], outs[1]) < _TOL[storage]
    assert torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p,c,b,nb,pos0", [(64, 3, 96, 70, 60), (5, 3, 64, 1, 2), (24, 5, 130, 100, 20),
                                           (3, 2, 256, 9, 1)])
def test_fused_stream_ragged_shapes(cuda, rng, storage, p, c, b, nb, pos0):
    """B3 at shapes off its tiles: B not a multiple of the 128-lane tile, C
    odd, nb = 1, nb not a multiple of the window, P < the window (P = 64 is
    the hybrid head's ring); each window runs each stage once."""
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, 1, 2 * b))).astype(np.float32)).to(cuda, mdt)
    cs, abt = mb.packed_stream_mats(2 * b, mdt, cuda)
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(cuda)
    dcfix = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(cuda)
    k_ring, p_ring = ring.clone(), ring.clone()
    k_s = None if scales is None else scales.clone()
    p_s = None if scales is None else scales.clone()
    before = _stage_counts()
    ko = fs.fused_stream(sigpad, k_ring, rim, pos0, dcfix, cs, abt, k_s)[0]
    after = _stage_counts()
    po = fs.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix, cs, abt, p_s)[0]
    r_ring, r_s = ring.clone(), None if scales is None else scales.clone()
    x_r, cs_r = _ring_plain(mdt, sigpad, cs)
    fs.fused_stream_reference(x_r, r_ring, rim, pos0, dcfix, cs_r, abt, r_s)
    torch.cuda.synchronize()
    assert _rel(ko, po) < _TOL[storage]
    _same_ring(storage, k_ring, r_ring, k_s, r_s)
    windows = -(-nb // fs.WINDOW)
    for name in ("window_forward", "quantize_rows", "stream_mac", "ring_writeback", "window_inverse"):
        assert after[name] - before[name] == windows, name


@pytest.mark.cuda
@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("p,c,b", [(7, 5, 130), (64, 3, 96), (2, 1, 1024)])
def test_fused_block_step_ragged_shapes(cuda, rng, storage, p, c, b):
    """B2 in one call at shapes off its tiles (B = 130: one lane a thread);
    each stage counted once a block."""
    mdt = fs.MATRIX_DTYPES[_DT[storage]]
    ring, scales = _ring(rng, storage, p, c, b, cuda)
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, c, 2 * b))).astype(np.float32)).to(cuda, mdt)
    cs, ab = mb.packed_mats(2 * b, mdt, cuda)
    for pos in sorted({0, p - 1}):
        frame = torch.from_numpy(rng.uniform(-1, 1, (c, 2 * b)).astype(np.float32)).to(cuda)
        dcfix = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32)).to(cuda)
        k_ring, p_ring = ring.clone(), ring.clone()
        k_s = None if scales is None else scales.clone()
        p_s = None if scales is None else scales.clone()
        before = _stage_counts()
        r_ring, r_s = ring.clone(), None if scales is None else scales.clone()
        ky = fs.fused_block_step(frame, k_ring, rim, pos, dcfix, cs, ab, k_s)[0]
        after = _stage_counts()
        py = fs.fused_block_step_reference(frame, p_ring, rim, pos, dcfix, cs, ab, p_s)[0]
        x_r, cs_r = _ring_plain(mdt, frame, cs)
        fs.fused_block_step_reference(x_r, r_ring, rim, pos, dcfix, cs_r, ab, r_s)
        torch.cuda.synchronize()
        assert _rel(ky, py) < _TOL[storage]
        _same_ring(storage, k_ring, r_ring, k_s, r_s)
        for name in ("window_forward", "quantize_rows", "ring_writeback", "step_mac", "step_reduce",
                     "window_inverse"):
            assert after[name] - before[name] == 1, name
        assert after["sched_widths"] == before["sched_widths"]  # no schedule, no widths launch


# ------------------------------------------------- the FFT transform kernels

_FFT_TOL = {torch.float32: 1e-6, torch.bfloat16: _TOL["bf16"]}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 48, 256, 512, 1024])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("wc", [1, 7, 64])
@pytest.mark.parametrize("c", [1, 64])
def test_fft_transforms_match_plain(cuda, rng, b, mdt, wc, c):
    """``window_forward`` / ``window_inverse`` (shared-memory FFTs) against
    their plain versions, the float64 products with the packed matrices:
    both forward forms (B3's [N, 2B], B2's [2, N, B]) and both inverse
    forms (B3's tail half, B2's all N samples), within 1e-6 of the peak for
    f32 matrices and ``_TOL["bf16"]`` for bf16 ones (B = 48: the odd factor
    3 through the direct stage)."""
    n, i0 = 2 * b, 3
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, (i0 + wc + 1) * b)).astype(np.float32)).to(cuda)
    cs_s, abt = mb.packed_stream_mats(n, mdt, cuda)
    cs_b, ab = mb.packed_mats(n, mdt, cuda)
    before = _stage_counts()
    for mat in (cs_s, cs_b):
        got = fs.window_forward(sig, mat, i0, wc)
        assert _rel(got, fs.window_forward_reference(sig, mat, i0, wc)) < _FFT_TOL[mdt]
    acc = torch.from_numpy(rng.standard_normal((wc, c, n)).astype(np.float32)).to(cuda)
    for inv in (abt, ab.reshape(n, n)):
        n_out = inv.shape[1]
        out_k = fs.window_inverse(acc, inv, torch.full((c, (i0 + wc + 1) * n_out), 7.0, device=cuda), i0)
        out_p = fs.window_inverse_reference(acc, inv, torch.full((c, (i0 + wc + 1) * n_out), 7.0, device=cuda), i0)
        assert _rel(out_k, out_p) < _FFT_TOL[mdt]
        assert bool((out_k[:, : i0 * n_out] == 7.0).all()) and bool((out_k[:, (i0 + wc) * n_out :] == 7.0).all())
    after = _stage_counts()
    assert (after["window_forward"] - before["window_forward"], after["window_inverse"] - before["window_inverse"]) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [48, 512])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fft_rows_bits_do_not_depend_on_the_launch(cuda, rng, b, mdt):
    """A row's bits are its own: one window of 64 blocks against 1 + 63,
    and one channel launched alone against its row of 64 channels, for
    both transforms."""
    n, c = 2 * b, 64
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, 65 * b)).astype(np.float32)).to(cuda)
    cs, abt = mb.packed_stream_mats(n, mdt, cuda)
    whole = fs.window_forward(sig, cs, 0, 64)
    split = torch.cat([fs.window_forward(sig, cs, 0, 1), fs.window_forward(sig, cs, 1, 63)])
    alone = fs.window_forward(sig[5:6].contiguous(), cs, 0, 64)
    assert torch.equal(whole, split) and torch.equal(whole[:, 5:6], alone)
    acc = torch.from_numpy(rng.standard_normal((64, c, n)).astype(np.float32)).to(cuda)
    o1 = fs.window_inverse(acc, abt, torch.empty((c, 64 * b), device=cuda), 0)
    o2 = torch.empty((c, 64 * b), device=cuda)
    fs.window_inverse(acc[:1], abt, o2, 0)
    fs.window_inverse(acc[1:], abt, o2, 1)
    o3 = fs.window_inverse(acc[:, 5:6].contiguous(), abt, torch.empty((1, 64 * b), device=cuda), 0)
    assert torch.equal(o1, o2) and torch.equal(o1[5:6], o3)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [48, 512])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fft_b2_and_b3_forward_bits_agree(cuda, rng, b, mdt):
    """B2 and B3 transform the same frame to the same bits: the stage with
    B2's [2, N, B] matrix on the frame against B3's [N, 2B] on the signal,
    and, for the split storage (whose ring holds the spectrum as it is), the
    ring row B2's one C call writes against the one B3 writes."""
    n, c, p, i0 = 2 * b, 64, 4, 9
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, 12 * b)).astype(np.float32)).to(cuda)
    frame = sig[:, i0 * b : i0 * b + n].contiguous()
    cs_s, abt = mb.packed_stream_mats(n, mdt, cuda)
    cs_b, ab = mb.packed_mats(n, mdt, cuda)
    assert torch.equal(fs.window_forward(sig, cs_s, i0, 1), fs.window_forward(frame, cs_b, 0, 1))
    if mdt != torch.float32:
        return
    rim = torch.from_numpy((0.1 * rng.standard_normal((2 * p, 1, n))).astype(np.float32)).to(cuda)
    dcfix = torch.zeros((2, c), device=cuda)
    r2 = torch.zeros((2, p, c, b), device=cuda)
    r3 = torch.zeros((2, p, c, b), device=cuda)
    fs.fused_block_step(frame, r2, rim, 2, dcfix, cs_b, ab)
    fs.fused_stream(frame, r3, rim, 2, dcfix[None], cs_s, abt)
    torch.cuda.synchronize()
    assert torch.equal(r2[:, 2], r3[:, 2]) and bool(r2[:, 2].abs().max() > 0)


@pytest.mark.cuda
def test_fft_kernels_take_only_the_dft(cuda, rng):
    """On the card the transforms take only the packed DFT matrices: an
    equal copy passes (compared once), any other matrix raises."""
    b = 64
    sig = torch.from_numpy(rng.uniform(-1, 1, (2, 4 * b)).astype(np.float32)).to(cuda)
    cs = mb.packed_stream_mats(2 * b, torch.float32, cuda)[0]
    copy = cs.clone()
    assert torch.equal(fs.window_forward(sig, copy, 0, 2), fs.window_forward(sig, cs, 0, 2))
    bad = cs.clone()
    bad[3, 5] += 1.0
    with pytest.raises(ValueError, match="packed DFT"):
        fs.window_forward(sig, bad, 0, 2)


@pytest.fixture
def tf32_on():
    """The caller's TF32 flags on (cuBLAS and cuDNN), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _peak_rel(a, b):
    a = torch.as_tensor(a).detach().double().cpu()
    b = torch.as_tensor(b).detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["split", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cuda_route_matches_cpu_route(cuda, rng, tf32_on, storage, masked):
    """The card's product (IEEE float32 for split, bf16 operands with a
    float32 accumulator for bf16) against the CPU route: split 2e-5 and
    bf16 5e-3 of the output peak (bf16 transform operands may round to
    neighbouring values after cuFFT and pocketfft)."""
    from neojax_torch.conv import chunked as ch

    b, p, c, s = 64, 24, 3, 8
    ir = (rng.uniform(-1, 1, p * b) * np.exp(-np.arange(p * b) / (4 * b)) * 0.3).astype(np.float32)
    parts = conv.uniform_partition(ir, b)
    mask = conv.perceptual_mask(parts[0], 48000.0, -50.0) if masked else None
    sig = rng.uniform(-1, 1, (c, 3 * s * b + 17)).astype(np.float32)
    cfg = cv.PartitionedConfig(b, p, c, storage=storage)
    outs = {}
    for dev in ("cpu", cuda):
        params = ch.chunked_filter_params(cfg, parts, s, mask=mask, device=dev)
        state, out = ch.process_chunked(cfg, params, ch.chunked_init_state(cfg, params), sig, s)
        assert out.device.type == torch.device(dev).type and out.dtype == torch.float32
        outs[str(dev)] = (params, state, out)
    (cp, cs_, co), (gp, gs, go) = outs["cpu"], outs[str(cuda)]
    for cb, gb in zip(cp["buckets"], gp["buckets"]):  # the device gather equals the CPU build
        assert torch.equal(cb["tcat"].view(torch.int16 if storage == "bf16" else torch.int32),
                           gb["tcat"].cpu().view(torch.int16 if storage == "bf16" else torch.int32))
    assert _peak_rel(go, co) < (2e-5 if storage == "split" else 5e-3)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32  # restored


@pytest.mark.cuda
def test_float32_products_stay_ieee_under_tf32(cuda, rng, tf32_on):
    """direct_convolve and the "matmul" DFT backend against float64 at
    1e-5 of the peak: TF32's 10-bit mantissa would miss it by two orders."""
    from neojax_torch import fft as tfft

    a = rng.uniform(-1, 1, 4000)
    h = rng.uniform(-1, 1, 1500)
    out = conv.direct_convolve(a.astype(np.float32), h.astype(np.float32), device=cuda)
    assert _peak_rel(out, np.convolve(a, h)) < 1e-5
    x = rng.uniform(-1, 1, (8, 1024))
    spec = tfft.rfft(x.astype(np.float32), backend="matmul", device=cuda)
    want = np.fft.rfft(x)
    assert _peak_rel(torch.view_as_real(spec), torch.view_as_real(torch.from_numpy(want))) < 1e-5
    back = tfft.irfft(spec, n=1024, backend="matmul")
    assert _peak_rel(back, x) < 1e-5
    z = (rng.standard_normal((4, 512)) + 1j * rng.standard_normal((4, 512)))
    got = tfft.fft(z.astype(np.complex64), backend="matmul", device=cuda)
    assert _peak_rel(torch.view_as_real(got), torch.view_as_real(torch.from_numpy(np.fft.fft(z)))) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["perblock", "nested", "hybrid", "chunked"])
def test_make_engine_cuda_route_matches_cpu_route(cuda, rng, tf32_on, engine):
    """Each engine at split on the card against its CPU route over two
    calls (2e-5 of the peak); storage=None on the card is "split"."""
    b, p, c, s = 32, 19, 2, 4
    parts = conv.uniform_partition(rng.uniform(-1, 1, p * b).astype(np.float32) * 0.2, b)
    sig = rng.uniform(-1, 1, (c, 6 * s * b)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        eng = conv.make_engine(engine, parts, storage="split", chunk_blocks=s, channels=c, device=dev)
        outs.append(torch.cat([eng.process(sig[:, : 2 * s * b]).cpu(), eng.process(sig[:, 2 * s * b :]).cpu()], -1))
    assert _peak_rel(outs[1], outs[0]) < 2e-5
    assert conv.make_engine(engine, parts, chunk_blocks=s, device=cuda).config.storage == "split"


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["auto", "direct", "fft", "ols", "ola", "upols", "upola"])
def test_convolve_on_the_card(cuda, rng, tf32_on, method):
    import neojax_torch

    a = rng.uniform(-1, 1, 6000)
    h = rng.uniform(-1, 1, 2500)
    out = neojax_torch.convolve(a.astype(np.float32), h.astype(np.float32), method=method)
    assert out.device.type == "cuda" and out.shape == (8499,)
    assert _peak_rel(out, np.convolve(a, h)) < 1e-5


# ------------------------------------------------- the fft/core/ops surface


_SURFACE = {
    "dct2/64": (lambda x: _fft().dct2(x), lambda x: _dct2(x), "real", 64),
    "dct2/4096": (lambda x: _fft().dct2(x), lambda x: _dct2(x), "real", 4096),
    "dft/17": (lambda x: _fft().dft(x), np.fft.fft, "complex", 17),
    "dft/100": (lambda x: _fft().dft(x), np.fft.fft, "complex", 100),
    "dft/4099": (lambda x: _fft().dft(x), np.fft.fft, "complex", 4099),
    "naive_dft/100": (lambda x: _fft().naive_dft(x), np.fft.fft, "complex", 100),
    "packed_rfft/1024": (lambda x: torch.complex(*_fft().packed_rfft(x)), np.fft.rfft, "real", 1024),
    "split_fft/1024": (lambda x: torch.complex(*_fft().split_fft(x.real.contiguous(), x.imag.contiguous())),
                       np.fft.fft, "complex", 1024),
}


def _fft():
    from neojax_torch import fft

    return fft


def _dct2(x):
    import scipy.fft

    return scipy.fft.dct(x, type=2)  # unscaled: 2 sum x_n cos(pi k (2n + 1) / 2N)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_SURFACE))
def test_surface_transforms_on_the_card(cuda, rng, tf32_on, name):
    """Each transform on the card against numpy/scipy in float64 within
    1e-5 of the peak, with the caller's TF32 flags on."""
    fn, ref_fn, kind, n = _SURFACE[name]
    x = rng.standard_normal((4, n)) + (1j * rng.standard_normal((4, n)) if kind == "complex" else 0)
    x_dev = torch.from_numpy(x.astype(np.complex64 if kind == "complex" else np.float32)).to(cuda)
    got = fn(x_dev)
    assert got.device.type == "cuda"
    ref = ref_fn(x)
    assert _peak_rel(torch.view_as_real(got.to(torch.complex128)), torch.view_as_real(torch.from_numpy(ref + 0j))) < 1e-5


@pytest.mark.cuda
def test_packed_irfft_and_host_input_on_the_card(cuda, rng):
    from neojax_torch import fft

    x = rng.standard_normal((3, 1024))
    spec = np.fft.rfft(x)
    back = fft.packed_irfft(spec.real.astype(np.float32), spec.imag.astype(np.float32))
    assert back.device.type == "cuda" and _peak_rel(back, x) < 1e-5
    assert fft.stft(x[0].astype(np.float32), 256).device.type == "cuda"
    from neojax_torch import core

    for build in (core.hann_window, core.hamming_window, core.rectangular_window):
        assert build(16).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fixed_add", "fixed_subtract", "fixed_multiply"])
@pytest.mark.parametrize("fmt", ["Q7", "Q15"])
def test_fixed_point_on_the_card_bit_for_bit(cuda, rng, op, fmt):
    from neojax_torch.core import fixed_point as fp

    if fmt == "Q7":
        q = np.arange(-128, 128, dtype=np.int8)
        a, b = (v.ravel() for v in np.meshgrid(q, q))
    else:
        a, b = (rng.integers(-32768, 32768, 100_000).astype(np.int16) for _ in range(2))
        a[:3], b[:3] = (-32768, -32768, 32767), (-32768, 32767, 32767)
    on_card = getattr(fp, op)(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), getattr(fp, op)(a, b, device="cpu"))
    x = rng.uniform(-1.2, 1.2, 10_000)
    assert torch.equal(fp.to_fixed(torch.from_numpy(x).to(cuda), getattr(fp, fmt)).cpu(),
                       fp.to_fixed(x, getattr(fp, fmt), device="cpu"))


@pytest.mark.cuda
def test_checked_raises_on_a_card_op(cuda):
    from neojax_torch.ops import debug

    t = torch.zeros(4, device=cuda)
    with pytest.raises(FloatingPointError, match="log"):
        debug.checked(lambda v: torch.log(v - 1.0) + 1.0)(t)
    assert float(debug.checked(lambda v: (v + 1.0).sum())(t)) == 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["split", "int8"])
def test_checkpoint_resumes_on_the_card(cuda, rng, tmp_path, storage):
    """A card stream saved, loaded onto the card and continued equals the
    same stream continued without the file, bit for bit."""
    from neojax_torch import io as tio

    b, p, c = 64, 40, 3
    parts = conv.uniform_partition(rng.uniform(-1, 1, p * b).astype(np.float32) * 0.2, b)
    sig = torch.from_numpy(rng.uniform(-1, 1, (c, 20 * b)).astype(np.float32)).to(cuda)
    cfg = cv.PartitionedConfig(b, p, c, storage=storage)
    params = cv.filter_params(cfg, parts, device=cuda)
    state, _ = cv.process(cfg, params, cv.init_state(cfg, cuda), sig[:, : 7 * b])
    tio.save_state(str(tmp_path / "s.npz"), state)
    loaded = tio.load_state(str(tmp_path / "s.npz"))
    assert isinstance(loaded["pos"], int)
    _, a = cv.process(cfg, params, state, sig[:, 7 * b :])
    _, b2 = cv.process(cfg, params, loaded, sig[:, 7 * b :])
    assert torch.equal(a, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["upols", "upola", "chunked", "nested", "hybrid"])
def test_cli_on_the_card_matches_its_cpu_run(cuda, rng, tmp_path, engine):
    """The CLI at split on the card against ``--device cpu`` on the same files."""
    from neojax_torch import cli
    from neojax_torch.io.wav import read_wav, write_wav

    write_wav(str(tmp_path / "s.wav"), rng.uniform(-0.3, 0.3, (2, 4000)).astype(np.float32), 8000, bits=32)
    write_wav(str(tmp_path / "i.wav"), (rng.uniform(-1, 1, (1, 700)) * 0.2).astype(np.float32), 8000, bits=32)
    outs = []
    for dev in ("cuda", "cpu"):
        argv = [str(tmp_path / "s.wav"), str(tmp_path / "i.wav"), str(tmp_path / f"o_{dev}.wav"), "--engine", engine,
                "--block", "64", "--chunk-blocks", "4", "--storage", "split", "--bits", "32", "--device", dev]
        assert cli.main(argv) == 0
        outs.append(read_wav(str(tmp_path / f"o_{dev}.wav"))[0])
    assert _peak_rel(outs[0], outs[1]) < 2e-5


@pytest.mark.cuda
def test_stream_executor_on_the_card(cuda, rng):
    """``io.StreamExecutor`` around a card ``HybridStream``, odd pushes,
    against the offline ``process_hybrid`` within 1e-4."""
    from neojax_torch.conv import hybrid
    from neojax_torch.io import StreamExecutor

    b, p, c, s = 64, 40, 2, 8
    parts = conv.uniform_partition(rng.uniform(-1, 1, p * b).astype(np.float32) * 0.2, b)
    cfg = cv.PartitionedConfig(b, p, c, storage="split")
    params = hybrid.hybrid_filter_params(cfg, parts, s, device=cuda)
    sig = rng.uniform(-1, 1, (c, 4 * s * b)).astype(np.float32)
    _, ref = hybrid.process_hybrid(cfg, params, hybrid.hybrid_init_state(cfg, params), torch.from_numpy(sig).to(cuda))
    stream = hybrid.HybridStream(cfg, params)
    got, sent, t0 = [], 0, time.perf_counter()
    with StreamExecutor(lambda st, blk: (st, stream(blk)), None, c, b) as ex:
        while sum(g.shape[1] for g in got) < sig.shape[1] and time.perf_counter() - t0 < 60:
            if sent < sig.shape[1]:
                sent += ex.push(sig[:, sent : sent + 333])
            chunk = ex.pull(4 * b)
            if chunk.shape[1]:
                got.append(chunk)
    out = np.concatenate(got, axis=-1)
    assert float(np.abs(out - ref.cpu().numpy()).max()) < 1e-4
