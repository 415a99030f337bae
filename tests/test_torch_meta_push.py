"""The nested engine's meta push (``kernels.meta_push``) on the CPU.

On CPU tensors the wrapper runs ``meta_push_reference``, the push the
nested engine ran as inline tensor ops before it had a kernel (frozen here
as ``_former_push``). These tests hold the wrapper to that push bit for bit
and to a float32 numpy formula (IEEE division, rint half to even), on the
``.real`` / ``.imag`` views of a complex row with all-zero groups, exact
half-way values and values at the clamp; check that the wrapper refuses
what the kernel does not take; and check that its launch counter is listed
and that the nested engine pushes once a chunk, inside ``nested.push``.
The kernel itself is held to the reference on the card
(``tests/test_torch_cuda.py -k meta_push``).
"""

import numpy as np
import pytest
import torch

from neojax_torch import kernels, trace
from neojax_torch.conv import make_engine
from neojax_torch.conv import nested as nested_lib
from neojax_torch.kernels import meta_push as mp

_DT = {"split": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16, "int8": torch.int8}
_INT_MAX = {"int16": 32767, "int8": 127}
# (storage, L, G): int8 at the benchmark cell's L = 256 and the small
# fixtures' L = 16 (G = min(64, L)), int16 at one group a row, the floats
CASES = [("int8", 256, 64), ("int8", 16, 16), ("int8", 8, 2), ("int16", 256, 1), ("int16", 12, 1),
         ("split", 16, None), ("bf16", 16, None)]
P2, C, K = 3, 2, 5


def _former_push(fdl, scales, pos, xre, xim):
    """The nested engine's push before the kernel, as it was written."""
    row = torch.stack([xre, xim])
    if scales is None:
        fdl[:, pos] = row.to(fdl.dtype)
        return
    imax = {torch.int8: 127, torch.int16: 32767}[fdl.dtype]
    _, c, k, l = row.shape
    g = scales.shape[-1]
    grp = row.reshape(2, c, k, g, l // g)
    peak = torch.amax(torch.abs(grp), dim=(0, 4))
    scale = torch.where(peak > 0, peak, torch.ones_like(peak))
    q = torch.clamp(torch.round(grp / scale[None, :, :, :, None] * imax), -imax, imax)
    fdl[:, pos] = q.reshape(2, c, k, l).to(fdl.dtype)
    scales[pos] = scale


def _row(rng, l, g, imax):
    """A complex64 [C, K, L] row: noise, then (c=0, k=0) all zero, (c=0,
    k=1) values whose quotient lands on n + 1/2 exactly (x = 4 fl((n + 1/2)
    / imax) in groups of peak 4), and (c=1, k=0) values a rounding away
    from the peak (the clamp)."""
    z = (rng.standard_normal((C, K, l)) + 1j * rng.standard_normal((C, K, l))).astype(np.complex64)
    z[0, 0] = 0
    w = l // (g or l)
    if imax:
        steps = (np.arange(l) % (min(imax, 127) - 1) + 0.5).astype(np.float32)
        half = (steps / np.float32(imax)).astype(np.float32) * np.float32(4)
        half[::w] = 4.0  # each group's peak
        z[0, 1] = half + 1j * -half
        z[1, 0, ::2] = np.float32(7.0) * (1 + 1j)
        z[1, 0, 1::2] = np.nextafter(np.float32(7.0), np.float32(0)) * (1 - 1j)
    return torch.from_numpy(z)


def _ring(storage, l, g):
    fdl = torch.full((2, P2, C, K, l), 3, dtype=_DT[storage])
    scales = None if g is None else torch.full((P2, C, K, g), 2.0)
    return fdl, scales


@pytest.mark.parametrize("storage,l,g", CASES)
def test_cpu_push_is_the_former_push_bit_for_bit(rng, storage, l, g):
    z = _row(rng, l, g, _INT_MAX.get(storage))
    got, want = _ring(storage, l, g), _ring(storage, l, g)
    for pos in (1, P2 - 1):
        before = mp.meta_push.launches
        mp.meta_push(got[0], got[1], pos, z.real, z.imag)
        assert mp.meta_push.launches == before  # the CPU route launches nothing
        _former_push(want[0], want[1], pos, z.real, z.imag)
        assert torch.equal(got[0], want[0])
        assert g is None or torch.equal(got[1], want[1])
    assert torch.equal(got[0][:, 0], torch.full_like(got[0][:, 0], 3))  # other slots untouched


@pytest.mark.parametrize("storage,l,g", [c for c in CASES if c[2]])
def test_int_push_matches_a_float32_formula(rng, storage, l, g):
    """peak per group, scale 1 for an all-zero group, rint(x / scale *
    int_max) half to even in float32, clamped: numpy's float32 ops."""
    imax = _INT_MAX[storage]
    z = _row(rng, l, g, imax)
    fdl, scales = _ring(storage, l, g)
    mp.meta_push(fdl, scales, 2, z.real, z.imag)
    x = np.stack([z.real.numpy(), z.imag.numpy()]).reshape(2, C, K, g, l // g)
    peak = np.abs(x).max(axis=(0, 4))
    scale = np.where(peak > 0, peak, np.float32(1)).astype(np.float32)
    q = np.clip(np.rint((x / scale[None, ..., None]).astype(np.float32) * np.float32(imax)), -imax, imax)
    assert np.array_equal(fdl[:, 2].numpy(), q.reshape(2, C, K, l).astype(np.int64))
    assert np.array_equal(scales[2].numpy(), scale)
    assert (scales[2, 0, 0] == 1).all() and (fdl[:, 2, 0, 0] == 0).all()
    assert int(fdl[:, 2].abs().max()) == imax
    if storage == "int8" and l // g > 1:  # a half-way quotient goes to even, not away from 0
        halves = (x / scale[None, ..., None]).astype(np.float32) * np.float32(imax)
        tie = np.abs(halves - np.trunc(halves)) == 0.5
        assert tie.any() and (q[tie] % 2 == 0).all()


def test_push_refuses_what_the_kernel_does_not_take(rng):
    z = _row(rng, 16, 16, 127)
    xre, xim = z.real, z.imag
    fdl, scales = _ring("int8", 16, 16)
    with pytest.raises(ValueError, match=r"\[2, P2, C, K, L\]"):
        mp.meta_push(fdl[0], scales, 0, xre, xim)
    with pytest.raises(ValueError, match=r"\[C, K, L\]"):
        mp.meta_push(fdl, scales, 0, xre[:, :, :8], xim[:, :, :8])
    with pytest.raises(TypeError, match="float32"):
        mp.meta_push(fdl, scales, 0, xre.double(), xim.double())
    with pytest.raises(TypeError, match="dtype"):
        mp.meta_push(fdl.to(torch.int32), scales, 0, xre, xim)
    with pytest.raises(ValueError, match="ring slot"):
        mp.meta_push(fdl, scales, P2, xre, xim)
    with pytest.raises(ValueError, match="strides"):
        mp.meta_push(fdl, scales, 0, xre, xim.contiguous())
    with pytest.raises(ValueError, match="G dividing"):
        mp.meta_push(fdl, scales[..., :3].contiguous(), 0, xre, xim)
    with pytest.raises(ValueError, match="required for int storage"):
        mp.meta_push(fdl, None, 0, xre, xim)
    with pytest.raises(ValueError, match="required for int storage"):
        mp.meta_push(fdl.float(), scales, 0, xre, xim)
    with pytest.raises(ValueError, match="one device"):
        mp.meta_push(fdl, scales, 0, xre.to("meta"), xim.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        mp.meta_push(fdl.transpose(3, 4).contiguous().transpose(3, 4), scales, 0, xre, xim)
    assert torch.equal(fdl, _ring("int8", 16, 16)[0])  # nothing was written


def test_launch_counts_list_the_push():
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["meta_push"] == 0
    assert trace.snapshot()["launches"]["meta_push"] == 0


def test_nested_engine_pushes_once_a_chunk_inside_its_push_span(rng, monkeypatch):
    b, p, s, chunks = 16, 7, 2, 3
    parts = ((rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1))) * 0.1
             ).astype(np.complex64)
    seen = []

    def spy(*args):
        seen.append(trace.totals().get("nested.push", {"calls": 0})["calls"])
        return mp.meta_push(*args)

    monkeypatch.setattr(nested_lib, "meta_push", spy)
    eng = make_engine("nested", parts, block_size=b, storage="int8", chunk_blocks=s, channels=C, device="cpu")
    pushes = trace.totals().get("nested.push", {"calls": 0})["calls"]
    eng.process(torch.from_numpy(rng.uniform(-1, 1, (C, chunks * s * b)).astype(np.float32)))
    assert seen == [pushes + i for i in range(chunks)]  # each call is in a span not yet closed
    assert trace.totals()["nested.push"]["calls"] == pushes + chunks
