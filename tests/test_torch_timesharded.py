"""neojax_torch.dist.timesharded_process (the block stream over a "time"
axis, one halo ppermute, a batched warmup) on a 4-rank gloo world of CPU
processes, held against neojax's at the same axis size and against the
single-process ``process``.

One world runs every case (``torch_dist_cases.timesharded_world``); each
case is its own test. Cases (``tests/test_timesharded.py:37-115``):

- time in {2, 4} x {upols, upola} x {dense, split, int8, int16}: the
  gathered output against neojax's ``timesharded_process`` and against the
  port's single-process ``process`` over the whole signal;
- the shift layout and a mono ([T]) signal;
- both validation errors, on both packages;
- the warmup: on the unfused route its state equals P-1 sequential
  ``insert_only_step`` pushes; on the fused route its ring holds, bit for
  bit, the rows the stream's own kernels write (B3's for UPOLS, B2's for
  UPOLA); and at a transform size where neojax keeps its sequential
  four-step scan (N = 4096) it equals neojax's ``_warmup``;
- ``insert_only_step`` advances the state as a full step does.

Tolerances. Against ``process``: ``tests/test_timesharded.py``'s own,
absolute (f32 2e-6, int8 5e-3, int16 1e-4): where the warmup's spectra
come from a batched transform, rounding, and through it an int code, may
differ. Against neojax: the per-block convolver's port-vs-neojax bounds of
``tests/test_torch_convolver.py``, relative to the output peak (f32 2e-5,
int16 5e-4, int8 2e-2: the fused int8 route transforms in bf16).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from neojax.conv import convolver as jcv
from neojax.dist import timesharded as jts

import torch_dist_cases as cases
from torch_dist_world import run_world
from neojax_torch import convert
from neojax_torch import dist as tdist
from neojax_torch.conv import convolver as tcv
from neojax_torch.dist import timesharded as tts

VS_PROCESS = {"dense": 2e-6, "split": 2e-6, "int8": 5e-3, "int16": 1e-4}
VS_NEOJAX = {"dense": 2e-5, "split": 2e-5, "int8": 2e-2, "int16": 5e-4}


@pytest.fixture(scope="module")
def world():
    return run_world(4, "torch_dist_cases.timesharded_world")[0]


def _case(world, name):
    res = world[name]
    if isinstance(res, tuple) and res and res[0] == "error":
        pytest.fail(f"case {name} raised on the ranks:\n{res[1]}")
    return res


def _jax_timesharded(d, scheme, storage, channels=cases.TS_C, layout="ring", mono=False):
    cfg, prt, sig = cases.ts_inputs(scheme, storage, channels, layout)
    jcfg = jcv.PartitionedConfig(cfg.block_size, cfg.num_partitions, channels, scheme=scheme,
                                 storage=storage, layout=layout)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:d]), axis_names=("time",))
    return np.asarray(jts.timesharded_process(jcfg, jcv.filter_params(jcfg, prt), sig[0] if mono else sig, mesh))


def _check(res, want, storage):
    out = res["out"]
    assert out.shape == want.shape == res["single"].shape
    np.testing.assert_allclose(out, res["single"], atol=VS_PROCESS[storage])
    np.testing.assert_allclose(out, want, atol=VS_NEOJAX[storage] * np.abs(want).max())


@pytest.mark.parametrize("storage", ["dense", "split", "int8", "int16"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("d", [2, 4])
def test_timesharded_matches(world, d, scheme, storage):
    _check(_case(world, f"ts-{d}-{scheme}-{storage}"), _jax_timesharded(d, scheme, storage), storage)


def test_timesharded_shift_layout(world):
    _check(_case(world, "ts-shift"), _jax_timesharded(4, "upols", "split", layout="shift"), "split")


def test_timesharded_mono(world):
    _check(_case(world, "ts-mono"), _jax_timesharded(4, "upols", "split", channels=1, mono=True), "split")


@pytest.mark.parametrize("length,match", [(2 * cases.TS_B, "halo"), (100, "divisible")])
def test_timesharded_validation(length, match):
    """Fewer blocks a rank than partitions, and a length that does not
    split into blocks: the same errors as neojax's (one process: a 1-rank
    "time" axis)."""
    cfg, prt, sig = cases.ts_inputs("upols", "split")
    mesh = tdist.Mesh(("time",), (1,), device="cpu")
    with pytest.raises(ValueError, match=match):
        tts.timesharded_process(cfg, tcv.filter_params(cfg, prt, device="cpu"), sig[:, :length], mesh)
    jcfg = jcv.PartitionedConfig(cfg.block_size, cfg.num_partitions, cfg.channels, storage="split")
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), axis_names=("time",))
    with pytest.raises(ValueError, match=match):
        jts.timesharded_process(jcfg, jcv.filter_params(jcfg, prt), sig[:, :length], jmesh)


def _halo(cfg, seed=9):
    return np.random.default_rng(seed).uniform(-1, 1, (cfg.channels, cfg.num_partitions * cfg.block_size)
                                               ).astype(np.float32)


@pytest.mark.parametrize("storage", ["dense", "split", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
def test_batched_warmup_equals_sequential_inserts(scheme, storage):
    """Unfused route: the warmup's state equals P-1 ``insert_only_step``
    pushes of the halo blocks (UPOLA then one full step, as the warmup)."""
    cfg, prt, _ = cases.ts_inputs(scheme, storage)
    cfg = dataclasses.replace(cfg, fused=False)
    params = tcv.filter_params(cfg, prt, device="cpu")
    halo = torch.from_numpy(_halo(cfg))
    got = tts._warmup(cfg, params, halo)
    blocks = halo.reshape(cfg.channels, cfg.num_partitions, cfg.block_size)
    want = tcv.init_state(cfg, "cpu")
    if scheme == "upols":
        want["tail"] = blocks[:, 0].clone()
    for i in range(1 if scheme == "upols" else 0, cfg.num_partitions - (scheme == "upola")):
        want = tcv.insert_only_step(cfg, want, blocks[:, i])
    if scheme == "upola":
        want, _ = tcv.step(cfg, params, want, blocks[:, -1])
    assert set(got) == set(want) and got["pos"] == want["pos"]
    for key in ("tail", "dcny"):
        if key in got:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-5)
    gf, wf = got["fdl"], want["fdl"]
    if isinstance(gf, tuple):
        assert (gf[0].int() - wf[0].int()).abs().max() <= 1
        np.testing.assert_allclose(gf[1].numpy(), wf[1].numpy(), rtol=1e-5)
    else:
        np.testing.assert_allclose(torch.view_as_real(gf).numpy() if gf.is_complex() else gf.numpy(),
                                   torch.view_as_real(wf).numpy() if wf.is_complex() else wf.numpy(), atol=1e-4)


def _planes(fdl):
    return fdl if isinstance(fdl, tuple) else (fdl,)


@pytest.mark.parametrize("storage", ["split", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
def test_fused_warmup_writes_the_stream_rows(scheme, storage):
    """Fused route: the warmup's ring rows (and scales, DC/Nyquist pairs)
    are bit for bit the ones ``process`` writes for the same frames — UPOLS
    frame j in slot j-1 where a stream from zeros puts it in slot j; UPOLA
    the whole state of ``process`` over the halo blocks."""
    cfg, prt, _ = cases.ts_inputs(scheme, storage)
    params = tcv.filter_params(cfg, prt, device="cpu")
    assert tcv._use_fused(cfg, params)
    halo = torch.from_numpy(_halo(cfg))
    got = tts._warmup(cfg, params, halo)
    want, _ = tcv.process(cfg, params, tcv.init_state(cfg, "cpu"), halo)
    p = cfg.num_partitions
    if scheme == "upola":
        for g, w in zip(_planes(got["fdl"]), _planes(want["fdl"])):
            assert torch.equal(g, w)
        assert torch.equal(got["dcny"], want["dcny"]) and torch.equal(got["tail"], want["tail"])
        assert got["pos"] == want["pos"]
    else:
        gp, wp = _planes(got["fdl"]), _planes(want["fdl"])
        assert torch.equal(gp[0][:, : p - 1], wp[0][:, 1:])
        if len(gp) == 2:
            assert torch.equal(gp[1][: p - 1], wp[1][1:])
        assert torch.equal(got["dcny"][: p - 1], want["dcny"][1:])
        assert got["pos"] == p - 1 and torch.equal(got["tail"], want["tail"])


def test_batched_warmup_matches_neojax_four_step_scan():
    """At N = 4096 neojax warms up by a sequential scan of four-step
    inserts; the port's one batched transform gives the same state."""
    b, p, c = 2048, 3, 2
    cfg = tcv.PartitionedConfig(b, p, c, storage="split")
    jcfg = jcv.PartitionedConfig(b, p, c, storage="split")
    assert jcv._use_fourstep_stream(jcfg)
    ir = np.random.default_rng(8).uniform(-1, 1, (c, p * b)).astype(np.float32) * 0.2
    prt = cases.uniform_partition(ir, b)
    halo = _halo(cfg)
    got = convert.state_to_numpy(tts._warmup(cfg, tcv.filter_params(cfg, prt, device="cpu"),
                                             torch.from_numpy(halo)))
    want = jts._warmup(jcfg, jcv.filter_params(jcfg, prt), jnp.asarray(halo))
    assert set(got) == set(want) and got["pos"] == int(want["pos"])
    for key in ("tail", "fdl", "dcny"):
        w = np.asarray(want[key])
        assert np.abs(got[key] - w).max() <= 2e-5 * np.abs(w).max(), key


def test_insert_only_step_equals_full_step_state():
    """On the unfused route, the route of neojax's CPU test (the fused step
    transforms through B2's own product)."""
    cfg, prt, sig = cases.ts_inputs("upols", "int8")
    cfg = dataclasses.replace(cfg, fused=False)
    params = tcv.filter_params(cfg, prt, device="cpu")
    a, b = tcv.init_state(cfg, "cpu"), tcv.init_state(cfg, "cpu")
    blocks = torch.from_numpy(sig).reshape(cfg.channels, -1, cfg.block_size)
    for i in range(4):
        a, _ = tcv.step(cfg, params, a, blocks[:, i])
        b = tcv.insert_only_step(cfg, b, blocks[:, i])
    for x, y in zip(a["fdl"], b["fdl"]):
        assert torch.equal(x, y)
    assert a["pos"] == b["pos"] and torch.equal(a["tail"], b["tail"]) and torch.equal(a["dcny"], b["dcny"])
