"""neojax_torch.dist's PipelineConvolver (partitions over "part", the
ring hand-off) and BinShardedConvolver (bins over "bin") on a 4-rank gloo
world of CPU processes, held against neojax.dist at the same mesh shape.

One world runs every case (``torch_dist_cases.pipeline_world``); each case
is its own test. Cases (``tests/test_dist.py``, ``tests/test_dist_split.py``):

- ``PipelineConvolver`` at (part, ch) in {(4, 1), (2, 2)} x {dense, split,
  bf16, int16, int8}: output and state (``fdl``, ``incoming`` and, for int
  storage, ``scales``/``inc_scale``) against neojax's; streaming resumed
  across two calls against one call;
- ``BinShardedConvolver`` at (bin, ch) in {(2, 2), (4, 1)} x {split, bf16,
  int16, int8}: output and state against neojax's (its per-shard int
  scales make a run comparable only at the same "bin" size), resume, and
  the K padding (K = 65 padded to 66 and 68, the padded bins all zero);
  at bin = 4, on the inputs of ``tests/test_dist.py``'s bin-sharded tests,
  each quantized storage against the split run within that file's bounds
  (line 115). At bin = 2 the per-shard int8 scales are coarser and
  neojax's own int8 run is 5.2e-3 from its split run, past the 5e-3 bound,
  so there the check is against neojax alone;
- dense storage rejected by ``BinShardedConvolver``, as by neojax's;
- neojax's int8 filter and state after a first call carried into the
  ranks by ``convert`` (a plain slice of its global arrays), the second
  call against neojax's.

Tolerances: abs, f32 2e-5, bf16 5e-2, int16 1e-3, int8 2e-2
(``tests/test_partnested.py:49-52``); state rings of int storage to one
code (the two packages' f32 transforms round differently, so a value on a
rounding boundary may land one code apart), their scales to 1e-5 of the
largest.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import neojax
from neojax.conv import convolver as jcv

import torch_dist_cases as cases
from torch_dist_world import run_world
from neojax_torch import dist as tdist
from neojax_torch.conv import convolver as tcv

ATOL = {"dense": 2e-5, "split": 2e-5, "bf16": 5e-2, "int16": 1e-3, "int8": 2e-2}
BIN_VS_SPLIT = {"bf16": 2e-2, "int16": 1e-4, "int8": 5e-3}  # tests/test_dist.py:115


def _jax_pipeline_int8():
    cfg = jcv.PartitionedConfig(cases.B, cases.PIPE_P, cases.PIPE_C, storage="int8", fft_backend="matmul")
    return neojax.dist.PipelineConvolver(cfg, _jmesh(part=2, ch=2))


def _jax_bin_int8():
    cfg = jcv.PartitionedConfig(cases.B, cases.BIN_P, cases.BIN_C, storage="int8")
    return neojax.dist.BinShardedConvolver(cfg, _jmesh(bin=2, ch=2))


def _numpy_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def carried():
    """neojax's int8 pipeline and bin-sharded engines (2x2 mesh) after a
    first call: (global filter, global state) for the ranks to carry over
    through ``convert``, and neojax's output of the second call."""
    out = {}
    for name, eng, filt, sig in (
        ("pipeline", _jax_pipeline_int8(), cases.pipe_filter(), cases.signal(cases.PIPE_C, cases.NB, seed=5)),
        ("bin", _jax_bin_int8(), cases.bin_inputs()[0], cases.bin_inputs()[1]),
    ):
        f = eng.shard_filter(filt)
        st, _ = eng.process(f, eng.init_state(), sig)
        c = cases.PIPE_C if name == "pipeline" else cases.BIN_C
        _, second = eng.process(f, st, cases.signal(c, cases.NB, seed=7))
        out[name] = ((np.asarray(f), _numpy_tree(st)), np.asarray(second))
    return out


@pytest.fixture(scope="module")
def world(carried):
    return run_world(4, "torch_dist_cases.pipeline_world", {k: v[0] for k, v in carried.items()})[0]


def _case(world, name):
    res = world[name]
    if isinstance(res, tuple) and res and res[0] == "error":
        pytest.fail(f"case {name} raised on the ranks:\n{res[1]}")
    return res


def _jmesh(**kw):
    import jax

    return neojax.dist.make_mesh(devices=jax.devices()[:4], **kw)


@pytest.mark.parametrize("name", ["pipeline", "bin"])
def test_state_carried_from_neojax(world, carried, name):
    """neojax's filter and state after a first call, carried into each rank
    by ``convert.{pipeline,binsharded}_{filter,state}_from_neojax``: the
    second call continues neojax's stream (int8, 2x2 mesh)."""
    res = _case(world, f"convert-{name}")
    np.testing.assert_allclose(res["out"], carried[name][1], atol=ATOL["int8"])


def _check_state(storage, got: dict, want: dict, quant_keys=()):
    assert set(got) == set(want)
    for key, t in got.items():
        j = want[key]
        if isinstance(t, int):
            assert t == int(j), key
            continue
        t = np.asarray(t)
        j = np.asarray(jnp.asarray(j).astype(jnp.complex64 if np.iscomplexobj(t) else jnp.float32))
        if key in quant_keys:
            assert np.abs(t.astype(np.float64) - j).max() <= 1, key
        elif key in ("scales", "inc_scale", "scl"):
            assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max(), key
        else:
            assert np.abs(t - j).max() <= ATOL[storage] * max(1.0, np.abs(j).max()), key


@pytest.mark.parametrize("storage", ["dense", "split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("part,ch", [(4, 1), (2, 2)])
def test_pipeline_matches_neojax(world, part, ch, storage):
    res = _case(world, f"pipe-{part}x{ch}-{storage}")
    cfg = jcv.PartitionedConfig(cases.B, cases.PIPE_P, cases.PIPE_C, storage=storage, fft_backend="matmul")
    pipe = neojax.dist.PipelineConvolver(cfg, _jmesh(part=part, ch=ch))
    st, out = pipe.process(pipe.shard_filter(cases.pipe_filter()), pipe.init_state(),
                           cases.signal(cases.PIPE_C, cases.NB, seed=5))
    np.testing.assert_allclose(res["out"], np.asarray(out), atol=ATOL[storage])
    quant = ("fdl", "incoming") if storage in ("int8", "int16") else ()
    _check_state(storage, res["state"], st, quant)


def test_pipeline_streaming_resume(world):
    res = _case(world, "pipe-2x2-split")
    np.testing.assert_allclose(res["resumed"], res["out"], atol=1e-6)


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("bins,ch", [(2, 2), (4, 1)])
def test_bin_sharded_matches_neojax(world, bins, ch, storage):
    res = _case(world, f"bin-{bins}x{ch}-{storage}")
    cfg = jcv.PartitionedConfig(cases.B, cases.BIN_P, cases.BIN_C, storage=storage)
    bc = neojax.dist.BinShardedConvolver(cfg, _jmesh(bin=bins, ch=ch))
    filt, sig = cases.bin_inputs()
    st, out = bc.process(bc.shard_filter(filt), bc.init_state(), sig)
    np.testing.assert_allclose(res["out"], np.asarray(out), atol=ATOL[storage])
    _check_state(storage, res["state"], st, ("fdl",) if storage in ("int8", "int16") else ())
    if storage != "split" and bins == 4:  # each quantized storage against the split run
        split = _case(world, f"bin-{bins}x{ch}-split")["out"]
        assert np.abs(res["out"] - split).max() / np.abs(split).max() < BIN_VS_SPLIT[storage]


def test_bin_sharded_resume(world):
    res = _case(world, "bin-4x1-split")
    np.testing.assert_allclose(res["resumed"], res["out"], atol=1e-6)


@pytest.mark.parametrize("bins", [2, 4])
def test_bin_sharded_k_padding(world, bins):
    """K = B + 1 = 65 padded to a multiple of the bin size; the padded
    bins carry nothing."""
    res = _case(world, f"bin-{bins}x{4 // bins}-split")
    k = cases.B + 1
    assert res["k_pad"] == -(-k // bins) * bins and res["local_lanes"] == res["k_pad"] // bins
    fdl = res["state"]["fdl"]
    assert fdl.shape[-1] == res["k_pad"]
    assert not np.any(fdl[..., k:])


def test_bin_sharded_rejects_dense():
    mesh = tdist.make_mesh(bin=1, device="cpu")  # one process: a 1x1 mesh
    with pytest.raises(NotImplementedError, match="split-plane only"):
        tdist.BinShardedConvolver(tcv.PartitionedConfig(cases.B, cases.BIN_P, 2), mesh)
    import jax

    with pytest.raises(NotImplementedError, match="split-plane only"):
        neojax.dist.BinShardedConvolver(jcv.PartitionedConfig(cases.B, cases.BIN_P, 2),
                                        neojax.dist.make_mesh(bin=1, devices=jax.devices()[:1]))
