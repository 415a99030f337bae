"""neojax_torch.dist.PartShardedNested (the meta-FDL over "part", the row
hand-off and one psum a chunk) on a 4-rank gloo world of CPU processes,
held against neojax's PartShardedNested at the same mesh shape and against
the port's single-process ``process_nested``.

One world runs every case (``torch_dist_cases.partnested_world``); each
case is its own test. Cases (``tests/test_partnested.py:48-126``):
(part, ch) in {(2, 2), (4, 1)} x {upols, upola} x {split, bf16, int16,
int8}: the output and the state (``tail``, ``prev``, the sharded meta ring
and its scales) against neojax's, and the stream continued over a second
call against one ``process_nested`` call over both signals; a per-channel
filter; P2 = 5 padded to the shard count (6 and 8), which is why a run
compares with neojax only at the same "part" size; and neojax's int8
params and state after a first call carried into the ranks by
``convert``, the second call against neojax's.

Tolerances: ``tests/test_partnested.py``'s own (split 2e-5, bf16 5e-2,
int16 1e-3, int8 2e-2): absolute against ``process_nested`` (the same
package: only the psum's order differs), and relative to the output peak
against neojax (the packages' f32 transforms round apart: 1.2e-6 of the
peak at split). The int meta rings to one code (a value on a rounding
boundary may land one code apart), their scales and the rest of the state
to 2e-5 of the peak, or 1e-2 at bf16 (UPOLA's ``tail`` is output).
"""

import numpy as np
import pytest
import jax.numpy as jnp

import neojax
from neojax.conv import convolver as jcv
from neojax.dist import partnested as jpn

import torch_dist_cases as cases
from torch_dist_world import run_world

ATOL = {"split": 2e-5, "bf16": 5e-2, "int16": 1e-3, "int8": 2e-2}


@pytest.fixture(scope="module")
def carried():
    """neojax's int8 part-sharded engine (2x2 mesh) after a first call:
    (global params, global state) for the ranks to carry over through
    ``convert``, and neojax's output of the second call."""
    import jax

    cfg = jcv.PartitionedConfig(cases.PN_B, cases.PN_P, cases.PN_C, storage="int8")
    eng = jpn.PartShardedNested(cfg, neojax.dist.make_mesh(part=2, ch=2, devices=jax.devices()[:4]), cases.PN_S)
    gparams = jpn.partnested_filter_params(cfg, cases.pn_parts(), cases.PN_S, eng.d_part)
    params = eng.shard_params(gparams)
    st, _ = eng.process(params, eng.shard_state(jpn.partnested_init_state(cfg, params, eng.d_part)),
                        cases.pn_signal(6 * cases.PN_S))
    state_np = {k: np.asarray(v) for k, v in st.items()}
    _, second = eng.process(params, st, cases.pn_signal(2 * cases.PN_S, seed=11))
    return ({k: np.asarray(v) for k, v in gparams.items()}, state_np), np.asarray(second)


@pytest.fixture(scope="module")
def world(carried):
    return run_world(4, "torch_dist_cases.partnested_world", carried[0])[0]


def test_state_carried_from_neojax(world, carried):
    """neojax's params and state after a first call, carried into each
    rank by ``convert.partnested_{params,state}_from_neojax``: the second
    call continues neojax's stream (int8, 2x2 mesh)."""
    res = _case(world, "pn-convert")
    np.testing.assert_allclose(res["out"], carried[1], atol=ATOL["int8"] * np.abs(carried[1]).max())


def _case(world, name):
    res = world[name]
    if isinstance(res, tuple) and res and res[0] == "error":
        pytest.fail(f"case {name} raised on the ranks:\n{res[1]}")
    return res


def _jax(part, ch, scheme, storage, c_filt=1):
    import jax

    cfg = jcv.PartitionedConfig(cases.PN_B, cases.PN_P, cases.PN_C, scheme=scheme, storage=storage)
    mesh = neojax.dist.make_mesh(part=part, ch=ch, devices=jax.devices()[:4])
    eng = jpn.PartShardedNested(cfg, mesh, cases.PN_S)
    params = eng.shard_params(jpn.partnested_filter_params(cfg, cases.pn_parts(c_filt), cases.PN_S, eng.d_part))
    state = eng.shard_state(jpn.partnested_init_state(cfg, params, eng.d_part))
    st, out = eng.process(params, state, cases.pn_signal(6 * cases.PN_S))
    return st, np.asarray(out)


def _check(res, storage, st, out):
    np.testing.assert_allclose(res["out"], out, atol=ATOL[storage] * np.abs(out).max())
    assert res["vs_process_nested"] < ATOL[storage]
    got = res["state"]
    assert set(got) == set(st) and got["pos"] == int(st["pos"])
    quant = storage in ("int8", "int16")
    for key in set(got) - {"pos"}:
        t = np.asarray(got[key], np.float64)
        j = np.asarray(jnp.asarray(st[key]).astype(jnp.float32), np.float64)
        if key == "fdl" and quant:
            assert np.abs(t - j).max() <= 1, key
        else:
            rel = 1e-2 if storage == "bf16" else 2e-5
            assert np.abs(t - j).max() <= rel * np.abs(j).max(), key


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("part,ch", [(2, 2), (4, 1)])
def test_partsharded_matches_neojax(world, part, ch, scheme, storage):
    res = _case(world, f"pn-{part}x{ch}-{scheme}-{storage}")
    _check(res, storage, *_jax(part, ch, scheme, storage))


def test_partsharded_per_channel_filter(world):
    _check(_case(world, "pn-per-channel"), "split", *_jax(2, 2, "upols", "split", c_filt=cases.PN_C))


@pytest.mark.parametrize("part,ch,p2", [(2, 2, 6), (4, 1, 8)])
def test_meta_partitions_padded_to_the_shards(world, part, ch, p2):
    assert -(-cases.PN_P // cases.PN_S) == 5
    assert _case(world, f"pn-{part}x{ch}-upols-split")["p2"] == p2
