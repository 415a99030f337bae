"""neojax_torch.dist's mesh, collectives and channel-sharded engines on a
4-rank gloo world of CPU processes, held against neojax.dist on the
8-device CPU mesh at the same mesh shape.

One world runs every case (``torch_dist_cases.dist_world``) in a
module-scoped fixture; each case is its own test. The ranks return global
arrays assembled from their shards; the JAX side runs here. Checks:

- ``make_mesh``'s shapes, axis names and errors, and that rank r has the
  coordinates JAX device r has (row-major);
- ``psum`` (over each axis of a 2x2 mesh, on a size-1 axis, complex) and
  ``ppermute`` (cyclic ring, one-hop halo with zeros at rank 0, a tuple in
  one round, size-1 identity), and ``channel_sharding``'s blocks;
- ``sharded_process`` at ch = 4 and ch = 2 (a 2x2 mesh), dense and split,
  streamed in two calls (the second takes the rank's own state), against
  ``neojax.dist.sharded_process`` (output and state) and bit-equal, output
  and state, to the port's single-process ``process`` over each rank's
  channels; a masked filter against ``neojax``'s single-device ``process``
  and the port's single-process engine;
- ``sharded_process_{chunked,nested,hybrid}`` at ch = 4 against
  ``neojax.dist``'s functions and bit-equal to the port's single-process
  engines.

Tolerance: 2e-5 of the output peak against neojax (f32 transforms of the
two packages round differently); quantized codes are not involved.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import neojax
from neojax.conv import chunked as jch
from neojax.conv import convolver as jcv
from neojax.conv import hybrid as jhy
from neojax.conv import nested as jne

import torch_dist_cases as cases
from torch_dist_world import run_world

TOL = 2e-5
WORLD = 4


@pytest.fixture(scope="module")
def world():
    return run_world(WORLD, "torch_dist_cases.dist_world")[0]


def _case(world, name):
    res = world[name]
    if isinstance(res, tuple) and res and res[0] == "error":
        pytest.fail(f"case {name} raised on the ranks:\n{res[1]}")
    return res


def _rel(a, b):
    """Max abs difference over the peak of ``b`` (complex arrays too)."""
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return np.abs(a - b).max() / max(1e-12, np.abs(b).max())


def _jmesh(**kw):
    return neojax.dist.make_mesh(devices=jax.devices()[:WORLD], **kw)


def _jax_coords(mesh):
    """JAX device r's coordinates on ``mesh``, by device id."""
    devs = np.vectorize(lambda d: d.id)(mesh.devices)
    out = {}
    for idx in np.ndindex(devs.shape):
        out[int(devs[idx])] = dict(zip(mesh.axis_names, idx))
    return out


def test_mesh_shapes_and_rank_coordinates(world):
    res = _case(world, "mesh")
    for name, kw in {"all": {}, "ch2": {"ch": 2}, "bin2": {"bin": 2}, "part4": {"part": 4}}.items():
        jm = _jmesh(**kw)
        assert res[name]["shape"] == dict(jm.shape)
        assert tuple(res[name]["axes"]) == tuple(jm.axis_names)
        want = _jax_coords(jm)
        for r, coords in enumerate(res[name]["coords"]):
            assert coords == want[r], (name, r)


@pytest.mark.parametrize("name,kw", [("ch3", {"ch": 3}), ("bin_part", {"bin": 2, "part": 2}),
                                     ("part2_ch4", {"part": 2, "ch": 4}), ("bin3", {"bin": 3})])
def test_make_mesh_errors(world, name, kw):
    got = _case(world, "mesh")["errors"][name]
    with pytest.raises(ValueError) as e:
        _jmesh(**kw)
    assert got == str(e.value)


def test_psum(world):
    g = _case(world, "collectives")
    for r, res in enumerate(g):
        x = np.array([r, 10.0 * r])
        part, ch = divmod(r, 2)  # 2x2 mesh, row-major
        same_part = [2 * part, 2 * part + 1]
        same_ch = [ch, ch + 2]
        np.testing.assert_array_equal(res["psum_ch"], sum(np.array([q, 10.0 * q]) for q in same_part))
        np.testing.assert_array_equal(res["psum_part"], sum(np.array([q, 10.0 * q]) for q in same_ch))
        np.testing.assert_array_equal(res["psum_size1"], x)
        np.testing.assert_array_equal(res["psum_complex"], 6 * np.array([1, 10]) * (1 - 1j))
        assert res["staged_bytes"] == 0  # CPU tensors are not staged


def test_ppermute(world):
    g = _case(world, "collectives")
    for r, res in enumerate(g):
        prev = (r - 1) % 4
        np.testing.assert_array_equal(res["ring"], [prev, 10.0 * prev])
        np.testing.assert_array_equal(res["halo"], [0.0, 0.0] if r == 0 else [r - 1, 10.0 * (r - 1)])
        peer = r ^ 2  # the other part index, same ch index
        np.testing.assert_array_equal(res["pair"][0], [peer, 10.0 * peer])
        np.testing.assert_array_equal(res["pair"][1], [peer + 100.0])
        np.testing.assert_array_equal(res["size1_ring"], [r, 10.0 * r])
        np.testing.assert_array_equal(res["size1_halo"], [0.0, 0.0])


def test_channel_sharding(world):
    g = _case(world, "collectives")
    for r, res in enumerate(g):
        assert res["sharding"] == (slice(2 * r, 2 * r + 2), slice(None))
        ch = r % 2
        assert res["sharding_ch2"] == (slice(None), slice(4 * ch, 4 * ch + 4), slice(None))


def _compare_state(tstate, jstate):
    assert set(tstate) == set(jstate)
    for key, t in tstate.items():
        j = jstate[key]
        if isinstance(t, int):
            assert t == int(j), key
        elif isinstance(t, tuple):
            for a, b in zip(t, j):
                assert _rel(a, b) < TOL, key
        else:
            assert _rel(t, np.asarray(j)) < TOL, key


@pytest.mark.parametrize("mesh_name,storage", [("ch4", "dense"), ("ch4", "split"), ("ch2", "dense"),
                                               ("ch2", "split")])
def test_sharded_process(world, mesh_name, storage):
    res = _case(world, f"sharded-{mesh_name}-{storage}")
    assert res["bit_equal"], "a rank's shard differs from the port's single-process process"
    assert res["local_fdl_contiguous"]
    cfg = jcv.PartitionedConfig(cases.B, cases.P, cases.C, storage=storage)
    params = jcv.filter_params(cfg, cases.parts())
    mesh = _jmesh(ch=4) if mesh_name == "ch4" else _jmesh(ch=2, part=2)
    sig = cases.signal()
    half = cases.NB // 2 * cases.B
    st, a = neojax.dist.sharded_process(cfg, params, jcv.init_state(cfg), jnp.asarray(sig[:, :half]), mesh)
    st, b = neojax.dist.sharded_process(cfg, params, st, jnp.asarray(sig[:, half:]), mesh)
    assert _rel(res["out"], np.concatenate([np.asarray(a), np.asarray(b)], axis=-1)) < TOL
    _compare_state(res["state"], st)


def test_sharded_process_masked(world):
    """A masked filter (the schedule tables rebuilt for each rank's channel
    count) against neojax's single-device ``process``."""
    res = _case(world, "sharded-ch4-masked")
    assert res["bit_equal"]
    cfg = jcv.PartitionedConfig(cases.B, cases.P, cases.C, storage="split")
    params = jcv.filter_params(cfg, cases.parts(), sparsity=cases.mask())
    _, ref = jcv.process(cfg, params, jcv.init_state(cfg), jnp.asarray(cases.signal()))
    assert _rel(res["out"], ref) < TOL


@pytest.mark.parametrize("kind", ["chunked", "nested", "hybrid"])
def test_sharded_engines(world, kind):
    res = _case(world, f"{kind}-ch4")
    assert res["bit_equal"], f"a rank's {kind} shard differs from the port's single-process engine"
    cfg = jcv.PartitionedConfig(cases.B, cases.P, cases.C, storage="split")
    sig = jnp.asarray(cases.signal())
    mesh = _jmesh(ch=4)
    if kind == "chunked":
        params = jch.chunked_filter_params(cfg, cases.parts(), cases.S)
        st, ref = neojax.dist.sharded_process_chunked(cfg, params, jch.chunked_init_state(cfg, params), sig,
                                                      mesh, cases.S)
        assert _rel(res["state"]["tail"], st["tail"]) < TOL
        for a, b in zip(res["state"]["hists"], st["hists"]):
            assert _rel(a, b) < TOL
    elif kind == "nested":
        params = jne.nested_filter_params(cfg, cases.parts(), cases.S)
        st, ref = neojax.dist.sharded_process_nested(cfg, params, jne.nested_init_state(cfg, params), sig, mesh)
        _compare_state(res["state"], st)
    else:
        params = jhy.hybrid_filter_params(cfg, cases.parts(), cases.S)
        _, ref = neojax.dist.sharded_process_hybrid(cfg, params, jhy.hybrid_init_state(cfg, params), sig, mesh)
    assert _rel(res["out"], ref) < TOL
