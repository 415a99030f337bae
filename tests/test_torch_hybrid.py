"""neojax_torch.conv.hybrid end to end on the CPU (the kernels' plain
route), held against neojax.conv.hybrid.

- ``process_hybrid`` with the unfused head (params without
  ``head_packed``) against neojax's XLA head, every storage, shared and
  per-channel filters, P not a multiple of S;
- ``process_hybrid`` with the fused head (B3 with ``acc_add``) against
  neojax's fused head with its Pallas kernels in interpret mode
  (``fused_step._INTERPRET`` and ``nested._INTERPRET``, then
  ``jax.clear_caches()``), and against the port's own unfused head;
- ``HybridStream`` block for block against ``process_hybrid``;
- a head-only filter, and a neojax stream continued in the port through
  ``neojax_torch.convert``.

Tolerances, relative to the output peak: ``_TOL`` is 1e-5 for split and
for the other storages the bounds of ``tests/test_hybrid.py``'s
reduced-precision test (bf16 5e-2, int16 1e-2, int8 1e-1); fused against
unfused head uses ``tests/test_hybrid.py:129``'s (split 1e-5, int16 2e-3,
int8 6e-2: the fused head's meta window reads ring-stored spectra);
``HybridStream`` against ``process_hybrid`` uses ``:179``'s (1e-5 split,
1e-4 int8, absolute).
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from neojax.conv import convolver as jcv
from neojax.conv import hybrid as jhy
from neojax.conv import nested as jnested
from neojax.kernels import fused_step as jfs
from neojax_torch import convert
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import hybrid as thy
from neojax_torch.kernels import fdl_mac as tmac
from neojax_torch.kernels import fused_step as tfs

_TOL = {"split": 1e-5, "bf16": 5e-2, "int16": 1e-2, "int8": 1e-1}
_TOL_FUSED = {"split": 1e-5, "int16": 2e-3, "int8": 6e-2}
_TOL_STREAM = {"split": 1e-5, "bf16": 1e-4, "int16": 1e-4, "int8": 1e-4}
B, P, C, S = 32, 19, 2, 4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-12, np.abs(b).max())


def _parts(rng, cf=1, p=P):
    return ((rng.standard_normal((cf, p, B + 1)) + 1j * rng.standard_normal((cf, p, B + 1))) * 0.1
            ).astype(np.complex64)


def _unfused(params):
    return {k: v for k, v in params.items() if k != "head_packed"}


@pytest.fixture
def kernels_interpret():
    jfs._INTERPRET = True
    jnested._INTERPRET = True
    jax.clear_caches()
    yield
    jfs._INTERPRET = False
    jnested._INTERPRET = False
    jax.clear_caches()


def _jax_hybrid(storage, parts, sig, fused, mac_backend="xla"):
    cfg = jcv.PartitionedConfig(B, P, C, storage=storage, mac_backend=mac_backend)
    params = jhy.hybrid_filter_params(cfg, parts, S)
    if not fused:
        params = _unfused(params)
    state = jhy.hybrid_init_state(cfg, params)
    assert ("head_dcny" in state) == fused
    state, out = jax.jit(partial(jhy.process_hybrid, cfg))(params, state, jnp.asarray(sig))
    return params, state, np.asarray(out)


def _torch_hybrid(storage, parts, sig, fused, **kw):
    cfg = tcv.PartitionedConfig(B, P, C, storage=storage, **kw)
    params = thy.hybrid_filter_params(cfg, parts, S, device="cpu")
    if not fused:
        params = _unfused(params)
    state = thy.hybrid_init_state(cfg, params)
    assert ("head_dcny" in state) == fused
    state, out = thy.process_hybrid(cfg, params, state, torch.from_numpy(sig))
    return params, state, out.numpy()


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("shared", [True, False])
def test_process_hybrid_unfused_matches_neojax_xla(rng, storage, shared):
    parts = _parts(rng, cf=1 if shared else C)
    sig = rng.uniform(-1, 1, (C, 6 * S * B - 7)).astype(np.float32)
    _, jstate, ref = _jax_hybrid(storage, parts, sig, fused=False)
    before = tmac.fdl_mac.launches
    _, tstate, out = _torch_hybrid(storage, parts, sig, fused=False)
    assert tmac.fdl_mac.launches == before  # CPU tensors: B1's plain version
    assert out.shape == sig.shape and _rel(out, ref) < _TOL[storage]
    assert set(tstate) == set(jstate)
    assert tstate["meta_pos"] == int(jstate["meta_pos"]) and tstate["head_pos"] == 0
    _, _, out_t = _torch_hybrid(storage, parts, sig, fused=False, mac_backend="torch")
    assert _rel(out_t, out) < 1e-5


@pytest.mark.parametrize("storage", ["split", "int16", "int8"])
def test_process_hybrid_fused_matches_neojax_kernels(kernels_interpret, rng, storage):
    """The fused head (B3 + acc_add) and the B5 tail against neojax's
    fused head and Pallas nested-MAC in interpret mode, and against the
    port's own unfused head."""
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 4 * S * B)).astype(np.float32)
    _, jstate, ref = _jax_hybrid(storage, parts, sig, fused=True, mac_backend="pallas")
    _, tstate, out = _torch_hybrid(storage, parts, sig, fused=True)
    assert _rel(out, ref) < _TOL[storage]
    assert set(tstate) == set(jstate)
    np.testing.assert_allclose(tstate["head_dcny"].numpy(), np.asarray(jstate["head_dcny"]),
                               rtol=1e-5, atol=1e-5)
    _, _, out_u = _torch_hybrid(storage, parts, sig, fused=False)
    assert _rel(out_u, out) < _TOL_FUSED[storage]


def test_fused_head_runs_b3_with_acc_add(rng, monkeypatch):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 2 * S * B)).astype(np.float32)
    seeds = []
    real = thy.fused_stream

    def spy(*args, acc_add=None, **kw):
        seeds.append(acc_add)
        return real(*args, acc_add=acc_add, **kw)

    monkeypatch.setattr(thy, "fused_stream", spy)
    _torch_hybrid("split", parts, sig, fused=True)
    assert len(seeds) == 2 and all(t.shape == (S, 2, C, B) for t in seeds)
    assert float(seeds[0].abs().max()) == 0.0 and float(seeds[1].abs().max()) > 0.0
    assert tfs.fused_stream.launches == 0  # CPU route


def test_hybrid_head_only_and_state_carry(rng):
    parts = _parts(rng, p=3)
    sig = rng.uniform(-1, 1, (C, 3 * S * B)).astype(np.float32)
    cfg = tcv.PartitionedConfig(B, 3, C, storage="split")
    params = thy.hybrid_filter_params(cfg, parts, S, device="cpu")
    assert "tail" not in params
    state = thy.hybrid_init_state(cfg, params)
    assert "meta_fdl" not in state
    _, out = thy.process_hybrid(cfg, params, state, torch.from_numpy(sig))
    jcfg = jcv.PartitionedConfig(B, 3, C, storage="split")
    jp = jhy.hybrid_filter_params(jcfg, parts, S)
    _, ref = jhy.process_hybrid(jcfg, jp, jhy.hybrid_init_state(jcfg, jp), jnp.asarray(sig))
    assert _rel(out.numpy(), np.asarray(ref)) < _TOL["split"]

    cfg = tcv.PartitionedConfig(B, P, C, storage="int8")
    params = thy.hybrid_filter_params(cfg, _parts(rng), S, device="cpu")
    sig = rng.uniform(-1, 1, (C, 6 * S * B)).astype(np.float32)
    _, full = thy.process_hybrid(cfg, params, thy.hybrid_init_state(cfg, params), torch.from_numpy(sig))
    st = thy.hybrid_init_state(cfg, params)
    ring = st["meta_fdl"]
    st, a = thy.process_hybrid(cfg, params, st, torch.from_numpy(sig[:, : 2 * S * B]))
    assert st["meta_fdl"] is ring and st["head_fdl"][0].dtype == torch.int16  # int8 head at int16
    _, b = thy.process_hybrid(cfg, params, st, torch.from_numpy(sig[:, 2 * S * B :]))
    assert torch.equal(torch.cat([a, b], dim=-1), full)


@pytest.mark.parametrize("storage", ["split", "bf16", "int8"])
def test_hybrid_stream_matches_process(rng, storage):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 5 * S * B)).astype(np.float32)
    cfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    params = thy.hybrid_filter_params(cfg, parts, S, device="cpu")
    _, ref = thy.process_hybrid(cfg, _unfused(params), thy.hybrid_init_state(cfg, _unfused(params)),
                                torch.from_numpy(sig))
    stream = thy.HybridStream(cfg, params)
    for _ in range(2):  # reset() restarts the stream exactly
        outs = [stream(sig[:, i * B : (i + 1) * B]) for i in range(sig.shape[1] // B)]
        got = torch.cat(outs, dim=-1)
        assert float((got - ref).abs().max()) < _TOL_STREAM[storage]
        assert stream.state["r"] == 0 and stream._r == 0
        stream.reset()
    with pytest.raises(NotImplementedError):
        thy.HybridStream(dataclasses.replace(cfg, scheme="upola"), params)


def test_hybrid_stream_state_matches_neojax_layout(rng):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 6 * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, storage="int8")
    jstream = jhy.HybridStream(jcfg, _unfused(jhy.hybrid_filter_params(jcfg, parts, S)))
    tcfg = tcv.PartitionedConfig(B, P, C, storage="int8")
    tstream = thy.HybridStream(tcfg, thy.hybrid_filter_params(tcfg, parts, S, device="cpu"))
    for i in range(6):
        jo = np.asarray(jstream(sig[:, i * B : (i + 1) * B]))
        to = tstream(sig[:, i * B : (i + 1) * B]).numpy()
    assert _rel(to, jo) < _TOL["int8"]
    j_np = jax.tree_util.tree_map(np.asarray, jstream.state)
    t_np = convert.state_to_numpy(tstream.state)
    assert set(t_np) == set(j_np) and t_np["r"] == int(j_np["r"]) == 2
    for key in ("chunk_spec", "prev_spec", "tail_frames"):
        assert t_np[key].shape == j_np[key].shape
    assert _rel(t_np["chunk_spec"], j_np["chunk_spec"]) < 1e-5


@pytest.mark.parametrize("storage,fused", [("split", False), ("bf16", False), ("int8", False),
                                           ("split", True), ("int8", True)])
def test_convert_continues_a_neojax_hybrid_stream(rng, storage, fused):
    """k chunks in neojax, the rest in the port: equal to a run wholly in
    neojax (its fused head in interpret mode where the port's is fused)."""
    k = 2
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 5 * S * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, storage=storage)
    jparams = jhy.hybrid_filter_params(jcfg, parts, S)
    if not fused:
        jparams = _unfused(jparams)
    jfs._INTERPRET = fused
    jax.clear_caches()
    try:
        _, full = jhy.process_hybrid(jcfg, jparams, jhy.hybrid_init_state(jcfg, jparams),
                                     jnp.asarray(sig))
        jstate, head = jhy.process_hybrid(jcfg, jparams, jhy.hybrid_init_state(jcfg, jparams),
                                          jnp.asarray(sig[:, : k * S * B]))
    finally:
        jfs._INTERPRET = False
        jax.clear_caches()
    tcfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    tparams = convert.hybrid_params_from_neojax(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                               device="cpu")
    assert ("head_packed" in tparams) == fused
    if fused:
        assert "filt_rim8" not in tparams["head_packed"]
        assert tparams["head_packed"]["filt_rim"].shape == (2 * S, 1, 2 * B)
    state_np = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = convert.hybrid_state_from_neojax(tcfg, state_np, device="cpu")
    assert ("head_dcny" in tstate) == fused and tstate["meta_pos"] == k % 4
    tstate, tail = thy.process_hybrid(tcfg, tparams, tstate, torch.from_numpy(sig[:, k * S * B :]))
    got = np.concatenate([np.asarray(head), tail.numpy()], axis=-1)
    assert _rel(got, np.asarray(full)) < (_TOL_FUSED if fused else _TOL)[storage]
    back = convert.state_to_numpy(tstate)
    assert set(back) == set(state_np) and back["meta_pos"] == 5 % 4
