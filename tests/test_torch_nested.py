"""neojax_torch.conv.nested end to end on the CPU (the kernels' plain
route), held against neojax.conv.nested.

- the split and meta transforms against neojax's matrices
  (``rfft_split_cat`` / ``irfft_split_cat`` / ``_meta_gemm_mats``);
- ``process_nested`` for both schemes, every storage, shared and
  per-channel filters, against neojax on its XLA path; the shared filter
  also against neojax with its Pallas nested-MAC in interpret mode
  (``nested._INTERPRET``, then ``jax.clear_caches()``, as
  ``tests/test_nested.py`` does);
- state carried across calls, the mask, and a neojax stream continued in
  the port through ``neojax_torch.convert``.

Tolerance ``_TOL``, relative to the output peak: 1e-5 for split/dense;
for the other storages the bounds of neojax's own tests of these engines
(``tests/test_nested.py``, ``tests/test_hybrid.py``: bf16 5e-2, int16
1e-2, int8 1e-1). The quantized meta rings are also compared directly:
codes within one LSB (the two packages' transforms round differently,
so a value near a rounding boundary may land one code apart) and scales
to 1e-5 of the largest scale.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from neojax.conv import convolver as jcv
from neojax.conv import nested as jnested
from neojax.fft import matmul_backend as jmb
from neojax_torch import convert
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import nested as tnested
from neojax_torch.fft import matmul_backend as tmb

_TOL = {"dense": 1e-5, "split": 1e-5, "bf16": 5e-2, "int16": 1e-2, "int8": 1e-1}
_STORAGES = ["split", "bf16", "int16", "int8"]
B, P, C, S = 32, 12, 2, 4  # P not a multiple of S: zero meta-partition padding


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-12, np.abs(b).max())


def _parts(rng, cf=1, p=P):
    return ((rng.standard_normal((cf, p, B + 1)) + 1j * rng.standard_normal((cf, p, B + 1))) * 0.1
            ).astype(np.complex64)


def _jax_nested(jcfg, parts, sig, s=S, **kw):
    params = jnested.nested_filter_params(jcfg, parts, s, **kw)
    state, out = jax.jit(partial(jnested.process_nested, jcfg))(
        params, jnested.nested_init_state(jcfg, params), jnp.asarray(sig)
    )
    return params, state, np.asarray(out)


def _torch_nested(tcfg, parts, sig, s=S, **kw):
    params = tnested.nested_filter_params(tcfg, parts, s, **kw)
    state, out = tnested.process_nested(tcfg, params, tnested.nested_init_state(tcfg, params),
                                        torch.from_numpy(sig))
    return params, state, out.numpy()


def _check_ring(storage, t_fdl, t_scl, j_fdl, j_scl):
    t = t_fdl.float().numpy()
    j = np.asarray(jnp.asarray(j_fdl).astype(jnp.float32))
    if storage in ("int8", "int16"):
        assert np.abs(t - j).max() <= 1
        assert _rel(t_scl.numpy(), j_scl) < 1e-5
    else:
        assert _rel(t, j) < _TOL[storage]


@pytest.mark.parametrize("n", [64, 128])
def test_split_transforms_match_neojax(rng, n):
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    jre, jim = jmb.rfft_split_cat(jnp.asarray(x), n)
    tre, tim = tmb.rfft_split(torch.from_numpy(x), n)
    assert tre.shape == (3, n // 2 + 1)
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=1e-5)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=1e-5)
    re = rng.standard_normal((3, n // 2 + 1)).astype(np.float32)
    im = rng.standard_normal((3, n // 2 + 1)).astype(np.float32)  # DC/Ny imag must not enter
    want = np.asarray(jmb.irfft_split_cat(jnp.asarray(re), jnp.asarray(im), n))
    got = tmb.irfft_split(torch.from_numpy(re), torch.from_numpy(im), n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("s", [2, 4, 64])
def test_meta_transforms_match_meta_gemm_mats(rng, s):
    """Forward: unnormalized C2C over the 2S window; inverse: normalized,
    tail columns [S, 2S) — held against ``_meta_gemm_mats`` itself."""
    mf, mi_tail = (np.asarray(m, np.float64) for m in jnested._meta_gemm_mats(s))
    re = rng.standard_normal((3, 5, 2 * s)).astype(np.float32)
    im = rng.standard_normal((3, 5, 2 * s)).astype(np.float32)
    want = np.concatenate([re, im], axis=-1).astype(np.float64) @ mf
    xre, xim = tmb.meta_fft(torch.from_numpy(re), torch.from_numpy(im))
    got = np.concatenate([xre.numpy(), xim.numpy()], axis=-1)
    assert _rel(got, want) < 1e-6
    want = np.concatenate([re, im], axis=-1).astype(np.float64) @ mi_tail
    yre, yim = tmb.meta_ifft_tail(torch.from_numpy(re), torch.from_numpy(im))
    assert yre.shape == (3, 5, s)
    assert _rel(np.concatenate([yre.numpy(), yim.numpy()], axis=-1), want) < 1e-6


def test_round_operand():
    x = torch.tensor([1.0 + 2.0**-12, 3.0])
    assert torch.equal(tmb.round_operand(x, "highest"), x)
    assert torch.equal(tmb.round_operand(x, "default"), torch.tensor([1.0, 3.0]))
    with pytest.raises(ValueError):
        tmb.round_operand(x, "fast")


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("shared", [True, False])
def test_process_nested_matches_neojax_xla(rng, storage, scheme, shared):
    parts = _parts(rng, cf=1 if shared else C)
    sig = rng.uniform(-1, 1, (C, 15 * B - 5)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage, mac_backend="xla")
    _, jstate, ref = _jax_nested(jcfg, parts, sig)
    tcfg = tcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage)
    tparams, tstate, out = _torch_nested(tcfg, parts, sig)
    assert out.shape == sig.shape
    assert _rel(out, ref) < _TOL[storage]
    assert tstate["pos"] == int(jstate["pos"]) and isinstance(tstate["pos"], int)
    _check_ring(storage, tstate["fdl"], tstate.get("scales"), jstate["fdl"], jstate.get("scales"))
    assert set(tstate) == set(jstate)
    # the plain tensor-op route gives the same result
    tcfg_t = dataclasses.replace(tcfg, mac_backend="torch")
    _, out_t = tnested.process_nested(tcfg_t, tparams, tnested.nested_init_state(tcfg_t, tparams),
                                      torch.from_numpy(sig))
    assert _rel(out_t.numpy(), out) < 1e-5


@pytest.mark.parametrize("storage", _STORAGES)
def test_process_nested_matches_neojax_kernel(rng, storage):
    """Shared filter against neojax's Pallas nested-MAC (interpret mode)."""
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 16 * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, storage=storage, mac_backend="pallas")
    jnested._INTERPRET = True
    jax.clear_caches()
    try:
        _, jstate, ref = _jax_nested(jcfg, parts, sig)
    finally:
        jnested._INTERPRET = False
        jax.clear_caches()
    tcfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    _, tstate, out = _torch_nested(tcfg, parts, sig)
    assert _rel(out, ref) < _TOL[storage]
    _check_ring(storage, tstate["fdl"], tstate.get("scales"), jstate["fdl"], jstate.get("scales"))


def test_process_nested_dense_and_quant_groups(rng):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 9 * B)).astype(np.float32)
    _, _, ref = _jax_nested(jcv.PartitionedConfig(B, P, C, storage="dense"), parts, sig)
    tcfg = tcv.PartitionedConfig(B, P, C, storage="dense")
    _, tstate, out = _torch_nested(tcfg, parts, sig)
    assert tstate["fdl"].dtype == torch.float32 and _rel(out, ref) < _TOL["dense"]
    for storage, s, g in (("int8", 128, 64), ("int8", 4, 8), ("int8", 3, 6), ("int16", 64, 1)):
        cfg = tcv.PartitionedConfig(B, P, C, storage=storage)
        assert tnested._quant_groups(cfg, s) == g == jnested._quant_groups(cfg, s)


def test_process_nested_state_carries_across_calls(rng):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 16 * B)).astype(np.float32)
    cfg = tcv.PartitionedConfig(B, P, C, storage="int8")
    params = tnested.nested_filter_params(cfg, parts, S)
    _, full = tnested.process_nested(cfg, params, tnested.nested_init_state(cfg, params),
                                     torch.from_numpy(sig))
    st = tnested.nested_init_state(cfg, params)
    fdl = st["fdl"]
    st, a = tnested.process_nested(cfg, params, st, torch.from_numpy(sig[:, : 8 * B]))
    assert st["fdl"] is fdl  # the meta ring is written in place
    st, b = tnested.process_nested(cfg, params, st, torch.from_numpy(sig[:, 8 * B :]), chunk_blocks=S)
    assert torch.equal(torch.cat([a, b], dim=-1), full)
    with pytest.raises(ValueError, match="chunk_blocks"):
        tnested.process_nested(cfg, params, st, torch.from_numpy(sig), chunk_blocks=2 * S)


def test_nested_mask_matches_neojax(rng):
    parts = _parts(rng)
    mask = np.ones((P, B + 1), bool)
    mask[:, 20:] = False
    sig = rng.uniform(-1, 1, (C, 8 * B)).astype(np.float32)
    _, _, ref = _jax_nested(jcv.PartitionedConfig(B, P, C, storage="split"), parts, sig, mask=mask)
    _, _, out = _torch_nested(tcv.PartitionedConfig(B, P, C, storage="split"), parts, sig, mask=mask)
    assert _rel(out, ref) < _TOL["split"]


@pytest.mark.parametrize("storage", ["split", "bf16", "int8"])
def test_convert_continues_a_neojax_nested_stream(rng, storage):
    """k chunks in neojax, the rest in the port: equal to a run wholly in
    neojax."""
    k = 2
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 20 * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, storage=storage)
    jparams, _, full = _jax_nested(jcfg, parts, sig)
    jstate, head = jnested.process_nested(jcfg, jparams, jnested.nested_init_state(jcfg, jparams),
                                          jnp.asarray(sig[:, : k * S * B]))
    tcfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    tparams = convert.nested_params_from_neojax(tcfg, jax.tree_util.tree_map(np.asarray, jparams))
    state_np = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = convert.nested_state_from_neojax(tcfg, state_np)
    assert tstate["pos"] == k and tstate["prev"].dtype == tnested._prev_dtype(tcfg)
    tstate, tail = tnested.process_nested(tcfg, tparams, tstate, torch.from_numpy(sig[:, k * S * B :]))
    got = np.concatenate([np.asarray(head), tail.numpy()], axis=-1)
    assert _rel(got, full) < _TOL[storage]
    back = convert.state_to_numpy(tstate)
    assert set(back) == set(state_np) and back["pos"] == 5 % 3
