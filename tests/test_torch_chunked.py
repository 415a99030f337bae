"""neojax_torch.conv.chunked on the CPU (the product's plain route), held
against neojax.conv.chunked on the same seeded inputs.

- the five cases of ``tests/test_chunked.py`` through both packages: the
  port against neojax (split 1e-4 absolute, the bound of those tests), and
  against ``np.convolve`` (split, 1e-4 absolute) where the filter is
  unmasked, against the port's per-block convolver over the same mask
  where it is masked;
- the bf16 rung against neojax within 5e-2 of the output peak (the bf16
  bound of ``tests/test_nested.py``; neojax on the CPU computes its
  ``DEFAULT`` transforms in full float32, the port rounds their operands
  to bf16 as the MXU does);
- the Toeplitz params (``tcat``, ``bins``, ``band``) equal neojax's bit
  for bit, dense and bucketed;
- a stream that neojax started, continued in the port through
  ``convert.chunked_params_from_neojax`` / ``chunked_state_from_neojax``
  (split 1e-4 absolute, bf16 5e-2 of the peak).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neojax import conv as jconv
from neojax.conv import chunked as jch
from neojax_torch import conv as tconv
from neojax_torch import convert
from neojax_torch.conv import chunked as tch

_ABS = 1e-4  # split, absolute (tests/test_chunked.py)
_BF16 = 5e-2  # bf16, relative to the output peak


def _cfgs(b, p, c, **kw):
    return jconv.PartitionedConfig(b, p, c, **kw), tconv.PartitionedConfig(b, p, c, **kw)


def _jax(jcfg, parts, sig, s, mask=None):
    params = jch.chunked_filter_params(jcfg, parts, s, mask=mask)
    state, out = jch.process_chunked(jcfg, params, jch.chunked_init_state(jcfg, params),
                                     jnp.asarray(sig), s)
    return params, state, np.asarray(out)


def _port(tcfg, parts, sig, s, mask=None):
    params = tch.chunked_filter_params(tcfg, np.asarray(parts), s, mask=mask, device="cpu")
    state, out = tch.process_chunked(tcfg, params, tch.chunked_init_state(tcfg, params, device="cpu"),
                                     torch.from_numpy(sig), s)
    return params, state, out.numpy()


def _np_convolve(sig, ir):
    return np.stack([np.convolve(x.astype(np.float64), ir.astype(np.float64))[: sig.shape[1]] for x in sig])


def _peak_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("storage", ["split", "bf16"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("s", [4, 8])
def test_chunked_matches_neojax_and_np_convolve(make_noise, storage, scheme, s):
    b, p, c = 64, 12, 3
    ir = make_noise(p * b) * 0.2
    sig = make_noise(c, 16 * b)
    parts = jconv.uniform_partition(ir, b)
    jcfg, tcfg = _cfgs(b, p, c, scheme=scheme, storage=storage)
    _, _, jout = _jax(jcfg, parts, sig, s)
    _, _, tout = _port(tcfg, parts, sig, s)
    assert tout.shape == jout.shape == sig.shape
    if storage == "split":
        assert np.abs(tout - jout).max() < _ABS
        assert np.abs(tout - _np_convolve(sig, ir)).max() < _ABS
    else:
        assert _peak_rel(tout, jout) < _BF16


def test_chunked_matches_direct_oracle(make_noise):
    b, p = 128, 8
    ir = make_noise(p * b) * 0.1
    sig = make_noise(2, 16 * b)
    parts = jconv.uniform_partition(ir, b)
    jcfg, tcfg = _cfgs(b, p, 2, storage="split")
    _, _, jout = _jax(jcfg, parts, sig, 8)
    _, _, tout = _port(tcfg, parts, sig, 8)
    assert np.abs(tout - _np_convolve(sig, ir)).max() < _ABS
    assert np.abs(tout - jout).max() < _ABS


def test_chunked_state_carries_across_calls(make_noise):
    b, p = 64, 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(1, 16 * b)
    parts = jconv.uniform_partition(ir, b)
    jcfg, tcfg = _cfgs(b, p, 1, storage="split")
    params, state, full = _port(tcfg, parts, sig, 4)
    st0 = tch.chunked_init_state(tcfg, params)
    st, a = tch.process_chunked(tcfg, params, st0, torch.from_numpy(sig[:, : 8 * b]), 4)
    # the windows are written in place: odd (1) and even (2) chunk counts
    # both leave them in the tensors of the state passed in
    assert st["hists"][0] is st0["hists"][0]
    st, a1 = tch.process_chunked(tcfg, params, st, torch.from_numpy(sig[:, 8 * b : 12 * b]), 4)
    st, a2 = tch.process_chunked(tcfg, params, st, torch.from_numpy(sig[:, 12 * b :]), 4)
    assert st["hists"][0] is st0["hists"][0]
    got = np.concatenate([a.numpy(), a1.numpy(), a2.numpy()], axis=-1)
    assert np.abs(got - full).max() < 1e-6
    _, jstate, jfull = _jax(jcfg, parts, sig, 4)
    assert np.abs(full - jfull).max() < _ABS
    assert np.abs(state["hists"][0].numpy() - np.asarray(jstate["hists"][0])).max() < _ABS
    assert np.abs(state["tail"].numpy() - np.asarray(jstate["tail"])).max() == 0.0


def test_chunked_rejects_per_channel_filter(make_noise):
    b = 64
    parts = jconv.uniform_partition(make_noise(2, 4 * b), b)
    jcfg, tcfg = _cfgs(b, parts.shape[1], 2)
    with pytest.raises(ValueError, match="nested"):
        jch.chunked_filter_params(jcfg, parts, 4)
    with pytest.raises(ValueError, match="nested"):
        tch.chunked_filter_params(tcfg, np.asarray(parts), 4, device="cpu")


def _decaying_parts(make_noise, b, p):
    ir = (make_noise(p * b) * np.exp(-np.arange(p * b) / (4 * b))).astype(np.float32) * 0.3
    return jconv.uniform_partition(ir, b)


def test_chunked_banded_sparse_matches_neojax_and_masked_perblock(make_noise):
    b, p = 64, 24
    parts = _decaying_parts(make_noise, b, p)
    sig = make_noise(2, 16 * b)
    mask = np.asarray(jconv.perceptual_mask(np.asarray(parts)[0], 48000.0, -50.0))
    jcfg, tcfg = _cfgs(b, p, 2, storage="split")
    jparams, _, jout = _jax(jcfg, parts, sig, 8, mask=mask)
    tparams, _, tout = _port(tcfg, parts, sig, 8, mask=mask)
    assert len(tparams["buckets"]) == len(jparams["buckets"]) > 1
    assert np.abs(tout - jout).max() < _ABS
    # the port's per-block convolver over the same mask
    pparams = tconv.filter_params(tcfg, np.asarray(parts), sparsity=mask[None], device="cpu")
    _, ref = tconv.process(tcfg, pparams, tconv.init_state(tcfg, device="cpu"), torch.from_numpy(sig))
    assert np.abs(tout - ref.numpy()).max() < _ABS


def test_chunked_fully_masked_bins_are_zero(make_noise):
    b, p = 64, 8
    ir = make_noise(p * b) * 0.2
    parts = jconv.uniform_partition(ir, b)
    mask = np.ones((p, b + 1), bool)
    mask[:, 40:] = False  # kill all high bins entirely
    sig = make_noise(1, 8 * b)
    jcfg, tcfg = _cfgs(b, p, 1, storage="split")
    _, _, jout = _jax(jcfg, parts, sig, 4, mask=mask)
    tparams, _, tout = _port(tcfg, parts, sig, 4, mask=mask)
    assert all(int(bk["bins"].max()) < 40 for bk in tparams["buckets"])
    assert np.abs(tout - jout).max() < _ABS
    pparams = tconv.filter_params(tcfg, np.asarray(parts), sparsity=mask[None], device="cpu")
    _, ref = tconv.process(tcfg, pparams, tconv.init_state(tcfg, device="cpu"), torch.from_numpy(sig))
    assert np.abs(tout - ref.numpy()).max() < _ABS
    # an all-masked filter has no bucket and outputs exact zeros
    _, _, zero = _port(tcfg, parts, sig, 4, mask=np.zeros((p, b + 1), bool))
    assert not np.any(zero)


@pytest.mark.parametrize("storage", ["split", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_toeplitz_params_equal_neojax_bit_for_bit(make_noise, storage, masked):
    b, p, s = 32, 10, 4
    parts = _decaying_parts(make_noise, b, p)
    mask = np.asarray(jconv.perceptual_mask(np.asarray(parts)[0], 48000.0, -40.0)) if masked else None
    jcfg, tcfg = _cfgs(b, p, 2, storage=storage)
    jp = jch.chunked_filter_params(jcfg, parts, s, mask=mask)
    tp = tch.chunked_filter_params(tcfg, np.asarray(parts), s, mask=mask, device="cpu")
    assert len(tp["buckets"]) == len(jp["buckets"]) == (1 if mask is None else 4)
    for jb, tb in zip(jp["buckets"], tp["buckets"]):
        jt = np.asarray(jb["tcat"].astype(jnp.float32))
        tt = tb["tcat"].float().numpy()
        assert tb["tcat"].dtype == (torch.bfloat16 if storage == "bf16" else torch.float32)
        assert np.array_equal(jt.view(np.int32), tt.view(np.int32))  # -0.0 included
        assert tb["bins"].dtype == torch.int32 and np.array_equal(np.asarray(jb["bins"]), tb["bins"].numpy())
        assert isinstance(tb["band"], int) and tb["band"] == jb["band"]
    # the host build of the port (its copy of neojax's) equals the device gather
    for tb in tp["buckets"][:1]:
        band, bins = tb["band"], tb["bins"].numpy()
        sub = np.asarray(parts)[0] if mask is None else np.where(mask, np.asarray(parts)[0], 0)
        sub = sub[:band][:, bins]
        host = tch._fold_tcat(tch._toeplitz(np.real(sub).astype(np.float32), s),
                              tch._toeplitz(np.imag(sub).astype(np.float32), s))
        want = torch.from_numpy(host).to(tb["tcat"].dtype).float().numpy()
        assert np.array_equal(want.view(np.int32), tb["tcat"].float().numpy().view(np.int32))


@pytest.mark.parametrize("storage", ["split", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_port_continues_a_neojax_stream(make_noise, storage, masked):
    b, p, c, s = 32, 10, 2, 4
    parts = _decaying_parts(make_noise, b, p)
    mask = np.asarray(jconv.perceptual_mask(np.asarray(parts)[0], 48000.0, -40.0)) if masked else None
    sig = make_noise(c, 4 * s * b)
    half = 2 * s * b
    jcfg, tcfg = _cfgs(b, p, c, storage=storage)
    jp = jch.chunked_filter_params(jcfg, parts, s, mask=mask)
    jstate, _ = jch.process_chunked(jcfg, jp, jch.chunked_init_state(jcfg, jp), jnp.asarray(sig[:, :half]), s)
    _, jrest = jch.process_chunked(jcfg, jp, jstate, jnp.asarray(sig[:, half:]), s)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(host(v) for v in tree)
        return tree if isinstance(tree, int) else np.asarray(tree)

    tp = convert.chunked_params_from_neojax(tcfg, host(jp), device="cpu")
    tstate = convert.chunked_state_from_neojax(tcfg, host(jstate), device="cpu")
    assert tstate["hists"][0].dtype == tp["buckets"][0]["tcat"].dtype
    _, trest = tch.process_chunked(tcfg, tp, tstate, torch.from_numpy(sig[:, half:]), s)
    jrest = np.asarray(jrest)
    if storage == "split":
        assert np.abs(trest.numpy() - jrest).max() < _ABS
    else:
        assert _peak_rel(trest.numpy(), jrest) < _BF16
    back = convert.state_to_numpy(tstate)
    assert isinstance(back["hists"], tuple) and len(back["hists"]) == len(jstate["hists"])
