"""neojax_torch.conv.make_engine on the CPU (the kernels' plain routes),
held against itself across engines and against neojax.conv.make_engine.

- ``tests/test_convolution.py``'s uniform-surface test on the port: the
  four engines agree within 2e-5 absolute across two ``process`` calls and
  after ``reset``, and an unknown engine raises;
- each engine against neojax's ``Engine`` on the same inputs, plain and
  with a keep-mask or a sparsity predicate (2e-5 absolute; neojax's
  Pallas kernels in interpret mode, ``fused_step._INTERPRET`` and
  ``nested._INTERPRET``, then ``jax.clear_caches()``, as
  ``tests/test_torch_hybrid.py`` does);
- ``latency`` is 0 for every engine; ``storage=None`` on the CPU is
  ``"dense"``, and the dense engines convolve (1e-4 absolute against
  ``np.convolve``).
"""

import numpy as np
import pytest
import torch
import jax

from neojax import conv as jconv
from neojax.conv import nested as jnested
from neojax.kernels import fused_step as jfs
from neojax_torch import conv as tconv

_TOL = 2e-5  # tests/test_convolution.py's make_engine bound, absolute
_ENGINES = ["perblock", "nested", "hybrid", "chunked"]
B, S, C, P = 32, 4, 2, 12


@pytest.fixture
def kernels_interpret():
    jfs._INTERPRET = True
    jnested._INTERPRET = True
    jax.clear_caches()
    yield
    jfs._INTERPRET = False
    jnested._INTERPRET = False
    jax.clear_caches()


@pytest.fixture
def inputs(make_noise):
    ir = make_noise(P * B) * 0.2
    parts = np.asarray(jconv.uniform_partition(ir, B))
    return ir, parts, make_noise(C, 4 * S * B), make_noise(C, 2 * S * B)


def _two_calls(eng, sig, sig2):
    return np.concatenate([np.asarray(eng.process(sig)), np.asarray(eng.process(sig2))], axis=-1)


@pytest.mark.parametrize("engine", ["nested", "hybrid", "chunked"])
def test_make_engine_uniform_surface(inputs, engine):
    _, parts, sig, sig2 = inputs
    ref = _two_calls(tconv.make_engine("perblock", parts, storage="split", channels=C, device="cpu"), sig, sig2)
    eng = tconv.make_engine(engine, parts, storage="split", chunk_blocks=S, channels=C, device="cpu")
    np.testing.assert_allclose(_two_calls(eng, sig, sig2), ref, atol=_TOL, err_msg=engine)
    eng.reset()  # a fresh stream
    out_r = eng.process(np.concatenate([sig, sig2], axis=-1)).numpy()
    np.testing.assert_allclose(out_r, ref, atol=_TOL, err_msg=engine)


def test_make_engine_unknown_engine_raises(inputs):
    with pytest.raises(ValueError, match="unknown engine"):
        tconv.make_engine("warp", inputs[1], device="cpu")


def _sparsity(kind, parts):
    if kind == "mask":
        return np.asarray(jconv.perceptual_mask(parts[0], 48000.0, -20.0))
    if kind == "predicate":
        return lambda row, col, value: (col % 3) != 0
    return None


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("sparsity", [None, "mask", "predicate"])
def test_engine_matches_neojax(kernels_interpret, inputs, engine, sparsity):
    _, parts, sig, sig2 = inputs
    sp = _sparsity(sparsity, parts)
    kw = dict(storage="split", chunk_blocks=S, channels=C, sparsity=sp)
    jeng = jconv.make_engine(engine, parts, **kw)
    teng = tconv.make_engine(engine, parts, **kw, device="cpu")
    assert teng.chunk_blocks == jeng.chunk_blocks and teng.config.num_partitions == jeng.config.num_partitions
    np.testing.assert_allclose(_two_calls(teng, sig, sig2), _two_calls(jeng, sig, sig2), atol=_TOL)


@pytest.mark.parametrize("sparsity", ["mask", "predicate"])
def test_sparsity_reaches_all_four_engines(inputs, sparsity):
    """The masked engines agree with each other, and differ from the
    unmasked filter's output (the mask reached the engine)."""
    _, parts, sig, sig2 = inputs
    sp = _sparsity(sparsity, parts)
    kw = dict(storage="split", chunk_blocks=S, channels=C, device="cpu")
    ref = _two_calls(tconv.make_engine("perblock", parts, sparsity=sp, **kw), sig, sig2)
    dense = _two_calls(tconv.make_engine("perblock", parts, **kw), sig, sig2)
    assert np.abs(ref - dense).max() > 1e-2
    for engine in ("nested", "hybrid", "chunked"):
        out = _two_calls(tconv.make_engine(engine, parts, sparsity=sp, **kw), sig, sig2)
        np.testing.assert_allclose(out, ref, atol=_TOL, err_msg=engine)


@pytest.mark.parametrize("engine", _ENGINES)
def test_engine_defaults_on_the_cpu(inputs, engine):
    """``storage=None`` on the CPU is ``"dense"``; latency 0; the engine
    convolves; the default chunk sizes are neojax's."""
    ir, parts, sig, _ = inputs
    eng = tconv.make_engine(engine, parts, channels=C, device="cpu",
                            chunk_blocks=S if engine != "perblock" else None)
    assert eng.config.storage == "dense"
    assert eng.latency == 0
    assert eng.device == torch.device("cpu")
    assert tconv.make_engine(engine, parts, device="cpu").chunk_blocks == \
        {"perblock": 0, "nested": 128, "hybrid": 64, "chunked": 32}[engine]
    out = eng.process(sig).numpy()
    ref = np.stack([np.convolve(x.astype(np.float64), ir.astype(np.float64))[: sig.shape[1]] for x in sig])
    assert out.shape == sig.shape and np.abs(out - ref).max() < 1e-4
    assert set(eng.state) == set(eng._init())


def test_engine_rejects_mismatched_block_size(inputs):
    with pytest.raises(ValueError, match="block_size"):
        tconv.make_engine("chunked", inputs[1], block_size=2 * B, device="cpu")
