"""neojax_torch.conv.convolver end to end on the CPU (the kernels' plain
route), held against neojax and the C++-built goldens.

- ``process`` for both schemes and every storage against neojax's
  ``process``, in two forms: neojax's XLA path, and ``fused=True`` with the
  Pallas kernels in interpret mode (the ``fused_interpret`` fixture, as in
  ``tests/test_fused_step.py``).
- the goldens with the bounds of ``tests/test_reference_parity.py``
  (1e-5 absolute for f32 outputs; the reference's int8/int16 bounds).
- the re-blocking FIFO + ``flush`` contract, the entry points, and params
  and state carried over from neojax mid-stream.
- no ``jax`` import anywhere in the package.

``_TOL`` is relative to the output peak: the fused routes round the frame,
filter and accumulator to bf16 for the bf16/int8 storages, and int rows
may round one LSB apart after an ulp of difference upstream.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from neojax import conv as jconv
from neojax.conv import convolver as jcv
from neojax.kernels import fused_step as jfs
import neojax_torch
from neojax_torch import conv as tconv
from neojax_torch import convert
from neojax_torch.conv import convolver as tcv
from neojax_torch.kernels import fdl_mac as tmac_mod
from neojax_torch.kernels import fused_step as tfs_mod

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
_TOL = {"dense": 2e-5, "split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_STORAGES = ["dense", "split", "bf16", "int16", "int8"]
B, P, C = 32, 4, 2


@pytest.fixture
def fused_interpret():
    jfs._INTERPRET = True
    yield
    jfs._INTERPRET = False
    jax.clear_caches()


def _load(name):
    return np.load(os.path.join(GOLD, name))


def _parts(rng, p=P, cf=1):
    return ((rng.standard_normal((cf, p, B + 1)) + 1j * rng.standard_normal((cf, p, B + 1))) * 0.1
            ).astype(np.complex64)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(1e-6, np.abs(np.asarray(b)).max())


def _jax_process(cfg, parts, sig):
    params = jcv.filter_params(cfg, parts)
    _, out = jcv.process(cfg, params, jcv.init_state(cfg), jnp.asarray(sig))
    return np.asarray(out)


def _torch_process(cfg, parts, sig):
    params = tcv.filter_params(cfg, parts, device="cpu")
    _, out = tcv.process(cfg, params, tcv.init_state(cfg, device="cpu"), torch.from_numpy(sig))
    return out.numpy()


@pytest.mark.parametrize("storage", _STORAGES)
@pytest.mark.parametrize("scheme", ["upols", "upola"])
def test_process_matches_neojax_xla(rng, storage, scheme):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 7 * B - 5)).astype(np.float32)
    ref = _jax_process(jcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage), parts, sig)
    cfg = tcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage)
    assert _rel(_torch_process(cfg, parts, sig), ref) < _TOL[storage]
    if storage != "dense":  # the unfused route: torch.fft transforms + B1
        cfg_u = tcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage, fused=False)
        assert _rel(_torch_process(cfg_u, parts, sig), ref) < _TOL[storage]


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
def test_process_matches_neojax_fused(fused_interpret, rng, storage, scheme):
    parts = _parts(rng, cf=C if storage == "int16" else 1)
    sig = rng.uniform(-1, 1, (C, 6 * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage, fused=True)
    tcfg = tcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage, fused=True)
    assert _rel(_torch_process(tcfg, parts, sig), _jax_process(jcfg, parts, sig)) < _TOL[storage]


def _stream(scheme, storage, sig, sparsity=None):
    parts = tconv.uniform_partition(_load("in_ir.npy"), 128)
    if sparsity is None:
        c = tconv.make_convolver(scheme, storage, device="cpu")
    else:
        c = tconv.sparse_upols_convolver(sparsity=sparsity, device="cpu")
    c.filter(parts)
    return c.process(sig.astype(np.float32)).numpy()


@pytest.mark.parametrize("storage,scheme,golden", [
    ("dense", "upols", "ref_upols_b128"),
    ("dense", "upola", "ref_upola_b128"),
    ("split", "upols", "ref_upols_b128"),
    ("split", "upola", "ref_upola_b128"),
    ("split", "upols", "ref_split_upols_b128"),
    ("split", "upola", "ref_split_upola_b128"),
])
def test_goldens_f32(storage, scheme, golden):
    out = _stream(scheme, storage, _load("in_sig.npy"))
    assert np.abs(out - _load(f"{golden}.npy")).max() < 1e-5


def test_golden_sparse_upols():
    out = _stream("upols", "dense", _load("in_sig.npy"), sparsity=lambda row, col, value: (col % 3) != 0)
    assert np.abs(out - _load("ref_sparse_upols_b128.npy")).max() < 1e-5


@pytest.mark.parametrize("storage,tol_ref,tol_exact", [("int8", 5e-3, 5e-3), ("int16", 2e-4, 1e-4)])
def test_golden_quantized(storage, tol_ref, tol_exact):
    sig = _load("in_sig.npy") / 64.0
    ir = _load("in_ir.npy")
    out = _stream("upols", storage, sig)
    exact = np.stack([np.convolve(sig[i], ir[i])[: sig.shape[1]] for i in range(sig.shape[0])])
    assert np.abs(out - _load(f"ref_upols_{storage}_b128.npy")).max() < tol_ref
    assert np.abs(out - exact).max() < tol_exact


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_fifo_flush_equals_delayed_process(rng, storage):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 5 * B + 7)).astype(np.float32)
    ref_c = tconv.make_convolver("upols", storage, device="cpu")
    ref_c.filter(parts)
    ref = ref_c.process(sig).numpy()

    c = tconv.make_convolver("upols", storage, device="cpu")
    c.filter(parts)
    outs, off = [], 0
    for n in (5, 40, 1, 0, 64, 33, 7, 100):
        outs.append(c(sig[:, off : off + n]).numpy())
        off += n
    outs.append(c(sig[:, off:]).numpy())
    assert c.latency == B - 1
    outs.append(c.flush().numpy())
    got = np.concatenate(outs, axis=-1)
    want = np.concatenate([np.zeros((C, B - 1), np.float32), ref], axis=-1)
    assert got.shape == want.shape
    assert _rel(got, want) < _TOL[storage]


@pytest.mark.parametrize("storage", ["dense", "split", "int16"])
def test_exact_blocks_equal_process(rng, storage):
    """__call__ on exact blocks (the direct per-block path, B2 on the fused
    route) equals the whole-stream ``process`` (B3)."""
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 6 * B)).astype(np.float32)
    a = tconv.make_convolver("upols", storage, device="cpu")
    a.filter(parts)
    blocks = np.concatenate([a(sig[:, i * B : (i + 1) * B]).numpy() for i in range(6)], axis=-1)
    b = tconv.make_convolver("upols", storage, device="cpu")
    b.filter(parts)
    assert _rel(blocks, b.process(sig).numpy()) < _TOL[storage]
    assert a.latency == 0


def test_upola_equals_upols_and_mono_binding(rng):
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (3, 5 * B)).astype(np.float32)
    outs = []
    for make in (tconv.split_upols_convolver, tconv.split_upola_convolver, tconv.upola_convolver_v2):
        c = make(device="cpu")
        c.filter(parts)  # mono filter, bound to 3 channels at first use
        outs.append(c.process(sig).numpy())
    assert outs[0].shape == sig.shape
    assert _rel(outs[1], outs[0]) < 2e-5 and _rel(outs[2], outs[0]) < 2e-5
    mono = tconv.upols_convolver(device="cpu")
    mono.filter(parts)
    assert mono.process(sig[0]).shape == (5 * B,)


def test_convolver_errors(rng):
    c = tconv.upols_convolver(device="cpu")
    with pytest.raises(RuntimeError):
        c.process(np.zeros((1, B), np.float32))
    with pytest.raises(ValueError):
        tconv.sparse_upols_convolver(device="cpu").filter(_parts(rng))
    c.filter(_parts(rng, cf=2))
    with pytest.raises(ValueError):
        c.process(np.zeros((3, B), np.float32))
    with pytest.raises(ValueError):
        tcv.step(c.config, c.params, c.state, torch.zeros((2, B - 1)))
    with pytest.raises(ValueError):
        tcv.PartitionedConfig(B, P, C, storage="split", layout="shift", fused=True)
    with pytest.raises(ValueError):
        tcv.PartitionedConfig(B, P, C, mac_backend="pallas")


def test_filter_pads_partitions_and_default_storage():
    c = tconv.Convolver(device="cpu")
    assert c._storage == "dense"
    c.filter(np.zeros((1, 938, 513), np.complex64))
    assert c.config.num_partitions == 960
    gpu = tconv.Convolver(device="cuda")  # storage is chosen by device; nothing runs
    assert gpu._storage == "split"


def test_process_updates_ring_in_place(rng):
    cfg = tcv.PartitionedConfig(B, P, C, storage="int8")
    params = tcv.filter_params(cfg, _parts(rng), device="cpu")
    state = tcv.init_state(cfg, device="cpu")
    planes, scales = state["fdl"]
    dcny = state["dcny"]
    new, _ = tcv.process(cfg, params, state, torch.from_numpy(rng.uniform(-1, 1, (C, 3 * B)).astype(np.float32)))
    assert new["fdl"][0] is planes and new["fdl"][1] is scales and new["dcny"] is dcny
    assert new["pos"] == 3 and int(torch.count_nonzero(planes)) > 0


@pytest.mark.parametrize("storage", ["split", "bf16", "int8"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
def test_convert_continues_a_neojax_stream(rng, storage, scheme):
    """Run neojax for k blocks, carry params and state across, continue in
    the port; the result matches a stream run wholly in neojax."""
    k = 3
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 8 * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage)
    jparams = jcv.filter_params(jcfg, parts)
    _, full = jcv.process(jcfg, jparams, jcv.init_state(jcfg), jnp.asarray(sig))
    jstate, head = jcv.process(jcfg, jparams, jcv.init_state(jcfg), jnp.asarray(sig[:, : k * B]))

    tcfg = tcv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    state_np = jax.tree_util.tree_map(np.asarray, jstate)
    tparams = convert.params_from_neojax(tcfg, params_np, device="cpu")
    assert "filt_rim8" not in tparams and tparams["filt_rim"].shape == (2 * P, 1, 2 * B)
    tstate = convert.state_from_neojax(tcfg, state_np, device="cpu")
    assert tstate["pos"] == k
    tstate, tail = tcv.process(tcfg, tparams, tstate, torch.from_numpy(sig[:, k * B :]))
    got = np.concatenate([np.asarray(head), tail.numpy()], axis=-1)
    assert _rel(got, np.asarray(full)) < _TOL[storage]

    back = convert.state_to_numpy(tstate)
    assert set(back) == set(state_np)
    assert back["pos"] == 8 % P


def test_convert_round_trip_state(rng):
    cfg = tcv.PartitionedConfig(B, P, C, storage="bf16")
    state = tcv.init_state(cfg, device="cpu")
    state["fdl"].copy_(torch.from_numpy(rng.standard_normal((2, P, C, B)).astype(np.float32)))
    state["pos"] = 2
    again = convert.state_from_neojax(cfg, convert.state_to_numpy(state), device="cpu")
    assert again["pos"] == 2 and again["fdl"].dtype == torch.bfloat16
    assert torch.equal(again["fdl"], state["fdl"])


def test_kernel_wrappers_count_no_cpu_launches(rng):
    before = (tmac_mod.fdl_mac.launches, tfs_mod.fused_block_step.launches, tfs_mod.fused_stream.launches)
    cfg = tcv.PartitionedConfig(B, P, C, storage="split")
    _torch_process(cfg, _parts(rng), rng.uniform(-1, 1, (C, 2 * B)).astype(np.float32))
    after = (tmac_mod.fdl_mac.launches, tfs_mod.fused_block_step.launches, tfs_mod.fused_stream.launches)
    assert before == after


def test_package_never_imports_jax():
    root = Path(neojax_torch.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    offenders = []
    for path in files:
        if not path.exists():
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno}:{n}" for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "neojax")]
    assert len(files) > 10
    scanned = {path.relative_to(root.parent).as_posix() for path in files}
    assert {"neojax_torch/conv/nested.py", "neojax_torch/conv/hybrid.py",
            "neojax_torch/kernels/nested_mac.py", "chip_smoke.py"} <= scanned
    assert offenders == []
