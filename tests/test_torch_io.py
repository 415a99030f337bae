"""neojax_torch.io against neojax.io on the CPU: the WAV codec (bytes written
equal to ``neojax``'s), the IR resampler (within 1e-6 of ``neojax``'s, plus
``tests/test_resample.py``'s tone, identity, DC and alias checks), the
native runtime (``tests/test_native.py``: codec, re-blocker, SPSC ring,
extensible subformats; built from ``native/neo_runtime.cpp`` into
``neojax_torch/_build/``), ``StreamExecutor`` (equal to the offline stream
within 1e-5) and checkpoints (a round trip ``array_equal`` for every
storage, and a stream saved by one package and continued by the other
within the storage's tolerance of the uninterrupted stream).

Tolerances for the cross-package streams: ``_TOL``, max|a - b| / max|b|
(``tests/test_torch_convolver.py``'s ladder).
"""

import importlib
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neojax import io as jio
from neojax.conv import convolver as jcv
from neojax.io import native as jnat
from neojax.io import wav as jwav
from neojax_torch import conv as tconv
from neojax_torch import convert
from neojax_torch import io as tio
from neojax_torch.conv import convolver as tcv
from neojax_torch.conv import hybrid as thy
from neojax_torch.io import native as tnat
from neojax_torch.io import wav as twav

jrs = importlib.import_module("neojax.io.resample")  # the packages' io re-exports a function of that name
trs = importlib.import_module("neojax_torch.io.resample")

CPU = "cpu"
_TOL = {"dense": 2e-5, "split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
B, P, C = 32, 4, 2


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(1e-6, np.abs(np.asarray(b)).max())


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------------- WAV


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("channels", [1, 3])
def test_write_wav_bytes_equal_neojax(tmp_path, make_noise, bits, channels):
    x = make_noise(channels, 1001) * 1.2  # some samples clip
    x[0, :4] = [1.0, -1.0, 0.999999, -0.999999]
    twav.write_wav(str(tmp_path / "t.wav"), x, 44100, bits=bits)
    jwav.write_wav(str(tmp_path / "j.wav"), x, 44100, bits=bits)
    assert _bytes(tmp_path / "t.wav") == _bytes(tmp_path / "j.wav")
    y, sr = twav.read_wav(str(tmp_path / "t.wav"))
    assert sr == 44100 and y.shape == x.shape and y.dtype == np.float32
    np.testing.assert_array_equal(y, jwav.read_wav(str(tmp_path / "j.wav"))[0])
    twav.write_wav(str(tmp_path / "mono.wav"), x[0], 8000, bits=bits)  # [frames] is one channel
    assert twav.read_wav(str(tmp_path / "mono.wav"))[0].shape == (1, 1001)


def _riff(fmt: bytes, raw: bytes) -> bytes:
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(raw)) + raw
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _pcm24(x):
    ints = np.clip(np.round(x.T.reshape(-1) * (1 << 23)), -(1 << 23), (1 << 23) - 1).astype(np.int32)
    return np.stack([ints & 0xFF, (ints >> 8) & 0xFF, (ints >> 16) & 0xFF], -1).astype(np.uint8).tobytes()


_GUID_TAIL = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def _wav_file(kind, x, sr):
    """A WAV of format ``kind``: PCM 24, IEEE float, and the extensible
    PCM 16 / float 32 / PCM 32 (``tests/test_native.py``'s layouts)."""
    ch = x.shape[0]
    inter = x.T.reshape(-1)
    if kind == "pcm24":
        return _riff(struct.pack("<HHIIHH", 1, ch, sr, sr * ch * 3, ch * 3, 24), _pcm24(x))
    if kind == "float":
        return _riff(struct.pack("<HHIIHH", 3, ch, sr, sr * ch * 4, ch * 4, 32), inter.astype("<f4").tobytes())
    sub, bits, raw = {
        "ext_pcm16": (1, 16, (np.clip(inter, -1, 1) * 32767.0).round().astype("<i2").tobytes()),
        "ext_float": (3, 32, inter.astype("<f4").tobytes()),
        "ext_pcm32": (1, 32, np.clip((inter.astype(np.float64) * ((1 << 31) - 1)).round(), -(1 << 31),
                                     (1 << 31) - 1).astype("<i4").tobytes()),
    }[kind]
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, ch, sr, sr * ch * bits // 8, ch * bits // 8, bits, 22, bits,
                      (1 << ch) - 1) + struct.pack("<H", sub) + _GUID_TAIL
    return _riff(fmt, raw)


@pytest.mark.parametrize("kind", ["pcm24", "float", "ext_pcm16", "ext_float", "ext_pcm32"])
def test_read_wav_formats_match_neojax(tmp_path, make_noise, kind):
    x = make_noise(2, 500) * 0.8
    path = str(tmp_path / f"{kind}.wav")
    with open(path, "wb") as f:
        f.write(_wav_file(kind, x, 48000))
    y, sr = twav.read_wav(path)
    want, jsr = jwav.read_wav(path)
    assert sr == jsr == 48000
    np.testing.assert_array_equal(y, want)
    tol = {"ext_pcm16": 1e-4, "pcm24": 1e-6, "ext_pcm32": 1e-6}.get(kind, 1e-7)
    assert np.abs(y - x).max() < tol


def test_read_wav_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX\x00\x00\x00\x00WAVE")
    with pytest.raises(ValueError):
        twav.read_wav(str(bad))
    bad.write_bytes(_riff(struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8), b"\x00" * 8))
    with pytest.raises(ValueError, match="bit depth"):
        twav.read_wav(str(bad))
    with pytest.raises(ValueError):
        twav.write_wav(str(bad), np.zeros((1, 4), np.float32), 8000, bits=24)


def test_write_wav_pcm32_full_scale_roundtrip(tmp_path):
    x = np.array([[1.0, -1.0, 0.5, 0.999999]], np.float32)
    p = str(tmp_path / "fs.wav")
    twav.write_wav(p, x, 48000, bits=32)
    y, _ = twav.read_wav(p)
    assert np.abs(y - x).max() < 1e-6 and y[0, 0] > 0.99  # not sign-flipped


# -------------------------------------------------------------- resample


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 48000), (48000, 44100), (22050, 44100), (48000, 16000),
                                          (8000, 16000), (44100, 44100)])
def test_resample_matches_neojax(rng, sr_in, sr_out):
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    got = trs.resample(x, sr_in, sr_out)
    want = jrs.resample(x, sr_in, sr_out)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6
    np.testing.assert_array_equal(trs.polyphase_weights(160, 147), jrs.polyphase_weights(160, 147))


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 48000), (48000, 44100), (22050, 44100), (48000, 16000)])
def test_tone_preserved_across_rates(sr_in, sr_out):
    f = 1000.0
    x = np.sin(2 * np.pi * f * np.arange(int(sr_in * 0.4)) / sr_in).astype(np.float32)
    y = trs.resample(x, sr_in, sr_out)
    want = np.sin(2 * np.pi * f * np.arange(y.shape[-1]) / sr_out)
    m = slice(200, y.shape[-1] - 200)  # edge taper excluded
    assert np.abs(y[m] - want[m]).max() < 2e-4


def test_resample_length_identity_dc_and_errors():
    x = np.random.default_rng(0).standard_normal(12345).astype(np.float32)
    assert trs.resample(x, 48000, 48000).shape == x.shape
    assert trs.resample(x, 44100, 48000).shape[-1] == -(-12345 * 160 // 147)
    y = trs.resample(np.ones((3, 4000), np.float32), 44100, 48000)
    assert y.shape == (3, -(-4000 * 160 // 147)) and np.abs(y[:, 100:-100] - 1.0).max() < 1e-4
    with pytest.raises(ValueError):
        trs.resample(x, 0, 48000)


def test_downsample_rejects_aliasing():
    sr_in, sr_out = 48000, 16000
    x = np.sin(2 * np.pi * 11000.0 * np.arange(sr_in // 2) / sr_in).astype(np.float32)  # > 8 kHz
    y = trs.resample(x, sr_in, sr_out)
    assert np.sqrt(np.mean(y[200:-200] ** 2)) < 1e-3  # vs 0.707 if passed


def test_weight_bank_partition_of_unity():
    w = trs.polyphase_weights(160, 147, half_width=32)
    assert w.shape == (160, 64) and np.abs(w.sum(axis=1) - 1.0).max() < 1e-4


# ---------------------------------------------------------------- native


@pytest.fixture(scope="module")
def runtime():
    lib = tnat.load_runtime()
    assert lib is not None, "g++ could not build native/neo_runtime.cpp"
    return lib


def test_runtime_builds_into_the_package(runtime):
    path = os.path.join(os.path.dirname(tnat.__file__), os.pardir, "_build", "libneo_runtime.so")
    assert os.path.exists(path) and os.path.samefile(runtime._name, path)


def test_native_codec_bytes_equal_neojax(tmp_path, runtime, make_noise):
    if jnat.load_runtime() is None:
        pytest.skip("neojax's native runtime not built")
    x = (make_noise(3, 2000) * 0.9).astype(np.float32)
    tnat.native_write_wav(str(tmp_path / "t.wav"), x, 48000)
    jnat.native_write_wav(str(tmp_path / "j.wav"), x, 48000)
    assert _bytes(tmp_path / "t.wav") == _bytes(tmp_path / "j.wav")


def test_native_matches_python_codec(tmp_path, runtime, make_noise):
    x = (make_noise(3, 2000) * 0.5).astype(np.float32)
    p1, p2 = str(tmp_path / "n.wav"), str(tmp_path / "p.wav")
    tnat.native_write_wav(p1, x, 48000)
    twav.write_wav(p2, x, 48000)
    a, sr = tnat.native_read_wav(p2)
    assert sr == 48000
    np.testing.assert_array_equal(a, twav.read_wav(p2)[0])  # native decode == python decode
    assert np.abs(twav.read_wav(p1)[0] - x).max() < 1.0 / 10000
    y, sr = tnat.native_read_wav(p1)
    assert sr == 48000 and np.abs(y - x).max() < 1.0 / 10000


@pytest.mark.parametrize("kind", ["ext_pcm16", "ext_float", "ext_pcm32"])
def test_native_extensible_subformat(tmp_path, runtime, make_noise, kind):
    x = (make_noise(2, 500) * 0.8).astype(np.float32)
    path = str(tmp_path / f"{kind}.wav")
    with open(path, "wb") as f:
        f.write(_wav_file(kind, x, 48000))
    z, sr = tnat.native_read_wav(path)
    assert sr == 48000 and np.abs(z - x).max() < (1e-4 if kind == "ext_pcm16" else 1e-6)


def test_reblocker_identity_with_latency(runtime, make_noise):
    x = make_noise(2, 3000)
    rb = tnat.Reblocker(2, 128)
    outs = []
    for i in range(0, 3000, 100):  # host blocks not a divisor of the frame
        blk = x[:, i : i + 100]
        outs.append(rb.process(np.pad(blk, ((0, 0), (0, 100 - blk.shape[1]))), lambda f: f))
    out = np.concatenate(outs, axis=1)
    assert rb.latency == 128
    assert np.abs(out - np.pad(x, ((0, 0), (128, 0)))[:, : out.shape[1]]).max() == 0.0


def test_reblocker_with_convolver(runtime, make_noise):
    """The port's convolver behind the native re-blocker at an awkward host
    block size (its tensor outputs come back through ``.cpu()``)."""
    b = 128
    ir = make_noise(2 * b) * 0.3
    c = tconv.upols_convolver(device=CPU)
    c.filter(tconv.uniform_partition(ir, b))
    x = make_noise(1, 2048)
    rb = tnat.Reblocker(1, b)
    outs = []
    for i in range(0, 2048, 96):
        blk = x[:, i : i + 96]
        outs.append(rb.process(np.pad(blk, ((0, 0), (0, 96 - blk.shape[1]))), c))
    out = np.concatenate(outs, axis=1)
    got = out[0, b:]  # one frame of latency
    ref = np.convolve(x[0], ir)[: got.shape[0]]
    assert np.abs(got - ref).max() < 1e-4


def test_native_ring_spsc(runtime):
    r = tnat.Ring(64)
    assert r.capacity >= 64 and r.readable == 0
    data = np.arange(10, dtype=np.float32)
    assert r.write(data) == 10 and r.readable == 10
    np.testing.assert_array_equal(r.read(6), data[:6])
    assert r.readable == 4
    big = np.arange(r.capacity - 2, dtype=np.float32)  # wraps around
    wrote = r.write(big)
    assert wrote == min(big.size, r.writable + wrote)
    np.testing.assert_array_equal(r.read(r.readable)[:4], data[6:])
    with pytest.raises(ValueError):
        tnat.Ring(0)


def _drain(ex, sig, chunk, deadline_s=60):
    import time

    got, pos = [], 0
    t_end = time.time() + deadline_s
    while sum(g.shape[1] for g in got) < sig.shape[1]:
        if pos < sig.shape[1]:
            pos += ex.push(sig[:, pos : pos + chunk])
        out = ex.pull(256)
        if out.shape[1]:
            got.append(out)
        else:
            time.sleep(0.001)
        assert time.time() < t_end, "executor stalled"
    return np.concatenate(got, axis=1)


def test_stream_executor_matches_offline(runtime, make_noise):
    """``tests/test_native.py::test_stream_executor_matches_offline`` on the
    port: a ``conv.step`` closure, odd-sized pushes, polled pulls."""
    b, p, ch = 64, 6, 2
    parts = tconv.uniform_partition(make_noise(p * b) * 0.2, b)
    sig = make_noise(ch, 12 * b)
    cfg = tconv.PartitionedConfig(b, p, channels=ch, storage="split")
    params = tconv.filter_params(cfg, parts, device=CPU)
    _, ref = tconv.process(cfg, params, tconv.init_state(cfg, device=CPU), torch.from_numpy(sig))

    def step(state, block):
        return tconv.step(cfg, params, state, torch.from_numpy(np.ascontiguousarray(block)))

    with tio.StreamExecutor(step, tconv.init_state(cfg, device=CPU), ch, b) as ex:
        out = _drain(ex, sig, 100)
    assert out.shape == sig.shape
    assert np.max(np.abs(out - ref.numpy())) < 1e-5


def test_stream_executor_runs_hybrid_stream(runtime, make_noise):
    """The real-time example's topology: ``HybridStream`` behind the
    executor equals the offline ``process_hybrid`` (unfused head)."""
    b, s, ch = 32, 4, 2
    parts = tconv.uniform_partition(make_noise(10 * b) * 0.2, b)
    cfg = tcv.PartitionedConfig(b, parts.shape[1], ch, storage="split")
    params = {k: v for k, v in thy.hybrid_filter_params(cfg, parts, s, device=CPU).items() if k != "head_packed"}
    sig = make_noise(ch, 6 * s * b)
    _, ref = thy.process_hybrid(cfg, params, thy.hybrid_init_state(cfg, params), torch.from_numpy(sig))
    stream = thy.HybridStream(cfg, params)
    with tio.StreamExecutor(lambda st, blk: (st, stream(blk)), None, ch, b) as ex:
        out = _drain(ex, sig, 77)
    assert np.max(np.abs(out - ref.numpy())) < 1e-5


def test_realtime_example_run_matches_offline(runtime, tmp_path):
    """``examples/realtime_stream_torch.run`` at a small size: both paths
    equal the offline ``process_hybrid`` within 1e-4, its record written."""
    import json
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "examples"))
    try:
        example = importlib.import_module("realtime_stream_torch")
    finally:
        sys.path.pop(0)
    out = tmp_path / "demo.json"
    res = example.run(channels=2, seconds=0.5, ir_seconds=0.2, block=64, chunk_blocks=8, out=str(out), device=CPU)
    cb, ex = res["callback_path"], res["executor_path"]
    assert res["config"]["storage"] == "split" and res["config"]["partitions"] == 150
    assert cb["blocks"] == 368 and cb["max_abs_err_vs_offline"] < 1e-4
    assert ex["matches_offline_1e-4"] and ex["samples_out"] == 368 * 64
    assert json.loads(out.read_text()) == res


def test_executor_and_rings_raise_without_the_runtime(monkeypatch):
    monkeypatch.setattr(tnat, "load_runtime", lambda build=True: None)
    for make in (lambda: tio.StreamExecutor(lambda s, b: (s, b), None, 1, 8), lambda: tnat.Ring(8),
                 lambda: tnat.Reblocker(1, 8)):
        with pytest.raises(RuntimeError, match="native runtime not available"):
            make()


def test_executor_rejects_wrong_channels(runtime):
    with tio.StreamExecutor(lambda s, b: (s, b), None, 2, 8) as ex:
        with pytest.raises(ValueError):
            ex.push(np.zeros((3, 8), np.float32))


# ------------------------------------------------------------ checkpoint


def _parts(rng, p=P):
    return ((rng.standard_normal((1, p, B + 1)) + 1j * rng.standard_normal((1, p, B + 1))) * 0.1
            ).astype(np.complex64)


@pytest.mark.parametrize("storage", ["dense", "split", "bf16", "int16", "int8"])
def test_checkpoint_roundtrip(tmp_path, rng, storage):
    """``tests/test_extras.py::test_checkpoint_roundtrip`` on the port, at every storage."""
    cfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    params = tcv.filter_params(cfg, _parts(rng), device=CPU)
    sig = torch.from_numpy(rng.uniform(-1, 1, (C, 5 * B)).astype(np.float32))
    state, _ = tcv.process(cfg, params, tcv.init_state(cfg, device=CPU), sig)
    path = str(tmp_path / "state.npz")
    tio.save_state(path, state)
    restored = tio.load_state(path, device=CPU)
    assert restored["pos"] == state["pos"] == 5 % P and isinstance(restored["pos"], int)
    with np.load(path) as f:
        assert f["pos"].shape == () and f["pos"].dtype == np.int32
        assert all(".tuple" in k for k in f.files if k.startswith("fdl")) == isinstance(state["fdl"], tuple)
    for key, value in state.items():
        for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (value, restored[key]))):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), key
    _, out_a = tcv.process(cfg, params, state, sig)
    _, out_b = tcv.process(cfg, params, restored, sig)
    assert torch.equal(out_a, out_b)


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_checkpoint_roundtrip_hybrid(tmp_path, rng, storage):
    """The hybrid state: a quantized head ring (a tuple), three int positions."""
    cfg = tcv.PartitionedConfig(B, 10, C, storage=storage)
    params = thy.hybrid_filter_params(cfg, _parts(rng, 10), 4, device=CPU)
    sig = torch.from_numpy(rng.uniform(-1, 1, (C, 8 * B)).astype(np.float32))
    state, _ = thy.process_hybrid(cfg, params, thy.hybrid_init_state(cfg, params), sig)
    tio.save_state(str(tmp_path / "h.npz"), state)
    restored = tio.load_state(str(tmp_path / "h.npz"), device=CPU)
    assert isinstance(restored["head_pos"], int) and isinstance(restored["meta_pos"], int)
    _, out_a = thy.process_hybrid(cfg, params, state, sig)
    _, out_b = thy.process_hybrid(cfg, params, restored, sig)
    assert torch.equal(out_a, out_b)


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    tio.save_state(str(tmp_path / "s.npz"), {"pos": 1, "tail": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tio.load_state(str(tmp_path / "s.npz"))


@pytest.mark.parametrize("storage", ["dense", "split", "bf16", "int16", "int8"])
def test_neojax_checkpoint_continues_in_the_port(tmp_path, rng, storage):
    """neojax streams k blocks and saves; the port loads the file, carries it
    through ``convert`` and continues; the joined stream matches neojax's
    uninterrupted one."""
    k = 3
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 8 * B)).astype(np.float32)
    jcfg = jcv.PartitionedConfig(B, P, C, storage=storage)
    jparams = jcv.filter_params(jcfg, parts)
    _, full = jcv.process(jcfg, jparams, jcv.init_state(jcfg), jnp.asarray(sig))
    jstate, head = jcv.process(jcfg, jparams, jcv.init_state(jcfg), jnp.asarray(sig[:, : k * B]))
    path = str(tmp_path / "neojax.npz")
    jio.save_state(path, jstate)

    tcfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    loaded = tio.load_state(path, device=CPU)
    assert loaded["pos"] == k
    tstate = convert.state_from_neojax(tcfg, convert.state_to_numpy(loaded), device=CPU)
    tparams = convert.params_from_neojax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    _, tail = tcv.process(tcfg, tparams, tstate, torch.from_numpy(sig[:, k * B :]))
    got = np.concatenate([np.asarray(head), tail.numpy()], axis=-1)
    assert _rel(got, np.asarray(full)) < _TOL[storage]


@pytest.mark.parametrize("storage", ["dense", "split", "int16", "int8"])
def test_port_checkpoint_continues_in_neojax(tmp_path, rng, storage):
    """The port streams k blocks and saves; neojax's ``load_state`` reads the
    file and continues; the joined stream matches the port's uninterrupted
    one. (bf16 is left out: neojax cannot reload its own bf16 files, which
    numpy stores as raw ``|V2`` records.)"""
    k = 3
    parts = _parts(rng)
    sig = rng.uniform(-1, 1, (C, 8 * B)).astype(np.float32)
    tcfg = tcv.PartitionedConfig(B, P, C, storage=storage)
    tparams = tcv.filter_params(tcfg, parts, device=CPU)
    _, full = tcv.process(tcfg, tparams, tcv.init_state(tcfg, device=CPU), torch.from_numpy(sig))
    tstate, head = tcv.process(tcfg, tparams, tcv.init_state(tcfg, device=CPU), torch.from_numpy(sig[:, : k * B]))
    path = str(tmp_path / "port.npz")
    tio.save_state(path, tstate)

    jcfg = jcv.PartitionedConfig(B, P, C, storage=storage)
    jstate = jio.load_state(path)
    assert int(jstate["pos"]) == k
    _, tail = jcv.process(jcfg, jcv.filter_params(jcfg, parts), jstate, jnp.asarray(sig[:, k * B :]))
    got = np.concatenate([head.numpy(), np.asarray(tail)], axis=-1)
    assert _rel(got, full.numpy()) < _TOL[storage]
