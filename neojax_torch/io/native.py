"""ctypes loader for the native runtime (``neojax.io.native``).

The native library is the repo's own ``native/neo_runtime.cpp``: the
host-side streaming runtime (WAV codec, frame re-blocker, lock-free SPSC
float ring) in C++ — the role the reference implements natively for its
CLI and plugin. At first use it is built with ``g++`` into
``neojax_torch/_build/`` (git-ignored; rebuilt when the source is newer).
``load_runtime()`` keeps ``neojax``'s contract: the library, or None when
it cannot be built; :class:`Ring` and :class:`Reblocker` (and so
``io.StreamExecutor``) raise a RuntimeError saying so.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["load_runtime", "native_read_wav", "native_write_wav", "Reblocker", "Ring"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "neo_runtime.cpp")
_LIB_PATH = os.path.join(_PKG, "_build", "libneo_runtime.so")
_UNAVAILABLE = (f"native runtime not available: {_SOURCE} could not be built with g++ "
                f"into {os.path.dirname(_LIB_PATH)}")


def _build() -> bool:
    """Compile the runtime into a temporary file and move it into place
    (parallel first uses never load a half-written library)."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, _SOURCE],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=1)
def load_runtime(build: bool = True):
    """Load (building if needed and possible) the native runtime, or None."""
    stale = not os.path.exists(_LIB_PATH) or (
        os.path.exists(_SOURCE) and os.path.getmtime(_SOURCE) > os.path.getmtime(_LIB_PATH))
    if stale and build and os.path.exists(_SOURCE):
        _build()
    if not os.path.exists(_LIB_PATH):
        return None

    lib = ctypes.CDLL(_LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    lib.neo_wav_probe.restype = ctypes.c_int
    lib.neo_wav_probe.argtypes = [u8p, ctypes.c_uint64, i32p, i32p, i32p, i32p, u64p]
    lib.neo_wav_decode.restype = ctypes.c_int
    lib.neo_wav_decode.argtypes = [u8p, ctypes.c_uint64, f32p]
    lib.neo_wav_encode16.restype = ctypes.c_int64
    lib.neo_wav_encode16.argtypes = [f32p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32, u8p]
    lib.neo_reblocker_new.restype = ctypes.c_void_p
    lib.neo_reblocker_new.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.neo_reblocker_free.argtypes = [ctypes.c_void_p]
    lib.neo_reblocker_latency.restype = ctypes.c_int32
    lib.neo_reblocker_latency.argtypes = [ctypes.c_void_p]
    lib.neo_reblocker_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int32]
    lib.neo_reblocker_frames_ready.restype = ctypes.c_int32
    lib.neo_reblocker_frames_ready.argtypes = [ctypes.c_void_p]
    lib.neo_reblocker_pop_frame.restype = ctypes.c_int32
    lib.neo_reblocker_pop_frame.argtypes = [ctypes.c_void_p, f32p]
    lib.neo_reblocker_push_processed.argtypes = [ctypes.c_void_p, f32p]
    lib.neo_reblocker_pop.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int32]
    lib.neo_ring_new.restype = ctypes.c_void_p
    lib.neo_ring_new.argtypes = [ctypes.c_int64]
    lib.neo_ring_free.argtypes = [ctypes.c_void_p]
    lib.neo_ring_capacity.restype = ctypes.c_int64
    lib.neo_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.neo_ring_readable.restype = ctypes.c_int64
    lib.neo_ring_readable.argtypes = [ctypes.c_void_p]
    lib.neo_ring_writable.restype = ctypes.c_int64
    lib.neo_ring_writable.argtypes = [ctypes.c_void_p]
    lib.neo_ring_write.restype = ctypes.c_int64
    lib.neo_ring_write.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.neo_ring_read.restype = ctypes.c_int64
    lib.neo_ring_read.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    return lib


def _runtime():
    lib = load_runtime()
    if lib is None:
        raise RuntimeError(_UNAVAILABLE)
    return lib


def _as_u8(buf: bytes):
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr


def native_read_wav(path: str):
    """Native WAV decode -> ([channels, frames] f32, sample_rate)."""
    lib = _runtime()
    with open(path, "rb") as f:
        data = f.read()
    ptr, keep = _as_u8(data)
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    bits = ctypes.c_int32()
    fmt = ctypes.c_int32()
    frames = ctypes.c_uint64()
    rc = lib.neo_wav_probe(ptr, len(data), ch, sr, bits, fmt, frames)
    if rc != 0:
        raise ValueError(f"WAV probe failed ({rc}) for {path}")
    out = np.empty((ch.value, frames.value), np.float32)
    rc = lib.neo_wav_decode(ptr, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"WAV decode failed ({rc}) for {path}")
    return out, sr.value


def native_write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Native 16-bit PCM WAV encode of [channels, frames] (or [frames]) f32."""
    lib = _runtime()
    audio = np.ascontiguousarray(np.asarray(audio, np.float32))
    if audio.ndim == 1:
        audio = audio[None]
    ch, frames = audio.shape
    out = np.empty(44 + frames * ch * 2, np.uint8)
    n = lib.neo_wav_encode16(audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ch, frames,
                             sample_rate, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())


class Reblocker:
    """Native frame re-blocker: arbitrary host block sizes in/out, fixed
    processing frames with one frame of latency (the reference plugin's
    ``ConstantOverlapAdd`` adapter, ``ConstantOverlapAdd.hpp:89-199``)."""

    def __init__(self, channels: int, frame_size: int):
        self._lib = _runtime()
        self._h = self._lib.neo_reblocker_new(channels, frame_size)
        self.channels = channels
        self.frame_size = frame_size

    @property
    def latency(self) -> int:
        return self._lib.neo_reblocker_latency(self._h)

    def process(self, block: np.ndarray, frame_fn) -> np.ndarray:
        """Push a [C, N] host block, run ``frame_fn`` on every complete
        [C, F] frame (its output is brought to the host with ``np.asarray``;
        a card tensor's with ``.cpu()``), return [C, N] output
        (latency-compensated zeros at stream start)."""
        block = np.ascontiguousarray(np.asarray(block, np.float32))
        n = block.shape[-1]
        f32p = ctypes.POINTER(ctypes.c_float)
        self._lib.neo_reblocker_push(self._h, block.ctypes.data_as(f32p), n)
        while self._lib.neo_reblocker_frames_ready(self._h) > 0:
            frame = np.empty((self.channels, self.frame_size), np.float32)
            self._lib.neo_reblocker_pop_frame(self._h, frame.ctypes.data_as(f32p))
            processed = np.ascontiguousarray(np.asarray(_host(frame_fn(frame)), np.float32))
            self._lib.neo_reblocker_push_processed(self._h, processed.ctypes.data_as(f32p))
        out = np.empty((self.channels, n), np.float32)
        self._lib.neo_reblocker_pop(self._h, out.ctypes.data_as(f32p), n)
        return out

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None) is not None:
            self._lib.neo_reblocker_free(self._h)
            self._h = None


class Ring:
    """Native lock-free SPSC float ring buffer (audio-callback <-> compute
    worker transport; C++ ``neo_ring``)."""

    def __init__(self, min_capacity: int):
        if min_capacity <= 0:
            raise ValueError(f"ring capacity must be positive, got {min_capacity}")
        self._lib = _runtime()
        self._h = self._lib.neo_ring_new(int(min_capacity))
        if not self._h:
            raise RuntimeError("native ring allocation failed")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.neo_ring_free(h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.neo_ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.neo_ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.neo_ring_writable(self._h)

    def write(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32).ravel()
        return self._lib.neo_ring_write(self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size)

    def read(self, n: int) -> np.ndarray:
        out = np.empty(int(n), np.float32)
        got = self._lib.neo_ring_read(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n))
        return out[:got]


def _host(x):
    """A step's output on the host: a tensor's ``.cpu()`` (which waits for
    the card), anything else as it is."""
    return x.cpu() if hasattr(x, "cpu") else x
