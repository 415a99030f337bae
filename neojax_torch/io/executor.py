"""Streaming executor: the host-side runtime around a convolver step
(``neojax.io.executor``, the same semantics).

The role a native engine plays around the compute core in a real-time
product (and that the reference's plugin plays around its convolvers): an
audio producer writes arbitrary-size chunks into a lock-free native ring
(``io.native.Ring``, C++), a worker thread drains block-sized frames, runs
the step (``HybridStream``, ``Convolver.__call__``, a ``conv.step``
closure), brings its output to the host with ``.cpu()`` (which waits for
the card) and pushes it into an output ring the consumer reads at its own
pace. Sample-exact: output equals the offline processing of the same
stream.

The worker thread is the only one that touches torch; the producer and
consumer only touch the native rings (safe from a real-time callback).
Without the native runtime the constructor raises (``io.native``).
"""

from __future__ import annotations

import threading

import numpy as np

from neojax_torch.io.native import Ring, _host

__all__ = ["StreamExecutor"]


class StreamExecutor:
    """Run ``step_fn(state, block) -> (state, out)`` over a ring-buffered
    stream in a background thread.

    Rings carry standard interleaved audio (frame-major: one [c0..cC-1]
    frame per sample instant), so producers and consumers may use any
    chunk size — exactly how an audio callback hands over data. ``block``
    is a [C, B] float32 numpy array.
    """

    def __init__(self, step_fn, state, channels: int, block_size: int, capacity_blocks: int = 64):
        self._step = step_fn
        self.state = state
        self.channels = channels
        self.block_size = block_size
        cap = capacity_blocks * channels * block_size
        self._in = Ring(cap)
        self._out = Ring(cap)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- producer side (real-time safe: native ring only) ------------------

    def push(self, chunk: np.ndarray) -> int:
        """Write a [C, k] chunk; returns samples-per-channel accepted."""
        chunk = np.ascontiguousarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = chunk[None]
        if chunk.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        # only whole sample-frames may enter the ring, or the interleaving
        # would desync when the ring fills mid-frame
        fit = min(chunk.shape[1], self._in.writable // self.channels)
        if fit == 0:
            return 0
        wrote = self._in.write(np.ascontiguousarray(chunk[:, :fit].T).ravel())
        assert wrote == fit * self.channels
        return fit

    def pull(self, k: int) -> np.ndarray:
        """Read up to [C, k] processed samples (returns what is ready)."""
        got = self._out.read(k * self.channels)
        n = got.size // self.channels
        return got[: n * self.channels].reshape(n, self.channels).T

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        b = self.block_size
        c = self.channels
        frame = c * b
        while True:
            if self._in.readable >= frame:
                data = self._in.read(frame).reshape(b, c).T
                self.state, out = self._step(self.state, data)
                out = np.asarray(_host(out), np.float32)
                # spin until the consumer makes room (bounded stream)
                while self._out.writable < frame and not self._stop.is_set():
                    self._stop.wait(0.0005)
                # never write a partial frame: a torn write would desync the
                # channel interleaving for the rest of the stream. On close()
                # with a full ring the frame is dropped instead.
                if self._out.writable >= frame:
                    self._out.write(np.ascontiguousarray(out.T).ravel())
            elif self._stop.is_set():
                return
            else:
                self._stop.wait(0.0005)
