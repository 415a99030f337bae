"""One uniform handle over the four convolution engines (``neojax.conv.engines``).

The functional cores (``conv.convolver.process``, ``conv.chunked``,
``conv.nested``, ``conv.hybrid``) share the (params, state, signal) shape
but differ in their filter-param functions and chunking constraints.
``make_engine`` bundles them behind one stateful object so switching
engines is a string:

    eng = conv.make_engine("hybrid", parts, block_size=512,
                           storage="int16", chunk_blocks=64, device="cuda")
    wet = eng.process(sig)        # streaming state carries across calls
    eng.reset()

Engines: "perblock" (uniform per-block step — true 1-block latency),
"hybrid" (two-stage head+tail — 1-block latency at near-throughput
speed), "nested" (two-level FDL — the throughput engine, S-block
latency), "chunked" (Toeplitz product, S-block latency). For a per-block
real-time callback use ``conv.hybrid.HybridStream`` directly.

``latency`` is 0 for every engine, as in the JAX package: ``process``
returns output aligned with its input (nested and chunked pad a partial
chunk internally), so the schedule delays nothing the caller sees.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch

from neojax_torch.conv import chunked as chunked_lib
from neojax_torch.conv import convolver as cv
from neojax_torch.conv import hybrid as hybrid_lib
from neojax_torch.conv import nested as nested_lib
from neojax_torch.conv.sparse import sparsity_mask
from neojax_torch.core.device import resolve_device

__all__ = ["make_engine", "Engine"]

_DEFAULT_CHUNKS = {"nested": 128, "hybrid": 64, "chunked": 32}


class Engine:
    """Stateful wrapper: filter installed at construction on ``device``
    (None: the card), streaming state carried across ``process`` calls and
    exposed as ``.state``."""

    def __init__(
        self,
        engine: str,
        partitions,
        block_size: int | None = None,
        storage: str | None = None,
        scheme: str = "upols",
        chunk_blocks: int | None = None,
        channels: int | None = None,
        sparsity: Any = None,
        *,
        device=None,
    ):
        if engine not in ("perblock", "nested", "hybrid", "chunked"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = resolve_device(device)
        partitions = cv._host(partitions)
        if partitions.ndim == 2:
            partitions = partitions[None]
        c_filt, p, bins = partitions.shape
        if block_size is None:
            block_size = bins - 1
        if block_size != bins - 1:
            raise ValueError(
                f"partitions have {bins} bins but block_size={block_size} "
                f"expects {block_size + 1} (uniform_partition at the same "
                "block size)"
            )
        if storage is None:
            # the same rule as Convolver: complex64 on the CPU, split planes on the card
            storage = "dense" if self.device.type == "cpu" else "split"
        self.engine = engine
        self.chunk_blocks = chunk_blocks or _DEFAULT_CHUNKS.get(engine, 0)
        channels = channels or c_filt
        self.config = cv.PartitionedConfig(block_size, p, channels, scheme=scheme, storage=storage)

        mask = None
        if sparsity is not None:
            if callable(sparsity):
                per_channel = np.moveaxis(cv._canon_partitions(self.config, partitions), 1, 0)
                mask = sparsity_mask(per_channel, sparsity)
            else:
                mask = np.asarray(cv._host(sparsity), bool)

        s, dev = self.chunk_blocks, self.device
        if engine == "perblock":
            self.params = cv.filter_params(self.config, partitions, sparsity=mask, device=dev)
            self._init = lambda: cv.init_state(self.config, dev)
            self._proc = partial(cv.process, self.config)
        elif engine == "nested":
            self.params = nested_lib.nested_filter_params(self.config, partitions, s, mask=mask, device=dev)
            self._init = lambda: nested_lib.nested_init_state(self.config, self.params, dev)
            self._proc = partial(nested_lib.process_nested, self.config)
        elif engine == "hybrid":
            self.params = hybrid_lib.hybrid_filter_params(self.config, partitions, s, mask=mask, device=dev)
            self._init = lambda: hybrid_lib.hybrid_init_state(self.config, self.params, dev)
            self._proc = partial(hybrid_lib.process_hybrid, self.config)
        else:  # chunked
            self.params = chunked_lib.chunked_filter_params(self.config, partitions, s, mask=mask, device=dev)
            self._init = lambda: chunked_lib.chunked_init_state(self.config, self.params, dev)
            self._proc = partial(chunked_lib.process_chunked, self.config, chunk_blocks=s)
        self.reset()

    @property
    def latency(self) -> int:
        """Latency in samples that the schedule adds to ``process``'s output:
        0 for every engine (see the module docstring)."""
        return 0

    def reset(self) -> None:
        self.state = self._init()

    def process(self, signal) -> torch.Tensor:
        """[C, T] (or [T]) -> same-shape wet signal; state carries over.

        nested/chunked process in S*B-sample steps — feed multiples of
        ``chunk_blocks * block_size`` samples to keep the carried state
        exactly continuous across calls (a partial final chunk is
        zero-padded internally, exact for that call's output only)."""
        signal = torch.as_tensor(signal).to(device=self.device, dtype=torch.float32)
        self.state, out = self._proc(self.params, self.state, signal)
        return out


def make_engine(engine: str, partitions, **kwargs) -> Engine:
    return Engine(engine, partitions, **kwargs)
