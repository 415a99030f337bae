"""The inputs of a run: the deployment's filter (made once from the
configuration's own fixed seed, so every run does the same work) and the
input stream (made from ``--seed``). The same arrays go to the program and
to the reference."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import spec
from benchmark.reference import upols

__all__ = ["substream_seed", "Filter", "make_filter", "Stream", "make_stream"]

_MASK64 = (1 << 64) - 1


def substream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use (``stream``) of the run's ``--seed``: any
    whole number, large or negative, maps to a distinct generator state."""
    state = np.random.SeedSequence([seed & _MASK64, seed < 0, stream]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


class Filter:
    """``spectra`` complex64 as the program gets them, ``mask`` bool of the
    same shape or None, and ``reference``: the spectra the program's output
    should follow (dropped bins zeroed). Each is [P, K] for one filter that
    every channel shares, [C, P, K] for one filter a channel
    (``ir.per_channel``)."""

    def __init__(self, spectra: np.ndarray, mask):
        self.spectra = spectra
        self.mask = mask
        self.reference = spectra if mask is None else np.where(mask, spectra, 0).astype(spectra.dtype)

    @property
    def live(self) -> np.ndarray:
        return self.reference != 0


def make_filter(config: dict) -> Filter:
    """The deployment's filter from its IR generator and fixed seed. With
    ``ir.per_channel`` the one generator state makes ``channels`` IRs in
    turn, channel 0 first, stacked to [C, taps]; else it makes one."""
    make = spec.module("irs", config["ir"]["generator"]).make
    rng = np.random.default_rng(config["ir"]["seed"])
    if config["ir"].get("per_channel"):
        ir = np.stack([make(rng, config) for _ in range(config["channels"])])
    else:
        ir = make(rng, config)
    spectra = upols.partition(ir, config["block"])
    mask = None
    if config.get("mask"):
        mask = spec.module("masks", config["mask"]["kind"]).make(spectra, config)
    return Filter(spectra, mask)


class Stream:
    """The input stream in blocks of B samples, ``[C, B]`` each.

    render: a pool of ``pool_calls`` device chunks of ``call_blocks``
    blocks, call i taking chunk ``i % pool_calls`` (made in set-up, so no
    input is drawn inside the window); live: one host array ``[n, C, B]``
    of pageable float32 blocks, block g for callback g.
    """

    def __init__(self, chunks: torch.Tensor | None, host: np.ndarray | None, block: int):
        self.chunks = chunks
        self.host = host
        self.block = block

    def call_input(self, i: int):
        """The input of call i: a device chunk, or a host block."""
        if self.chunks is not None:
            return self.chunks[i % self.chunks.shape[0]]
        return self.host[i]

    def segment(self, g0: int, g1: int) -> torch.Tensor:
        """Input blocks g0 .. g1 - 1 as ``[C, (g1 - g0) * B]`` (zeros before
        the stream starts), where the stream lives: the device for a pool,
        the host for host blocks."""
        if self.chunks is not None:
            n_pool, c, call_len = self.chunks.shape
            nb = call_len // self.block
            parts = []
            g = g0
            while g < g1:
                if g < 0:
                    take = min(g1, 0) - g
                    parts.append(torch.zeros((c, take * self.block), dtype=self.chunks.dtype,
                                             device=self.chunks.device))
                else:
                    i, o = divmod(g, nb)
                    take = min(g1 - g, nb - o)
                    parts.append(self.chunks[i % n_pool][:, o * self.block : (o + take) * self.block])
                g += take
            return torch.cat(parts, dim=-1)
        lo = max(g0, 0)
        blocks = torch.from_numpy(self.host[lo:g1])  # [n, C, B]
        seg = blocks.permute(1, 0, 2).reshape(blocks.shape[1], -1)
        pad = (lo - g0) * self.block
        return torch.nn.functional.pad(seg, (pad, 0)) if pad else seg


def make_stream(config: dict, traffic: dict, seed: int, calls: int, device) -> Stream:
    """The input stream of a run: ``calls`` calls' worth of input for a
    host-fed traffic (every callback its own block), a pool for a
    device-fed one."""
    c, b, nb = config["channels"], config["block"], traffic["call_blocks"]
    gen = torch.Generator(device=device).manual_seed(substream_seed(seed, 1))
    make = spec.module("signals", traffic["signal"]).make
    if traffic.get("host_io"):
        x = make(gen, c, calls * nb * b, device)
        host = x.reshape(c, calls * nb, b).permute(1, 0, 2).contiguous().cpu().numpy()
        return Stream(None, host, b)
    n_pool = traffic["pool_calls"]
    x = make(gen, c, n_pool * nb * b, device)
    return Stream(x.reshape(c, n_pool, nb * b).permute(1, 0, 2).contiguous(), None, b)
