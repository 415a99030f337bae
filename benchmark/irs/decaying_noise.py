"""Exponentially decaying Gaussian noise: the shape of a reverb tail.

Frozen copy of the repo's ``bench.py::_make_ir`` (the JAX package's headline
IR), with the generator passed in: ``partitions * block`` taps of
``0.05 * exp(-t / (n / 4))`` noise."""

from __future__ import annotations

import numpy as np


def make(rng: np.random.Generator, config: dict) -> np.ndarray:
    n = config["ir"]["partitions"] * config["block"]
    t = np.arange(n)
    return (rng.standard_normal(n) * (0.05 * np.exp(-t / (n / 4)))).astype(np.float32)
