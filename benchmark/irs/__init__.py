"""Impulse-response generators, one module per name a configuration's
``ir.generator`` gives: ``make(rng, config) -> float32 [taps]``."""
