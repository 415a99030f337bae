"""The system under test, built for a configuration: by default
``neojax_torch.conv.Convolver``, the port's user API; where the
configuration names an ``engine``, that engine of
``neojax_torch.conv.make_engine``. The only harness module that imports
the program."""

from __future__ import annotations

import numpy as np

from benchmark.lib import spec

__all__ = ["require", "reset_counters", "build"]


def require() -> None:
    """Import the program; raises ImportError where the checkout lacks it."""
    import neojax_torch  # noqa: F401


def reset_counters() -> None:
    """Clear the program's span totals and kernel counters, so that what a
    run's readers read of them is that run's alone (the CPU tests and
    ``limits.py`` make many runs in one process)."""
    try:
        from neojax_torch import kernels, trace
    except ImportError:
        return
    trace.reset()
    kernels.reset_launch_counts()


def _padded(a: np.ndarray, partitions: int, fill) -> np.ndarray:
    """``a`` [P, K] or [C, P, K] with partition rows appended, each
    ``fill``, up to ``partitions``."""
    extra = partitions - a.shape[-2]
    if extra <= 0:
        return a
    return np.concatenate([a, np.full(a.shape[:-2] + (extra, a.shape[-1]), fill, a.dtype)], axis=-2)


def _channels_first(spectra: np.ndarray) -> np.ndarray:
    """The program's filter layout [C|1, P, K]: a shared filter [P, K] as
    one channel, one filter a channel [C, P, K] as it is."""
    return spectra if spectra.ndim == 3 else spectra[None]


def build(config: dict, filt, device, storage: str | None = None):
    """The configuration's system with its filter installed. ``storage``
    overrides the configuration's (the control's lower precision).

    ``Convolver`` (no ``engine``, or ``"convolver"``): a masked
    configuration takes the sparse convolver (``sparse_upols_convolver``'s
    arguments) with the benchmark's mask, and the ring is padded to
    ``ring_partitions``. Another engine gets the spectra (and mask)
    zero-padded to ``ring_partitions`` where the file gives it, as
    ``Convolver.filter`` pads them, which is exact, and the configuration's
    channel count, block and ``chunk_blocks``. Either takes the filter as
    one shared channel, or, with ``ir.per_channel``, one a channel."""
    storage = storage or config["storage"]
    kind = spec.engine(config)
    if kind == "convolver":
        from neojax_torch.conv.convolver import Convolver

        conv = Convolver(config["scheme"], storage, sparsity=filt.mask,
                         require_sparsity=filt.mask is not None, device=device)
        conv.filter(_channels_first(filt.spectra), pad_partitions=config["ring_partitions"])
        return conv

    from neojax_torch.conv import make_engine

    p = config.get("ring_partitions", 0)
    spectra = _padded(filt.spectra, p, 0)
    mask = None if filt.mask is None else _padded(filt.mask, p, False)
    return make_engine(kind, _channels_first(spectra), block_size=config["block"], storage=storage,
                       scheme=config["scheme"], chunk_blocks=config.get("chunk_blocks"),
                       channels=config["channels"], sparsity=mask, device=device)
