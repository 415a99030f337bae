"""The system under test: ``neojax_torch.conv.Convolver``, the port's user
API, built for a configuration. The only harness module that imports the
program."""

from __future__ import annotations

__all__ = ["require", "build"]


def require() -> None:
    """Import the program; raises ImportError where the checkout lacks it."""
    import neojax_torch  # noqa: F401


def build(config: dict, filt, device, storage: str | None = None):
    """A ``Convolver`` with the configuration's filter installed. A masked
    configuration takes the sparse convolver (``sparse_upols_convolver``'s
    arguments) with the benchmark's mask. ``storage`` overrides the
    configuration's (the control's lower precision)."""
    from neojax_torch.conv.convolver import Convolver

    conv = Convolver(config["scheme"], storage or config["storage"], sparsity=filt.mask,
                     require_sparsity=filt.mask is not None, device=device)
    conv.filter(filt.spectra[None], pad_partitions=config["ring_partitions"])
    return conv
