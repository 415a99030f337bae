"""Where the entry points run: on the card unless the caller asks for the CPU.

The port's hot paths are CUDA kernels; the CPU route (each kernel's plain
version) exists for tests and for callers who ask for it by name. So an
entry point given no ``device`` resolves to ``cuda`` and raises, never
falls back, when there is no card.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Raises RuntimeError when ``device`` is None and no CUDA card is
    visible: the port does not run its kernels' plain versions unless the
    caller passes ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: neojax_torch runs on the card by default; pass "
            'device="cpu" to run the kernels\' plain PyTorch versions on the CPU'
        )
    return torch.device("cuda")
