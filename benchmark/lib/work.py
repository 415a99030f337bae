"""The least work of a call, counted from the function and not from any
implementation of it, so that no algorithm can read above 100 % of it.

Bytes (nothing else is counted: the multiply-accumulate of the partition
sum has no lower bound that every algorithm shares, since an FFT over the
block axis, as the nested engine's meta-FFT does, computes the same
function with fewer operations):

- each input sample read once and each output sample written once, float32;
- each live (channel, partition, bin) entry of the filter read once, a
  complex number at the storage's precision (a masked filter: its kept
  entries; a filter that every channel shares: its entries once);
- the state read once and written once a call, less what the card can keep
  on chip between calls (its L2 and all shared memory). The state is the
  function's own: the input history the filter reaches back over,
  ``P_live * B - 1`` samples a channel (``P_live``: the deepest partition
  that any channel's filter keeps) at the storage's precision, whatever
  form (time samples or spectra) a program keeps it in. A call writes at
  most as much of it as it brings new samples.

Frozen with the benchmark: later changes to the program do not move it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PEAKS", "SAMPLE_BYTES", "least_bytes"]

# Data-sheet figures by ``torch.cuda.get_device_name()``: the H100 SXM part
# (3.35 TB/s HBM3, 50 MB L2, 132 SMs of up to 228 KiB shared memory each).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "onchip_bytes": 50 * 2**20 + 132 * 228 * 1024,
    },
}

# bytes of one real value at each storage's precision
SAMPLE_BYTES = {"dense": 4, "split": 4, "int16": 2, "bf16": 2, "int8": 1}


def least_bytes(channels: int, block: int, call_blocks: int, live: np.ndarray, storage: str,
                onchip_bytes: int) -> int:
    """Least bytes one call of ``call_blocks`` blocks must move.

    live : bool [P, K] (one filter that every channel shares) or [C', P, K]
           (one a channel), the filter entries that are kept and not zero
    """
    sb = SAMPLE_BYTES[storage]
    live = np.asarray(live)
    rows = np.flatnonzero(live.any(axis=-1).reshape(-1, live.shape[-2]).any(axis=0))
    p_live = int(rows[-1]) + 1 if rows.size else 0
    io = 2 * channels * call_blocks * block * 4
    filt = int(np.count_nonzero(live)) * 2 * sb
    state = channels * max(0, p_live * block - 1) * sb
    off_chip = max(0, state - onchip_bytes)
    return io + filt + off_chip + min(off_chip, channels * call_blocks * block * sb)
