"""Benchmark harness on the card: CUDA-event timing, items/s, bytes/s and
flop counters, and the card's peak rates.

Port of ``neojax.bench.harness``. It keeps the reference's measurement
taxonomy (google-benchmark items/s and bytes/s, the FFT flop model
``5 N log2 N``, memcpy and multiply-add roofline probes) and measures on an
NVIDIA card only: every timing function raises without one, so no CPU time
is ever reported under a device's name.

Timing protocol: a warm-up call, then each repeat is timed with CUDA events
recorded on the current stream around the call (the events bracket the
device work the call enqueued), synchronised, and the minimum is kept.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Callable

import numpy as np
import torch

__all__ = [
    "BenchResult",
    "measure",
    "card_line",
    "cuda_seconds",
    "slope_seconds",
    "fft_flops",
    "hbm_peak_bytes_per_sec",
    "f32_peak_flops_per_sec",
    "bf16_peak_flops_per_sec",
    "hbm_achievable_bytes_per_sec",
    "memcpy_probe",
    "multiply_add_probe",
]

# Data-sheet peaks by ``torch.cuda.get_device_name(0)`` (the H100 SXM part,
# dense rates, at the full 700 W power limit): device-memory bytes/s, and
# float32 operations/s outside the tensor cores (the port's kernels
# accumulate in f32 on the CUDA cores). A name not in the table gives None.
_HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
_F32_PEAK = {
    "NVIDIA H100 80GB HBM3": 67e12,
}
# dense bf16 operations/s on the tensor cores (the chunked engine's bf16
# product: bf16 operands, float32 accumulator)
_BF16_PEAK = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the bench harness measures on a CUDA card, and none is visible")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (first
    card): a time is only comparable beside its card's power limit."""
    _require_card()
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def hbm_peak_bytes_per_sec() -> float | None:
    """The card's data-sheet device-memory rate, or None for a card not in
    the table."""
    _require_card()
    return _HBM_PEAK.get(torch.cuda.get_device_name(0))


def f32_peak_flops_per_sec() -> float | None:
    """The card's data-sheet float32 rate outside the tensor cores, or None."""
    _require_card()
    return _F32_PEAK.get(torch.cuda.get_device_name(0))


def bf16_peak_flops_per_sec() -> float | None:
    """The card's data-sheet dense bf16 tensor-core rate, or None."""
    _require_card()
    return _BF16_PEAK.get(torch.cuda.get_device_name(0))


@dataclasses.dataclass(frozen=True)
class BenchResult:
    name: str
    seconds: float
    items_per_sec: float | None = None
    bytes_per_sec: float | None = None
    flops_per_sec: float | None = None
    roofline_fraction: float | None = None

    def __str__(self):
        parts = [f"{self.name}: {self.seconds * 1e3:.3f} ms"]
        if self.items_per_sec:
            parts.append(f"{self.items_per_sec / 1e6:.1f} M items/s")
        if self.bytes_per_sec:
            parts.append(f"{self.bytes_per_sec / 1e9:.0f} GB/s")
        if self.flops_per_sec:
            parts.append(f"{self.flops_per_sec / 1e9:.0f} GFLOP/s")
        if self.roofline_fraction:
            parts.append(f"{self.roofline_fraction * 100:.0f}% of HBM roofline")
        return " | ".join(parts)


def cuda_seconds(fn: Callable[[], object], repeats: int = 3) -> float:
    """Minimum over ``repeats`` of the CUDA-event time of one ``fn()``,
    after one warm-up call."""
    _require_card()
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        ev1.synchronize()
        best = min(best, ev0.elapsed_time(ev1) / 1e3)
    return best


def slope_seconds(run: Callable[[int], object], lengths: tuple[int, int], repeats: int = 3) -> float:
    """Seconds per unit of work from two lengths: ``(t(n2) - t(n1)) / (n2 - n1)``
    with ``t(n)`` the :func:`cuda_seconds` of ``run(n)``. A fixed per-call
    cost (launch, set-up, synchronisation) cancels."""
    n1, n2 = lengths
    if not 0 < n1 < n2:
        raise ValueError(f"lengths must be 0 < n1 < n2, got {lengths}")
    t1 = cuda_seconds(lambda: run(n1), repeats)
    t2 = cuda_seconds(lambda: run(n2), repeats)
    return (t2 - t1) / (n2 - n1)


def measure(
    name: str,
    fn: Callable,
    *args,
    repeats: int = 3,
    items: int | None = None,
    bytes_moved: int | None = None,
    flops: int | None = None,
) -> BenchResult:
    """Time ``fn(*args)`` on the card (CUDA events, minimum of ``repeats``
    after a warm-up). Raises RuntimeError without a card."""
    dt = cuda_seconds(lambda: fn(*args), repeats)
    peak = hbm_peak_bytes_per_sec()
    return BenchResult(
        name=name,
        seconds=dt,
        items_per_sec=items / dt if items else None,
        bytes_per_sec=bytes_moved / dt if bytes_moved else None,
        flops_per_sec=flops / dt if flops else None,
        roofline_fraction=(bytes_moved / dt / peak) if (bytes_moved and peak) else None,
    )


def fft_flops(n: int, batch: int = 1) -> int:
    """The reference's FFT flop model: 5 N log2 N per transform."""
    return int(5 * n * np.log2(n)) * batch


def hbm_achievable_bytes_per_sec(nbytes: int = 256 * 1024 * 1024, iters: int = 20,
                                 repeats: int = 3) -> float:
    """Measured read-heavy device-memory rate, bytes/s.

    The JAX version sums 8 resident arrays in one fused XLA loop. Here one
    ``torch.sum`` over a stacked ``[8, n]`` float32 tensor (``nbytes`` in
    all) into a preallocated ``[n]`` output is one reduction kernel that
    reads the 8 rows and writes the sum: it moves ``nbytes + n * 4`` bytes a
    pass, and that is what is counted (``iters`` passes a timed call). The
    rate says what the card delivers
    to a plain read-dominated pattern on this machine; the spec peak is not
    reachable by any real kernel.
    """
    _require_card()
    n = nbytes // 8 // 4
    xs = torch.arange(8, dtype=torch.float32, device="cuda")[:, None].expand(8, n).contiguous()
    out = torch.empty((n,), dtype=torch.float32, device="cuda")

    def passes():
        for _ in range(iters):
            torch.sum(xs, dim=0, out=out)

    dt = cuda_seconds(passes, repeats) / iters
    return (8 * n * 4 + n * 4) / dt


def memcpy_probe(nbytes: int = 256 * 1024 * 1024) -> BenchResult:
    """Device-memory copy rate (reference ``memcpy.cpp:27-36``): ``v + 1``
    reads and writes ``nbytes`` each."""
    _require_card()
    x = torch.arange(nbytes // 4, dtype=torch.float32, device="cuda")
    return measure("memcpy", lambda v: v + 1.0, x, bytes_moved=2 * nbytes)


def multiply_add_probe(nbytes: int = 128 * 1024 * 1024) -> BenchResult:
    """Split-complex multiply rate (``multiply_add.cpp``): 4 input planes,
    2 output planes; counted as the function's bytes and 6 flops a lane."""
    _require_card()
    n = nbytes // 4 // 4
    xr, xi, yr, yi = (torch.ones((n,), dtype=torch.float32, device="cuda") for _ in range(4))

    def mac(xr, xi, yr, yi):
        return xr * yr - xi * yi, xr * yi + xi * yr

    return measure("multiply_add", mac, xr, xi, yr, yi, bytes_moved=6 * n * 4, flops=6 * n)
