"""neojax_torch.bench — the measurement harness on the card: timing and
roofline counters, the headline configuration's bytes and operations, the
SNR-vs-sparsity quality sweep, the IR spectrum preview and the weak-scaling
sweep of the channel-sharded engine."""

from neojax_torch.bench.harness import (
    BenchResult,
    fft_flops,
    hbm_peak_bytes_per_sec,
    measure,
    memcpy_probe,
    multiply_add_probe,
)
from neojax_torch.bench.quality import (
    QualityPoint,
    max_channel_rms_error,
    sparse_quality_sweep,
)
from neojax_torch.bench.scaling import ScalingPoint, weak_scaling_sweep
from neojax_torch.bench.spectrum import db_histogram, power_spectrum_image

__all__ = [
    "BenchResult",
    "measure",
    "fft_flops",
    "hbm_peak_bytes_per_sec",
    "memcpy_probe",
    "multiply_add_probe",
    "QualityPoint",
    "max_channel_rms_error",
    "sparse_quality_sweep",
    "db_histogram",
    "power_spectrum_image",
    "ScalingPoint",
    "weak_scaling_sweep",
]
