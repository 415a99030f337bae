"""neojax_torch.bench — the measurement harness on the card: timing and
roofline counters, the headline configuration's bytes and operations, the
SNR-vs-sparsity quality sweep and the IR spectrum preview. (``neojax``'s
``bench.scaling`` needs the distributed package and is not ported yet.)"""

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
]
