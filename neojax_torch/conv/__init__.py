"""neojax_torch.conv — the convolution engine: direct, FFT, OLS/OLA, the
uniformly-partitioned FDL convolver (UPOLS/UPOLA), the nested (two-level
FDL) and chunked (Toeplitz-product) throughput engines, the hybrid
real-time engine, and ``make_engine`` over the four."""

from neojax_torch.conv.engines import Engine, make_engine
from neojax_torch.conv.chunked import chunked_filter_params, chunked_init_state, process_chunked
from neojax_torch.conv.convolver import (
    Convolver,
    PartitionedConfig,
    filter_params,
    init_state,
    insert_only_step,
    make_convolver,
    process,
    sparse_upola_convolver,
    sparse_upols_convolver,
    split_upola_convolver,
    split_upols_convolver,
    step,
    upola_convolver,
    upola_convolver_v2,
    upols_convolver,
)
from neojax_torch.conv.hybrid import (
    HybridStream,
    hybrid_filter_params,
    hybrid_init_state,
    process_hybrid,
)
from neojax_torch.conv.direct import direct_convolve
from neojax_torch.conv.fft_conv import fft_convolve
from neojax_torch.conv.modes import Method, Mode, output_size
from neojax_torch.conv.nested import nested_filter_params, nested_init_state, process_nested
from neojax_torch.conv.overlap import OverlapAdd, OverlapSave, stream_blocks, unstream_blocks
from neojax_torch.conv.partition import num_partitions, uniform_partition
from neojax_torch.conv.sparse import perceptual_mask, perceptual_weights, sparsity_mask
from neojax_torch.ops.normalize import normalize_impulse

__all__ = [
    "Engine",
    "make_engine",
    "Convolver",
    "PartitionedConfig",
    "filter_params",
    "init_state",
    "insert_only_step",
    "step",
    "process",
    "make_convolver",
    "upols_convolver",
    "upola_convolver",
    "upola_convolver_v2",
    "split_upols_convolver",
    "split_upola_convolver",
    "sparse_upols_convolver",
    "sparse_upola_convolver",
    "chunked_filter_params",
    "chunked_init_state",
    "process_chunked",
    "nested_filter_params",
    "nested_init_state",
    "process_nested",
    "hybrid_filter_params",
    "hybrid_init_state",
    "process_hybrid",
    "HybridStream",
    "direct_convolve",
    "fft_convolve",
    "Mode",
    "Method",
    "output_size",
    "OverlapSave",
    "OverlapAdd",
    "stream_blocks",
    "unstream_blocks",
    "uniform_partition",
    "num_partitions",
    "sparsity_mask",
    "perceptual_weights",
    "perceptual_mask",
    "normalize_impulse",
]
