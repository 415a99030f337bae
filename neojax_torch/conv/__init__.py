"""neojax_torch.conv — the uniformly-partitioned FDL convolver (UPOLS/UPOLA)."""

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
from neojax_torch.conv.overlap import stream_blocks, unstream_blocks
from neojax_torch.conv.partition import num_partitions, uniform_partition
from neojax_torch.conv.sparse import sparsity_mask
from neojax_torch.ops.normalize import normalize_impulse

__all__ = [
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
    "stream_blocks",
    "unstream_blocks",
    "uniform_partition",
    "num_partitions",
    "sparsity_mask",
    "normalize_impulse",
]
