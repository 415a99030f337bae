"""neojax_torch.dist — rank meshes, sharded convolvers and multi-process
streaming on ``torch.distributed`` (``neojax.dist``).

Every rank of a process group runs the same call; each engine takes
global inputs (or this rank's shard) and returns this rank's shard of the
output and state (``dist.mesh``, which also holds ``Mesh``, ``psum`` and
``ppermute``, importable from here). One process with no process group is
a 1x1 mesh. ``__all__`` is ``neojax.dist``'s.
"""

from neojax_torch.dist.mesh import Mesh, channel_sharding, make_mesh, ppermute, psum
from neojax_torch.dist.pipeline import PipelineConvolver
from neojax_torch.dist.multihost import StreamDriver, init_distributed
from neojax_torch.dist.sharded import shard_params, shard_state, sharded_process
from neojax_torch.dist.timesharded import timesharded_process
from neojax_torch.dist.binsharded import BinShardedConvolver
from neojax_torch.dist.sharded_chunked import (
    shard_chunked_state,
    shard_hybrid_state,
    shard_nested_state,
    sharded_process_chunked,
    sharded_process_hybrid,
    sharded_process_nested,
)

__all__ = [
    "make_mesh",
    "channel_sharding",
    "PipelineConvolver",
    "shard_params",
    "shard_state",
    "sharded_process",
    "timesharded_process",
    "sharded_process_chunked",
    "BinShardedConvolver",
    "shard_nested_state",
    "sharded_process_nested",
    "shard_hybrid_state",
    "sharded_process_hybrid",
    "shard_chunked_state",
    "StreamDriver",
    "init_distributed",
]
