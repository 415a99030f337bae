"""Multi-process streaming: fail-fast initialisation, per-rank checkpoints
and the checkpointed stream driver (``neojax.dist.multihost``).

The reference is a single-process library with no failure handling. Here
multi-process streaming jobs:

  * initialise ``torch.distributed`` fail-fast (:func:`init_distributed`
    raises when the group does not form in time instead of hanging in the
    first collective);
  * shard 256-channel streams over ranks on the mesh "ch" axis (pure data
    parallel, no traffic between ranks) and optionally over "part"
    (``dist.PipelineConvolver``);
  * checkpoint each rank's stream state every few chunks, so a lost rank
    restarts the stream from the last chunk boundary — the state is the
    whole job state (``io.checkpoint``).

One process with no process group runs the same code (a 1x1 mesh).
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from neojax_torch.io.checkpoint import _flatten, _unflatten, load_state, save_state

__all__ = [
    "init_distributed",
    "free_port",
    "StreamDriver",
    "save_sharded_state",
    "load_sharded_state",
]


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, timeout_secs: int = 60, backend: str | None = None) -> bool:
    """Fail-fast ``torch.distributed.init_process_group``. Returns False when
    running single-process (no coordinator given and no
    ``NEOJAX_COORDINATOR``), True after a successful multi-process init;
    raises if the group does not form within ``timeout_secs``.

    ``coordinator`` is ``host:port`` of rank 0's store; ``num_processes``
    and ``process_id`` default to ``WORLD_SIZE`` / ``RANK``. ``backend``
    None means ``"nccl"``; ranks that share a card (NCCL refuses two ranks
    of one group on one GPU) and CPU runs ask for ``"gloo"``.
    """
    coordinator = coordinator or os.environ.get("NEOJAX_COORDINATOR")
    if coordinator is None:
        return False
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dist.init_process_group(backend or "nccl", init_method=f"tcp://{coordinator}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_secs))
    return True


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a local
    :func:`init_distributed` coordinator (``127.0.0.1:<port>``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _rank_file(path: str, rank: int) -> str:
    root = path[:-4] if path.endswith(".npz") else path
    return f"{root}.rank{rank}.npz"


def save_sharded_state(path: str, state: dict) -> None:
    """Per-rank checkpoint of this rank's state shard: each rank writes only
    its own shard, to its own ``.npz`` (``path`` with ``.rank{r}``), keyed
    by the state's flattened key and the rank — no gather between ranks.
    Pair with :func:`load_sharded_state`."""
    r = _rank()
    np.savez(_rank_file(path, r), **{f"{key}__r{r}": val for key, val in _flatten(state).items()})


def _device_of(tree) -> torch.device:
    for val in tree.values():
        for leaf in val if isinstance(val, tuple) else (val,):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return torch.device("cpu")


def load_sharded_state(path: str, like: dict) -> dict:
    """This rank's state from its :func:`save_sharded_state` file, on the
    device of ``like`` (e.g. this rank's fresh state)."""
    r = _rank()
    suffix = f"__r{r}"
    with np.load(_rank_file(path, r)) as f:
        flat = {k[: -len(suffix)]: f[k] for k in f.files if k.endswith(suffix)}
    return _unflatten(flat, _device_of(like))


@dataclass
class StreamDriver:
    """Checkpointed streaming executor: run a ``(params, state, chunk) ->
    (state, out)`` step over a long stream, saving the state every
    ``checkpoint_every`` chunks and resuming from the latest checkpoint.

    ``save_fn(path, state)`` / ``load_fn(path, like)`` default to the
    single-process ``.npz`` format (``io.save_state`` / ``io.load_state``
    on ``like``'s device); multi-process jobs pass
    :func:`save_sharded_state` / :func:`load_sharded_state` (or
    ``io.save_state_dcp`` / ``io.load_state_dcp``) so each rank persists
    its own shard. In a group of several ranks each rank keeps its own
    resume index (``.meta.rank{r}``), written after its state."""

    process_fn: Callable
    checkpoint_path: str | None = None
    checkpoint_every: int = 16
    save_fn: Callable = staticmethod(save_state)
    load_fn: Callable = staticmethod(lambda path, like: load_state(path, _device_of(like)))

    def run(self, params, state, chunks):
        """chunks: iterable of [C, T_chunk] arrays. Yields (index, out, state)."""
        start = 0
        if self.checkpoint_path and os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                start = int(f.read().strip())
            state = self.load_fn(self._state_path(), state)

        for i, chunk in enumerate(chunks):
            if i < start:
                continue
            state, out = self.process_fn(params, state, chunk)
            if self.checkpoint_path and (i + 1) % self.checkpoint_every == 0:
                self._save(state, i + 1)
            yield i, out, state

    def _save(self, state, next_index: int) -> None:
        self.save_fn(self._state_path(), state)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(next_index))
        os.replace(tmp, self._meta_path())  # a rank lost mid-write leaves the old index

    def _state_path(self) -> str:
        return self.checkpoint_path + ".state.npz"

    def _meta_path(self) -> str:
        several = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
        return self.checkpoint_path + (f".meta.rank{_rank()}" if several else ".meta")
