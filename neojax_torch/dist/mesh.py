"""Rank meshes and the collectives of the distributed engines
(``neojax.dist.mesh``).

The engine's parallel axes, as in the JAX package:

  "ch"   — channels, embarrassingly parallel (no collective)
  "part" — FDL partitions, a reduction axis: partial MACs are summed over
           it (:func:`psum`) and spectra age across it (:func:`ppermute`)
  "bin"  — frequency bins, independent in the MAC; the partial inverse
           transforms are summed over it
  "time" — the block stream itself (``dist.timesharded``): one halo
           :func:`ppermute` per call

JAX runs one program over a mesh of devices and returns global arrays.
Here every rank of a ``torch.distributed`` process group runs the same
call (SPMD): a :class:`Mesh` gives this rank its coordinates on named axes
and one process group per axis slice, and each engine returns this rank's
shard of its output and state. Rank r takes the coordinates that JAX
device r takes: the ranks fill the mesh row-major.

A world of one process with no process group is a mesh of size one on
every axis; the collectives are then identities. That is how a
single-process caller uses the distributed API, as JAX does on one device.

Collectives. :func:`psum` is ``all_reduce(SUM)`` over an axis group and
:func:`ppermute` one ``batch_isend_irecv`` round, the counterparts of
``lax.psum`` / ``lax.ppermute``. Under NCCL the tensors stay on the card.
gloo moves CUDA tensors only by ``all_reduce``/``broadcast``, not by
``send``/``recv``, and NCCL refuses two ranks of one group on one card, so
ranks that share a card run gloo and these two functions copy a CUDA
tensor to host memory, run the collective there and copy the result back:
that staging is written here and nowhere else, and each mesh counts its
bytes (``Mesh.host_staged_bytes``, both directions). Compute never moves.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from neojax_torch.core.device import resolve_device

__all__ = [
    "Mesh",
    "NamedSharding",
    "make_mesh",
    "channel_sharding",
    "rank_device",
    "psum",
    "ppermute",
]


def _world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given; else the card
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``, else the global
    rank), made the current device. Without a card and without ``device``
    it raises ``core.device.resolve_device``'s RuntimeError."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", _world()[0]))
    index = local % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


class Mesh:
    """A named mesh of ranks: ``shape[name]`` is an axis size (as
    ``jax.sharding.Mesh.shape``), ``coords[name]`` this rank's index on it.

    ``ranks`` (default: the whole world, in rank order) fill the mesh
    row-major. Every rank of the world must build the same meshes in the
    same order: each axis slice gets its own process group
    (``torch.distributed.new_group``, a collective call). A rank outside
    ``ranks`` gets a mesh with ``member`` False, which no engine accepts.
    """

    def __init__(self, axis_names, sizes, ranks=None, device=None):
        axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
        if len(axis_names) != len(sizes) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names {axis_names} and sizes {sizes} do not match")
        rank, world = _world()
        ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
        if math.prod(sizes) != len(ranks):
            raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {len(ranks)} ranks")
        if any(r < 0 or r >= world for r in ranks):
            raise ValueError(f"ranks {ranks} outside a world of {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.ranks = np.asarray(ranks).reshape(sizes)
        self.member = rank in ranks
        self.rank = rank
        self.host_staged_bytes = 0
        self.device = rank_device(device) if self.member else None
        where = np.argwhere(self.ranks == rank)
        self.coords = dict(zip(axis_names, (int(i) for i in where[0]))) if self.member else {}
        # one group per axis slice; every rank of the world creates all of them
        self._groups: dict = {}
        self._backend = None
        if dist.is_available() and dist.is_initialized():
            for a, name in enumerate(axis_names):
                lines = np.moveaxis(self.ranks, a, -1).reshape(-1, sizes[a])
                for line in lines:
                    group = dist.new_group([int(r) for r in line])
                    if rank in line:
                        self._groups[name] = group
            self._backend = dist.get_backend()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, device={self.device})"

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis`` (None
        without a process group)."""
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, by axis index."""
        a = self.axis_names.index(axis)
        index = [self.coords[n] for n in self.axis_names]
        index[a] = slice(None)
        return [int(r) for r in self.ranks[tuple(index)]]

    def _need_member(self) -> None:
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in this mesh (ranks {self.ranks.ravel().tolist()})")

    def block(self, spec, shape, coords: dict | None = None) -> tuple:
        """This rank's (or the rank at ``coords``') index tuple into an
        array of global ``shape`` split by ``spec``, a JAX-style
        ``PartitionSpec`` tuple (an axis name, a tuple of axis names, or
        None per array axis): contiguous blocks, as JAX lays them out."""
        if coords is None:
            self._need_member()
            coords = self.coords
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        index = []
        for dim, names in zip(shape, spec):
            names = () if names is None else (names,) if isinstance(names, str) else tuple(names)
            parts, at = 1, 0
            for name in names:  # major to minor, as a JAX spec tuple
                at = at * self.shape[name] + coords[name]
                parts *= self.shape[name]
            if dim % parts:
                raise ValueError(f"axis of length {dim} does not split into {parts} shards ({names})")
            step = dim // parts
            index.append(slice(at * step, (at + 1) * step) if parts > 1 else slice(None))
        return tuple(index)

    def local_shape(self, spec, shape) -> tuple:
        return tuple(len(range(*s.indices(d))) for s, d in zip(self.block(spec, shape), shape))

    def place(self, x, spec, shape, dtype: torch.dtype | None = None) -> torch.Tensor:
        """This rank's shard of ``x`` on the mesh's device. A tensor (or host
        array) of the local shape is taken as this rank's shard already
        (moved to the device if it lies elsewhere); one of the global
        ``shape`` is cut to this rank's block as a private contiguous copy,
        never a view into the caller's tensor."""
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        local, shape = self.local_shape(spec, shape), tuple(shape)
        if tuple(x.shape) == local:
            return x.to(device=self.device, dtype=dtype or x.dtype).contiguous()
        if tuple(x.shape) != shape:
            raise ValueError(f"array of shape {tuple(x.shape)} is neither the global {shape} nor the local {local}")
        return x[self.block(spec, shape)].to(device=self.device, dtype=dtype or x.dtype, copy=True).contiguous()

    # -- host staging (gloo with CUDA tensors) -----------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self._backend == "gloo"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self._staged(t):
            self.host_staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _from_host(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if h.device != like.device:
            self.host_staged_bytes += h.numel() * h.element_size()
            return h.to(like.device)
        return h


class NamedSharding:
    """An array layout over a mesh: ``spec`` names, per array axis, the mesh
    axis (or None) it is split over (``jax.sharding.NamedSharding``).
    :meth:`index` is this rank's index tuple into an array of a given
    global shape."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def index(self, shape) -> tuple:
        return self.mesh.block(self.spec, shape)


def make_mesh(ch: int | None = None, part: int | None = None, bin: int | None = None,
              device=None, ranks=None) -> Mesh:
    """Build a mesh over the ranks of the world (or ``ranks``, the
    counterpart of JAX's ``devices=``).

    With only one axis size given, the other axis takes the rest; with two,
    ranks reshape to [first, second] in (part|bin, ch) order. Defaults to
    every rank on "ch". A ``bin`` axis requests the bin-sharded layout and
    is exclusive with ``part``. ``device``: this rank's device
    (:func:`rank_device`; None means the card).
    """
    n = len(ranks) if ranks is not None else _world()[1]
    if bin is not None:
        if part is not None:
            raise ValueError("bin and part axes are exclusive (one reduce axis)")
        if ch is None:
            if n % bin:
                raise ValueError(f"{n} devices not divisible into bin={bin}")
            ch = n // bin
        if bin * ch != n:
            raise ValueError(f"mesh {bin}x{ch} != {n} devices")
        return Mesh(("bin", "ch"), (bin, ch), ranks, device)
    if ch is None and part is None:
        ch = n
    if ch is not None and part is None:
        if n % ch:
            raise ValueError(f"{n} devices not divisible into ch={ch}")
        part = n // ch
    elif part is not None and ch is None:
        if n % part:
            raise ValueError(f"{n} devices not divisible into part={part}")
        ch = n // part
    if ch * part != n:
        raise ValueError(f"mesh {part}x{ch} != {n} devices")
    return Mesh(("part", "ch"), (part, ch), ranks, device)


def channel_sharding(mesh: Mesh, ndim: int, ch_axis: int) -> NamedSharding:
    """The layout placing array axis ``ch_axis`` on the mesh "ch" axis."""
    spec = [None] * ndim
    spec[ch_axis] = "ch"
    return NamedSharding(mesh, spec)


def psum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``axis`` through this rank
    (``all_reduce(SUM)`` of the axis group, at every axis size): a new
    tensor on ``t``'s device. Under gloo a CUDA tensor goes through host
    memory (counted in ``mesh.host_staged_bytes``)."""
    group = mesh.group(axis)
    if group is None:  # one process, no process group
        return t.clone()
    if t.is_complex():
        return torch.view_as_complex(psum(torch.view_as_real(t), mesh, axis))
    t = t.contiguous()
    h = mesh._to_host(t)
    h = h.clone() if h is t else h
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    return mesh._from_host(h, t)


def ppermute(x, mesh: Mesh, axis: str, perm):
    """Send ``x`` (a tensor, or a tuple of tensors riding the same round)
    along ``axis`` by ``perm``, a list of (source, destination) axis indices,
    in one ``batch_isend_irecv`` round. Returns what this rank receives:
    zeros where no pair sends to it (the non-cyclic halo's first rank). On
    a size-1 axis it is the identity, since a rank cannot send to itself.
    Under gloo a CUDA tensor goes through host memory (counted in
    ``mesh.host_staged_bytes``)."""
    many = isinstance(x, (tuple, list))
    xs = tuple(x) if many else (x,)
    if any(t.is_complex() for t in xs):
        out = ppermute(tuple(torch.view_as_real(t) if t.is_complex() else t for t in xs), mesh, axis, perm)
        out = tuple(torch.view_as_complex(o) if t.is_complex() else o for o, t in zip(out, xs))
        return out if many else out[0]
    if mesh.shape[axis] == 1:
        out = tuple(t.clone() for t in xs) if any(s == d for s, d in perm) else tuple(torch.zeros_like(t) for t in xs)
        return out if many else out[0]
    me = mesh.coords[axis]
    ranks = mesh.axis_ranks(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at index {me}")
    group = mesh.group(axis)
    sends = [mesh._to_host(t.contiguous()) for t in xs] if dst else []
    recvs = ([torch.empty(t.shape, dtype=t.dtype, device="cpu" if mesh._staged(t) else t.device) for t in xs]
             if src else [])
    ops = [dist.P2POp(dist.isend, t, ranks[dst[0]], group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, ranks[src[0]], group) for t in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = tuple(mesh._from_host(r, t) for r, t in zip(recvs, xs)) if src else tuple(torch.zeros_like(t) for t in xs)
    return out if many else out[0]
