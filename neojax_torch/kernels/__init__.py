"""Hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version: B1 ``fdl_mac.fdl_mac``, B2 ``fused_step.fused_block_step``, B3
``fused_step.fused_stream`` (the per-block convolver and the hybrid head;
both with the sparse chunk schedule), B4 ``sparse_mac.sparse_fdl_mac`` (the
unfused sparse MAC), B5 ``nested_mac.nested_mac`` (the nested engine and
the hybrid tail), and the measurement probes T1 ``probes.probe_ring_read``
and T2 ``probes.probe_stream``. B2 and B3 run as stage kernels
(``fused_step.stage_wrappers()``: the windowed forward and inverse
products, quantize, the time-batched MAC, the ring write-back, the
schedule's width table, and B2's split MAC and its reduction). Nothing is
compiled at import time.

Each wrapper counts its kernel launches in a plain int attribute
(``fdl_mac.fdl_mac.launches``); ``fused_block_step`` and ``fused_stream``
count the calls that ran their stage kernels, and, in ``sched_launches``,
those that ran a chunk schedule or a tap-tile table. ``stream_mac`` also
counts the steps of its walk (``counters()``). The CPU route counts
nothing."""

from neojax_torch.kernels import fdl_mac as _fdl_mac_mod
from neojax_torch.kernels import fused_step as _fused_step_mod
from neojax_torch.kernels import nested_mac as _nested_mac_mod
from neojax_torch.kernels import probes as _probes_mod
from neojax_torch.kernels import sparse_mac as _sparse_mac_mod


def _wrappers():
    return (_fdl_mac_mod.fdl_mac, _fused_step_mod.fused_block_step, _fused_step_mod.fused_stream,
            _sparse_mac_mod.sparse_fdl_mac, _nested_mac_mod.nested_mac,
            _probes_mod.probe_ring_read, _probes_mod.probe_stream, *_fused_step_mod.stage_wrappers())


def _sched_wrappers():
    return (_fused_step_mod.fused_block_step, _fused_step_mod.fused_stream)


def reset_launch_counts() -> None:
    """Zero the launch counters and :func:`counters`."""
    for k in _wrappers():
        k.launches = 0
    for k in _sched_wrappers():
        k.sched_launches = 0
    _fused_step_mod.stream_mac.steps_run = _fused_step_mod.stream_mac.steps_dense = 0


def launch_counts() -> dict:
    """{wrapper name: launches}, plus ``<name>_sched`` for B2 and B3's
    scheduled launches."""
    counts = {k.__name__: k.launches for k in _wrappers()}
    counts.update({f"{k.__name__}_sched": k.sched_launches for k in _sched_wrappers()})
    return counts


def counters() -> dict:
    """The kernels' work counters: ``stream_mac.steps_run``, the steps of
    history B3's time-batched MAC ran, and ``stream_mac.steps_dense``, those
    the dense kernel would have walked in the same windows (each counted
    once a lane tile, block tile and channel: ``fused_step.stream_mac``)."""
    mac = _fused_step_mod.stream_mac
    return {"stream_mac.steps_run": mac.steps_run, "stream_mac.steps_dense": mac.steps_dense}


__all__ = ["reset_launch_counts", "launch_counts", "counters"]
