"""Start a gloo world of CPU processes for the distributed tests of
``neojax_torch.dist`` and collect what each rank returns.

:func:`run_world` spawns ``n`` processes (``spawn``, never ``fork``) that
join one gloo group over a free port of 127.0.0.1 with a 60 s timeout,
run ``target(rank, world, *args)`` and send back its result (picklable:
numpy arrays, numbers, strings). The world runs under a limit of its own:
a rank that fails or a world that hangs raises here, with each rank's
traceback, and every process is stopped. Nothing waits on a fixed port or
a sleep.

This module imports numpy and torch only (the workers never import JAX);
the cases the workers run live in ``torch_dist_cases``.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import socket
import time
import traceback

WORLD_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, target: str, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        module, name = target.rsplit(".", 1)
        out = getattr(importlib.import_module(module), name)(rank, world, *args)
        results.put((rank, "ok", out))
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the world
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_world(n: int, target: str, *args, timeout: float = WORLD_TIMEOUT_S, expect_exit: dict | None = None) -> dict:
    """Run ``target`` ("module.function") on ``n`` gloo ranks; returns
    {rank: result}. ``expect_exit`` maps ranks that are meant to end the
    process themselves (``os._exit``) to their exit code; they return
    nothing, and their peers may fail after them (their errors are then
    returned as ``("error", traceback)``)."""
    expect_exit = expect_exit or {}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, n, port, target, args, results), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict = {}
    try:
        while len(got) < n - len(expect_exit):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{target}: world of {n} did not finish in {timeout} s (done: {sorted(got)})")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got and r not in expect_exit]
                if dead and results.empty():
                    raise RuntimeError(f"{target}: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if status == "error" and not expect_exit:
                raise RuntimeError(f"{target}: rank {rank} failed:\n{out}")
            got[rank] = out if status == "ok" else ("error", out)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for r, code in expect_exit.items():
            if procs[r].exitcode != code:
                raise RuntimeError(f"{target}: rank {r} exited with {procs[r].exitcode}, expected {code}")
        return got
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
