"""neojax_torch.dist's multi-process layer on gloo worlds of CPU processes:
``init_distributed``, the per-rank checkpoints, ``StreamDriver``'s
kill-and-resume, the DCP checkpoint pair, ``weak_scaling_sweep`` and a dry
run of every distributed engine on 8 ranks.

- ``init_distributed``: False without a coordinator; with an unreachable
  one (a free port of 127.0.0.1 that nobody serves) it raises within its
  timeout instead of hanging.
- ``save_sharded_state``/``load_sharded_state`` and ``io.save_state_dcp``/
  ``load_state_dcp`` round trips of an int8 state at 2 ranks (each rank's
  own shard back bit for bit), and the DCP pair in one process.
- ``StreamDriver`` at 2 ranks over ``sharded_process``, checkpointing every
  2 chunks: rank 1 ends its process (``os._exit``) after chunk 3, the world
  is started again and resumes from each rank's checkpoint; every rank's
  outputs then equal one uninterrupted single-process ``process`` within
  1e-5 (the bound of ``tests/test_multiprocess.py``, its JAX counterpart).
- ``weak_scaling_sweep`` at [1, 2] ranks: the structure of its points
  (``tests/test_dist.py``'s check); and at [1] in the 2-rank world, where
  rank 1 is outside the point's mesh: both ranks report the one point,
  and each joins the MAX reduce on its own device.
- the counterpart of ``__graft_entry__.dryrun_multichip`` on an 8-rank
  world at its tiny shapes: ``PipelineConvolver`` (part 2 x ch 4),
  ``sharded_process``, ``timesharded_process`` on a "time" mesh,
  ``BinShardedConvolver`` int16, ``sharded_process_nested``/``_hybrid`` and
  ``PartShardedNested`` int8, output shapes checked. (The JAX dry run's
  interpret-mode step has no counterpart: the port's plain versions are
  what run on the CPU.)
"""

import datetime
import os

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_world import free_port, run_world
from neojax_torch import io as tio
from neojax_torch.conv import convolver as tcv
from neojax_torch.dist import init_distributed


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("multihost"))


@pytest.fixture(scope="module")
def world(tmp):
    """The 2-rank world, whose last step is the stream rank 1 cuts short,
    then the world started again to resume it."""
    first = run_world(2, "torch_dist_cases.multihost_world", tmp, expect_exit={1: cases.KILLED_EXIT})
    resumed = run_world(2, "torch_dist_cases.multihost_resume_world", tmp)
    return {"first": first[0], "resumed": resumed}


def _case(res, name):
    val = res[name]
    if isinstance(val, tuple) and val and val[0] == "error":
        pytest.fail(f"case {name} raised on the ranks:\n{val[1]}")
    return val


def test_init_distributed_without_coordinator(monkeypatch):
    monkeypatch.delenv("NEOJAX_COORDINATOR", raising=False)
    assert init_distributed() is False


def test_init_distributed_unreachable_raises_in_time():
    import torch.distributed as dist

    t0 = datetime.datetime.now()
    with pytest.raises(Exception):
        init_distributed(f"127.0.0.1:{free_port()}", num_processes=2, process_id=1, timeout_secs=2,
                         backend="gloo")
    assert (datetime.datetime.now() - t0).total_seconds() < 30
    assert not dist.is_initialized()


@pytest.mark.parametrize("pair", ["sharded_npz", "dcp"])
def test_sharded_checkpoint_roundtrip(world, pair):
    assert _case(world["first"], pair) is True


def test_dcp_single_process(tmp_path):
    cfg = cases.mh_config()
    params = tcv.filter_params(cfg, cases.parts(cases.MH_P, seed=13), device="cpu")
    st, _ = tcv.process(cfg, params, tcv.init_state(cfg, "cpu"), cases.mh_signal()[:, : 3 * cases.B])
    path = str(tmp_path / "dcp")
    tio.save_state_dcp(path, st)
    back = tio.load_state_dcp(path, tcv.init_state(cfg, "cpu"))
    assert back["pos"] == st["pos"] == 3
    for key in ("tail", "fdl", "dcny"):
        assert torch.equal(back[key], st[key])


def test_stream_driver_kill_and_resume(world, tmp):
    assert world["first"]["driver_first_run"] == list(range(cases.MH_CHUNKS))  # rank 0 ran through
    assert world["resumed"][1] == list(range(2, cases.MH_CHUNKS))  # rank 1 from its checkpoint at 2
    assert world["resumed"][0] == []  # rank 0's checkpoint was the end of the stream
    cfg = cases.mh_config()
    params = tcv.filter_params(cfg, cases.parts(cases.MH_P, seed=13), device="cpu")
    _, ref = tcv.process(cfg, params, tcv.init_state(cfg, "cpu"), cases.mh_signal())
    half = cases.MH_C // 2
    for rank in (0, 1):
        got = np.concatenate([np.load(os.path.join(tmp, f"out_r{rank}_c{i}.npy")) for i in range(cases.MH_CHUNKS)],
                             axis=1)
        np.testing.assert_allclose(got, ref.numpy()[rank * half : (rank + 1) * half], atol=1e-5)


def test_weak_scaling_sweep_structure(world):
    points = _case(world["first"], "sweep")
    assert [p["devices"] for p in points] == [1, 2]
    assert [p["channels"] for p in points] == [2, 4]
    assert points[0]["efficiency"] == 1.0
    for p in points:
        assert p["samples_per_sec"] > 0
        assert abs(p["per_device"] - p["samples_per_sec"] / p["devices"]) < 1e-6


def test_weak_scaling_sweep_rank_outside_the_mesh(world):
    got = _case(world["first"], "sweep_outside_rank")
    assert [p["devices"] for p in got["points"]] == [1]
    assert got["own_device"]
    assert got["samples_per_sec"][0] == got["samples_per_sec"][1] > 0


@pytest.fixture(scope="module")
def dryrun():
    return run_world(8, "torch_dist_cases.dryrun_world")[0]


@pytest.mark.parametrize("engine", ["pipeline", "sharded", "binsharded", "nested", "hybrid", "partnested",
                                    "timesharded"])
def test_dryrun_multichip(dryrun, engine):
    c, b = dryrun["channels"], dryrun["block"]
    want = {"nested": (c, 4 * b), "hybrid": (c, 4 * b), "partnested": (c, 4 * b),
            "timesharded": (c, dryrun["time_len"])}.get(engine, (c, b))
    assert tuple(dryrun["shapes"][engine]) == want
