"""What the ranks of the distributed tests run (``tests/test_torch_dist*.py``,
``test_torch_timesharded.py``, ``test_torch_partnested.py``,
``test_torch_multihost.py``).

Each ``*_world`` function runs on every rank of a gloo world started by
``torch_dist_world.run_world``, on the CPU (the kernels' plain versions),
runs every case of its test file and returns, on rank 0, a dict of case
name -> result: global arrays assembled from the ranks' shards
(``convert.gather_shards``) for the parent to hold against ``neojax``, and
per-rank checks against the port's single-process engines. A case that
raises on every rank records its traceback instead. Inputs come from
``np.random.default_rng(seed)`` so the parent builds the same ones.

Imports numpy, torch and neojax_torch only.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from neojax_torch import convert, dist as tdist
from neojax_torch.conv import chunked, hybrid, nested
from neojax_torch.conv import convolver as cv
from neojax_torch.conv.partition import uniform_partition
from neojax_torch.dist import partnested as pn
from neojax_torch.dist.timesharded import timesharded_process

CPU = "cpu"
B = 64
C = 8
P = 8
S = 4
NB = 8


def parts(p=P, c_filt=1, seed=1, block=B) -> np.ndarray:
    ir = np.random.default_rng(seed).uniform(-1, 1, (c_filt, p * block)).astype(np.float32) * 0.2
    return uniform_partition(ir, block)  # [c_filt, P, K] complex64


def signal(c=C, nb=NB, seed=2, block=B) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (c, nb * block)).astype(np.float32)


def mask(p=P, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(p, B + 1)) > 0.4


def _run_cases(cases: dict) -> dict:
    """Run each case on this rank; a case that raises records its traceback."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:  # the parent's test of this case reports it
            out[name] = ("error", traceback.format_exc())
    return out


def _all(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank."""
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(flag))
    return all(flags)


def _gather_state(state: dict, specs: dict, mesh) -> dict:
    """Every entry of this rank's state assembled into the global array
    (ints kept; a (planes, scales) tuple entry by its pair of specs)."""
    out = {}
    for key, val in state.items():
        if isinstance(val, int):
            out[key] = val
        elif isinstance(val, tuple):
            out[key] = tuple(convert.gather_shards(v, mesh, s) for v, s in zip(val, specs[key]))
        else:
            out[key] = convert.gather_shards(val, mesh, specs[key])
    return out


def _equal_state(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, tuple):
            if not all(torch.equal(u, v) for u, v in zip(x, y)):
                return False
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _local(x: np.ndarray, mesh, spec) -> torch.Tensor:
    return torch.from_numpy(convert.local_shard(x, mesh, spec))


# ----------------------------------------------------- test_torch_dist.py


_PERBLOCK_SPECS = {"tail": ("ch", None), "fdl": (None, "ch", None), "dcny": (None, "ch", None)}


def _perblock_specs(state):
    specs = dict(_PERBLOCK_SPECS)
    fdl = state["fdl"]
    if isinstance(fdl, tuple):
        specs["fdl"] = ((None, None, "ch", None), (None, "ch", None))
    elif fdl.ndim == 4:
        specs["fdl"] = (None, None, "ch", None)
    return specs


def _sharded_case(mesh, storage, sparsity=None):
    cfg = cv.PartitionedConfig(B, P, C, storage=storage)
    sig = signal()
    params = cv.filter_params(cfg, parts(), sparsity=sparsity, device=CPU)
    half = NB // 2 * B
    st, a = tdist.sharded_process(cfg, params, cv.init_state(cfg, CPU), sig[:, :half], mesh)
    st, b = tdist.sharded_process(cfg, params, st, sig[:, half:], mesh)  # this rank's state, resumed
    out = torch.cat([a, b], dim=-1)
    # the port's single-process engine over this rank's channels
    local = dataclasses.replace(cfg, channels=C // mesh.shape["ch"])
    lp = cv.filter_params(local, parts(), sparsity=sparsity, device=CPU)
    ls, ref = cv.process(local, lp, cv.init_state(local, CPU), _local(sig, mesh, ("ch", None)))
    return {"out": convert.gather_shards(out, mesh, ("ch", None)),
            "state": _gather_state(st, _perblock_specs(st), mesh),
            "bit_equal": _all(torch.equal(out, ref) and _equal_state(st, ls)),
            "local_fdl_contiguous": _all(all(t.is_contiguous() for t in
                                             (st["fdl"] if isinstance(st["fdl"], tuple) else (st["fdl"],))))}


def _engine_case(mesh, kind):
    cfg = cv.PartitionedConfig(B, P, C, storage="split")
    sig = signal()
    local = dataclasses.replace(cfg, channels=C // mesh.shape["ch"])
    sig_l = _local(sig, mesh, ("ch", None))
    if kind == "chunked":
        params = chunked.chunked_filter_params(cfg, parts(), S, device=CPU)
        st, out = tdist.sharded_process_chunked(cfg, params, chunked.chunked_init_state(cfg, params), sig,
                                                mesh, S)
        lp = chunked.chunked_filter_params(local, parts(), S, device=CPU)
        ls, ref = chunked.process_chunked(local, lp, chunked.chunked_init_state(local, lp), sig_l, S)
        state = {"tail": convert.gather_shards(st["tail"], mesh, ("ch", None)),
                 "hists": tuple(convert.gather_shards(h, mesh, (None, None, "ch")) for h in st["hists"])}
        same = torch.equal(st["tail"], ls["tail"]) and all(torch.equal(x, y) for x, y in
                                                           zip(st["hists"], ls["hists"]))
    elif kind == "nested":
        params = nested.nested_filter_params(cfg, parts(), S, device=CPU)
        st, out = tdist.sharded_process_nested(cfg, params, nested.nested_init_state(cfg, params), sig, mesh)
        lp = nested.nested_filter_params(local, parts(), S, device=CPU)
        ls, ref = nested.process_nested(local, lp, nested.nested_init_state(local, lp), sig_l)
        specs = {"tail": ("ch", None), "prev": (None, "ch"), "fdl": (None, None, "ch")}
        state = _gather_state(st, specs, mesh)
        same = _equal_state(st, ls)
    else:
        params = hybrid.hybrid_filter_params(cfg, parts(), S, device=CPU)
        st, out = tdist.sharded_process_hybrid(cfg, params, hybrid.hybrid_init_state(cfg, params), sig, mesh)
        lp = hybrid.hybrid_filter_params(local, parts(), S, device=CPU)
        ls, ref = hybrid.process_hybrid(local, lp, hybrid.hybrid_init_state(local, lp), sig_l)
        state = None
        same = _equal_state(st, ls)
    return {"out": convert.gather_shards(out, mesh, ("ch", None)), "state": state,
            "bit_equal": _all(torch.equal(out, ref) and same)}


def _mesh_case():
    meshes = {"all": {}, "ch2": {"ch": 2}, "bin2": {"bin": 2}, "part4": {"part": 4}}
    out = {}
    for name, kw in meshes.items():
        m = tdist.make_mesh(device=CPU, **kw)
        coords = [None] * dist.get_world_size()
        dist.all_gather_object(coords, m.coords)
        out[name] = {"shape": dict(m.shape), "axes": m.axis_names, "coords": coords}
    errors = {}
    for name, kw in {"ch3": {"ch": 3}, "bin_part": {"bin": 2, "part": 2}, "part2_ch4": {"part": 2, "ch": 4},
                     "bin3": {"bin": 3}}.items():
        try:
            tdist.make_mesh(device=CPU, **kw)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def _collectives_case(rank):
    m = tdist.make_mesh(device=CPU)  # part 1 x ch 4
    m2 = tdist.make_mesh(ch=2, device=CPU)  # part 2 x ch 2
    x = torch.tensor([float(rank), 10.0 * rank])
    res = {
        "psum_ch": tdist.psum(x, m2, "ch"),
        "psum_part": tdist.psum(x, m2, "part"),
        "psum_size1": tdist.psum(x, m, "part"),
        "psum_complex": tdist.psum(torch.complex(x, -x), m, "ch"),
        "ring": tdist.ppermute(x, m, "ch", [(i, (i + 1) % 4) for i in range(4)]),
        "halo": tdist.ppermute(x, m, "ch", [(i, i + 1) for i in range(3)]),
        "pair": tdist.ppermute((x, x[:1] + 100), m2, "part", [(0, 1), (1, 0)]),
        "size1_ring": tdist.ppermute(x, m, "part", [(0, 0)]),
        "size1_halo": tdist.ppermute(x, m, "part", []),
        "staged_bytes": m.host_staged_bytes + m2.host_staged_bytes,
        "sharding": tdist.channel_sharding(m, 2, 0).index((8, 10)),
        "sharding_ch2": tdist.channel_sharding(m2, 3, 1).index((2, 8, 5)),
    }
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, {k: (tuple(t.numpy() for t in v) if isinstance(v, tuple) and v and
                                          isinstance(v[0], torch.Tensor) else
                                          v.numpy() if isinstance(v, torch.Tensor) else v)
                                      for k, v in res.items()})
    return gathered


def dist_world(rank, world):
    m4 = tdist.make_mesh(device=CPU)
    m22 = tdist.make_mesh(ch=2, device=CPU)
    cases = {
        "mesh": _mesh_case,
        "collectives": lambda: _collectives_case(rank),
        "sharded-ch4-dense": lambda: _sharded_case(m4, "dense"),
        "sharded-ch4-split": lambda: _sharded_case(m4, "split"),
        "sharded-ch2-dense": lambda: _sharded_case(m22, "dense"),
        "sharded-ch2-split": lambda: _sharded_case(m22, "split"),
        "sharded-ch4-masked": lambda: _sharded_case(m4, "split", sparsity=mask()),
        "chunked-ch4": lambda: _engine_case(m4, "chunked"),
        "nested-ch4": lambda: _engine_case(m4, "nested"),
        "hybrid-ch4": lambda: _engine_case(m4, "hybrid"),
    }
    out = _run_cases(cases)
    return out if rank == 0 else None


# ---------------------------------------------- test_torch_dist_pipeline.py

PIPE_C, PIPE_P = 4, 16
BIN_C, BIN_P = 4, 8
STORAGES = ("split", "bf16", "int16", "int8")


def pipe_filter(p=PIPE_P) -> np.ndarray:
    """The shared filter as ``shard_filter`` takes it: [P, 1, K] complex."""
    return np.moveaxis(parts(p=p, seed=4), 0, 1)


def _pipeline_case(part, ch, storage, resume=False):
    cfg = cv.PartitionedConfig(B, PIPE_P, PIPE_C, storage=storage)
    mesh = tdist.make_mesh(part=part, ch=ch, device=CPU)
    pipe = tdist.PipelineConvolver(cfg, mesh)
    filt = pipe.shard_filter(pipe_filter())
    sig = signal(PIPE_C, NB, seed=5)
    st, out = pipe.process(filt, pipe.init_state(), sig)
    res = {"out": convert.gather_shards(out, mesh, ("ch", None)),
           "state": _gather_state(st, pipe._specs(), mesh)}
    if resume:
        half = NB // 2 * B
        st2, first = pipe.process(filt, pipe.init_state(), sig[:, :half])
        _, second = pipe.process(filt, st2, sig[:, half:])
        res["resumed"] = convert.gather_shards(torch.cat([first, second], dim=-1), mesh, ("ch", None))
    return res


def bin_inputs():
    """(filter [P, 1, K], signal [C, 8B]) drawn as ``tests/test_dist.py``'s
    bin-sharded tests draw theirs (the conftest ``rng``, seed 12345: the IR,
    then the signal), so its quantized bounds apply."""
    rng = np.random.default_rng(12345)
    ir = rng.uniform(-1.0, 1.0, (BIN_P * B,)).astype(np.float32) * 0.2
    sig = rng.uniform(-1.0, 1.0, (BIN_C, NB * B)).astype(np.float32)
    return np.moveaxis(uniform_partition(ir[None], B), 0, 1), sig


def _binsharded_case(bins, ch, storage, resume=False):
    cfg = cv.PartitionedConfig(B, BIN_P, BIN_C, storage=storage)
    mesh = tdist.make_mesh(bin=bins, ch=ch, device=CPU)
    bc = tdist.BinShardedConvolver(cfg, mesh)
    filt_np, sig = bin_inputs()
    filt = bc.shard_filter(filt_np)
    st, out = bc.process(filt, bc.init_state(), sig)
    specs = {"tail": ("ch", None), "fdl": (None, None, "ch", "bin"), "scl": (None, "ch", "bin")}
    res = {"out": convert.gather_shards(out, mesh, ("ch", None)), "state": _gather_state(st, specs, mesh),
           "k_pad": bc.k_pad, "local_lanes": int(st["fdl"].shape[-1])}
    if resume:
        half = NB // 2 * B
        st2, first = bc.process(filt, bc.init_state(), sig[:, :half])
        _, second = bc.process(filt, st2, sig[:, half:])
        res["resumed"] = convert.gather_shards(torch.cat([first, second], dim=-1), mesh, ("ch", None))
    return res


def _convert_case(kind, carried):
    """Carry ``neojax``'s filter and state (global numpy, after its first
    call) into this rank's engine through ``convert`` and stream the second
    signal (2x2 mesh, int8)."""
    filt_np, state_np = carried
    if kind == "pipeline":
        cfg = cv.PartitionedConfig(B, PIPE_P, PIPE_C, storage="int8")
        eng = tdist.PipelineConvolver(cfg, tdist.make_mesh(part=2, ch=2, device=CPU))
        filt = convert.pipeline_filter_from_neojax(eng, filt_np)
        state = convert.pipeline_state_from_neojax(eng, state_np)
        _, out = eng.process(filt, state, signal(PIPE_C, NB, seed=7))
    else:
        cfg = cv.PartitionedConfig(B, BIN_P, BIN_C, storage="int8")
        eng = tdist.BinShardedConvolver(cfg, tdist.make_mesh(bin=2, ch=2, device=CPU))
        filt = convert.binsharded_filter_from_neojax(eng, filt_np)
        state = convert.binsharded_state_from_neojax(eng, state_np)
        _, out = eng.process(filt, state, signal(BIN_C, NB, seed=7))
    return {"out": convert.gather_shards(out, eng.mesh, ("ch", None))}


def pipeline_world(rank, world, carried):
    cases = {"convert-pipeline": lambda: _convert_case("pipeline", carried["pipeline"]),
             "convert-bin": lambda: _convert_case("bin", carried["bin"])}
    for part, ch in ((4, 1), (2, 2)):
        for storage in ("dense",) + STORAGES:
            cases[f"pipe-{part}x{ch}-{storage}"] = (lambda a=part, b=ch, s=storage:
                                                    _pipeline_case(a, b, s, resume=(a, b, s) == (2, 2, "split")))
    for bins, ch in ((2, 2), (4, 1)):
        for storage in STORAGES:
            cases[f"bin-{bins}x{ch}-{storage}"] = (lambda a=bins, b=ch, s=storage:
                                                   _binsharded_case(a, b, s, resume=(a, b, s) == (4, 1, "split")))
    out = _run_cases(cases)
    return out if rank == 0 else None


# ------------------------------------------------ test_torch_timesharded.py

TS_C, TS_B, TS_P, TS_NB = 3, 32, 4, 64


def ts_inputs(scheme, storage, channels=TS_C, layout="ring", seed=7):
    """(config, filter partitions [C, P, K], signal [C, T]) of
    ``tests/test_timesharded.py``'s shapes."""
    rng = np.random.default_rng(seed)
    ir = rng.uniform(-1, 1, (channels, TS_P * TS_B)).astype(np.float32) * 0.5
    sig = rng.uniform(-1, 1, (channels, TS_NB * TS_B)).astype(np.float32)
    cfg = cv.PartitionedConfig(TS_B, TS_P, channels, scheme=scheme, storage=storage, layout=layout)
    return cfg, uniform_partition(ir, TS_B), sig


def _timesharded_case(mesh, scheme, storage, channels=TS_C, layout="ring", mono=False):
    cfg, prt, sig = ts_inputs(scheme, storage, channels, layout)
    params = cv.filter_params(cfg, prt, device=CPU)
    x = sig[0] if mono else sig
    out = timesharded_process(cfg, params, x, mesh) if mesh.member else None
    got = convert.gather_shards(out, mesh, ("time",) if mono else (None, "time"))
    _, ref = cv.process(cfg, cv.filter_params(cfg, prt, device=CPU), cv.init_state(cfg, CPU), x)
    return {"out": got, "single": ref.numpy()}


def timesharded_world(rank, world):
    meshes = {d: tdist.Mesh(("time",), (d,), ranks=range(d), device=CPU) for d in (2, 4)}
    cases = {}
    for d, mesh in meshes.items():
        for scheme in ("upols", "upola"):
            for storage in ("dense", "split", "int8", "int16"):
                cases[f"ts-{d}-{scheme}-{storage}"] = (lambda m=mesh, a=scheme, s=storage:
                                                       _timesharded_case(m, a, s))
    cases["ts-shift"] = lambda: _timesharded_case(meshes[4], "upols", "split", layout="shift")
    cases["ts-mono"] = lambda: _timesharded_case(meshes[4], "upols", "split", channels=1, mono=True)
    out = _run_cases(cases)
    return out if rank == 0 else None


# ------------------------------------------------- test_torch_partnested.py

PN_B, PN_S, PN_C, PN_P = 64, 8, 4, 40  # P2 = 5 meta-partitions, padded to 6 (part 2) or 8 (part 4)


def pn_parts(c_filt=1, p=PN_P, seed=3) -> np.ndarray:
    """``tests/test_partnested.py``'s decaying IR spectra [c_filt, P, K]."""
    rng = np.random.default_rng(seed)
    ir = rng.standard_normal((c_filt, p * PN_B)) * np.exp(-np.arange(p * PN_B) / (p * PN_B / 3))
    seg = ir.reshape(c_filt, p, PN_B)
    return np.fft.rfft(np.concatenate([seg, np.zeros_like(seg)], axis=-1), axis=-1).astype(np.complex64)


def pn_signal(nb, seed=5) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (PN_C, nb * PN_B)).astype(np.float32)


def _partnested_case(part, ch, scheme, storage, c_filt=1):
    cfg = cv.PartitionedConfig(PN_B, PN_P, PN_C, scheme=scheme, storage=storage)
    mesh = tdist.make_mesh(part=part, ch=ch, device=CPU)
    eng = pn.PartShardedNested(cfg, mesh, PN_S)
    params = pn.partnested_filter_params(cfg, pn_parts(c_filt), PN_S, eng.d_part, device=CPU)
    state = pn.partnested_init_state(cfg, params, eng.d_part)
    st, out = eng.process(params, state, pn_signal(6 * PN_S))
    specs = {"tail": ("ch", None), "prev": (None, "ch"), "fdl": (None, "part", "ch"), "scales": ("part", "ch")}
    state = _gather_state(st, specs, mesh)  # before the next call writes the ring in place
    _, out2 = eng.process(params, st, pn_signal(2 * PN_S, seed=11))  # the stream continued
    # the port's single-process nested engine over this rank's channels, in one call
    local = dataclasses.replace(cfg, channels=PN_C // ch)
    lp = nested.nested_filter_params(local, _local(pn_parts(c_filt), mesh, ("ch",)) if c_filt > 1
                                     else pn_parts(), PN_S, device=CPU)
    whole = np.concatenate([pn_signal(6 * PN_S), pn_signal(2 * PN_S, seed=11)], axis=1)
    _, ref = nested.process_nested(local, lp, nested.nested_init_state(local, lp),
                                   _local(whole, mesh, ("ch", None)))
    both = torch.cat([out, out2], dim=-1)
    return {"out": convert.gather_shards(out, mesh, ("ch", None)),
            "state": state,
            "vs_process_nested": float((both - ref).abs().max()),
            "p2": int(st["fdl"].shape[1]) * eng.d_part}


def _partnested_convert_case(carried):
    """neojax's part-sharded params and state (global numpy, after its first
    call) carried into this rank's engine through ``convert``; the stream
    continues (2x2 mesh, int8)."""
    params_np, state_np = carried
    cfg = cv.PartitionedConfig(PN_B, PN_P, PN_C, storage="int8")
    eng = pn.PartShardedNested(cfg, tdist.make_mesh(part=2, ch=2, device=CPU), PN_S)
    params = convert.partnested_params_from_neojax(eng, params_np)
    state = convert.partnested_state_from_neojax(eng, state_np)
    _, out = eng.process(params, state, pn_signal(2 * PN_S, seed=11))
    return {"out": convert.gather_shards(out, eng.mesh, ("ch", None))}


def partnested_world(rank, world, carried):
    cases = {"pn-convert": lambda: _partnested_convert_case(carried)}
    for part, ch in ((2, 2), (4, 1)):
        for scheme in ("upols", "upola"):
            for storage in STORAGES:
                cases[f"pn-{part}x{ch}-{scheme}-{storage}"] = (
                    lambda a=part, b=ch, sc=scheme, s=storage: _partnested_case(a, b, sc, s))
    cases["pn-per-channel"] = lambda: _partnested_case(2, 2, "upols", "split", c_filt=PN_C)
    out = _run_cases(cases)
    return out if rank == 0 else None


# ------------------------------------------------- test_torch_multihost.py

MH_C, MH_P, MH_CHUNK, MH_CHUNKS = 4, 8, 2, 6  # 6 chunks of 2 blocks
KILLED_EXIT = 17  # the exit code of the rank that ends itself mid-stream


def mh_config():
    return cv.PartitionedConfig(B, MH_P, MH_C, storage="split")


def mh_signal() -> np.ndarray:
    return signal(MH_C, MH_CHUNK * MH_CHUNKS, seed=12)


def _driver_run(rank, tmp, kill_after=None):
    """Stream ``mh_signal`` chunk by chunk through ``StreamDriver`` over
    ``sharded_process`` (2 ranks on "ch"), checkpointing every 2 chunks
    with the per-rank npz pair; each chunk's output goes to a file. With
    ``kill_after`` rank 1 ends its process after that chunk."""
    cfg = mh_config()
    mesh = tdist.make_mesh(device=CPU)
    params = cv.filter_params(cfg, parts(MH_P, seed=13), device=CPU)
    step = MH_CHUNK * B
    chunks = [mh_signal()[:, i * step : (i + 1) * step] for i in range(MH_CHUNKS)]
    driver = tdist.StreamDriver(lambda p, s, x: tdist.sharded_process(cfg, p, s, x, mesh),
                                checkpoint_path=os.path.join(tmp, "stream"), checkpoint_every=2,
                                save_fn=tdist.multihost.save_sharded_state,
                                load_fn=tdist.multihost.load_sharded_state)
    done = []
    for i, out, _ in driver.run(params, tdist.shard_state(cfg, cv.init_state(cfg, CPU), mesh), chunks):
        np.save(os.path.join(tmp, f"out_r{rank}_c{i}.npy"), out.numpy())
        done.append(i)
        if kill_after is not None and rank == 1 and i == kill_after:
            os._exit(KILLED_EXIT)
    return done


def _sharded_roundtrip(tmp, save, load):
    """A sharded state saved and loaded by ``save``/``load`` on each rank."""
    cfg = dataclasses.replace(mh_config(), storage="int8")
    mesh = tdist.make_mesh(device=CPU)
    params = cv.filter_params(cfg, parts(MH_P, seed=13), device=CPU)
    st, _ = tdist.sharded_process(cfg, params, cv.init_state(cfg, CPU), mh_signal()[:, : 3 * B], mesh)
    path = os.path.join(tmp, "sharded")
    save(path, st)
    like = tdist.shard_state(cfg, cv.init_state(cfg, CPU), mesh)
    back = load(path, like)
    return _all(_equal_state(st, back) and back["pos"] == 3)


def _sweep_outside_rank():
    """``weak_scaling_sweep`` at one rank of two: rank 1 is outside the
    point's mesh. Every rank must join the MAX reduce on its own device
    (``rank_device``'s, the one NCCL needs), member or not: the device
    each rank hands ``_slowest`` is checked by identity. Returns rank 0's
    points, whether every rank passed its own device, and every rank's
    samples/s."""
    from neojax_torch.bench import scaling

    own, seen = torch.device(CPU), []
    real_rank_device, real_slowest = scaling.rank_device, scaling._slowest
    scaling.rank_device = lambda device=None: own
    scaling._slowest = lambda seconds, device: (seen.append(device is own), real_slowest(seconds, device))[1]
    try:
        points = scaling.weak_scaling_sweep(device_counts=[1], channels_per_device=2, block_size=64,
                                            num_partitions=8, chunk_blocks=4, seconds=0.05, storage="split",
                                            device=CPU)
    finally:
        scaling.rank_device, scaling._slowest = real_rank_device, real_slowest
    sps = [None] * dist.get_world_size()
    dist.all_gather_object(sps, points[0].samples_per_sec)
    return {"points": [dataclasses.asdict(pt) for pt in points], "own_device": _all(seen == [True]),
            "samples_per_sec": sps}


def multihost_world(rank, world, tmp):
    from neojax_torch import bench, io

    cases = {
        "sharded_npz": lambda: _sharded_roundtrip(tmp, tdist.multihost.save_sharded_state,
                                                  tdist.multihost.load_sharded_state),
        "dcp": lambda: _sharded_roundtrip(os.path.join(tmp, "dcp"), io.save_state_dcp, io.load_state_dcp),
        "sweep": lambda: [dataclasses.asdict(pt) for pt in bench.weak_scaling_sweep(
            device_counts=[1, 2], channels_per_device=2, block_size=64, num_partitions=8, chunk_blocks=4,
            seconds=0.05, storage="split", device=CPU)],
        "sweep_outside_rank": _sweep_outside_rank,
    }
    out = _run_cases(cases)
    out["driver_first_run"] = _driver_run(rank, tmp, kill_after=2)  # rank 1 ends here
    return out


def multihost_resume_world(rank, world, tmp):
    return _driver_run(rank, tmp)


def dryrun_world(rank, world):
    """The 8-rank dry run: every distributed engine once at tiny shapes
    (``__graft_entry__.dryrun_multichip``'s)."""
    block, d_part = 64, 2
    d_ch = world // d_part
    channels, p = 4 * d_ch, 4 * d_part
    rng = np.random.default_rng(0)
    prt = uniform_partition(rng.uniform(-1, 1, (1, p * block)).astype(np.float32), block)
    sig = rng.uniform(-1, 1, (channels, block)).astype(np.float32)
    shapes = {}

    mesh = tdist.make_mesh(part=d_part, ch=d_ch, device=CPU)
    cfg = cv.PartitionedConfig(block, p, channels=channels, layout="shift")
    pipe = tdist.PipelineConvolver(cfg, mesh)
    _, out = pipe.process(pipe.shard_filter(np.moveaxis(prt, 0, 1)), pipe.init_state(), sig)
    shapes["pipeline"] = convert.gather_shards(out, mesh, ("ch", None)).shape

    mesh2 = tdist.make_mesh(ch=world, device=CPU)
    cfg2 = cv.PartitionedConfig(block, p, channels=channels)
    _, out = tdist.sharded_process(cfg2, cv.filter_params(cfg2, prt, device=CPU), cv.init_state(cfg2, CPU),
                                   sig, mesh2)
    shapes["sharded"] = convert.gather_shards(out, mesh2, ("ch", None)).shape

    mesh_t = tdist.Mesh(("time",), (world,), device=CPU)
    cfg_t = cv.PartitionedConfig(block, p, channels=channels, storage="split")
    sig_t = rng.uniform(-1, 1, (channels, world * p * block)).astype(np.float32)
    out = timesharded_process(cfg_t, cv.filter_params(cfg_t, prt, device=CPU), sig_t, mesh_t)
    shapes["timesharded"] = convert.gather_shards(out, mesh_t, (None, "time")).shape

    mesh_b = tdist.make_mesh(bin=d_part * 2, ch=world // (d_part * 2), device=CPU)
    bc = tdist.BinShardedConvolver(cv.PartitionedConfig(block, p, channels=channels, storage="int16"), mesh_b)
    _, out = bc.process(bc.shard_filter(np.moveaxis(prt, 0, 1)), bc.init_state(), sig)
    shapes["binsharded"] = convert.gather_shards(out, mesh_b, ("ch", None)).shape

    cfg3 = cv.PartitionedConfig(block, p, channels=channels, storage="split")
    sig3 = np.random.default_rng(1).uniform(-1, 1, (channels, 4 * block)).astype(np.float32)
    params3 = nested.nested_filter_params(cfg3, prt, 2, device=CPU)
    _, out = tdist.sharded_process_nested(cfg3, params3, nested.nested_init_state(cfg3, params3), sig3, mesh2)
    shapes["nested"] = convert.gather_shards(out, mesh2, ("ch", None)).shape
    params4 = hybrid.hybrid_filter_params(cfg3, prt, 2, device=CPU)
    _, out = tdist.sharded_process_hybrid(cfg3, params4, hybrid.hybrid_init_state(cfg3, params4), sig3, mesh2)
    shapes["hybrid"] = convert.gather_shards(out, mesh2, ("ch", None)).shape

    mesh5 = tdist.make_mesh(part=d_part * 2, ch=world // (d_part * 2), device=CPU)
    cfg5 = cv.PartitionedConfig(block, p, channels=channels, storage="int8")
    eng = pn.PartShardedNested(cfg5, mesh5, 2)
    params5 = pn.partnested_filter_params(cfg5, prt, 2, eng.d_part, device=CPU)
    _, out = eng.process(params5, pn.partnested_init_state(cfg5, params5, eng.d_part), sig3)
    shapes["partnested"] = convert.gather_shards(out, mesh5, ("ch", None)).shape
    return {"shapes": shapes, "channels": channels, "block": block, "time_len": sig_t.shape[1]} if rank == 0 \
        else None
