"""Device time of the partition MACs (B1 ``fdl_mac``, B4 ``sparse_fdl_mac``,
and B2's ``step_mac`` inside ``fused_block_step``) of one checkout of this
repository, at the convolver's shapes: the headline ring [2, 960, 64, 512]
(four storages; split also with a per-channel filter), the hybrid head's
[2, 64, 64, 513] and a non-packed [2, 960, 64, 513] ring; B4 on the
``band30`` mask (the first 30 % of the partitions) at ring position P - 1.

To compare two trees on one card, run it from this checkout once per tree,
in turns (A, B, B, A), each in its own process:

    python neojax_torch/tools/mac_ab.py --tree <root of a checkout> --label A --out ab.jsonl

It imports ``neojax_torch`` from ``--tree`` (run it as a file, not with
``-m``, so that nothing of the package is imported before). Each row is
one JSON line: ``out_sha``, a digest of the bytes of the first call's
outputs (the inputs are drawn alike in every tree, so two trees whose
kernels sum alike print the same digest); ``dev_us``, the median over five
calls of the summed device time of the call's kernels
(``bench.profile.kernel_timeline``); ``host_us``,
the median host time of one call from an idle card to its return (the
enqueue, not the kernel); ``loop_us``, the wall time a call of 200 back to
back (the larger of host and device time, as a loop of calls sees it);
and the card's name and power limit. The probe T1 (``probe_ring_read``)
is timed on the same rings as B1 (headline split and bf16, K = 513, the
hybrid head), each row beside B1's. A last row times the hybrid engine
with its unfused head (bf16: one B1 call a block) in µs a block.
Without a card it exits non-zero.

``--rows transforms`` times only the transform rows (``--rows macs`` all
but them): ``window_forward`` and ``window_inverse`` on B3's headline
window of 64 blocks (64 channels, B = 512) with f32 and bf16 matrices, B2's
one block (``fused_block_step``, split) and a B3 split call of 64 blocks
(``fused_stream`` on the headline ring). The transforms of two trees may
round apart (a matrix product against an FFT), so each of these rows also
carries ``plain_rel_err``: max|out - plain| / max|plain| of its output
against the tree's own plain version on the same inputs.

``--rows stream_mac`` times only B3's time-batched MAC (``stream_mac``) on
a window of 64 blocks at ring position P - 5 (the window wraps the ring)
with an untiled random rim: the headline ring in the four storages, split
with a per-channel filter (Cf = C), the hybrid head (P = 64, with a seed;
split and int16, the int8 hybrid's head storage),
split with the tap-tile table of the ``band30`` and ``perc30`` masks (the
convolver's masked filter and ``params["tap_tiles"]``; the walk's plan
built before the timed calls), and a B3 split call of 64 blocks
(``fused_stream``). Each row carries ``plain_rel_err`` against the tree's
own plain version; the trees' kernels sum alike, so their ``out_sha``
agree.

``--variants`` (a tree whose ``kernels.fdl_mac`` has ``_MAC_VEC_BYTES``)
first times B1 and B4 on the headline ring at the geometries the kept one
was chosen against, each row with its ``variant``: ``vec16`` (V = 16 /
itemsize lanes a thread, 16-byte ring loads) and ``split32`` (splits of
at least 32 slots instead of 64).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

DT = ("split", "bf16", "int16", "int8")
INT_MAX = {"int16": 32767, "int8": 127}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".", help="root of the checkout whose neojax_torch is measured")
    ap.add_argument("--label", default="tree", help="name of the tree in the output rows")
    ap.add_argument("--out", help="append the JSON lines here too")
    ap.add_argument("--variants", action="store_true",
                    help="also time B1/B4 at the geometries the kept one was chosen against")
    ap.add_argument("--rows", choices=("all", "macs", "transforms", "stream_mac"), default="all",
                    help="the MAC rows, the transform rows, both, or only B3's stream_mac rows")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("mac_ab: no CUDA device; this tool measures on the card", file=sys.stderr)
        return 2
    from neojax_torch.bench import profile
    from neojax_torch.fft import matmul_backend as mb
    from neojax_torch.kernels import _build, fdl_mac as mac, fused_step as fs, probes as pr, sparse_mac as sm

    _build.load()
    dev = torch.device("cuda")
    dtypes = {"split": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16, "int8": torch.int8}
    gen = torch.Generator(dev).manual_seed(5)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "a") if args.out else None

    def ring_of(storage, p, c, k):
        if storage in INT_MAX:
            m = INT_MAX[storage]
            ring = torch.randint(-m, m + 1, (2, p, c, k), device=dev, generator=gen).to(dtypes[storage])
            return ring, torch.rand((p, c), device=dev, generator=gen) * 39 + 1
        return (torch.randn((2, p, c, k), device=dev, generator=gen) * 10).to(dtypes[storage]), None

    def dev_us(fn, name_has=None):
        fn()
        torch.cuda.synchronize()
        calls = [c for c in profile.kernel_timeline(fn, 5) if c]
        return float(np.median([sum(us for n, us in c if name_has is None or name_has in n) for c in calls]))

    def host_us(fn, n=30):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return 1e6 * float(np.median(ts))

    def loop_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / n

    def sha(outs):
        h = hashlib.sha256()
        for t in outs if isinstance(outs, (tuple, list)) else (outs,):
            if isinstance(t, torch.Tensor):
                h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def emit(kernel, fn, plain=None, **kw):
        got = fn()
        first = sha(got)
        if plain is not None:  # the output against the plain version, before the timing calls
            want = plain()
            got, want = (t[0] if isinstance(t, (tuple, list)) else t for t in (got, want))
            kw["plain_rel_err"] = float((got.double() - want.double()).abs().max() / want.double().abs().max())
        row = {"tree": args.label, "kernel": kernel, **kw, "out_sha": first, "dev_us": dev_us(fn),
               "host_us": host_us(fn), "loop_us": loop_us(fn), "card": card}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    def mac_rows(p, c, k, storages, **tag):
        for storage in storages:
            ring, scales = ring_of(storage, p, c, k)
            for cf in (1, c) if (storage == "split" and p == 960 and k == 512) else (1,):
                tiled = torch.randn((2, 2 * p, cf, k), device=dev, generator=gen) * 0.05
                fr, fi = tiled[0, p - 8 : 2 * p - 8], tiled[1, p - 8 : 2 * p - 8]  # ring position 7
                emit("fdl_mac", lambda: mac.fdl_mac(ring, fr, fi, scales), ring=[p, c, k], storage=storage, cf=cf,
                     **tag)
                if storage in ("split", "bf16") and cf == 1 and not tag:  # T1 on B1's ring and filter plane
                    fr0 = fr[:, 0]
                    pc = mac.choose_chunks(dtypes[storage], p, c, k)[1]
                    geo = pr.ring_read_geometry(ring, fr0) if hasattr(pr, "ring_read_geometry") else None
                    emit("probe_ring_read", lambda: pr.probe_ring_read(ring, fr0, pc), ring=[p, c, k],
                         storage=storage, p_chunk=pc, geometry=geo)
            if p == 960 and storage != "bf16":
                mask = np.zeros((p, k), bool)
                mask[: int(0.3 * p)] = True
                kt, pc = mac.choose_chunks(dtypes[storage], p, c, k)
                sched = sm.build_sparse_schedule(mask, pc, kt)
                tables = [torch.from_numpy(sched[key]).to(dev) for key in ("k_idx", "p_idx", "flags")]
                m = torch.from_numpy(mask).to(dev)[:, None, :]
                tr, ti = (torch.cat([(torch.randn((p, 1, k), device=dev, generator=gen) * m).flip(0)] * 2)
                          for _ in range(2))
                fr, fi = tr[:p], ti[:p]  # ring position P - 1
                kw = {}
                if hasattr(sm, "tile_live_table"):  # the table the convolver keeps beside the tables
                    kw["live"] = sm.tile_live_table(*tables, p // pc, -(-k // kt))
                emit("sparse_fdl_mac", lambda: sm.sparse_fdl_mac(ring, fr, fi, p - 1, *tables, scales, p_chunk=pc,
                                                                 k_tile=kt, **kw),
                     ring=[p, c, k], storage=storage, mask="band30", pos=p - 1, **tag)
            del ring, scales
            torch.cuda.empty_cache()

    if args.rows == "stream_mac":
        from neojax_torch import conv
        from neojax_torch.bench import headline
        from neojax_torch.conv import convolver as cv

        c, b, n, wc = 64, 512, 1024, 64

        def window(storage, p, cf=1, seed=False):
            ring, scales = ring_of(storage, p, c, b)
            mdt = fs.MATRIX_DTYPES[dtypes[storage]]
            rim = (torch.randn((2 * p, cf, n), device=dev, generator=gen) * 0.05).to(mdt)
            x, scl = fs.quantize_rows(torch.randn((wc, c, n), device=dev, generator=gen) * 3, dtypes[storage])
            dcfix = torch.randn((wc, 2, c), device=dev, generator=gen)
            sd = torch.randn((wc, 2, c, b), device=dev, generator=gen) if seed else None
            return ring, scales, x, scl, rim, dcfix, sd

        def mac_row(ops, p, tiles=None, **tag):
            ring, scales, x, scl, rim, dcfix, sd = ops
            args_ = (ring, scales, x, scl, rim, dcfix, p - 5, sd)
            emit("stream_mac", lambda: fs.stream_mac(*args_, tiles=tiles),
                 lambda: fs.stream_mac_reference(*args_, tiles=tiles),
                 ring=[p, c, b], blocks=wc, cf=rim.shape[1], seed=sd is not None, **tag)

        for storage in DT:
            mac_row(window(storage, 960), 960, storage=storage)
        mac_row(window("split", 960, cf=c), 960, storage="split")
        for storage in ("split", "int16"):  # int16: the int8 hybrid's head
            mac_row(window(storage, 64, seed=True), 64, storage=storage, shape="hybrid_head")
        ir = conv.normalize_impulse(torch.from_numpy(headline.make_ir(938, b).astype(np.float32))).numpy()
        parts = conv.uniform_partition(ir, b)
        parts_pad = np.concatenate([parts, np.zeros((1, 960 - 938, b + 1), parts.dtype)], axis=1)
        masks = {"band30": np.zeros((960, b + 1), bool)}
        masks["band30"][:288] = True
        masks["perc30"] = np.concatenate([conv.perceptual_mask(parts[0], 48000, threshold_db=-30.0),
                                          np.zeros((960 - 938, b + 1), bool)])
        for mname, mask in masks.items():
            prm = cv.filter_params(cv.PartitionedConfig(b, 960, c, storage="split"), parts_pad, sparsity=mask,
                                   device=dev)
            ops = list(window("split", 960))
            ops[4] = prm["filt_rim"]
            mac_row(ops, 960, prm["tap_tiles"], storage="split", mask=mname)
            del prm, ops
        p = 960
        sig = torch.rand((c, 65 * b), device=dev, generator=gen) * 2 - 1
        ring, _ = ring_of("split", p, c, b)
        rings = [ring.clone() for _ in range(2)]
        rim = torch.randn((2 * p, 1, n), device=dev, generator=gen) * 0.05
        cs2, abt = mb.packed_stream_mats(n, torch.float32, dev)
        dcfix_all = torch.randn((64, 2, c), device=dev, generator=gen)
        emit("fused_stream", lambda: fs.fused_stream(sig, rings[0], rim, p - 5, dcfix_all, cs2, abt),
             lambda: fs.fused_stream_reference(sig, rings[1], rim, p - 5, dcfix_all, cs2, abt), storage="split",
             blocks=64)
        if out:
            out.close()
        return 0

    if args.rows in ("all", "transforms"):
        p, c, b = 960, 64, 512
        n = 2 * b
        sig = torch.rand((c, 65 * b), device=dev, generator=gen) * 2 - 1
        acc = torch.randn((64, c, n), device=dev, generator=gen)
        outs = [torch.zeros((c, 64 * b), device=dev) for _ in range(2)]
        for mdt in (torch.float32, torch.bfloat16):
            cs, abt = mb.packed_stream_mats(n, mdt, dev)
            emit("window_forward", lambda: fs.window_forward(sig, cs, 0, 64),
                 lambda: fs.window_forward_reference(sig, cs, 0, 64), rows=64 * c, block=b, matrix=str(mdt)[6:])
            emit("window_inverse", lambda: fs.window_inverse(acc, abt, outs[0], 0),
                 lambda: fs.window_inverse_reference(acc, abt, outs[1], 0), rows=64 * c, block=b,
                 matrix=str(mdt)[6:])
        ring, _ = ring_of("split", p, c, b)
        rings = [ring.clone() for _ in range(2)]
        rim = torch.randn((2 * p, 1, n), device=dev, generator=gen) * 0.05
        cs, ab = mb.packed_mats(n, torch.float32, dev)
        cs2, abt = mb.packed_stream_mats(n, torch.float32, dev)
        frame = torch.rand((c, n), device=dev, generator=gen) * 2 - 1
        dcfix = torch.randn((2, c), device=dev, generator=gen)
        dcfix_all = torch.randn((64, 2, c), device=dev, generator=gen)
        emit("fused_block_step", lambda: fs.fused_block_step(frame, rings[0], rim, 3, dcfix, cs, ab),
             lambda: fs.fused_block_step_reference(frame, rings[1], rim, 3, dcfix, cs, ab), storage="split",
             transform_rows=True)
        rings = [ring.clone() for _ in range(2)]
        emit("fused_stream", lambda: fs.fused_stream(sig, rings[0], rim, p - 5, dcfix_all, cs2, abt),
             lambda: fs.fused_stream_reference(sig, rings[1], rim, p - 5, dcfix_all, cs2, abt), storage="split",
             blocks=64)
        del ring, rings, sig, acc, outs
        torch.cuda.empty_cache()
        if args.rows == "transforms":
            if out:
                out.close()
            return 0

    if args.variants:
        kept = mac._MAC_VEC_BYTES, mac._MIN_SPLIT  # read by kernels.fdl_mac.mac_geometry at each call
        try:
            for storage in DT:
                if dtypes[storage].itemsize < kept[0]:  # at f32, 16-byte ring loads are the kept V = 4
                    mac._MAC_VEC_BYTES, mac._MIN_SPLIT = dtypes[storage].itemsize, kept[1]
                    mac_rows(960, 64, 512, (storage,), variant="vec16")
                mac._MAC_VEC_BYTES, mac._MIN_SPLIT = kept[0], 32
                mac_rows(960, 64, 512, (storage,), variant="split32")
        finally:
            mac._MAC_VEC_BYTES, mac._MIN_SPLIT = kept
    for (p, c, k), storages in (((960, 64, 512), DT), ((64, 64, 513), DT), ((960, 64, 513), ("split", "int16"))):
        mac_rows(p, c, k, storages)

    p, c, b = 960, 64, 512
    for storage in ("split", "bf16", "int8"):
        ring, scales = ring_of(storage, p, c, b)
        mdt = fs.MATRIX_DTYPES[dtypes[storage]]
        rim = (torch.randn((2 * p, 1, 2 * b), device=dev, generator=gen) * 0.05).to(mdt)
        cs, ab = mb.packed_mats(2 * b, mdt, dev)
        frame = torch.rand((c, 2 * b), device=dev, generator=gen) * 2 - 1
        dcfix = torch.randn((2, c), device=dev, generator=gen)

        def step():
            return fs.fused_block_step(frame, ring, rim, 3, dcfix, cs, ab, scales)

        emit("fused_block_step", step, storage=storage, step_mac_us=dev_us(step, "step_mac"))
        del ring, scales
    # the hybrid engine with the unfused head (bf16: one B1 call a block),
    # µs a block over 256 blocks of a 10 s decaying-noise IR, state carried
    from neojax_torch import conv
    from neojax_torch.bench import headline
    from neojax_torch.conv import hybrid as hy

    ir = conv.normalize_impulse(torch.from_numpy(headline.make_ir(938, b).astype(np.float32))).numpy()
    parts = conv.uniform_partition(ir, b)
    cfg = conv.PartitionedConfig(b, 938, c, storage="bf16")
    params = hy.hybrid_filter_params(cfg, parts, 64, device=dev)
    sig = torch.rand((c, 256 * b), device=dev, generator=gen) * 2 - 1
    state, _ = hy.process_hybrid(cfg, params, hy.hybrid_init_state(cfg, params), sig)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hy.process_hybrid(cfg, params, state, sig)
    torch.cuda.synchronize()
    row = {"tree": args.label, "kernel": "process_hybrid", "storage": "bf16", "blocks": 256,
           "us_per_block": 1e6 * (time.perf_counter() - t0) / 256, "card": card}
    print(json.dumps(row), flush=True)
    if out:
        out.write(json.dumps(row) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
