"""Real-time deadline demo on the card: the hybrid engine behind an audio
callback (``neojax_torch``; ``examples/realtime_stream.py`` is the JAX
package's).

Drives ``conv.HybridStream`` (single-block latency, Gardner-style
two-stage scheduling) at block 512 / 48 kHz against a 10 s IR — the
reference plugin's scenario (``extra/plugin/src/PerceptualConvolution.hpp:13``,
``dsp/ConstantOverlapAdd.hpp:89-199``, CLI loop
``extra/cli/src/convolver.cpp:108-143``) — and reports per-callback wall
latency statistics against the 512/48000 = 10.667 ms deadline:

  1. **callback path**: N process-block calls, each fully synced (the
     output copied to the host like an audio callback writing its
     buffer); p50/p95/p99/max latency + deadline-miss rate, and the error
     against the offline ``process_hybrid`` of the same stream.
  2. **executor path**: the same engine behind ``io.StreamExecutor`` —
     the producer pushes odd-sized chunks into the native lock-free ring,
     the worker drains block frames, the consumer pulls at its own pace;
     held sample-exact against the offline stream (within 1e-4) and timed
     end to end (real-time factor).

Writes ``REALTIME_DEMO_TORCH.json`` (``--out``). Runs on the card; pass
``--device cpu`` for the kernels' plain versions.

Usage: python examples/realtime_stream_torch.py [--channels 2] [--seconds 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run(channels: int = 2, seconds: float = 20.0, ir_seconds: float = 10.0, block: int = 512,
        sr: int = 48000, chunk_blocks: int = 64, out: str | None = "REALTIME_DEMO_TORCH.json",
        device=None) -> dict:
    """Both paths at this configuration; returns the result dict (also
    written to ``out`` unless it is None)."""
    import torch

    from neojax_torch.conv import convolver as cv
    from neojax_torch.conv import hybrid, partition
    from neojax_torch.core.device import resolve_device
    from neojax_torch.io import StreamExecutor

    dev = resolve_device(device)
    b, c, s = block, channels, chunk_blocks
    deadline_ms = 1e3 * b / sr
    p = int(np.ceil(ir_seconds * sr / b))

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal((1, p * b)) * 0.05 * np.exp(-np.arange(p * b) / (p * b / 4))).astype(np.float32)
    parts = partition.uniform_partition(ir, b)

    cfg = cv.PartitionedConfig(b, p, c, storage="split")
    params = hybrid.hybrid_filter_params(cfg, parts, s, device=dev)
    params = {k: v for k, v in params.items() if k != "head_packed"}
    stream = hybrid.HybridStream(cfg, params)

    nb = int(seconds * sr / b)
    nb -= nb % s
    sig = rng.uniform(-1, 1, (c, nb * b)).astype(np.float32)

    # -- 1. callback path: per-block wall latency, fully synced ------------
    for i in range(2 * s):  # warm both paths (the tail refresh runs every S blocks)
        stream(sig[:, i * b : (i + 1) * b]).cpu()
    stream.reset()

    lat = np.zeros(nb)
    outs = []
    t_run0 = time.perf_counter()
    for i in range(nb):
        t0 = time.perf_counter()
        y = stream(sig[:, i * b : (i + 1) * b]).cpu().numpy()
        lat[i] = time.perf_counter() - t0
        outs.append(y)
    t_run = time.perf_counter() - t_run0
    out_cb = np.concatenate(outs, axis=-1)

    # exactness against the offline engine
    _, ref = hybrid.process_hybrid(cfg, params, hybrid.hybrid_init_state(cfg, params),
                                   torch.from_numpy(sig).to(dev))
    ref = ref.cpu().numpy()
    max_err = float(np.max(np.abs(out_cb - ref)))

    def q(x):
        return float(np.quantile(lat, x) * 1e3)

    callback = {
        "blocks": nb,
        "deadline_ms": deadline_ms,
        "p50_ms": q(0.50),
        "p95_ms": q(0.95),
        "p99_ms": q(0.99),
        "max_ms": float(lat.max() * 1e3),
        "miss_rate": float(np.mean(lat > deadline_ms / 1e3)),
        "meets_deadline_p99": bool(q(0.99) < deadline_ms),
        "amortized_ms_per_block": t_run / nb * 1e3,
        "max_abs_err_vs_offline": max_err,
        "matches_offline_1e-4": bool(max_err < 1e-4),
        "realtime_factor": deadline_ms / (t_run / nb * 1e3),
    }

    # -- 2. executor path: native rings + worker thread --------------------
    stream2 = hybrid.HybridStream(cfg, params)

    def step(state, blk):
        return state, stream2(blk)

    got = []
    t0 = last = time.perf_counter()
    with StreamExecutor(step, None, c, b, capacity_blocks=128) as ex:
        sent = 0
        while sum(x.shape[1] for x in got) < nb * b:
            if time.perf_counter() - last > 30:
                break  # no output for 30 s: the worker stopped
            if sent < sig.shape[1]:
                sent += ex.push(sig[:, sent : sent + 4391])  # odd chunks
            chunk = ex.pull(8 * b)
            if chunk.shape[1]:
                got.append(chunk)
                last = time.perf_counter()
            else:
                # yield the GIL to the worker thread — a spinning producer
                # starves it (real audio callbacks are naturally paced)
                time.sleep(0.002)
    t_exec = time.perf_counter() - t0
    out_ex = np.concatenate(got, axis=-1)[:, : nb * b]
    ex_err = float(np.max(np.abs(out_ex - ref[:, : out_ex.shape[1]])))
    executor = {
        "wall_s": t_exec,
        "audio_s": nb * b / sr,
        "samples_out": int(out_ex.shape[1]),
        "realtime_factor": nb * b / sr / t_exec,
        # f32 tolerance: per-block HybridStream against the S-blocks-per-call
        # offline engine reassociate the same sums differently
        "max_abs_err_vs_offline": ex_err,
        "matches_offline_1e-4": bool(ex_err < 1e-4 and out_ex.shape[1] == nb * b),
    }

    result = {
        "metric": "realtime_deadline_demo",
        "device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        "config": {
            "block": b, "sample_rate": sr, "channels": c,
            "ir_seconds": ir_seconds, "partitions": p,
            "chunk_blocks": s, "storage": "split",
        },
        "callback_path": callback,
        "executor_path": executor,
    }
    if out is not None:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--ir-seconds", type=float, default=10.0)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--chunk-blocks", type=int, default=64)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="REALTIME_DEMO_TORCH.json")
    args = ap.parse_args()
    result = run(args.channels, args.seconds, args.ir_seconds, args.block, args.sr, args.chunk_blocks,
                 args.out, args.device)
    print(json.dumps(result, indent=1))
    print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
