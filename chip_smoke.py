#!/usr/bin/env python3
"""Drive neojax_torch's engines end to end on one CUDA card: the per-block
convolver (dense and sparse), the nested (two-level FDL) engine, the
hybrid real-time engine, the chunked (Toeplitz-product) engine,
``make_engine`` over the four, and ``neojax_torch.convolve``.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (the kernels are built for sm_90a) and nvcc; it exits
non-zero without a card and never falls back to the CPU.

Configuration: the repo's headline (``bench.py``, BASELINE.json config
#3) — 64 channels, a 10 s shared decaying-noise IR at 48 kHz (938
partitions; the per-block convolver pads them to P = 960), block B = 512,
transform N = 1024. The nested engine runs at S = 128 blocks a chunk
(meta ring [2, 8, 64, 513, 256]), the hybrid at S = 64 (head ring of 64
partitions, tail meta ring [2, 14, 64, 513, 128]), as ``bench.py:192-225``;
the chunked engine at S = 128 (``bench.py:391``). The sparse convolver runs two keep-masks of that IR: ``band30``, the first
30 % of the 960 partitions (``bench.py:298-299``), and ``perc30``, the
A-weighted ``conv.perceptual_mask`` at -30 dB over the 938 real partitions.

Phases, each printing one JSON object per line:
  1. device and environment (plus the raw nvidia-smi name/power-limit line)
  2. build the CUDA kernels from ``neojax_torch/csrc`` (nvcc, sm_90a)
  3. each kernel against its plain PyTorch version at the headline shapes,
     all four storages (B1 shared + per-channel filter, B2 at three ring
     positions, B3 over 64 blocks starting at P-5 so the ring wraps); then
     at the nested and hybrid shapes: B5 on both meta rings (all four
     storages, two ring positions), B3 with ``acc_add`` on the hybrid head
     (P = 64, split and int16, from 5 rows before the wrap) and B1 on the
     unfused head's K = 513 bins (P = 64, all four storages). B1 rows give
     the kernel's P splits, lanes a thread (``vec``), bound and share, and
     B1's and B4's ``ms`` is device time with the host's enqueue hidden
     behind a sleep kernel (``ms_back_to_back``: events around back-to-back
     calls, which the wrapper's host time bounds for short calls). B2 and B3 run
     as stage kernels (``kernels.fused_step.stage_wrappers``): each row of
     theirs also prints its device time by stage (``stages_us``, from the
     call's kernel timeline), and each stage kernel is held against its
     plain version on B3's window of 64 blocks and B2's block
     (``stage_vs_plain``; the schedule's width table in 3c)
 3c. the sparse kernels at the headline shapes, all four storages and both
     masks: B4 on the packed K = 512 ring (shared and per-channel filter,
     three positions) and on a non-packed K = 513 ring (split, int16), B2
     with the chunk schedule at three positions and B3 with it over 64
     blocks from P-5, each against its plain version and against the dense
     kernel on the same masked filter (B4 against B1: max abs difference
     0.0 required; B4 reads the schedule's ``tile_live`` table as the
     convolver passes it)
  4. the main path, UPOLS ``Convolver.process`` per storage, SNR against an
     f64 FFT-convolution oracle in steady state (blocks 1152-1167, 4
     channels), gated on the storage's class (split 90, int16 74, bf16 40
     dB; int8 is printed: the reference's per-block int8 sits below its
     46 dB class)
  5. the other entry points (split and int8): ``__call__`` on exact blocks
     (B2), the re-blocking FIFO + ``flush``, UPOLA ``process`` (B2 per
     block) and ``fused=False`` (B1), each against ``process``
 5b. the sparse main path, ``sparse_upols_convolver(sparsity=mask).process``
     over 1168 blocks per storage and mask, SNR against an f64 UPOLS oracle
     over the masked spectra, gated as phase 4; then its other entry points
     (split and int8, band30): ``__call__`` (B2 + schedule), ``fused=False``
     (B4, K = 512) and ``packed=False`` (B4, K = 513) against ``process``
  6. the nested main path, ``process_nested`` per storage over 1280
     blocks, and the hybrid main path, ``process_hybrid`` over 1216
     blocks, each with the SNR of phase 4 gated on the class of all four
     storages (split 90, int16 74, int8 46, bf16 40 dB)
  7. the hybrid's and nested's other entry points: ``HybridStream`` over
     1216 blocks (split, int8) against ``process_hybrid`` with the unfused
     and the fused head, and ``process_nested`` with its state carried
     across two calls against one call
  7c. the chunked engine's main path, ``process_chunked`` at S = 128 over
     1280 blocks, split and bf16, SNR-gated as phase 6 (split 90, bf16 40
     dB), with its warm µs a block, one traced call's device time by op
     (product, transforms, every ``cat``) and idle share, its product
     alone against the card's peak (``bench.headline.chunked_work``) and
     its window's shift-concat alone against the HBM rate; then
     the perc30 mask at bf16 (four buckets, the gather path) against the
     masked oracle of 5b. The product is ``torch.bmm`` (cuBLAS; the JAX
     package runs it outside any Pallas kernel), so this window expects no
     kernel of the port
  7d. ``make_engine`` over the four engines at split on one input (two
     calls, then ``reset`` and one call), their pairwise difference, and
     ``storage=None`` on the card resolving to ``"split"``
  7e. ``neojax_torch.convolve`` by all seven methods, 48 000 samples by a
     24 000-tap IR, with both TF32 flags on, against ``np.convolve`` in
     float64; and ``fft_convolve(backend="matmul")`` over 64 channels of
     4096 samples by a 4096-tap IR (transform size 8192, the backend's
     largest), whose DFT products TF32 would round, beside the same
     forward product with TF32 left on
  7f. the WAV-convolver CLI, ``neojax_torch.cli.main`` in-process, on a
     16-channel 20 s 48 kHz file (32-bit PCM) and a mono 10 s hall IR
     written at 44.1 kHz (resampled by the CLI to 938 partitions at block
     512): the five engines at block 512 (chunk 128, the hybrid 64) at
     their card storages, upols with ``--threshold-db -30``, and upols at
     the default block 4096; each called twice, the second reported (the
     CLI's real-time factor, launch counts, SNR of the output WAV against
     an f64 oracle, gated on the storage's class). In the first call each
     kernel wrapper the engines reach keeps a copy of the operands of its
     last call of each kind (B2/B3 with and without the chunk schedule or
     ``acc_add``); after it, the kernel and its plain version run on
     copies of those operands (``cli_kernel_vs_plain``: B1 at block 4096
     and on the hybrid's 16-channel head, B2, B3 and B3 ``sched`` at 16
     channels, B5 on the nested and hybrid-tail rings), gated as phase 3
  7g. ``examples/realtime_stream_torch.run``: ``HybridStream`` callbacks
     against the 10 667 µs deadline and ``io.StreamExecutor`` with odd
     pushes (2 channels, 10 s IR, block 512, S = 64, split), both within
     1e-4 of the offline ``process_hybrid``
  7h. the fft/core/ops surface on the card (dct2, dft, split and packed
     transforms against float64 with TF32 on; ``fft.four_step`` —
     ``fft_split_large`` at 2^14, 2^17 and 2^20, ``rfft_split_large`` /
     ``irfft_split_large`` at 2^17, the packed pair at 8192 and
     ``fft(backend="matmul")`` at 2^16, 8 rows each, within 1e-4 of the
     float64 FFT with TF32 on, each timed beside cuFFT; the fixed-point
     ops bit for bit against the CPU; ``debug.checked``) and a split
     ``Convolver.process`` checkpointed with ``io.save_state`` /
     ``load_state`` and continued
  7i. the distributed engines (``neojax_torch.dist``). D0, in this
     process, one rank on NCCL: ``sharded_process`` at 256 channels over
     1168 blocks (bit-equal to ``process``; B3 held against its plain
     version on the operands of such a call), an NCCL ``psum`` of a
     [2, 64, 513] card tensor and one ``weak_scaling_sweep`` point. D1, two
     gloo ranks of worker processes of this script (``--dist-worker``) on
     the one card (NCCL refuses two ranks on one GPU, so their collectives
     stage through host memory, counted), in two worlds. "cut": the
     ``PipelineConvolver`` (part = 2, four storages) and the
     ``BinShardedConvolver`` (bin = 2, split and int8; 257 lanes a shard)
     over 960 blocks at split and 640 quantized, SNR-gated on the last 16
     blocks and at split within TOL of ``process``, B1 held against its
     plain version on the ring each leaves; then ``StreamDriver`` streams
     (per-rank npz and DCP checkpoints every 2 chunks of 128 blocks) that
     rank 1 cuts with ``os._exit`` after chunk 2 (rank 0 ends its DCP
     stream there, its npz stream runs on). "resume": those streams
     resumed, bit-equal to an uninterrupted stream; ``sharded_process`` at
     256 channels (each rank bit-equal to ``process`` over its 128; split
     and int8, B3 held against its plain version on each call's
     operands); ``timesharded_process`` (time = 2, 1920 blocks) against
     one ``process`` call (split within CUT_TOL, int8 TOL; bit equality
     printed); ``PartShardedNested`` (part = 2, S = 128, split, bf16,
     int8) against ``process_nested``, SNR-gated, B5 on its meta ring
     against its plain version; the channel-sharded nested, hybrid and
     chunked engines against the single-card engine over each rank's
     channels, B5 and B3 ``acc_add`` held on their operands. The B1/B5
     rows carry times, bounds and the library call. Every rank zeroes
     the launch counters before each path, reads them after it and checks
     that its state lies on the card; every kernel a channel-sharded call
     launches must have been held against its plain version; a worker
     that fails or a world past 90 s fails the phase. ``--dist-only`` runs
     phases 1-2 and this one alone (no kernels line, no ok line).
  7j. the sweep tools (``neojax_torch.tools``): each tool's ``--smoke``
     grid in-process, its JSON line printed and its exit code required
     to be 0 — ``int8_sweep`` (int8 HIGH G = 64 on B5 and on plain ops,
     which the tool gates at 46 dB, G = 16 on B5, split HIGHEST, gated
     at 90 dB), ``bench_sparse_sweep`` (dense and a 30 %
     band, slope over 64 and 512 blocks), ``bench_perceptual`` (bf16 at
     -60 dB, 256 blocks), ``bench_quality_sweep`` (two thresholds),
     ``bench_grid`` (split, L = 2^17 at block 4096, 64 blocks) and
     ``bench_timesharded`` (64 blocks; world-1 ``timesharded_process``
     bit-equal to ``process``); each tool in a launch window of its own
     (summed into ``tools``), every kernel call it made held against its
     plain version after the window (B5 at G = 64 and 16, B3 dense and
     with a band and a perceptual schedule, B1 on the grid's ring [2, 32,
     64, 4096]; the window also counts ``bench_grid``'s own B1 check, one
     launch a row), then B1 on that ring timed twice for the ``bounds``
     line ``fdl_mac/grid4096``, with the card's clocks read around it. The tools' own times in this phase include
     the copies that keep each call's operands
  7b. probes: T1 (``probe_ring_read``, bf16 and split) at the
     [2, 960, 64, 512] ring, the non-packed [2, 960, 64, 513] one (one
     lane a thread) and the hybrid head's [2, 64, 64, 513] (one split),
     both outputs, each with its grid (which must be B1's on the same
     operands) and its time beside B1's on the same ring, and T2 (``probe_stream``, its
     three modes, f32 and bf16 matrices) over 64 blocks, each against its
     plain version; then the measurement path (the tools' own row
     functions, ``neojax_torch.tools.roofline_cal`` / ``fused_probe``, at
     64 and 256 iterations or blocks: T1, B1, T2, dense B3, B3 with an
     all-zero chunk schedule, B3 at P = 32) in its own launch window; a
     ``torch.profiler`` trace of one ``process`` call (``bench.profile``);
     and for every kernel its bytes and operations
     (``bench.headline``), its bound on the card (the larger of bytes over
     the HBM rate and operations over the f32 rate), its share of the
     bound, and the time of one PyTorch call computing the same function
     where there is one (``library_ms``); B1 also at the hybrid head's
     [2, 64, 64, 513] ring and B4 also at K = 513
  8. times: per-block ``process``, ``process_nested`` and
     ``process_hybrid`` per storage, kernel route against the plain torch
     route (``mac_backend="torch"``: cuFFT transforms + tensor-op MAC), and
     ``HybridStream``'s per-callback latency (chunk-boundary callbacks
     apart); sparse ``process`` per storage and mask beside the dense
     ``process`` on the unmasked filter and the plain torch route
  9. the kernels summary, then the final ``{"ok": true, ...}`` line

Launch counters are zeroed right before each main path (phases 4+5, 5b,
the nested and the hybrid halves of 6, 7, 7c, 7d, 7e, each reported CLI
call of 7f (summed into one window), 7g, 7h, each path of 7i (summed over
its ranks), each tool of 7j (summed into one window) and 7b's measurement
path) and read right after it; each kernel of that path must have launched in its
window (B2 and B3 with the chunk schedule counted apart, and each of their
stage kernels by its own count).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 48000
BLOCK = 512
CHANNELS = 64
P_REAL = int(np.ceil(10.0 * SR / BLOCK))  # 938 partitions: a 10 s IR
P = 960  # Convolver.filter's padding of 938
NB_MAIN = 1168  # blocks streamed on the per-block main path
S_NESTED, NB_NESTED = 128, 1280  # 10 chunks, covering the SNR window
S_HYBRID, NB_HYBRID = 64, 1216  # 19 chunks
S_CHUNKED, NB_CHUNKED = 128, 1280  # 10 chunks, covering the SNR window
S_ENGINES, NB_ENGINES = 64, 512  # make_engine: two calls of 256 blocks
SNR_START, SNR_BLOCKS, SNR_CH = 1152, 16, 4  # steady-state window (> P_REAL)
STORAGES = ("split", "bf16", "int16", "int8")
SNR_CLASS_DB = {"split": 90.0, "int16": 74.0, "bf16": 40.0}  # bench.py:319
# the nested and hybrid engines meet the int8 class too (bench.py:319)
ENGINE_SNR_CLASS_DB = SNR_CLASS_DB | {"int8": 46.0}
# max|kernel - plain| / max|plain| (tests/test_fused_step.py:43)
TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
# HybridStream against process_hybrid: unfused head, max abs difference
# (tests/test_hybrid.py:179); fused head, relative to the peak (:129)
STREAM_TOL = {"split": 1e-5, "int8": 1e-4}
FUSED_HEAD_TOL = {"split": 1e-5, "int16": 2e-3, "int8": 6e-2}
INT_MAX = {"int16": 32767, "int8": 127}
# make_engine's engines against each other at split, and convolve's
# methods against np.convolve: max|a - b| / max|b|
ENGINES_TOL = 1e-4
CONVOLVE_TOL = 2e-5
# the CLI phase: a 16-channel (third-order Ambisonics) 20 s file and a mono
# hall IR written at 44.1 kHz; runs as (engine, --block, --chunk-blocks,
# --threshold-db, the kernels the run must launch), a block of None being
# the CLI's default (4096, above B3's 1024: B1 block by block); at the
# card's bf16 the hybrid keeps its unfused head (B1), and chunked runs
# torch.bmm
CLI_CHANNELS, CLI_SECONDS, CLI_IR_SR = 16, 20, 44100
CLI_RUNS = (("upols", 512, 128, None, ("fused_stream",)),
            ("upola", 512, 128, None, ("fused_block_step",)),
            ("chunked", 512, 128, None, ()),
            ("nested", 512, 128, None, ("nested_mac",)),
            ("hybrid", 512, 64, None, ("fdl_mac", "nested_mac")),
            ("upols", 512, 128, -30.0, ("fused_stream_sched",)),
            ("upols", None, None, None, ("fdl_mac",)))
# the surface's transforms against float64: max|got - ref| / max|ref|
SURFACE_TOL = 1e-5
# fft.four_step against numpy's float64 FFT (tests/test_four_step.py's bound)
FOUR_STEP_TOL = 1e-4
FOUR_STEP_ROWS = 8
# a stream cut off B3's 64-block windows against one call, relative to the
# peak: it rounds apart by 9.98e-7 on the H100 at 94 blocks; 5x margin
CUT_TOL = 5e-6
DEVICE = "cuda"


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """The card's SM and memory clocks (MHz), temperature and power draw
    now, as ``nvidia-smi`` reads them: the state a timing was taken in."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def snr_db(out: np.ndarray, ref: np.ndarray) -> float:
    err = np.asarray(out, np.float64) - ref
    den = float(np.sum(err**2))
    return float("inf") if den == 0 else 10.0 * np.log10(float(np.sum(ref**2)) / den)


def mac_ptxas(log_path: str) -> list[dict]:
    """Registers and spill bytes of each instance of the partition MAC
    (``step_mac_kernel``, ``step_reduce_kernel``; in ``probes.cu`` T1's
    probe mode) and of B3's ``stream_mac_kernel`` in the nvcc log, by
    translation unit."""
    out, cur = [], None
    if not os.path.exists(log_path):
        return out
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                hit = re.search(r"((?:step_(?:mac|reduce)|stream_mac)_kernel\w*?)(?:EEEv|EEvP)", name)
                cur = None
                if hit:
                    unit = next((u for u in ("fdl_mac", "probes") if f"{u}_cu" in name), "fused_step")
                    cur = {"unit": f"{unit}.cu", "kernel": hit.group(1)}
                    out.append(cur)
            elif cur is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    cur["registers"] = int(m.group(1))
    return out


def rel_err(a, b) -> tuple[float, float]:
    """(max|a - b|, max|a - b| / max|b|) in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = float(np.abs(a - b).max())
    return d, d / max(1e-30, float(np.abs(b).max()))


def device_rel_err(a, b) -> tuple[float, float]:
    """``rel_err`` of two tensors on their own device (float64 there too):
    a ring of a few hundred million values takes seconds to copy to the
    host and scan there."""
    d = float((a.double() - b.double()).abs().max())
    return d, d / max(1e-30, float(b.double().abs().max()))


# the card kernels of the chunked engine's ops, by name (cuBLAS's product,
# cuFFT's transforms, and every cat: the window's shift-concat, the UPOLS
# frames' two cats a chunk, the output's stack once a call)
OP_CLASSES = (("product", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
              ("transforms", re.compile(r"fft", re.I)),
              ("cats", re.compile(r"CatArray")))


def kernel_breakdown(events: list[dict]) -> dict:
    """Device µs by op class (``OP_CLASSES``, the rest "other") of a Chrome
    trace's kernel events, the largest kernels, and the idle share of the
    span from the first kernel's start to the last one's end."""
    kern = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    by_op, by_name = {}, {}
    busy, end = 0.0, None
    for e in kern:
        t0, dur = float(e["ts"]), float(e["dur"])
        op = next((name for name, pat in OP_CLASSES if pat.search(e["name"])), "other")
        by_op[op] = by_op.get(op, 0.0) + dur
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + dur
        busy += max(0.0, t0 + dur - max(t0, end)) if end is not None else dur  # union of intervals
        end = t0 + dur if end is None else max(end, t0 + dur)
    span = (end - float(kern[0]["ts"])) if kern else 0.0
    return {"device_us_by_op": by_op, "device_us": sum(by_op.values()), "busy_us": busy, "span_us": span,
            "idle_share": (1.0 - busy / span) if span > 0 else None,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:5], "kernels": len(kern)}


def trace_events(fn) -> list[dict]:
    """The Chrome-trace events of one call of fn (``bench.profile.trace``)."""
    import torch
    from neojax_torch.bench import profile as bench_profile

    with tempfile.TemporaryDirectory() as tmp:
        with bench_profile.trace(tmp):
            fn()
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            return json.load(f)["traceEvents"]


def snr_window(a, start: int) -> np.ndarray:
    """The steady-state SNR window: SNR_BLOCKS blocks of SNR_CH channels."""
    return np.asarray(a[:SNR_CH, start * BLOCK : (start + SNR_BLOCKS) * BLOCK], np.float64)


def stream_mac_toeplitz(ring, x, rim, pos_first):
    """The operands of ``stream_mac``'s yardstick (split storage, Cf = 1):
    for each lane k, T_k [wc, P - 1 + wc], the filter value block i meets at
    history row q (d = q - P + 1; the rim row it reads, untiled rim
    included; zero outside its P taps), and H_k [P - 1 + wc, C], the ring's
    rows as they stood and then the window's, complex64. (T_k H_k)[i, c] is
    the kernel's acc[i, c, k] before the seed, lane 0 and rounding."""
    import torch

    _, p, c, b = ring.shape
    wc = x.shape[0]
    dev = ring.device
    old = torch.tensor([(pos_first + d) % p for d in range(-(p - 1), 0)], dtype=torch.long, device=dev)
    hist = torch.cat([ring[:, old].transpose(0, 1), x])  # [P - 1 + wc, 2, C, B]
    h = torch.complex(hist[:, 0], hist[:, 1]).permute(2, 0, 1).contiguous()
    del hist
    i = torch.arange(wc, device=dev)[:, None]
    a = i - (torch.arange(p - 1 + wc, device=dev)[None, :] - (p - 1))  # the tap, [wc, P - 1 + wc]
    row = torch.where(a <= (pos_first + i) % p, p - 1 - a, 2 * p - 1 - a).clamp(0, 2 * p - 1)
    f = rim[row, 0]  # [wc, P - 1 + wc, 2B]
    t = torch.complex(f[..., :b], f[..., b:]) * ((a >= 0) & (a < p))[..., None]
    del f
    return t.permute(2, 0, 1).contiguous(), h


def run_ring_read(dev, card, rng, cuda_ms, device_ms, bound_of) -> dict:
    """7b, T1 on B1's grid: the headline ring [2, P, C, B], the non-packed
    one (K = B + 1, one lane a thread) and the hybrid head's (P = S_HYBRID,
    one split), split and bf16. Each row holds both outputs against the
    plain version at TOL, asserts that T1's grid is B1's on the same
    operands, and times T1 beside B1 on the same ring and filter plane (the
    ratio is printed, not gated). Keys: the storage for the headline rows,
    ``<storage>/<shape>`` for the others."""
    import torch
    from neojax_torch.bench import headline
    from neojax_torch.conv import convolver as cv
    from neojax_torch.kernels import fdl_mac as mac_mod
    from neojax_torch.kernels import probes as pr_mod

    c, b = CHANNELS, BLOCK
    out = {}
    for shape, p_t, k_t in (("headline", P, b), ("k513", P, b + 1), ("head", S_HYBRID, b + 1)):
        for storage in ("split", "bf16"):
            sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
            ring = torch.from_numpy((10 * rng.standard_normal((2, p_t, c, k_t))).astype(np.float32)).to(dev, sdt)
            tiled = torch.from_numpy((0.05 * rng.standard_normal((2 * p_t, k_t))).astype(np.float32)).to(dev)
            fr = tiled[p_t - 8 : 2 * p_t - 8]  # the rotated filter of ring position 7
            fr1 = fr[:, None]
            _, pc = mac_mod.choose_chunks(sdt, p_t, c, k_t)
            geo = pr_mod.ring_read_geometry(ring, fr)
            assert geo == mac_mod.mac_geometry(ring, fr1, fr1), f"T1 {geo} is not B1's grid"
            got = pr_mod.probe_ring_read(ring, fr, pc)
            want = pr_mod.probe_ring_read_reference(ring, fr, pc)
            torch.cuda.synchronize()
            errs = [rel_err(g.cpu(), w.cpu()) for g, w in zip(got, want)]
            for (_, r), out_name in zip(errs, ("out0", "out1")):
                assert r < TOL[storage], f"probe_ring_read {storage} {shape} {out_name}: rel err {r}"
            row = {"max_abs_err": max(e[0] for e in errs), "rel_err": max(e[1] for e in errs), "p_chunk": pc,
                   "splits": geo[0], "per": geo[1], "vec": geo[2],
                   "ms": cuda_ms(lambda: pr_mod.probe_ring_read(ring, fr, pc), 20),
                   "device_ms": device_ms(lambda: pr_mod.probe_ring_read(ring, fr, pc), 20),
                   "plain_ms": cuda_ms(lambda: pr_mod.probe_ring_read_reference(ring, fr, pc), 3),
                   "fdl_mac_ms_same_shape": cuda_ms(lambda: mac_mod.fdl_mac(ring, fr1, fr1), 20),
                   "fdl_mac_device_ms_same_shape": device_ms(lambda: mac_mod.fdl_mac(ring, fr1, fr1), 20)}
            row.update(vs_fdl_mac=row["ms"] / row["fdl_mac_ms_same_shape"],
                       device_vs_fdl_mac=row["device_ms"] / row["fdl_mac_device_ms_same_shape"],
                       **bound_of(headline.ring_read_work(storage, p_t, c, k_t, pc), row["ms"]))
            out[storage if shape == "headline" else f"{storage}/{shape}"] = row
            emit(phase="probes", kernel="probe_ring_read", storage=storage, shape=shape, ring=list(ring.shape),
                 tol=TOL[storage], **row, **card)
            del ring, tiled, fr, fr1, got, want
        torch.cuda.empty_cache()
    return out


def run_chunked(dev, card, parts, sig2, oracle2, sig, masked_oracle, mask_perc30, cuda_ms, peaks) -> dict:
    """7c. The chunked engine's main path at the headline (``process_chunked``
    over NB_CHUNKED blocks at S_CHUNKED, split and bf16, SNR-gated against
    the f64 oracle), its warm µs a block, one traced call's device time by
    op and idle share (the profiler's host cost included), its product
    alone against the card's peak (``headline.chunked_work``) and its
    window's shift-concat alone (``chunked._shift_window``, reading and
    writing the window once) against the HBM rate; then the
    perc30 mask at bf16 (4 buckets, the gather path) against the masked
    oracle, with its own trace."""
    import torch
    from neojax_torch import conv
    from neojax_torch.bench import headline
    from neojax_torch.conv import chunked as ch
    from neojax_torch.fft import matmul_backend as mb

    peak_b, peak_f32, peak_bf16 = peaks
    x = sig2[:, : NB_CHUNKED * BLOCK]
    out_summary = {}
    for storage in ("split", "bf16"):
        cfg = conv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
        t0 = time.perf_counter()
        params = conv.chunked_filter_params(cfg, parts, S_CHUNKED, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        (bucket,) = params["buckets"]
        kb, m2 = bucket["tcat"].shape[0], bucket["tcat"].shape[2]
        assert (kb, bucket["tcat"].shape[1], m2) == (BLOCK + 1, 2 * S_CHUNKED, 2 * (P_REAL + S_CHUNKED - 1))
        state = conv.chunked_init_state(cfg, params)
        t0 = time.perf_counter()
        state, out = conv.process_chunked(cfg, params, state, x, S_CHUNKED)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        assert tuple(out.shape) == (CHANNELS, NB_CHUNKED * BLOCK) and bool(torch.isfinite(out).all())
        snr = snr_db(snr_window(out.cpu().numpy(), SNR_START), snr_window(oracle2, SNR_START))
        cls = ENGINE_SNR_CLASS_DB[storage]
        st = conv.chunked_init_state(cfg, params)
        ms = cuda_ms(lambda: conv.process_chunked(cfg, params, st, x, S_CHUNKED), 3)
        trace = kernel_breakdown(trace_events(lambda: conv.process_chunked(cfg, params, st, x, S_CHUNKED)))
        # the product alone, on this run's window operand
        hw = state["hists"][0]
        prod_ms = cuda_ms(lambda: ch._bucket_product(bucket["tcat"], hw), 10)
        # the window's shift-concat alone, on this run's window and on new
        # spectra in the path's own K-major view of the first chunk's frames
        frames = x[:, : S_CHUNKED * BLOCK].reshape(CHANNELS, S_CHUNKED, BLOCK).transpose(0, 1)
        sre, sim = mb.rfft_split(torch.cat([frames, frames], dim=-1), 2 * BLOCK)
        nre, nim = (v.permute(2, 0, 1).to(hw.dtype) for v in (sre, sim))
        nxt = torch.empty_like(hw)
        shift_ms = cuda_ms(lambda: ch._shift_window(hw, nre, nim, nxt), 10)
        shift_bytes = 2 * hw.numel() * hw.element_size()
        chunks = NB_CHUNKED // S_CHUNKED
        shift = {"ms_per_chunk": shift_ms, "bytes": shift_bytes, "bytes_per_s": shift_bytes / (shift_ms * 1e-3),
                 "ms_per_call": chunks * shift_ms, "share_of_call": chunks * shift_ms / ms}
        if peak_b:
            shift["share_of_bytes_peak"] = shift["bytes_per_s"] / peak_b
        work = headline.chunked_work(storage, kb, S_CHUNKED, m2 // 2, CHANNELS)
        peak_f = peak_bf16 if storage == "bf16" else peak_f32
        prod = {"ms": prod_ms, "flops": work.flops, "bytes": work.bytes,
                "flops_per_s": work.flops / (prod_ms * 1e-3), "bytes_per_s": work.bytes / (prod_ms * 1e-3)}
        if peak_b and peak_f:
            t_b, by = headline.bound(work, peak_b, peak_f)
            prod.update(peak_flops_per_s=peak_f, share_of_flops_peak=prod["flops_per_s"] / peak_f,
                        share_of_bytes_peak=prod["bytes_per_s"] / peak_b, bound_ms=1e3 * t_b, bound_by=by,
                        share_of_bound=1e3 * t_b / prod_ms)
        row = {"snr_db_vs_f64": snr, "snr_class_db": cls, "us_per_block": 1e3 * ms / NB_CHUNKED,
               "samples_per_s": CHANNELS * NB_CHUNKED * BLOCK / (ms * 1e-3), "build_s": build_s,
               "first_call_s": first_s, "tcat": list(bucket["tcat"].shape),
               "tcat_gbytes": bucket["tcat"].numel() * bucket["tcat"].element_size() / 1e9,
               "product": prod, "shift_concat": shift, "trace": trace, "chunks_per_call": chunks}
        out_summary[storage] = row
        emit(phase="main_path", entry="process_chunked", storage=storage, chunk_blocks=S_CHUNKED,
             channels=CHANNELS, partitions=P_REAL, block=BLOCK, blocks=NB_CHUNKED, **row, **card)
        assert snr >= cls, f"chunked {storage}: SNR {snr:.1f} dB below its {cls} dB class"
        del params, state, st, out, bucket, hw, nxt
        torch.cuda.empty_cache()

    # perc30 at bf16: the bucketed (gather/scatter) route, on phase 4's signal
    cfg = conv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage="bf16")
    params = conv.chunked_filter_params(cfg, parts, S_CHUNKED, mask=mask_perc30[:P_REAL], device=dev)
    assert len(params["buckets"]) == 4, len(params["buckets"])
    state, out = conv.process_chunked(cfg, params, conv.chunked_init_state(cfg, params), sig, S_CHUNKED)
    torch.cuda.synchronize()
    assert tuple(out.shape) == tuple(sig.shape) and bool(torch.isfinite(out).all())
    snr = snr_db(snr_window(out.cpu().numpy(), SNR_START), masked_oracle(mask_perc30))
    st = conv.chunked_init_state(cfg, params)
    ms = cuda_ms(lambda: conv.process_chunked(cfg, params, st, sig, S_CHUNKED), 3)
    nb = -(-sig.shape[1] // (S_CHUNKED * BLOCK)) * S_CHUNKED
    row = {"snr_db_vs_masked_f64": snr, "snr_class_db": ENGINE_SNR_CLASS_DB["bf16"],
           "us_per_block": 1e3 * ms / nb, "buckets": [[int(b["bins"].shape[0]), b["band"]] for b in params["buckets"]],
           "tcat_gbytes": sum(b["tcat"].numel() * 2 for b in params["buckets"]) / 1e9,
           "trace": kernel_breakdown(trace_events(lambda: conv.process_chunked(cfg, params, st, sig, S_CHUNKED)))}
    out_summary["bf16/perc30"] = row
    emit(phase="main_path", entry="process_chunked", storage="bf16", mask="perc30", chunk_blocks=S_CHUNKED,
         channels=CHANNELS, partitions=P_REAL, block=BLOCK, blocks=sig.shape[1] // BLOCK, **row, **card)
    assert snr >= ENGINE_SNR_CLASS_DB["bf16"], f"chunked bf16 perc30: SNR {snr:.1f} dB below its class"
    del params, state, st, out
    torch.cuda.empty_cache()
    return out_summary


def run_engines(dev, card, parts, sig2) -> dict:
    """7d. ``make_engine``'s four engines at split on one input (the
    headline IR and channels, two calls of NB_ENGINES / 2 blocks at
    S_ENGINES), pairwise max difference relative to the peak (gated at
    ENGINES_TOL), ``reset`` then one call against the two, ``latency``,
    and ``storage=None`` resolving to ``"split"`` on the card."""
    import torch
    from neojax_torch import conv

    half = NB_ENGINES // 2 * BLOCK
    x = sig2[:, : 2 * half]
    outs, rows = {}, {}
    for engine in ("perblock", "nested", "hybrid", "chunked"):
        eng = conv.make_engine(engine, parts, storage="split", channels=CHANNELS, device=dev,
                               chunk_blocks=None if engine == "perblock" else S_ENGINES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        two = torch.cat([eng.process(x[:, :half]), eng.process(x[:, half:])], dim=-1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        eng.reset()
        one = eng.process(x)
        assert tuple(two.shape) == tuple(x.shape) and bool(torch.isfinite(two).all())
        assert eng.latency == 0
        rows[engine] = {"two_calls_s": dt, "reset_then_one_call_rel_diff": rel_err(one.cpu(), two.cpu())[1],
                        "chunk_blocks": eng.chunk_blocks, "partitions": eng.config.num_partitions}
        outs[engine] = two.cpu()
        del eng, one, two
        torch.cuda.empty_cache()
    pairs = {f"{a}/{b}": rel_err(outs[a], outs[b])[1]
             for i, a in enumerate(outs) for b in list(outs)[i + 1 :]}
    default = conv.make_engine("perblock", parts, device=dev).config.storage
    emit(phase="entry_point", entry="make_engine", storage="split", channels=CHANNELS, partitions=P_REAL,
         blocks=2 * half // BLOCK, calls=2, engines=rows, pairwise_rel_diff=pairs, tol=ENGINES_TOL,
         storage_none_on_card=default, **card)
    want = "split" if torch.device(dev).type == "cuda" else "dense"  # the convolver's rule
    assert default == want, f"make_engine storage=None on {dev} resolved to {default!r}"
    for key, r in pairs.items():
        assert r < ENGINES_TOL, f"make_engine {key}: rel diff {r}"
    for engine, row in rows.items():
        assert row["reset_then_one_call_rel_diff"] < ENGINES_TOL, f"{engine}: reset then one call differs"
    return {"engines": rows, "pairwise_rel_diff": pairs}


def run_convolve(dev, card, cuda_ms) -> dict:
    """7e. ``neojax_torch.convolve`` by all seven methods on the card, a
    48 000-sample signal and a 24 000-tap IR, both TF32 flags set on first
    (the products must stay IEEE float32), each against ``np.convolve`` in
    float64 (max error relative to the peak, gated at CONVOLVE_TOL). Then
    ``fft_convolve(backend="matmul")`` on 64 channels of 4096 samples by
    a 4096-tap IR: its DFT products are GEMMs, which TF32 would round, so
    this row's gate fails if ``ieee_float32`` does not hold; beside it the
    same forward product with TF32 left on (reported, not gated)."""
    import torch
    import torch.nn.functional as F
    import neojax_torch
    from neojax_torch import conv
    from neojax_torch.fft import matmul_backend as mb

    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, 48000).astype(np.float32)
    h = (rng.uniform(-1, 1, 24000) * np.exp(-np.arange(24000) / 4800.0)).astype(np.float32)
    ref = np.convolve(a.astype(np.float64), h.astype(np.float64))
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    rows = {}
    try:
        flags = {"allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
                 "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32}
        a_dev, h_dev = torch.from_numpy(a).to(dev), torch.from_numpy(h).to(dev)
        for method in ("auto", "direct", "fft", "ols", "ola", "upols", "upola"):
            out = neojax_torch.convolve(a_dev, h_dev, method=method, device=dev)
            torch.cuda.synchronize()
            assert out.device.type == torch.device(dev).type and tuple(out.shape) == ref.shape
            d, r = rel_err(out.cpu(), ref)
            rows[method] = {"max_abs_err": d, "rel_err": r,
                            "ms": cuda_ms(lambda: neojax_torch.convolve(a_dev, h_dev, method=method, device=dev), 3)}
        n2 = 4096
        a2 = rng.uniform(-1, 1, (CHANNELS, n2))
        h2 = h[:n2].astype(np.float64)
        spec_want = np.fft.rfft(a2, 2 * n2)
        ref2 = np.fft.irfft(spec_want * np.fft.rfft(h2, 2 * n2), 2 * n2)[:, : 2 * n2 - 1]
        a2_dev = torch.from_numpy(a2.astype(np.float32)).to(dev)
        h2_dev = torch.from_numpy(h2.astype(np.float32)).to(dev)
        out = conv.fft_convolve(a2_dev, h2_dev, backend="matmul")
        torch.cuda.synchronize()
        assert tuple(out.shape) == ref2.shape
        d, r = rel_err(out.cpu(), ref2)
        x2 = F.pad(a2_dev, (0, n2))
        cm, sm = mb.rfft_matrices(2 * n2, dev)
        want = np.stack([spec_want.real, spec_want.imag])
        rows["fft/matmul"] = {
            "max_abs_err": d, "rel_err": r, "channels": CHANNELS, "signal": n2, "ir": n2,
            "ms": cuda_ms(lambda: conv.fft_convolve(a2_dev, h2_dev, backend="matmul"), 3),
            "forward_rel_err_ieee": rel_err(torch.stack([mb._product(x2, cm), mb._product(x2, sm)]).cpu(), want)[1],
            "forward_rel_err_tf32": rel_err(torch.stack([x2 @ cm, x2 @ sm]).cpu(), want)[1]}
        flags_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    emit(phase="entry_point", entry="convolve", signal=a.size, ir=h.size, tf32_flags=flags, methods=rows,
         tol=CONVOLVE_TOL, **card)
    assert flags_after == (True, True), "the caller's TF32 flags were not restored"
    for method, row in rows.items():
        assert row["rel_err"] < CONVOLVE_TOL, f"convolve {method}: rel err {row['rel_err']}"
    return rows


def masked_upols_oracle(x64: np.ndarray, h: np.ndarray, block: int, start: int, blocks: int) -> np.ndarray:
    """UPOLS over the spectra h [P, K] in float64, output blocks
    [start, start + blocks) of every row of x64 [C, T]:
    out_i = irfft(sum_p X_{i-p} H_p)[B:], X_j = rfft([block j-1 | block j])."""
    p = h.shape[0]
    j0 = start - p + 1
    x = np.concatenate([np.zeros((x64.shape[0], block)), x64], axis=1)
    frames = np.stack([x[:, j * block : (j + 2) * block] for j in range(j0, start + blocks)], 1)
    spec = np.fft.rfft(frames, 2 * block)
    outs = [np.fft.irfft(np.einsum("cpk,pk->ck", spec[:, i - j0 - np.arange(p)], h), 2 * block)[:, block:]
            for i in range(start, start + blocks)]
    return np.concatenate(outs, axis=1)


# the kernel wrappers the CLI's engines call, by the module that binds each
# name; B2/B3 apart by the chunk schedule and the seed they were given
CLI_KERNEL_SITES = (("convolver", ("fdl_mac", "sparse_fdl_mac", "fused_block_step", "fused_stream")),
                    ("hybrid", ("fdl_mac", "fused_stream")),
                    ("nested", ("nested_mac",)))


def _clone(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.clone()
    return tuple(_clone(x) for x in v) if isinstance(v, tuple) else v


@contextlib.contextmanager
def last_kernel_calls(calls: dict):
    """Within the block, each wrapper of ``CLI_KERNEL_SITES`` keeps a copy
    of the operands of its last call of each kind, before the kernel writes
    its ring: ``calls["fused_stream/sched"] = (wrapper, arguments, calls
    seen)``."""
    import importlib
    import inspect

    def spy(fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            named = sig.bind(*args, **kwargs).arguments
            kind = "/".join([fn.__name__] + [k for k in ("sched", "acc_add") if named.get(k) is not None])
            if fn.__name__ == "nested_mac" and named.get("scales") is not None:  # B5 by its group count
                kind += f"/G{named['scales'].shape[-1]}"
            seen = calls[kind][2] if kind in calls else 0
            calls[kind] = (fn, {k: _clone(v) for k, v in named.items()}, seen + 1)
            return fn(*args, **kwargs)

        return call

    saved = []
    for mod_name, names in CLI_KERNEL_SITES:
        mod = importlib.import_module(f"neojax_torch.conv.{mod_name}")
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, spy(getattr(mod, name)))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def exact_ring(plain, x, ring, rim, pos, dcfix, cs, inv, scales=None, **kw):
    """The ring (and scales) a fused kernel's are held against, or None.
    With bf16 matrices the transform kernels compute the f32 DFT of the
    bf16-rounded frames, whose twiddles are more exact than the bf16 matrix
    (ROADMAP §C), so the ring and its scales (the spectrum's peak) go
    against the plain version ``plain`` (B2's or B3's) rerun on copies with
    those rounded frames and the f32 forward matrix; the output stays held
    against the plain run as it is. None with f32 matrices: the plain run's
    own ring is the reference."""
    import torch
    from neojax_torch.fft import matmul_backend as mb

    if cs.dtype != torch.bfloat16:
        return None
    mats = mb.packed_mats if cs.ndim == 3 else mb.packed_stream_mats
    r, s = ring.clone(), None if scales is None else scales.clone()
    plain(x.to(torch.bfloat16).float(), r, rim, pos, dcfix, mats(cs.shape[1], torch.float32, cs.device)[0],
          inv, s, **kw)
    return r, s


def kernel_vs_plain_on(fn, named: dict) -> dict:
    """A kernel wrapper and its plain version on copies of one call's
    operands: max|kernel - plain| / max|plain| of the output at the ring's
    storage tolerance (phase 3's), and for B2/B3 the ring each writes."""
    import inspect

    import torch
    from neojax_torch.conv import fdl as fdl_lib
    from neojax_torch.kernels import fdl_mac, fused_step, nested_mac, sparse_mac

    plain = {"fdl_mac": fdl_mac.fdl_mac_reference, "sparse_fdl_mac": sparse_mac.sparse_fdl_mac_reference,
             "fused_block_step": fused_step.fused_block_step_reference,
             "fused_stream": fused_step.fused_stream_reference,
             "nested_mac": nested_mac.nested_mac_reference}[fn.__name__]
    ring = named.get("fdl", named.get("planes"))
    storage = next(k for k, v in fdl_lib.STORAGE_DTYPES.items() if v == ring.dtype)
    k_args = {k: _clone(v) for k, v in named.items()}
    params = inspect.signature(plain).parameters
    p_args = {k: _clone(v) for k, v in named.items() if k in params}
    got, want = fn(**k_args), plain(**p_args)
    torch.cuda.synchronize()
    writes = fn.__name__.startswith("fused_")  # (out, ring[, scales]); the MACs give (re, im)
    k_out, p_out = (got[0], want[0]) if writes else (torch.cat(got[:2]), torch.cat(want[:2]))
    d, r = device_rel_err(k_out, p_out)
    row = {"storage": storage, "ring": list(ring.shape), "max_abs_err": d, "rel_err": r, "tol": TOL[storage]}
    assert r < TOL[storage], f"{fn.__name__} at the CLI's operands ({storage}): rel err {r}"
    if writes:
        k_ring, p_ring, p_scl = k_args["fdl"], p_args["fdl"], p_args.get("scales")
        o = {k: _clone(v) for k, v in named.items() if k in params}
        x, pos, dcfix, inv = (o.pop(k) for k in (("frame", "pos", "dcfix", "ab") if "frame" in o
                                                  else ("sigpad", "pos0", "dcfix_all", "abt")))
        exact = exact_ring(plain, x, o.pop("fdl"), o.pop("filt_rim"), pos, dcfix, o.pop("cs"), inv, **o)
        if exact is not None:
            p_ring, p_scl = exact
        if storage in INT_MAX:  # rint ties may flip by 1 LSB
            row["ring_lsb"] = int((k_ring.to(torch.int32) - p_ring.to(torch.int32)).abs().max())
            row["scales_rel_err"] = device_rel_err(k_args["scales"], p_scl)[1]
            assert row["ring_lsb"] <= 1 and row["scales_rel_err"] < 1e-5, row
        else:
            row["ring_rel_err"] = device_rel_err(k_ring, p_ring)[1]
            assert row["ring_rel_err"] < TOL[storage], row
    return row


def unheld_kernels(counts: dict, held) -> list:
    """The launch counters of ``counts`` that went up for a wrapper of
    ``CLI_KERNEL_SITES`` with no call of that kind in ``held`` (kinds as
    ``last_kernel_calls`` names them) held against its plain version."""
    missing = []
    for name, v in counts.items():
        wrapper = name.removesuffix("_sched")
        if v and any(wrapper in names for _, names in CLI_KERNEL_SITES):
            if not any(k.split("/")[0] == wrapper and (name == wrapper or "sched" in k) for k in held):
                missing.append(name)
    return missing


def run_cli(dev, card) -> dict:
    """7f. The WAV-convolver CLI (``neojax_torch.cli.main``) in-process on a
    user's file: CLI_CHANNELS channels of CLI_SECONDS s at 48 kHz (32-bit
    PCM, amplitude 0.25) and a mono 10 s decaying-noise IR written at
    44.1 kHz, so the CLI resamples it (480 000 samples: 938 partitions at
    block 512). Seven runs (``CLI_RUNS``), each called twice and the second
    reported: the CLI's own timed region as it prints it (to the ms; all
    of ``main`` timed from outside beside it), real-time factor and M
    samples/s, the launch
    counts of that call, and the SNR of the 32-bit output WAV against
    ``scipy.signal.fftconvolve`` of the signal as read back with the port's
    resampled, normalized IR (the masked run: against the UPOLS oracle over
    the masked spectra on phase 5b's window), gated on the storage's
    class. The first call of each run keeps its kernels' operands
    (``last_kernel_calls``); each kernel is held against its plain version
    on them before the second, and every kernel the second launches must
    have been so held. Returns the rows and the summed launch counts."""
    import io as pyio

    import scipy.signal
    import torch
    from neojax_torch import cli, conv, kernels
    from neojax_torch.conv.sparse import perceptual_mask
    from neojax_torch.io.resample import resample
    from neojax_torch.io.wav import read_wav, write_wav

    rng = np.random.default_rng(8)
    frames = CLI_SECONDS * SR
    n_ir = 10 * CLI_IR_SR
    rows, total = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        sig_path, ir_path = os.path.join(tmp, "signal.wav"), os.path.join(tmp, "hall.wav")
        write_wav(sig_path, rng.uniform(-0.25, 0.25, (CLI_CHANNELS, frames)).astype(np.float32), SR, bits=32)
        hall = 0.1 * rng.standard_normal(n_ir) * np.exp(-np.arange(n_ir) / (n_ir / 4.0))
        write_wav(ir_path, hall.astype(np.float32), CLI_IR_SR, bits=32)
        x64 = read_wav(sig_path)[0].astype(np.float64)
        ir_read, ir_sr = read_wav(ir_path)
        h = conv.normalize_impulse(resample(ir_read, ir_sr, SR)).numpy()  # the CLI's filter prep
        assert h.shape == (1, 10 * SR), h.shape
        oracle = scipy.signal.fftconvolve(x64, h.astype(np.float64), axes=-1)[:, :frames]
        parts512 = conv.uniform_partition(h, BLOCK)
        mask = perceptual_mask(parts512, float(SR), -30.0)
        h_masked = parts512[0].astype(np.complex128) * mask[0]
        masked_oracle = masked_upols_oracle(x64[:SNR_CH], h_masked, BLOCK, SNR_START, SNR_BLOCKS)

        for engine, block, chunk, threshold, expect in CLI_RUNS:
            out_path = os.path.join(tmp, f"out_{engine}.wav")
            argv = [sig_path, ir_path, out_path, "--engine", engine, "--bits", "32", "--device", DEVICE]
            if block is not None:
                argv += ["--block", str(block), "--chunk-blocks", str(chunk)]
            if threshold is not None:
                argv += ["--threshold-db", str(threshold)]
            calls, checked = {}, {}
            for call in range(2):  # the first call builds, warms and keeps its kernels' operands
                if call:
                    for kind, (fn, named, seen) in calls.items():
                        checked[kind] = {"calls_seen": seen, **kernel_vs_plain_on(fn, named)}
                        emit(phase="cli_kernel_vs_plain", engine=engine, block=block or 4096,
                             threshold_db=threshold, kernel=kind, **checked[kind], **card)
                    calls.clear()
                    torch.cuda.synchronize()
                    kernels.reset_launch_counts()
                log = pyio.StringIO()
                t0 = time.perf_counter()
                with (contextlib.nullcontext() if call else last_kernel_calls(calls)), \
                        contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
                    rc = cli.main(argv)
                wall = time.perf_counter() - t0
                assert rc == 0, f"cli {engine}: exit code {rc}\n{log.getvalue()}"
            counts = kernels.launch_counts()
            for name, v in counts.items():
                total[name] = total.get(name, 0) + v
            text = log.getvalue()
            m = re.search(r"processed ([\d.]+) s in ([\d.]+) s -> real-time factor ([\d.]+)x \(([\d.]+) M samples/s\)",
                          text)
            assert m and f"impulse resampled {CLI_IR_SR} Hz -> {SR} Hz" in text, text
            out, out_sr = read_wav(out_path)
            assert out_sr == SR and out.shape == (CLI_CHANNELS, frames) and np.isfinite(out).all()
            renorm = "normalized output peak" in text
            storage = "bf16" if engine in ("chunked", "nested", "hybrid") else "split"  # the CLI's card defaults
            if threshold is None:
                ref = oracle / np.abs(oracle).max() if renorm else oracle
                snr = snr_db(out, ref)
            else:
                snr = snr_db(snr_window(out, SNR_START), masked_oracle)
            dt = float(m.group(2))
            row = {"engine": engine, "storage": storage, "block": block or 4096,
                   "chunk_blocks": chunk if engine in ("chunked", "nested", "hybrid") else None,
                   "threshold_db": threshold, "timed_s": dt, "realtime_factor": frames / SR / dt,
                   "msamples_per_s": CLI_CHANNELS * frames / dt / 1e6, "main_wall_s": wall, "peak_renormalized": renorm, "snr_db": snr,
                   "snr_against": "masked f64 UPOLS oracle (phase 5b window)" if threshold is not None
                   else "scipy.signal.fftconvolve f64, whole output",
                   "snr_class_db": SNR_CLASS_DB[storage],
                   "launches": {k: v for k, v in counts.items() if v},
                   "kernels_vs_plain": sorted(checked)}
            rows.append(row)
            emit(phase="cli", channels=CLI_CHANNELS, frames=frames, ir_frames_44k1=n_ir, **row, **card)
            for name in expect:
                assert counts[name] > 0, f"cli {engine} block {row['block']}: {name} was not launched"
            missing = unheld_kernels(counts, checked)  # every kernel the run launched, held at its operands
            assert not missing, f"cli {engine} block {row['block']}: {missing} launched but not held against " \
                                "its plain version"
        for row in rows:
            assert row["snr_db"] >= row["snr_class_db"], \
                f"cli {row['engine']} block {row['block']}: SNR {row['snr_db']:.1f} dB below its class"
    return {"runs": rows, "launches": total}


def run_executor(dev, card) -> dict:
    """7g. ``examples/realtime_stream_torch.run``: ``HybridStream`` callbacks
    (2 channels, 10 s IR, block 512, S = 64, split, about 5 s) against the
    10 667 µs deadline, and the same engine behind ``io.StreamExecutor``
    with odd-sized pushes; both gated at 1e-4 against the offline
    ``process_hybrid``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import realtime_stream_torch

    with tempfile.TemporaryDirectory() as tmp:
        res = realtime_stream_torch.run(channels=2, seconds=5.0, ir_seconds=10.0, block=BLOCK, sr=SR,
                                        chunk_blocks=64, out=os.path.join(tmp, "demo.json"), device=dev)
    cb, ex = res["callback_path"], res["executor_path"]
    emit(phase="executor", config=res["config"], callback=cb, executor=ex, **card)
    assert cb["max_abs_err_vs_offline"] < 1e-4, f"HybridStream callbacks vs offline: {cb['max_abs_err_vs_offline']}"
    assert ex["matches_offline_1e-4"], f"StreamExecutor vs offline: {ex}"
    return res


def run_surface(dev, card) -> dict:
    """7h. The fft/core/ops surface on the card: ``dct2`` at 64 and 4096,
    ``dft`` at 17, 100 and 4099, ``split_fft``/``packed_rfft``/
    ``packed_irfft`` at 1024, each against numpy/scipy in float64 within
    SURFACE_TOL x max|ref| with both TF32 flags on; the fixed-point ops bit
    for bit against the CPU; ``debug.checked`` raising on a card op that
    makes a NaN; and a split ``Convolver.process`` checkpointed after 94
    blocks (about 1 s) and after 128 (a boundary of B3's 64-block
    windows), saved, loaded and continued, against the same two calls
    without the file (bit for bit) and against one uninterrupted call: bit
    for bit at 128 blocks; at 94, where B3's windows fall on other blocks,
    printed and gated at ``CUT_TOL`` of the peak."""
    import scipy.fft
    import torch
    from neojax_torch import conv
    from neojax_torch import fft as tfft
    from neojax_torch import io as tio
    from neojax_torch.core import fixed_point as fp
    from neojax_torch.ops import debug

    rng = np.random.default_rng(9)
    rows = {}

    def check(name, got, ref):
        got = np.asarray(got, np.complex128 if np.iscomplexobj(ref) else np.float64)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        rows[name] = {"rel_err": err, "tol": SURFACE_TOL}

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for n in (64, 4096):
            x = rng.standard_normal((4, n))
            got = tfft.dct2(torch.from_numpy(x.astype(np.float32)).to(dev))
            check(f"dct2/{n}", got.cpu().numpy(), scipy.fft.dct(x, type=2))
        for n in (17, 100, 4099):
            x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
            got = tfft.dft(torch.from_numpy(x.astype(np.complex64)).to(dev))
            check(f"dft/{n}", got.cpu().numpy(), np.fft.fft(x))
            got = tfft.naive_dft(torch.from_numpy(x.astype(np.complex64)).to(dev)) if n < 4099 else None
            if got is not None:
                check(f"naive_dft/{n}", got.cpu().numpy(), np.fft.fft(x))
        n = 1024
        re, im = rng.standard_normal((2, 8, n))
        fr, fi = tfft.split_fft(torch.from_numpy(re.astype(np.float32)).to(dev),
                                torch.from_numpy(im.astype(np.float32)).to(dev))
        check("split_fft/1024", (fr + 1j * fi).cpu().numpy(), np.fft.fft(re + 1j * im))
        x = rng.standard_normal((8, n))
        pre, pim = tfft.packed_rfft(torch.from_numpy(x.astype(np.float32)).to(dev))
        spec = np.fft.rfft(x)
        check("packed_rfft/1024", (pre + 1j * pim).cpu().numpy(), spec)
        back = tfft.packed_irfft(torch.from_numpy(spec.real.astype(np.float32)).to(dev),
                                 torch.from_numpy(spec.imag.astype(np.float32)).to(dev))
        check("packed_irfft/1024", back.cpu().numpy(), x)
        flags_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    emit(phase="surface", part="transforms", tf32_flags_on=True, rows=rows, **card)
    assert flags_after == (True, True), "the caller's TF32 flags were not restored"
    for name, row in rows.items():
        assert row["rel_err"] < SURFACE_TOL, f"{name}: rel err {row['rel_err']}"
    four = run_four_step(dev, card, rng)

    # fixed point: every Q7 pair, the Q15 edges and random pairs
    q7 = np.arange(-128, 128, dtype=np.int8)
    a7, b7 = (v.ravel() for v in np.meshgrid(q7, q7))
    edge = np.array([-32768, -32767, -1, 0, 1, 32766, 32767], np.int16)
    a15 = np.concatenate([np.repeat(edge, edge.size), rng.integers(-32768, 32768, 200_000).astype(np.int16)])
    b15 = np.concatenate([np.tile(edge, edge.size), rng.integers(-32768, 32768, 200_000).astype(np.int16)])
    fixed = {}
    for fmt, a, b in (("Q7", a7, b7), ("Q15", a15, b15)):
        for op in ("fixed_add", "fixed_subtract", "fixed_multiply"):
            on_card = getattr(fp, op)(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)).cpu()
            fixed[f"{op}/{fmt}"] = bool(torch.equal(on_card, getattr(fp, op)(a, b, device="cpu")))
        xs = rng.uniform(-1.2, 1.2, 50_000)
        q_card = fp.to_fixed(torch.from_numpy(xs).to(dev), getattr(fp, fmt))
        q_cpu = fp.to_fixed(xs, getattr(fp, fmt), device="cpu")
        fixed[f"to_fixed/{fmt}"] = bool(torch.equal(q_card.cpu(), q_cpu))
        fixed[f"to_float/{fmt}"] = bool(torch.equal(fp.to_float(q_card).cpu(), fp.to_float(q_cpu)))
    emit(phase="surface", part="fixed_point", bit_equal_to_cpu=fixed, pairs={"Q7": int(a7.size), "Q15": int(a15.size)},
         **card)
    assert all(fixed.values()), f"fixed point on the card differs from the CPU: {fixed}"

    # checked: the first card op that makes a NaN from finite inputs raises
    t = torch.zeros(4, device=dev)
    try:
        debug.checked(lambda v: torch.log(v - 1.0) + 1.0)(t)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    finite_ok = float(debug.checked(lambda v: (v + 1.0).sum())(t)) == 4.0
    emit(phase="surface", part="checked", raised=raised, finite_passes=finite_ok, **card)
    assert raised is not None and "log" in raised and finite_ok, f"debug.checked: {raised}, {finite_ok}"

    # a split Convolver.process on the card, checkpointed after 94 blocks
    # (about 1 s) and after 128 (on a boundary of B3's 64-block windows)
    ir = 0.05 * rng.standard_normal(10 * SR) * np.exp(-np.arange(10 * SR) / (2.5 * SR))
    parts = conv.uniform_partition(conv.normalize_impulse(ir.astype(np.float32)).numpy(), BLOCK)
    x = torch.from_numpy(rng.uniform(-1, 1, (CHANNELS, 256 * BLOCK)).astype(np.float32)).to(dev)

    def fresh():
        v = conv.Convolver(storage="split", device=dev)
        v.filter(parts)
        return v

    whole = fresh().process(x)
    repeat_exact = bool(torch.equal(whole, fresh().process(x)))
    rows_ck = {}
    for blocks in (94, 128):
        split = blocks * BLOCK
        two = fresh()
        head = two.process(x[:, :split])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            tio.save_state(path, two.state)
            resumed = fresh()
            resumed.process(x[:, :BLOCK])  # binds the channels
            resumed.state = tio.load_state(path, device=dev)
        tail_two = two.process(x[:, split:])
        tail_res = resumed.process(x[:, split:])
        torch.cuda.synchronize()
        joined = torch.cat([head, tail_res], dim=-1)
        d, r = rel_err(joined.cpu(), whole.cpu())
        rows_ck[blocks] = {"resumed_equals_two_calls_bitwise": bool(torch.equal(tail_res, tail_two)),
                           "equals_uninterrupted_bitwise": bool(torch.equal(joined, whole)),
                           "max_abs_diff_vs_uninterrupted": d, "rel_diff_vs_uninterrupted": r}
    row = {"blocks": 256, "channels": CHANNELS, "partitions": parts.shape[1], "repeat_bitwise": repeat_exact,
           "checkpoints": rows_ck, "tol_off_window_boundary": CUT_TOL}
    emit(phase="surface", part="checkpoint", storage="split", **row, **card)
    for blocks, ck in rows_ck.items():
        assert ck["resumed_equals_two_calls_bitwise"], f"the state reloaded after {blocks} blocks continues differently"
        assert ck["equals_uninterrupted_bitwise"] or (blocks % 64 and ck["rel_diff_vs_uninterrupted"] < CUT_TOL), \
            f"checkpoint after {blocks} blocks vs uninterrupted: rel diff {ck['rel_diff_vs_uninterrupted']}"
    return {"transforms": rows, "four_step": four, "fixed_point": fixed, "checked": raised, "checkpoint": row}


def run_four_step(dev, card, rng) -> dict:
    """7h, part ``four_step``: ``fft.four_step`` and ``fft.api``'s
    ``"matmul"`` route above 8192 on the card with both TF32 flags on,
    FOUR_STEP_ROWS rows each: ``fft_split_large`` at 2^14, 2^17 and 2^20,
    ``rfft_split_large``/``irfft_split_large`` at 2^17, the packed pair at
    8192 and ``fft(..., backend="matmul")`` at 2^16, each against numpy's
    float64 FFT within FOUR_STEP_TOL of the peak, its ms (CUDA events)
    beside cuFFT's on the same rows."""
    import torch
    from neojax_torch import fft as tfft
    from neojax_torch.bench import harness
    from neojax_torch.fft import four_step

    r = FOUR_STEP_ROWS
    rows = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def row(name, got, ref, fn, lib):
        got = got.cpu().numpy()
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        rows[name] = {"rel_err": err, "tol": FOUR_STEP_TOL, "ms": 1e3 * harness.cuda_seconds(fn),
                      "cufft_ms": 1e3 * harness.cuda_seconds(lib)}

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for e in (14, 17, 20):
            n = 1 << e
            x = rng.standard_normal((r, n)) + 1j * rng.standard_normal((r, n))
            re, im = put(x.real), put(x.imag)
            xc = torch.complex(re, im)
            fn = lambda: four_step.fft_split_large(re, im, n)  # noqa: E731
            row(f"fft_split_large/{n}", torch.complex(*fn()), np.fft.fft(x), fn, lambda: torch.fft.fft(xc))
            del x, re, im, xc
        n = 1 << 17
        x = rng.standard_normal((r, n))
        xt = put(x)
        spec = np.fft.rfft(x)
        fn = lambda: four_step.rfft_split_large(xt, n)  # noqa: E731
        row(f"rfft_split_large/{n}", torch.complex(*fn()), spec, fn, lambda: torch.fft.rfft(xt))
        sre, sim = put(spec.real), put(spec.imag)
        sc = torch.complex(sre, sim)
        fn = lambda: four_step.irfft_split_large(sre, sim, n)  # noqa: E731
        row(f"irfft_split_large/{n}", fn(), x, fn, lambda: torch.fft.irfft(sc, n=n))
        n = 8192
        x = rng.standard_normal((r, n))
        xt = put(x)
        spec = np.fft.rfft(x)
        packed = spec[:, : n // 2].copy()
        packed.imag[:, 0] = spec[:, n // 2].real
        fn = lambda: four_step.rfft_packed_split_large(xt, n)  # noqa: E731
        row(f"rfft_packed_split_large/{n}", torch.complex(*fn()), packed, fn, lambda: torch.fft.rfft(xt))
        pre, pim = put(packed.real), put(packed.imag)
        sc = put(spec.real) + 1j * put(spec.imag)
        fn = lambda: four_step.irfft_packed_split_large(pre, pim, n)  # noqa: E731
        row(f"irfft_packed_split_large/{n}", fn(), x, fn, lambda: torch.fft.irfft(sc, n=n))
        n = 1 << 16
        x = rng.standard_normal((r, n))
        xt = put(x)
        fn = lambda: tfft.fft(xt, backend="matmul")  # noqa: E731
        row(f"api.fft/matmul/{n}", fn(), np.fft.fft(x), fn, lambda: torch.fft.fft(xt))
        flags_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    emit(phase="surface", part="four_step", tf32_flags_on=True, rows_per_call=r, rows=rows, **card)
    assert flags_after == (True, True), "the caller's TF32 flags were not restored"
    for name, rw in rows.items():
        assert rw["rel_err"] < FOUR_STEP_TOL, f"{name}: rel err {rw['rel_err']}"
    return rows


# ----------------------------------------------------------------- 7j. tools
#
# The sweep tools (``neojax_torch.tools``), each run in-process on its
# ``--smoke`` grid in a launch window of its own; the windows are summed
# into the ``tools`` path. B5 kinds carry their group count (``/G64``).

TOOLS = ("int8_sweep", "bench_sparse_sweep", "bench_perceptual", "bench_quality_sweep", "bench_grid",
         "bench_timesharded")
# the kernel calls each tool's smoke must make and hold against their
# plain versions (kinds as ``last_kernel_calls`` names them)
TOOL_HELD = {"int8_sweep": ("nested_mac/G64", "nested_mac/G16"),
             "bench_sparse_sweep": ("fused_stream", "fused_stream/sched"),
             "bench_perceptual": ("fused_stream", "fused_stream/sched"),
             "bench_quality_sweep": ("fused_stream", "fused_stream/sched"), "bench_grid": ("fdl_mac",),
             "bench_timesharded": ("fused_stream",)}
GRID_RING = [2, 32, CHANNELS, 4096]  # the grid's largest ring: L = 2^17 at block 4096, packed


def run_tools(dev, card, cuda_ms, device_ms, bound_of) -> dict:
    """7j. Each tool's ``main(["--smoke"])`` in-process, its JSON line
    printed as a ``tools`` line; the launch counters zeroed before it and
    read after; each kernel call it made kept (``last_kernel_calls``) and,
    after the counts are read, held against its plain version
    (``hold_kept``): B5 at G = 64 and G = 16, B3 dense and with the
    schedule of a band and of a perceptual mask, B1 on the grid's
    GRID_RING. Every kernel a tool launched must have been held. Then B1
    at GRID_RING timed (device ms twice, plain, the complex ``einsum``;
    the card's clocks before and after) for the ``bounds`` line. Returns {"tools", "launches", "grid_b1", "wall_s"}."""
    import importlib
    import io as pyio

    import torch
    from neojax_torch import kernels
    from neojax_torch.bench import headline
    from neojax_torch.kernels import fdl_mac as mac_mod

    t_phase = time.perf_counter()
    results, total, grid_b1 = {}, {}, None
    for name in TOOLS:
        tool = importlib.import_module(f"neojax_torch.tools.{name}")
        calls, log = {}, pyio.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with last_kernel_calls(calls), contextlib.redirect_stdout(log):
            rc = tool.main(["--smoke"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        res = json.loads(log.getvalue().strip().splitlines()[-1])
        held = hold_kept(calls)
        missing = unheld_kernels(counts, held)
        emit(phase="tools", tool=name, rc=rc, wall_s=wall, launches={k: v for k, v in counts.items() if v},
             kernels_vs_plain=held, not_held=missing, result=res)
        results[name] = {"rc": rc, "wall_s": wall, "result": res, "kernels_vs_plain": sorted(held)}
        assert rc == 0, f"tool {name} --smoke: exit code {rc}, failed {res.get('failed')}"
        for k in TOOL_HELD[name]:
            assert k in held, f"tool {name}: no {k} call held against its plain version ({sorted(held)})"
        assert not missing, f"tool {name}: {missing} launched but not held against its plain version"
        if name == "bench_grid":
            fn, named, _ = calls["fdl_mac"]
            assert list(named["fdl"].shape) == GRID_RING, named["fdl"].shape
            grid_b1 = (named, counts["fdl_mac"], res["b1_check_launches"])
        del calls
        torch.cuda.empty_cache()

    # B1 at the grid's largest ring: device ms, plain, one complex einsum
    named, launches, checks = grid_b1
    args = (named["fdl"], named["filt_re"], named["filt_im"], named.get("scales"))
    clocks = gpu_clocks()
    ms = device_ms(lambda: mac_mod.fdl_mac(*args), 50)
    xc, fc = torch.complex(args[0][0], args[0][1]), torch.complex(args[1][:, 0], args[2][:, 0])
    row = {"ring": GRID_RING, "launches": launches, "launches_of_the_tools_check": checks, "ms": ms,
           "clocks_before": clocks,
           "ms_back_to_back": cuda_ms(lambda: mac_mod.fdl_mac(*args), 50),
           "plain_ms": cuda_ms(lambda: mac_mod.fdl_mac_reference(*args), 5),
           **bound_of(headline.fdl_mac_work("split", GRID_RING[1], CHANNELS, GRID_RING[3]), ms),
           "library_ms": cuda_ms(lambda: torch.einsum("pck,pk->ck", xc, fc), 20),
           "library_call": "torch.einsum('pck,pk->ck') on complex64 at the grid's [32, 64, 4096] ring "
                           "(inputs built outside)"}
    row["ms_again"] = device_ms(lambda: mac_mod.fdl_mac(*args), 50)  # the same reading after the others
    row["clocks_after"] = gpu_clocks()
    row["max_abs_err"] = float((torch.cat(mac_mod.fdl_mac(*args)) - torch.cat(mac_mod.fdl_mac_reference(*args)))
                               .abs().max())
    del xc, fc, named, args
    wall = time.perf_counter() - t_phase
    emit(phase="tools", part="summary", wall_s=wall, budget_s=60, tools={k: v["wall_s"] for k, v in results.items()},
         **card)
    return {"tools": results, "launches": total, "grid_b1": row, "wall_s": wall}


# ------------------------------------------------------------------ 7i. dist
#
# D0 runs in this process: a world of one rank on NCCL. D1 runs in worker
# processes of this script (``--dist-worker``), two gloo ranks on cuda:0 —
# NCCL refuses two ranks of one group on one card — so their collectives
# go through host memory (``dist.mesh``'s staging, counted). D1 is two
# worlds of about 50 s each (``DIST_STAGES``), each limited to
# DIST_WORLD_S.

DIST_CH = 256  # the channel-sharded stream: BASELINE.json's multi-host config
DIST_NB = 1168  # blocks of the sharded path (D0 and D1)
# the pipeline and bin-sharded paths (host-bound: their collectives stage
# through host memory every block) stream 960 blocks at split and 640 at
# the quantized storages, to fit the phase's budget; the SNR window is the
# last SNR_BLOCKS blocks (944-959: every partition of the IR; 624-639:
# rank 1's pipeline partitions from 480 on)
DIST_PIPE_NB = {"split": 960, "bf16": 640, "int16": 640, "int8": 640}
DIST_TS_NB = 1920  # time-sharded: 960 blocks a rank (m = P)
DIST_PN_NB = 1280  # part-sharded nested: 10 chunks of S = 128
DIST_DRIVER_CHUNK, DIST_DRIVER_CHUNKS = 128, 6  # StreamDriver: two B3 windows a chunk
DIST_KILL_AFTER = 2  # rank 1 ends itself once its streams yielded this chunk
DIST_KILLED = 17  # exit code of the rank that ends itself mid-stream
DIST_B3_SPAN = 128  # blocks of each span of a B3 call held against its plain version
DIST_STAGES = ("cut", "resume")  # the two D1 worlds, in order
DIST_WORLD_S = 90  # each world's limit
DIST_NOTE = "2 ranks on one card, gloo through host memory — not a scaling figure"
_B3 = ("fused_stream", "window_forward", "quantize_rows", "stream_mac", "ring_writeback", "window_inverse")
# the kernels each dist path must launch (its launch window in the summary)
DIST_EXPECT = {
    "dist_d0": _B3,
    "dist_sharded_process": _B3,
    "dist_PipelineConvolver": ("fdl_mac",),
    "dist_BinShardedConvolver": ("fdl_mac",),
    "dist_timesharded_process": _B3,
    "dist_PartShardedNested": ("nested_mac",),
    "dist_sharded_process_nested": ("nested_mac",),
    "dist_sharded_process_hybrid": ("fused_stream", "nested_mac"),
    "dist_sharded_process_chunked": (),
}


def dist_ir():
    """The headline IR (normalized) and its partitions: [1, P_REAL, K] and
    zero-padded to P."""
    import torch
    from neojax_torch import conv
    from neojax_torch.bench import headline

    ir = conv.normalize_impulse(torch.from_numpy(headline.make_ir(P_REAL, BLOCK).astype(np.float32))).numpy()
    parts = conv.uniform_partition(ir, BLOCK)
    pad = np.zeros((1, P - P_REAL, BLOCK + 1), parts.dtype)
    return ir, parts, np.concatenate([parts, pad], axis=1)


def device_signal(channels: int, blocks: int, seed: int, dev):
    """Uniform +-1 noise [channels, blocks * BLOCK] made on the card from a
    seed (the same on every rank)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.rand((channels, blocks * BLOCK), generator=g, device=dev) * 2 - 1


def oracle_window(x4: np.ndarray, ir: np.ndarray, start: int) -> np.ndarray:
    """The f64 FFT convolution of [SNR_CH, T] with the IR on the SNR window."""
    t = x4.shape[1]
    nfft = 1 << int(np.ceil(np.log2(t + ir.size)))
    y = np.fft.irfft(np.fft.rfft(x4.astype(np.float64), nfft) * np.fft.rfft(ir.astype(np.float64), nfft)[None],
                     nfft)[:, :t]
    return snr_window(y, start)


def run_dist_world(world: int, stage: str, outdir: str, expect_exit=None) -> dict:
    """Start ``world`` worker processes of this script on one gloo group,
    wait for them within DIST_WORLD_S and return {rank: their JSON}. A
    worker that fails or a world that overruns raises (every process is
    stopped); ``expect_exit`` maps ranks that end themselves to their code."""
    from neojax_torch.dist.multihost import free_port

    expect_exit = expect_exit or {}
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(outdir, f"{stage}_r{r}.log"), "w")
        env = dict(os.environ, LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
                                       str(world), str(port), outdir, stage], stdout=log, stderr=log, env=env))
        logs.append(log)
    deadline = time.monotonic() + DIST_WORLD_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dist world {stage} did not finish in {DIST_WORLD_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = {}
    for r, p in enumerate(procs):
        path = os.path.join(outdir, f"{stage}_r{r}.json")
        if p.returncode != expect_exit.get(r, 0):
            with open(os.path.join(outdir, f"{stage}_r{r}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"dist world {stage}: rank {r} exited with {p.returncode}\n{tail}")
        with open(path) as f:
            out[r] = json.load(f)
    return out


def _chunk_digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def dist_worker(rank: int, world: int, port: int, outdir: str, stage: str) -> int:
    """One rank of a D1 world: run ``stage``'s paths on cuda:0 and write
    their records to ``{outdir}/{stage}_r{rank}.json`` as they finish."""
    import torch
    import torch.distributed as tdd

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neojax_torch import dist as tdist
    from neojax_torch.kernels import _build

    _build.load()
    assert _build.build_info()["built"] is False, "a worker built the kernel library (the parent builds it)"
    assert tdist.init_distributed(f"127.0.0.1:{port}", world, rank, timeout_secs=60, backend="gloo")
    res = _Results(os.path.join(outdir, f"{stage}_r{rank}.json"), rank=rank, stage=stage, records=[])
    try:
        {"cut": _dist_cut, "resume": _dist_resume}[stage](rank, res)
    finally:
        res.save()
    tdd.destroy_process_group()
    return 0


class _Results(dict):
    """A worker's results, rewritten to its JSON file on every ``save`` (a
    rank that ends itself leaves what it had done)."""

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self.path = path

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self, f)
        os.replace(tmp, self.path)


def _record(res: _Results, rec: dict) -> dict:
    res["records"].append(rec)
    res.save()
    return rec


def _on_card_state(state) -> bool:
    import torch

    leaves = [v for val in state.values() for v in (val if isinstance(val, tuple) else (val,))]
    return all(v.device.type == DEVICE for v in leaves if isinstance(v, torch.Tensor))


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernel_vs_plain(name, kernel, plain, library, args, storage, work) -> dict:
    """A kernel and its plain version on the same dist operands (gated on
    TOL), with both times, the library call's (one einsum on complex64
    inputs built outside) and the kernel's bound."""
    import torch
    from neojax_torch.bench import harness, headline

    got, want = kernel(*args), plain(*args)
    d, r = rel_err(torch.stack(got).cpu(), torch.stack(want).cpu())
    row = {"kernel": name, "storage": storage, "shape": list(args[0].shape), "max_abs_err": d, "rel_err": r,
           "tol": TOL[storage], "ms": _event_ms(lambda: kernel(*args)), "plain_ms": _event_ms(lambda: plain(*args), 3),
           "library_ms": _event_ms(library, 3)}
    peak_b, peak_f = harness.hbm_peak_bytes_per_sec(), harness.f32_peak_flops_per_sec()
    if peak_b and peak_f:
        t, by = headline.bound(work, peak_b, peak_f)
        row.update(bound_ms=1e3 * t, bound_by=by, share=1e3 * t / row["ms"])
    assert r < TOL[storage], f"{name} on the dist operands ({storage}): {r}"
    return row


def _counts_window(fn):
    """Run fn with the launch counters zeroed just before and read just
    after: (fn's result, seconds, counts)."""
    from neojax_torch import kernels

    kernels.reset_launch_counts()
    out, dt = _timed(fn)
    return out, dt, kernels.launch_counts()


def _oracle(sig, ir, start: int = None) -> np.ndarray:
    """The f64 oracle of a signal's first SNR_CH channels on the SNR window
    from block ``start`` (SNR_START)."""
    return oracle_window(sig[:SNR_CH].cpu().numpy(), ir, SNR_START if start is None else start)


def _snr(out, oracle, start: int = None) -> float:
    return snr_db(snr_window(out.cpu().numpy(), SNR_START if start is None else start), oracle)


def _warm(dev, parts_pad) -> None:
    """One small B3 stream, to load this process's libraries and B3 outside
    every launch window."""
    from neojax_torch.conv import convolver as cv
    from neojax_torch.kernels.fused_step import WINDOW

    cfg_w = cv.PartitionedConfig(BLOCK, P, 4, storage="split")
    cv.process(cfg_w, cv.filter_params(cfg_w, parts_pad, device=dev), cv.init_state(cfg_w, dev),
               device_signal(4, 2 * WINDOW, 1, dev))


def fused_stream_spans(fn, named: dict, span: int) -> list:
    """A B3 call's operands cut to at most two spans of ``span`` blocks:
    its first ``span`` blocks from its own ring, and the ``span`` blocks
    around the ring's first wrap (window-aligned; 896-1023 at P = 960 from
    slot 0) from the ring that ``fn``, the kernel, leaves on a copy before
    them. A call of at most ``span`` blocks stays whole. Returns
    [(first block, operands)]."""
    from neojax_torch.kernels.fused_step import WINDOW

    p, b = named["fdl"].shape[1], named["fdl"].shape[3]
    nb = named["sigpad"].shape[1] // b - 1
    if nb <= span:
        return [(0, named)]
    pos0 = int(named["pos0"])

    def cut(start, n):
        out = dict(named, sigpad=named["sigpad"][:, start * b : (start + n + 1) * b].contiguous(),
                   dcfix_all=named["dcfix_all"][start : start + n].contiguous(), pos0=(pos0 + start) % p)
        if named.get("acc_add") is not None:
            out["acc_add"] = named["acc_add"][start : start + n].contiguous()
        return out

    spans = [(0, cut(0, span))]
    wrap = p - pos0 if pos0 else p  # the first block written to ring slot 0
    start = max(span, (wrap - span // 2) // WINDOW * WINDOW)
    if start + span <= nb:
        before = {k: _clone(v) for k, v in cut(0, start).items()}
        fn(**before)  # the ring after blocks 0..start-1, on copies
        spans.append((start, dict(cut(start, span), fdl=before["fdl"], scales=before.get("scales"))))
    return spans


def held_calls(run) -> dict:
    """Run ``run`` once with the kernel wrappers' operands kept
    (``last_kernel_calls``), then hold each kept call's kernel against its
    plain version on copies of those operands (``kernel_vs_plain_on``, at
    TOL): {kind: row}. B3 is held on two spans of its call
    (``fused_stream_spans``, DIST_B3_SPAN blocks each): its plain version
    loops blocks in float64, 13-16 s for a whole 1168-block call at 128 or
    256 channels. The run is an extra call, outside every launch window."""
    calls = {}
    with last_kernel_calls(calls):
        run()
    return hold_kept(calls)


def hold_kept(calls: dict) -> dict:
    """Each call ``last_kernel_calls`` kept, its kernel held against its
    plain version on copies of its operands (``kernel_vs_plain_on``, at
    TOL; B3 on at most two spans of DIST_B3_SPAN blocks,
    ``fused_stream_spans``): {kind: row}."""
    rows = {}
    for kind, (fn, named, seen) in calls.items():
        if fn.__name__ != "fused_stream":
            rows[kind] = {"calls_seen": seen, **kernel_vs_plain_on(fn, named)}
            continue
        b = named["fdl"].shape[3]
        spans = [{"blocks": [s, s + op["dcfix_all"].shape[0]], **kernel_vs_plain_on(fn, op)}
                 for s, op in fused_stream_spans(fn, named, DIST_B3_SPAN)]
        rows[kind] = {"calls_seen": seen, "call_blocks": named["sigpad"].shape[1] // b - 1,
                      "rel_err": max(r["rel_err"] for r in spans), "spans": spans}
    return rows


def _dist_cut(rank: int, res: dict) -> None:
    """The first D1 world: the engines whose collectives stage through host
    memory every block (pipeline, bin-sharded), then the ``StreamDriver``
    streams, which rank 1 cuts short."""
    import torch
    from neojax_torch import dist as tdist
    from neojax_torch.conv import convolver as cv
    from neojax_torch.bench import headline
    from neojax_torch.kernels import fdl_mac as mac_mod

    dev = tdist.mesh.rank_device(None)
    ir, parts, parts_pad = dist_ir()
    _warm(dev, parts_pad)

    # 2-3. PipelineConvolver (part = 2) and BinShardedConvolver (bin = 2), 64 channels
    sig = device_signal(CHANNELS, DIST_PIPE_NB["split"], 12, dev)
    oracles = {nb: _oracle(sig, ir, nb - SNR_BLOCKS) for nb in set(DIST_PIPE_NB.values())}
    cfg_s = cv.PartitionedConfig(BLOCK, P, CHANNELS, storage="split")
    _, single = cv.process(cfg_s, cv.filter_params(cfg_s, parts_pad, device=dev), cv.init_state(cfg_s, dev), sig)
    filt = np.moveaxis(parts_pad, 0, 1)  # [P, 1, K]
    for kind, mesh in (("PipelineConvolver", tdist.make_mesh(part=2)), ("BinShardedConvolver", tdist.make_mesh(bin=2))):
        for storage in (STORAGES if kind == "PipelineConvolver" else ("split", "int8")):
            nb = DIST_PIPE_NB[storage]
            x = sig[:, : nb * BLOCK]
            cfg = cv.PartitionedConfig(BLOCK, P, CHANNELS, storage=storage)
            eng = (tdist.PipelineConvolver if kind == "PipelineConvolver" else tdist.BinShardedConvolver)(cfg, mesh)
            f = eng.shard_filter(filt)
            staged0 = mesh.host_staged_bytes
            (st, out), dt, counts = _counts_window(lambda: eng.process(f, eng.init_state(), x))
            rec = {"path": kind, "storage": storage, "channels": CHANNELS, "blocks": nb, "s": dt,
                   "ms_per_block": 1e3 * dt / nb, "launches": counts,
                   "host_staged_bytes": mesh.host_staged_bytes - staged0,
                   "snr_db_vs_f64": _snr(out, oracles[nb], nb - SNR_BLOCKS), "snr_window_start": nb - SNR_BLOCKS,
                   "state_on_card": _on_card_state(st),
                   "note": DIST_NOTE}
            if storage == "split":
                rec["max_abs_err_vs_process"], rec["rel_err_vs_process"] = rel_err(out.cpu(), single.cpu())
            # B1 against its plain version on this path's operands (the ring it leaves)
            planes, scales = st["fdl"], st.get("scales", st.get("scl"))
            if kind == "PipelineConvolver":
                ell = planes.shape[1]
                fr, fi = f[0, ell : 2 * ell], f[1, ell : 2 * ell]
            else:
                fr, fi = f[0, P - 1 - st["pos"] : 2 * P - 1 - st["pos"]], f[1, P - 1 - st["pos"] : 2 * P - 1 - st["pos"]]
            sc = None if scales is None else scales[..., 0]
            dq = 1.0 if sc is None else (sc * (1.0 / INT_MAX[storage]))[..., None]
            xc = torch.complex(planes[0].float() * dq, planes[1].float() * dq)
            fc = torch.complex(fr[:, 0], fi[:, 0])
            rec["fdl_mac_vs_plain"] = _kernel_vs_plain(
                "fdl_mac", mac_mod.fdl_mac, mac_mod.fdl_mac_reference,
                lambda: torch.einsum("pck,pk->ck", xc, fc), (planes, fr, fi, sc), storage,
                headline.fdl_mac_work(storage, planes.shape[1], planes.shape[2], planes.shape[3], fr.shape[1]))
            del xc, fc
            rec["fdl_mac_vs_plain"]["vec"] = mac_mod.mac_geometry(planes, fr, fi)[2]
            _record(res, rec)
            assert rec["state_on_card"] and counts["fdl_mac"] > 0, rec
            if storage in SNR_CLASS_DB:
                assert rec["snr_db_vs_f64"] >= SNR_CLASS_DB[storage], rec
            if storage == "split":
                assert rec["rel_err_vs_process"] < TOL["split"], rec
            del st, out
    del sig, single
    torch.cuda.empty_cache()

    # 7. StreamDriver: an uninterrupted stream, then the npz and DCP streams
    # that rank 1 cuts short (resumed by the next world)
    res["uninterrupted"] = _streams(rank, ("none",))["none"]
    res.save()
    _streams(rank, ("npz", "dcp"), kill_after=DIST_KILL_AFTER, res=res)


def _dist_resume(rank: int, res: dict) -> None:
    """The second D1 world: first the streams the last world cut, resumed
    from each rank's checkpoints; then the engines whose collectives, if
    any, come once a call or a chunk (channel-, time- and part-sharded),
    with B3 and B5 held against their plain versions on the operands of
    the channel-sharded calls."""
    import torch
    from neojax_torch import dist as tdist
    from neojax_torch.conv import chunked as ch_lib
    from neojax_torch.conv import convolver as cv
    from neojax_torch.conv import hybrid as hy
    from neojax_torch.conv import nested as ne
    from neojax_torch.dist import partnested as pn
    from neojax_torch.bench import headline
    from neojax_torch.kernels import nested_mac as nm_mod

    res["resumed"] = _streams(rank, ("npz", "dcp"))
    res.save()
    dev = tdist.mesh.rank_device(None)
    ir, parts, parts_pad = dist_ir()
    _warm(dev, parts_pad)

    # 1. sharded_process, 256 channels over "ch"
    mesh = tdist.make_mesh()
    sig = device_signal(DIST_CH, DIST_NB, 11, dev)
    sig_l = sig[mesh.block(("ch", None), sig.shape)]
    oracle = _oracle(sig_l, ir)
    for storage in ("split", "int8"):
        cfg = cv.PartitionedConfig(BLOCK, P, DIST_CH, storage=storage)
        local = tdist.sharded.local_config(cfg, mesh)
        params = cv.filter_params(cfg, parts_pad, device=dev)
        held, held_s = _timed(lambda: held_calls(
            lambda: tdist.sharded_process(cfg, params, cv.init_state(local, dev), sig, mesh)))
        (st, out), dt, counts = _counts_window(
            lambda: tdist.sharded_process(cfg, params, cv.init_state(local, dev), sig, mesh))
        _, ref = cv.process(local, cv.filter_params(local, parts_pad, device=dev), cv.init_state(local, dev), sig_l)
        rec = _record(res, {"path": "sharded_process", "storage": storage, "channels": DIST_CH,
                            "rank_channels": local.channels, "blocks": DIST_NB, "s": dt,
                            "us_per_block": 1e6 * dt / DIST_NB, "launches": counts,
                            "bit_equal_vs_process": bool(torch.equal(out, ref)),
                            "snr_db_vs_f64": _snr(out, oracle), "state_on_card": _on_card_state(st),
                            "kernels_vs_plain": held, "kernels_vs_plain_s": held_s,
                            "not_held": unheld_kernels(counts, held)})
        assert rec["bit_equal_vs_process"] and rec["state_on_card"] and counts["fused_stream"] > 0, rec
        assert "fused_stream" in held and not rec["not_held"], rec
        if storage in SNR_CLASS_DB:
            assert rec["snr_db_vs_f64"] >= SNR_CLASS_DB[storage], rec
    del sig, sig_l, st, out, ref, params
    torch.cuda.empty_cache()

    # 4. timesharded_process over a "time" axis of 2
    mesh_t = tdist.Mesh(("time",), (2,))
    sig = device_signal(CHANNELS, DIST_TS_NB, 13, dev)
    m = DIST_TS_NB // 2
    for storage in ("split", "int8"):
        cfg = cv.PartitionedConfig(BLOCK, P, CHANNELS, storage=storage)
        params = cv.filter_params(cfg, parts_pad, device=dev)
        staged0 = mesh_t.host_staged_bytes
        out, dt, counts = _counts_window(lambda: tdist.timesharded_process(cfg, params, sig, mesh_t))
        staged = mesh_t.host_staged_bytes - staged0
        _, ref = cv.process(cfg, params, cv.init_state(cfg, dev), sig)
        ref = ref[:, rank * m * BLOCK : (rank + 1) * m * BLOCK]
        d, r = rel_err(out.cpu(), ref.cpu())
        tol = CUT_TOL if storage == "split" else TOL[storage]
        rec = _record(res, {"path": "timesharded_process", "storage": storage, "channels": CHANNELS,
                            "blocks": DIST_TS_NB, "rank_blocks": m, "s": dt, "us_per_block": 1e6 * dt / m,
                            "launches": counts, "halo_bytes": CHANNELS * P * BLOCK * 4,
                            "host_staged_bytes": staged, "max_abs_err_vs_process": d, "rel_err_vs_process": r,
                            "tol": tol, "bit_equal_vs_process": bool(torch.equal(out, ref)), "note": DIST_NOTE})
        assert r < tol and counts["fused_stream"] > 0, rec
    del sig, out, ref
    torch.cuda.empty_cache()

    # 5. PartShardedNested (part = 2, S = 128)
    mesh = tdist.make_mesh(part=2)
    sig = device_signal(CHANNELS, DIST_PN_NB, 14, dev)
    oracle = _oracle(sig, ir)
    for storage in ("split", "bf16", "int8"):
        cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
        eng = pn.PartShardedNested(cfg, mesh, S_NESTED)
        gparams = pn.partnested_filter_params(cfg, parts, S_NESTED, eng.d_part, device=dev)
        params = eng.shard_params(gparams)
        state = eng.shard_state(pn.partnested_init_state(cfg, gparams, eng.d_part))
        del gparams
        staged0 = mesh.host_staged_bytes
        (st, out), dt, counts = _counts_window(lambda: eng.process(params, state, sig))
        nparams = ne.nested_filter_params(cfg, parts, S_NESTED, device=dev)
        _, ref = ne.process_nested(cfg, nparams, ne.nested_init_state(cfg, nparams), sig)
        d, r = rel_err(out.cpu(), ref.cpu())
        rec = {"path": "PartShardedNested", "storage": storage, "channels": CHANNELS, "chunk_blocks": S_NESTED,
               "blocks": DIST_PN_NB, "s": dt, "ms_per_block": 1e3 * dt / DIST_PN_NB, "launches": counts,
               "host_staged_bytes": mesh.host_staged_bytes - staged0, "max_abs_err_vs_process_nested": d,
               "rel_err_vs_process_nested": r, "tol": TOL[storage], "snr_db_vs_f64": _snr(out, oracle),
               "snr_class_db": ENGINE_SNR_CLASS_DB[storage], "state_on_card": _on_card_state(st),
               "local_ring": list(st["fdl"].shape), "note": DIST_NOTE}
        ell, pos_l = st["fdl"].shape[1], (st["pos"] - 1) % st["fdl"].shape[1]
        fre = params["filt_re"][ell - 1 - pos_l : 2 * ell - 1 - pos_l, 0].float()
        fim = params["filt_im"][ell - 1 - pos_l : 2 * ell - 1 - pos_l, 0].float()
        x, sc = st["fdl"], st.get("scales")
        dq = 1.0 if sc is None else (sc * (1.0 / INT_MAX[storage])).repeat_interleave(
            x.shape[-1] // sc.shape[-1], dim=-1)
        xc = torch.complex(x[0].float() * dq, x[1].float() * dq)
        fc = torch.complex(fre, fim)
        rec["nested_mac_vs_plain"] = _kernel_vs_plain(
            "nested_mac", nm_mod.nested_mac, nm_mod.nested_mac_reference,
            lambda: torch.einsum("pckm,pkm->ckm", xc, fc), (x, sc, fre, fim), storage,
            headline.nested_mac_work(storage, x.shape[1], x.shape[2], x.shape[3], x.shape[4]))
        del xc, fc
        _record(res, rec)
        assert rec["state_on_card"] and r < TOL[storage] and counts["nested_mac"] > 0, rec
        assert rec["snr_db_vs_f64"] >= ENGINE_SNR_CLASS_DB[storage], rec
        del st, out, ref, params, state, nparams
        torch.cuda.empty_cache()
    del sig

    # 6. the channel-sharded nested, hybrid and chunked engines (ch = 2)
    mesh = tdist.make_mesh()
    for name, s_e, nb in (("nested", S_NESTED, NB_NESTED), ("hybrid", S_HYBRID, NB_HYBRID),
                          ("chunked", S_CHUNKED, NB_CHUNKED)):
        cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage="split")
        local = tdist.sharded.local_config(cfg, mesh)
        sig = device_signal(CHANNELS, nb, 15, dev)
        sig_l = sig[mesh.block(("ch", None), sig.shape)]
        if name == "nested":
            build, init = ne.nested_filter_params, ne.nested_init_state
            run = lambda p_, s_: tdist.sharded_process_nested(cfg, p_, s_, sig, mesh)
            one = lambda p_, s_: ne.process_nested(local, p_, s_, sig_l)
        elif name == "hybrid":
            build, init = hy.hybrid_filter_params, hy.hybrid_init_state
            run = lambda p_, s_: tdist.sharded_process_hybrid(cfg, p_, s_, sig, mesh)
            one = lambda p_, s_: hy.process_hybrid(local, p_, s_, sig_l)
        else:
            build, init = ch_lib.chunked_filter_params, ch_lib.chunked_init_state
            run = lambda p_, s_: tdist.sharded_process_chunked(cfg, p_, s_, sig, mesh, S_CHUNKED)
            one = lambda p_, s_: ch_lib.process_chunked(local, p_, s_, sig_l, S_CHUNKED)
        params = build(cfg, parts, s_e, device=dev)
        held = held_calls(lambda: run(params, init(local, params)))
        (st, out), dt, counts = _counts_window(lambda: run(params, init(local, params)))
        lp = build(local, parts, s_e, device=dev)
        _, ref = one(lp, init(local, lp))
        d, r = rel_err(out.cpu(), ref.cpu())
        rec = _record(res, {"path": f"sharded_process_{name}", "storage": "split", "channels": CHANNELS,
                            "chunk_blocks": s_e, "blocks": nb, "s": dt, "us_per_block": 1e6 * dt / nb,
                            "launches": counts, "max_abs_err_vs_engine": d, "rel_err_vs_engine": r,
                            "bit_equal_vs_engine": bool(torch.equal(out, ref)), "state_on_card": _on_card_state(st),
                            "kernels_vs_plain": held, "not_held": unheld_kernels(counts, held)})
        assert r < TOL["split"] and rec["state_on_card"] and not rec["not_held"], rec
        assert name == "chunked" or (counts["nested_mac"] > 0 and "nested_mac" in held), rec
        assert name != "hybrid" or "fused_stream/acc_add" in held, rec
        del st, out, ref, params, lp, sig, sig_l
        torch.cuda.empty_cache()


def _streams(rank: int, kinds, kill_after=None, res=None) -> dict:
    """``StreamDriver`` over ``sharded_process`` (64 channels over "ch",
    split): DIST_DRIVER_CHUNKS chunks of DIST_DRIVER_CHUNK blocks, one
    stream per kind — "none" (no checkpoint), "npz" (the per-rank pair) or
    "dcp" (the DCP pair), a checkpoint every 2 chunks — advanced in turns,
    a chunk each. Returns {kind: [(chunk, sha256 of its output)]}.

    With ``kill_after``, rank 1 ends its process once every stream has
    yielded that chunk. Rank 0 ends its DCP stream there too, since that
    stream's next checkpoint is a collective with the rank that is gone;
    its npz stream, which writes this rank's files alone, runs to the end."""
    from neojax_torch import dist as tdist
    from neojax_torch import io
    from neojax_torch.conv import convolver as cv

    dev = tdist.mesh.rank_device(None)
    _, _, parts_pad = dist_ir()
    cfg = cv.PartitionedConfig(BLOCK, P, CHANNELS, storage="split")
    mesh = tdist.make_mesh()
    local = tdist.sharded.local_config(cfg, mesh)
    params = tdist.shard_params(cfg, cv.filter_params(cfg, parts_pad, device=dev), mesh)
    sig = device_signal(CHANNELS, DIST_DRIVER_CHUNK * DIST_DRIVER_CHUNKS, 16, dev)
    step = DIST_DRIVER_CHUNK * BLOCK
    chunks = [sig[:, i * step : (i + 1) * step] for i in range(DIST_DRIVER_CHUNKS)]
    pairs = {"npz": (tdist.multihost.save_sharded_state, tdist.multihost.load_sharded_state),
             "dcp": (io.save_state_dcp, io.load_state_dcp)}
    live = {}
    for kind in kinds:
        kw = {}
        if kind in pairs:
            kw = dict(checkpoint_path=os.path.join(os.environ["NEOJAX_DIST_OUT"], f"stream_{kind}"),
                      checkpoint_every=2, save_fn=pairs[kind][0], load_fn=pairs[kind][1])
        driver = tdist.StreamDriver(lambda p_, s_, x: tdist.sharded_process(cfg, p_, s_, x, mesh), **kw)
        live[kind] = driver.run(params, cv.init_state(local, dev), chunks)
    done = {kind: [] for kind in kinds}
    while live:
        for kind, gen in list(live.items()):
            try:
                i, out, _ = next(gen)
            except StopIteration:
                del live[kind]
                continue
            done[kind].append((i, _chunk_digest(out)))
            if res is not None:
                res[f"progress_{kind}"] = done[kind]
                res.save()
            if kill_after is not None and kind == "dcp" and i >= kill_after:
                del live[kind]
        if kill_after is not None and rank == 1 and all(d and d[-1][0] >= kill_after for d in done.values()):
            os._exit(DIST_KILLED)
    return done


def run_dist(dev, card) -> dict:
    """7i. The distributed engines on the card (module comment above).
    D0: world 1 on NCCL in this process; D1: two 2-rank gloo worlds of
    worker processes. Returns {"summary", "windows": {path: counts}}."""
    import torch
    import torch.distributed as tdd
    from neojax_torch import dist as tdist
    from neojax_torch.bench import scaling
    from neojax_torch.conv import convolver as cv

    t_phase = time.perf_counter()
    ir, parts, parts_pad = dist_ir()
    windows, summary = {}, {"note": DIST_NOTE}

    # D0: one rank on NCCL
    assert tdist.init_distributed(f"127.0.0.1:{tdist.multihost.free_port()}", 1, 0, timeout_secs=60,
                                  backend="nccl")
    try:
        mesh = tdist.make_mesh()
        sig = device_signal(DIST_CH, DIST_NB, 11, dev)
        cfg = cv.PartitionedConfig(BLOCK, P, DIST_CH, storage="split")
        params = cv.filter_params(cfg, parts_pad, device=dev)
        (st, out), dt, counts = _counts_window(
            lambda: tdist.sharded_process(cfg, params, cv.init_state(cfg, dev), sig, mesh))
        _, ref = cv.process(cfg, params, cv.init_state(cfg, dev), sig)
        _, warm = _timed(lambda: tdist.sharded_process(cfg, params, cv.init_state(cfg, dev), sig, mesh))
        held, held_s = _timed(lambda: held_calls(
            lambda: tdist.sharded_process(cfg, params, cv.init_state(cfg, dev), sig, mesh)))
        x = torch.randn((2, CHANNELS, BLOCK + 1), device=dev)
        y = tdist.psum(x, mesh, "ch")
        torch.cuda.synchronize()
        pt = scaling.weak_scaling_sweep(device_counts=[1])[0]
        d0 = {"backend": tdd.get_backend(), "world": tdd.get_world_size(), "channels": DIST_CH, "blocks": DIST_NB,
              "sharded_first_call_s": dt, "sharded_us_per_block": 1e6 * warm / DIST_NB,
              "bit_equal_vs_process": bool(torch.equal(out, ref)), "launches": counts,
              "kernels_vs_plain": held, "kernels_vs_plain_s": held_s, "not_held": unheld_kernels(counts, held),
              "psum_equal": bool(torch.equal(x, y)), "psum_staged_bytes": mesh.host_staged_bytes,
              "weak_scaling_point": dataclasses.asdict(pt)}
        emit(phase="dist", part="D0", **d0, **card)
        windows["dist_d0"] = counts
        assert d0["bit_equal_vs_process"] and d0["psum_equal"] and d0["psum_staged_bytes"] == 0
        assert counts["fused_stream"] > 0 and "fused_stream" in held and not d0["not_held"], d0
        summary["D0"] = d0
        del sig, st, out, ref, params, x, y
    finally:
        tdd.destroy_process_group()
    torch.cuda.empty_cache()

    # D1: two gloo ranks on cuda:0, in two worlds: "cut" ends with rank 1
    # leaving mid-stream, "resume" starts by resuming those streams
    world_s, first = {}, {}
    with tempfile.TemporaryDirectory() as outdir:
        os.environ["NEOJAX_DIST_OUT"] = outdir
        t0 = time.perf_counter()
        for stage in DIST_STAGES:
            t1 = time.perf_counter()
            first[stage] = run_dist_world(2, stage, outdir, expect_exit={1: DIST_KILLED} if stage == "cut" else {})
            world_s[stage] = time.perf_counter() - t1
            for r, rank_res in first[stage].items():
                for rec in rank_res["records"]:
                    key = f"dist_{rec['path']}"
                    windows.setdefault(key, {})
                    for name, n in rec["launches"].items():
                        windows[key][name] = windows[key].get(name, 0) + n
                    emit(phase="dist", part="D1", world=stage, rank=r, **rec, **card)
        d1_s = time.perf_counter() - t0
    # each cut stream, its chunks before the cut and after the resume
    # together, against the uninterrupted stream, chunk by chunk
    cut, resumed = first["cut"], first["resume"]
    for r in (0, 1):
        want = dict(map(tuple, cut[r]["uninterrupted"]))
        row = {"rank": r, "chunks": DIST_DRIVER_CHUNKS, "chunk_blocks": DIST_DRIVER_CHUNK,
               "cut_after_chunk": DIST_KILL_AFTER}
        for kind in ("npz", "dcp"):
            before = [i for i, _ in cut[r].get(f"progress_{kind}", [])]
            again = resumed[r]["resumed"][kind]
            got = dict(map(tuple, cut[r].get(f"progress_{kind}", []))) | dict(map(tuple, again))
            row[f"{kind}_last_before_cut"] = before[-1] if before else None
            row[f"{kind}_resumed_from"] = again[0][0] if again else None
            row[f"{kind}_bit_equal"] = got == want
        emit(phase="dist", part="D1", path="StreamDriver kill-and-resume", **row, **card)
        assert row["npz_bit_equal"] and row["dcp_bit_equal"], row
        # a checkpoint every 2 chunks: the DCP stream (and rank 1's npz
        # stream) resume from the last even chunk at or before the cut;
        # rank 0's npz stream ran to its end
        resume_at = DIST_KILL_AFTER - DIST_KILL_AFTER % 2
        assert row["dcp_last_before_cut"] == DIST_KILL_AFTER and row["dcp_resumed_from"] == resume_at, row
        assert row["npz_resumed_from"] == (resume_at if r == 1 else None), row
    summary.update(d1_s=d1_s, world_s=world_s, phase_s=time.perf_counter() - t_phase,
                   records=[{k: v for k, v in rec.items() if k != "launches"}
                            for stage in DIST_STAGES for r in first[stage] for rec in first[stage][r]["records"]])
    emit(phase="dist", part="summary", d1_s=d1_s, world_s=world_s, world_limit_s=DIST_WORLD_S,
         phase_s=summary["phase_s"], budget_s=120, **card)
    return {"summary": summary, "windows": windows}


def main(dist_only: bool = False) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neojax_torch import conv
    from neojax_torch import kernels
    from neojax_torch.conv import convolver as cv
    from neojax_torch.fft import matmul_backend as mb
    from neojax_torch.kernels import _build
    from neojax_torch.conv import hybrid as hy
    from neojax_torch.conv import nested as ne
    from neojax_torch.kernels import fdl_mac as mac_mod
    from neojax_torch.core.device import ieee_float32
    from neojax_torch.kernels import fused_step as fs_mod
    from neojax_torch.kernels import nested_mac as nm_mod
    from neojax_torch.kernels import sparse_mac as sm_mod
    from neojax_torch.kernels import probes as pr_mod
    from neojax_torch.bench import harness, headline
    from neojax_torch.bench import profile as bench_profile
    from neojax_torch.tools import fused_probe, roofline_cal

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    # ---- 1. device and environment
    smi = nvidia_smi_line()
    print(smi, flush=True)
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(phase="device", **card, count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    log_path = info["path"][: -len(".so")] + ".log"
    ptxas = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            ptxas = [ln.strip() for ln in f
                     if any(w in ln for w in ("Function properties", "registers", "spill"))]
    mac_lines = mac_ptxas(log_path)
    emit(phase="build", seconds=time.perf_counter() - t0, built=info["built"],
         library=os.path.relpath(info["path"], os.path.dirname(os.path.abspath(__file__))),
         ptxas=ptxas, partition_mac=mac_lines)
    # the stage map below finds B3's MAC in a trace by this kernel name
    assert not mac_lines or any(r["kernel"].startswith("stream_mac_kernel") for r in mac_lines), \
        "no stream_mac_kernel in the build log"

    if dist_only:  # the dist phase alone, for work on it; no kernels line and no ok line
        res = run_dist(torch.device(DEVICE), card)
        for path, counts in res["windows"].items():
            emit(phase="launch_counts", path=path, **counts)
            for name in DIST_EXPECT[path]:
                assert counts[name] > 0, f"{name} was not launched on the {path} path"
        return 0

    # the card's data-sheet peaks, for each kernel's bound (None off the H100)
    peak_b, peak_f = harness.hbm_peak_bytes_per_sec(), harness.f32_peak_flops_per_sec()
    no_peaks = None if peak_b and peak_f else f"the harness has no data-sheet peaks for {card['card']}"

    def bound_of(work, ms):
        """bound_ms and share of the bound of a kernel time, from its work."""
        if no_peaks is not None:
            return {"bound_ms": None, "bound_by": None, "share": None}
        t, by = headline.bound(work, peak_b, peak_f)
        return {"bound_ms": 1e3 * t, "bound_by": by, "share": 1e3 * t / ms}

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1) / reps

    def device_ms(fn, reps: int) -> float:
        """Device ms of one call of fn with the host's enqueue hidden: a
        sleep kernel holds the stream while the reps calls queue up behind
        it (a short call's back-to-back time is its host time)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        one = time.perf_counter() - t0
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (reps * one + 1e-3)))  # clock cycles, > the enqueue time
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1) / reps

    # B2/B3 run as stage kernels: a call's device time by stage, from its
    # kernel timeline (fft_forward_kernel / fft_inverse_kernel: the transforms)
    stage_of = {"fft_forward": "window_forward", "fft_inverse": "window_inverse",
                "quantize_kernel": "quantize_rows", "writeback_kernel": "ring_writeback",
                "stream_mac_kernel": "stream_mac", "step_mac_kernel": "step_mac",
                "step_reduce_kernel": "step_reduce", "widths_kernel": "sched_widths"}

    b2_need = ("window_forward", "quantize_rows", "ring_writeback", "step_mac", "step_reduce", "window_inverse")
    b3_need = ("window_forward", "quantize_rows", "stream_mac", "ring_writeback", "window_inverse")

    def stage_us(fn, need=(), rounds: int = 4) -> dict:
        """Device µs by stage of one call of fn: the median over the
        profiled calls that show the stage. A trace may miss a kernel, so
        fn is traced three calls at a time, up to ``rounds`` times, until
        every stage in ``need`` was seen; a stage still unseen is left out
        and its caller times it alone."""
        fn()
        per_call = []
        for _ in range(rounds):
            for timeline in bench_profile.kernel_timeline(fn, 3):
                call = {}
                for name, us in timeline:
                    label = next((v for k, v in stage_of.items() if k in name), None)
                    if label:
                        call[label] = call.get(label, 0.0) + us
                per_call.append(call)
            if all(any(k in call for call in per_call) for k in need):
                break
        labels = {k for call in per_call for k in call}
        return {k: float(np.median([call[k] for call in per_call if k in call])) for k in sorted(labels)}

    # ---- 3. each kernel against its plain version at the headline shapes
    rng = np.random.default_rng(7)
    c, b, n = CHANNELS, BLOCK, 2 * BLOCK
    summary = {"fdl_mac": {}, "fused_block_step": {}, "fused_stream": {}, "nested_mac": {}}
    stages = {f.__name__: {} for f in fs_mod.stage_wrappers()}  # B2/B3's stage kernels

    def ring_inputs(storage):
        sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
        if storage in INT_MAX:
            m = INT_MAX[storage]
            ring = torch.from_numpy(rng.integers(-m, m + 1, (2, P, c, b), dtype=np.int32)).to(dev, sdt)
            scales = torch.from_numpy(rng.uniform(1.0, 40.0, (P, c)).astype(np.float32)).to(dev)
        else:
            ring = torch.from_numpy((10 * rng.standard_normal((2, P, c, b))).astype(np.float32)).to(dev, sdt)
            scales = None
        return ring, scales

    def check_ring(storage, k_ring, p_ring, k_scl, p_scl, what, exact=None):
        if exact is not None:  # bf16 matrices: exact_ring's reference
            p_ring, p_scl = exact
        if storage in INT_MAX:
            lsb = int((k_ring.to(torch.int32) - p_ring.to(torch.int32)).abs().max())
            assert lsb <= 1, f"{what}: int ring differs by {lsb} LSB"
            _, r = rel_err(k_scl.cpu(), p_scl.cpu())
            assert r < 1e-5, f"{what}: scales differ ({r})"
        else:
            _, r = rel_err(k_ring.float().cpu(), p_ring.float().cpu())
            assert r < TOL[storage], f"{what}: ring differs ({r})"

    for storage in STORAGES:
        sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
        mdt = fs_mod.MATRIX_DTYPES[sdt]
        ring, scales = ring_inputs(storage)

        # B1: shared and per-channel rotated filters
        row = {}
        for cf in (1, c):
            fr = torch.from_numpy((0.05 * rng.standard_normal((P, cf, b))).astype(np.float32)).to(dev)
            fi = torch.from_numpy((0.05 * rng.standard_normal((P, cf, b))).astype(np.float32)).to(dev)
            k_re, k_im = mac_mod.fdl_mac(ring, fr, fi, scales)
            p_re, p_im = mac_mod.fdl_mac_reference(ring, fr, fi, scales)
            torch.cuda.synchronize()
            d, r = rel_err(torch.cat([k_re, k_im]).cpu(), torch.cat([p_re, p_im]).cpu())
            assert r < TOL[storage], f"fdl_mac {storage} cf={cf}: rel err {r}"
            form = "shared" if cf == 1 else "per_channel"
            s_n, _, vec = mac_mod.mac_geometry(ring, fr, fi)
            ms = device_ms(lambda: mac_mod.fdl_mac(ring, fr, fi, scales), 20)
            row[form] = {"max_abs_err": d, "rel_err": r, "ms": ms, "splits": s_n, "vec": vec,
                         **bound_of(headline.fdl_mac_work(storage, P, c, b, cf), ms),
                         "plain_ms": cuda_ms(lambda: mac_mod.fdl_mac_reference(ring, fr, fi, scales), 3)}
        emit(phase="kernel_vs_plain", kernel="fdl_mac", storage=storage, tol=TOL[storage], **row, **card)
        summary["fdl_mac"][storage] = row["shared"] | {"per_channel": row["per_channel"]}

        # shared fused filter [2P, 1, 2B] in the matrix dtype
        rim = torch.from_numpy((0.05 * rng.standard_normal((2 * P, 1, 2 * b))).astype(np.float32)).to(dev, mdt)

        # B2 at three ring positions
        cs, ab = mb.packed_mats(n, mdt, dev)
        worst = (0.0, 0.0)
        for pos in (0, P // 2, P - 1):
            frame = torch.from_numpy(rng.uniform(-1, 1, (c, n)).astype(np.float32)).to(dev)
            dcfix = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32)).to(dev)
            k_ring, p_ring = ring.clone(), ring.clone()
            k_scl = None if scales is None else scales.clone()
            p_scl = None if scales is None else scales.clone()
            ky = fs_mod.fused_block_step(frame, k_ring, rim, pos, dcfix, cs, ab, k_scl)[0]
            py = fs_mod.fused_block_step_reference(frame, p_ring, rim, pos, dcfix, cs, ab, p_scl)[0]
            torch.cuda.synchronize()
            d, r = rel_err(ky.cpu(), py.cpu())
            assert r < TOL[storage], f"fused_block_step {storage} pos={pos}: rel err {r}"
            check_ring(storage, k_ring, p_ring, k_scl, p_scl, f"fused_block_step {storage} pos={pos}",
                       exact_ring(fs_mod.fused_block_step_reference, frame, ring, rim, pos, dcfix, cs, ab, scales))
            worst = max(worst, (d, r), key=lambda x: x[1])
        step_ms = cuda_ms(lambda: fs_mod.fused_block_step(frame, k_ring, rim, 3, dcfix, cs, ab, k_scl), 20)
        step_plain = cuda_ms(lambda: fs_mod.fused_block_step_reference(frame, p_ring, rim, 3, dcfix, cs, ab, p_scl), 3)
        summary["fused_block_step"][storage] = {"max_abs_err": worst[0], "rel_err": worst[1],
                                                "ms": step_ms, "plain_ms": step_plain,
                                                "stages_us": stage_us(lambda: fs_mod.fused_block_step(
                                                    frame, k_ring, rim, 3, dcfix, cs, ab, k_scl), b2_need)}
        emit(phase="kernel_vs_plain", kernel="fused_block_step", storage=storage, tol=TOL[storage],
             positions=[0, P // 2, P - 1], **summary["fused_block_step"][storage], **card)

        # B3 over 64 blocks from pos0 = P-5 (wraps the ring)
        nb, pos0 = 64, P - 5
        cs2, abt = mb.packed_stream_mats(n, mdt, dev)
        sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(dev)
        dcfix_all = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(dev)
        k_ring, p_ring = ring.clone(), ring.clone()
        k_scl = None if scales is None else scales.clone()
        p_scl = None if scales is None else scales.clone()
        ko = fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl)[0]
        po = fs_mod.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix_all, cs2, abt, p_scl)[0]
        torch.cuda.synchronize()
        d, r = rel_err(ko.cpu(), po.cpu())
        assert r < TOL[storage], f"fused_stream {storage}: rel err {r}"
        check_ring(storage, k_ring, p_ring, k_scl, p_scl, f"fused_stream {storage}",
                   exact_ring(fs_mod.fused_stream_reference, sigpad, ring, rim, pos0, dcfix_all, cs2, abt, scales))
        s_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl), 3)
        s_plain = cuda_ms(lambda: fs_mod.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix_all, cs2, abt, p_scl), 1)
        b3_stages = stage_us(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl),
                             b3_need)
        summary["fused_stream"][storage] = {"max_abs_err": d, "rel_err": r, "ms": s_ms, "plain_ms": s_plain,
                                            "blocks": nb, "us_per_block": 1e3 * s_ms / nb, "stages_us": b3_stages}
        emit(phase="kernel_vs_plain", kernel="fused_stream", storage=storage, tol=TOL[storage],
             pos0=pos0, **summary["fused_stream"][storage], **card)

        # the stage kernels on B3's window (the 64 blocks above) and B2's
        # block, each against its plain version on the same inputs
        w_spec = fs_mod.window_forward(sigpad, cs2, 0, nb)
        w_x, w_scl = fs_mod.quantize_rows(w_spec, sdt)
        w_acc = fs_mod.stream_mac(ring, scales, w_x, w_scl, rim, dcfix_all, pos0)
        w_part = fs_mod.step_mac(ring, scales, rim, 3)
        wb_ring = [ring.clone(), ring.clone()]
        wb_scl = [None if scales is None else scales.clone() for _ in range(2)]
        inv_out = [torch.zeros((c, nb * b), device=dev) for _ in range(2)]
        stage_calls = {  # name: (kernel result, plain result)
            "window_forward": (lambda: w_spec, lambda: fs_mod.window_forward_reference(sigpad, cs2, 0, nb)),
            "quantize_rows": (lambda: w_x, lambda: fs_mod.quantize_rows_reference(w_spec, sdt)[0]),
            "stream_mac": (lambda: w_acc, lambda: fs_mod.stream_mac_reference(ring, scales, w_x, w_scl, rim,
                                                                                dcfix_all, pos0)),
            "ring_writeback": (lambda: fs_mod.ring_writeback(w_x, w_scl, wb_ring[0], wb_scl[0], pos0),
                               lambda: fs_mod.ring_writeback_reference(w_x, w_scl, wb_ring[1], wb_scl[1], pos0)),
            "window_inverse": (lambda: fs_mod.window_inverse(w_acc, abt, inv_out[0], 0),
                               lambda: fs_mod.window_inverse_reference(w_acc, abt, inv_out[1], 0)),
            "step_mac": (lambda: w_part, lambda: fs_mod.step_mac_reference(ring, scales, rim, 3)),
            "step_reduce": (lambda: fs_mod.step_reduce(w_part, dcfix, mdt),
                            lambda: fs_mod.step_reduce_reference(w_part, dcfix, mdt)),
        }
        for name, (kernel_fn, plain_fn) in stage_calls.items():
            got, want = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            if name == "ring_writeback":  # a pure copy: rings and scales equal exactly
                assert torch.equal(got, want), f"{name} {storage}: rings differ"
                assert wb_scl[0] is None or torch.equal(wb_scl[0], wb_scl[1]), f"{name} {storage}: scales differ"
                d, r = 0.0, 0.0
            elif name == "quantize_rows" and storage in INT_MAX:  # rint ties may flip by 1 LSB
                lsb = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
                assert lsb <= 1, f"{name} {storage}: {lsb} LSB"
                d, r = float(lsb), 0.0
                assert rel_err(w_scl.cpu(), fs_mod.quantize_rows_reference(w_spec, sdt)[1].cpu())[1] < 1e-5
            else:
                d, r = rel_err(got.float().cpu(), want.float().cpu())
                assert r < TOL[storage], f"{name} {storage}: rel err {r}"
            stages[name][storage] = {"max_abs_err": d, "rel_err": r,
                                     "plain_ms": cuda_ms(plain_fn, 1)}
        b2_stages = summary["fused_block_step"][storage]["stages_us"]
        stage_alone = {  # each stage launched by itself on the operands above
            "window_forward": lambda: fs_mod.window_forward(sigpad, cs2, 0, nb),
            "quantize_rows": lambda: fs_mod.quantize_rows(w_spec, sdt),
            "stream_mac": lambda: fs_mod.stream_mac(ring, scales, w_x, w_scl, rim, dcfix_all, pos0),
            "ring_writeback": lambda: fs_mod.ring_writeback(w_x, w_scl, wb_ring[0], wb_scl[0], pos0),
            "window_inverse": lambda: fs_mod.window_inverse(w_acc, abt, inv_out[0], 0),
            "step_mac": lambda: fs_mod.step_mac(ring, scales, rim, 3),
            "step_reduce": lambda: fs_mod.step_reduce(w_part, dcfix, mdt),
        }
        for name in stage_calls:  # device ms of the stage within the B3 (B2) call timed above
            traced = b2_stages if name.startswith("step_") else b3_stages
            if name in traced:
                stages[name][storage]["ms"] = traced[name] / 1e3
            else:  # no trace of the call showed the stage: time it alone with CUDA events
                stages[name][storage]["ms"] = device_ms(stage_alone[name], 20)
                stages[name][storage]["ms_from"] = "the stage alone (CUDA events): the traces missed it"
        emit(phase="stage_vs_plain", storage=storage, tol=TOL[storage], blocks=nb, pos0=pos0,
             stages={k: v[storage] for k, v in stages.items() if storage in v}, **card)
        del w_spec, w_x, w_acc, w_part, wb_ring, inv_out
        del ring, scales, k_ring, p_ring
        torch.cuda.empty_cache()

    # ---- 3a. the transform kernels (shared-memory FFTs) at the main path's
    # shapes, with f32 and bf16 matrices: B3's window, B2's block, the hybrid
    # head's chunk, the largest fused block and a block with an odd factor
    transforms = {}
    for shape, tb, wc in (("b3_window", BLOCK, 64), ("b2_block", BLOCK, 1), ("hybrid_head", BLOCK, S_HYBRID),
                          ("b1024", 1024, 64), ("b768_odd3", 768, 64)):
        tn = 2 * tb
        sig_t = torch.from_numpy(rng.uniform(-1, 1, (c, (wc + 1) * tb)).astype(np.float32)).to(dev)
        acc_t = torch.from_numpy(rng.standard_normal((wc, c, tn)).astype(np.float32)).to(dev)
        for mdt in (torch.float32, torch.bfloat16):
            tol = TOL["split"] if mdt == torch.float32 else TOL["bf16"]
            if shape == "b2_block":  # B2's operands: the frame, [2, N, B] and all N samples
                fwd, inv = mb.packed_mats(tn, mdt, dev)
                inv = inv.reshape(tn, tn)
            else:
                fwd, inv = mb.packed_stream_mats(tn, mdt, dev)
            out_t = [torch.zeros((c, wc * inv.shape[1]), device=dev) for _ in range(2)]
            calls = {"window_forward": (lambda: fs_mod.window_forward(sig_t, fwd, 0, wc),
                                        lambda: fs_mod.window_forward_reference(sig_t, fwd, 0, wc),
                                        headline.transform_work(wc * c, tn, c * (wc + 1) * tb * 4, tn)),
                     "window_inverse": (lambda: fs_mod.window_inverse(acc_t, inv, out_t[0], 0),
                                        lambda: fs_mod.window_inverse_reference(acc_t, inv, out_t[1], 0),
                                        headline.transform_work(wc * c, tn, wc * c * tn * 4, inv.shape[1]))}
            for name, (kernel_fn, plain_fn, work) in calls.items():
                got, want = kernel_fn(), plain_fn()
                torch.cuda.synchronize()
                d, r = rel_err(got.cpu(), want.cpu())
                assert r < tol, f"{name} {shape} {mdt}: rel err {r}"
                ms = device_ms(kernel_fn, 20)
                transforms[f"{name}/{shape}/{str(mdt)[6:]}"] = {
                    "block": tb, "blocks": wc, "channels": c, "max_abs_err": d, "rel_err": r, "tol": tol,
                    "ms": ms, "plain_ms": cuda_ms(plain_fn, 1), **bound_of(work, ms)}
            del out_t
        del sig_t, acc_t
    emit(phase="transform_shapes", rows=transforms, **card)
    torch.cuda.empty_cache()

    # ---- 3b. the nested and hybrid engines' kernels at their shapes
    k = BLOCK + 1
    for engine, s_e in (("nested", S_NESTED), ("hybrid_tail", S_HYBRID)):
        p_tail = P_REAL - (S_HYBRID if engine == "hybrid_tail" else 0)
        p2 = -(-p_tail // s_e)
        l = 2 * s_e
        for storage in STORAGES:
            sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
            g = ne._quant_groups(cv.PartitionedConfig(BLOCK, P_REAL, c, storage=storage), s_e)
            if storage in INT_MAX:
                m = INT_MAX[storage]
                planes = torch.randint(-m, m + 1, (2, p2, c, k, l), device=dev,
                                       generator=torch.Generator(dev).manual_seed(3)).to(sdt)
                scales = torch.rand((p2, c, k, g), device=dev,
                                    generator=torch.Generator(dev).manual_seed(4)) * 40 + 1
            else:
                planes = torch.randn((2, p2, c, k, l), device=dev,
                                     generator=torch.Generator(dev).manual_seed(3)).mul_(10).to(sdt)
                scales = None
            tiled = torch.from_numpy((0.05 * rng.standard_normal((2, 2 * p2, 1, k, l))).astype(np.float32)).to(dev)
            worst = (0.0, 0.0)
            for pos in (0, p2 - 1):
                fr = tiled[0, p2 - 1 - pos : 2 * p2 - 1 - pos, 0]
                fi = tiled[1, p2 - 1 - pos : 2 * p2 - 1 - pos, 0]
                k_re, k_im = nm_mod.nested_mac(planes, scales, fr, fi)
                p_re, p_im = nm_mod.nested_mac_reference(planes, scales, fr, fi)
                torch.cuda.synchronize()
                d, r = rel_err(torch.cat([k_re, k_im]).cpu(), torch.cat([p_re, p_im]).cpu())
                assert r < TOL[storage], f"nested_mac {engine} {storage} pos={pos}: rel err {r}"
                worst = max(worst, (d, r), key=lambda x: x[1])
                del k_re, k_im, p_re, p_im
            ms = cuda_ms(lambda: nm_mod.nested_mac(planes, scales, fr, fi), 20)
            plain = cuda_ms(lambda: nm_mod.nested_mac_reference(planes, scales, fr, fi), 2)
            nbytes = (planes.numel() * planes.element_size() + 2 * fr.numel() * 4
                      + (0 if scales is None else scales.numel() * 4))
            row = {"max_abs_err": worst[0], "rel_err": worst[1], "ms": ms, "plain_ms": plain,
                   "planes": list(planes.shape), "groups": g, "mbytes": nbytes / 1e6,
                   "gbytes_per_s": nbytes / ms / 1e6}
            summary["nested_mac"].setdefault(engine, {})[storage] = row
            emit(phase="kernel_vs_plain", kernel="nested_mac", shapes=engine, storage=storage,
                 tol=TOL[storage], positions=[0, p2 - 1], **row, **card)
            del planes, scales, tiled
            torch.cuda.empty_cache()

    # B3 with acc_add on the hybrid head (P = S = 64): the head's storages
    # are split and int16 (int8 keeps an int16 head)
    ph = S_HYBRID
    summary["fused_stream_acc_add"] = {}
    summary["fdl_mac_head"] = {}
    for storage in ("split", "int16"):
        sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
        mdt = fs_mod.MATRIX_DTYPES[sdt]
        if storage in INT_MAX:
            ring = torch.from_numpy(rng.integers(-32767, 32768, (2, ph, c, b), dtype=np.int32)).to(dev, sdt)
            scales = torch.from_numpy(rng.uniform(1.0, 40.0, (ph, c)).astype(np.float32)).to(dev)
        else:
            ring = torch.from_numpy((10 * rng.standard_normal((2, ph, c, b))).astype(np.float32)).to(dev)
            scales = None
        rim = torch.from_numpy((0.05 * rng.standard_normal((2 * ph, 1, 2 * b))).astype(np.float32)).to(dev, mdt)
        nb, pos0 = 64, ph - 5
        cs2, abt = mb.packed_stream_mats(n, mdt, dev)
        sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(dev)
        dcfix_all = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(dev)
        seed = torch.from_numpy((20 * rng.standard_normal((nb, 2, c, b))).astype(np.float32)).to(dev)
        k_ring, p_ring = ring.clone(), ring.clone()
        k_scl = None if scales is None else scales.clone()
        p_scl = None if scales is None else scales.clone()
        ko = fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl, acc_add=seed)[0]
        po = fs_mod.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix_all, cs2, abt, p_scl,
                                           acc_add=seed)[0]
        torch.cuda.synchronize()
        d, r = rel_err(ko.cpu(), po.cpu())
        assert r < TOL[storage], f"fused_stream acc_add {storage}: rel err {r}"
        check_ring(storage, k_ring, p_ring, k_scl, p_scl, f"fused_stream acc_add {storage}",
                   exact_ring(fs_mod.fused_stream_reference, sigpad, ring, rim, pos0, dcfix_all, cs2, abt, scales,
                              acc_add=seed))
        s_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl,
                                                   acc_add=seed), 3)
        s_plain = cuda_ms(lambda: fs_mod.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix_all, cs2,
                                                                abt, p_scl, acc_add=seed), 1)
        summary["fused_stream_acc_add"][storage] = {
            "max_abs_err": d, "rel_err": r, "ms": s_ms, "plain_ms": s_plain, "blocks": nb,
            "us_per_block": 1e3 * s_ms / nb,
            "stages_us": stage_us(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt,
                                                              k_scl, acc_add=seed), b3_need)}
        emit(phase="kernel_vs_plain", kernel="fused_stream", acc_add=True, storage=storage, partitions=ph,
             tol=TOL[storage], pos0=pos0, **summary["fused_stream_acc_add"][storage], **card)

        del ring, k_ring, p_ring
    torch.cuda.empty_cache()

    # B1 on the unfused head's non-packed bins, [2, 64, 64, 513], all four
    # storages (the head keeps split or int16; the others run the same kernel)
    for storage in STORAGES:
        sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
        if storage in INT_MAX:
            m = INT_MAX[storage]
            hring = torch.from_numpy(rng.integers(-m, m + 1, (2, ph, c, k), dtype=np.int32)).to(dev, sdt)
            scales = torch.from_numpy(rng.uniform(1.0, 40.0, (ph, c)).astype(np.float32)).to(dev)
        else:
            hring = torch.from_numpy((10 * rng.standard_normal((2, ph, c, k))).astype(np.float32)).to(dev, sdt)
            scales = None
        fr = torch.from_numpy((0.05 * rng.standard_normal((ph, 1, k))).astype(np.float32)).to(dev)
        fi = torch.from_numpy((0.05 * rng.standard_normal((ph, 1, k))).astype(np.float32)).to(dev)
        k_re, k_im = mac_mod.fdl_mac(hring, fr, fi, scales)
        p_re, p_im = mac_mod.fdl_mac_reference(hring, fr, fi, scales)
        torch.cuda.synchronize()
        d, r = rel_err(torch.cat([k_re, k_im]).cpu(), torch.cat([p_re, p_im]).cpu())
        assert r < TOL[storage], f"fdl_mac head K={k} {storage}: rel err {r}"
        s_n, _, vec = mac_mod.mac_geometry(hring, fr, fi)
        # device time with the host hidden; back to back, a loop of these
        # short calls is bound by the host (as the hybrid head is)
        ms = device_ms(lambda: mac_mod.fdl_mac(hring, fr, fi, scales), 50)
        summary["fdl_mac_head"][storage] = {
            "max_abs_err": d, "rel_err": r, "splits": s_n, "vec": vec,
            "ms": ms, "ms_back_to_back": cuda_ms(lambda: mac_mod.fdl_mac(hring, fr, fi, scales), 50),
            **bound_of(headline.fdl_mac_work(storage, ph, c, k), ms),
            "plain_ms": cuda_ms(lambda: mac_mod.fdl_mac_reference(hring, fr, fi, scales), 5)}
        if storage == "split":  # the bounds phase's hybrid-head row
            xc_h, fc_h = torch.complex(hring[0], hring[1]), torch.complex(fr[:, 0], fi[:, 0])
            head_lib = {"library_ms": cuda_ms(lambda: torch.einsum("pck,pk->ck", xc_h, fc_h), 50),
                        "library_call": "torch.einsum('pck,pk->ck') on complex64 at the hybrid head's "
                                        "[64, 64, 513] ring (inputs built outside)"}
            del xc_h, fc_h
        emit(phase="kernel_vs_plain", kernel="fdl_mac", shapes="hybrid_head", storage=storage,
             ring=list(hring.shape), tol=TOL[storage], **summary["fdl_mac_head"][storage], **card)
        del hring
    torch.cuda.empty_cache()

    # ---- 3c. the sparse kernels at the headline shapes, both masks
    ir = conv.normalize_impulse(torch.from_numpy(headline.make_ir(P_REAL, BLOCK).astype(np.float32))).numpy()
    parts = conv.uniform_partition(ir, BLOCK)
    assert parts.shape == (1, P_REAL, BLOCK + 1)
    parts_pad = np.concatenate([parts, np.zeros((1, P - P_REAL, k), parts.dtype)], axis=1)
    masks = {"band30": np.zeros((P, k), bool)}
    masks["band30"][: int(P * 0.3)] = True  # bench.py:298-299
    masks["perc30"] = np.concatenate(
        [conv.perceptual_mask(parts[0], SR, threshold_db=-30.0), np.zeros((P - P_REAL, k), bool)])
    mask_stats = {}
    for mname, mask in masks.items():
        prm = cv.filter_params(cv.PartitionedConfig(BLOCK, P, c, storage="bf16"), parts_pad, sparsity=mask,
                               device="cpu")
        cflags = prm["sp_c_flags"].numpy()
        pcf = fs_mod.fused_chunk_rows(torch.bfloat16, P, c, b)
        mask_stats[mname] = {
            "bins_kept": float(mask.mean()),
            "chunk_density_bf16": float(cflags.sum(1).mean() / (P // pcf)),
            "chunk_rows_bf16": pcf, "chunk_entries_per_row": int(cflags.shape[1]),
            "tile_density_bf16": float(prm["sp_flags"].numpy().sum(1).mean()
                                       / ((P // mac_mod.choose_chunks(torch.bfloat16, P, c, b)[1]) * 2)),
        }
        emit(phase="sparse_masks", mask=mname, **mask_stats[mname])

    sp_sum = {"sparse_fdl_mac": {}, "fused_block_step_sched": {}, "fused_stream_sched": {}}
    gen = torch.Generator(dev).manual_seed(11)
    for storage in STORAGES:
        sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
        mdt = fs_mod.MATRIX_DTYPES[sdt]
        for mname, mask in masks.items():
            key = f"{storage}/{mname}"
            prm = cv.filter_params(cv.PartitionedConfig(BLOCK, P, c, storage=storage), parts_pad,
                                   sparsity=mask, device=dev)
            ring, scales = ring_inputs(storage)

            # B4 on the packed K = 512 ring: the IR's shared masked filter and
            # a random per-channel masked filter, against its plain version
            # and against B1 on the same masked filter
            k_tile, pc = mac_mod.choose_chunks(sdt, P, c, b)
            tables = (prm["sp_k_idx"], prm["sp_p_idx"], prm["sp_flags"])
            live = prm["tile_live"]  # the schedule's tile-live table, as the convolver passes it
            m_dev = torch.from_numpy(mask[:, :b]).to(dev)[:, None, :]
            rnd = [torch.randn((P, c, b), device=dev, generator=gen).mul_(0.05).mul_(m_dev) for _ in range(2)]
            filters = {"shared": (prm["filt_re"], prm["filt_im"]),
                       "per_channel": tuple(torch.cat([f.flip(0)] * 2) for f in rnd)}
            row = {"k_tile": k_tile, "p_chunk": pc}

            def b4_row(ring_, scales_, tre, tim, tables_, live_, pc_, kt_, k_):
                """B4 at three positions against its plain version and against
                B1 on the same masked filter (difference 0.0 required); then
                its time at the last position, with that row's bound."""
                worst, vs_dense = (0.0, 0.0), 0.0
                for pos in (0, P // 2 + 1, P - 1):
                    fr, fi = tre[P - 1 - pos : 2 * P - 1 - pos], tim[P - 1 - pos : 2 * P - 1 - pos]
                    got = sm_mod.sparse_fdl_mac(ring_, fr, fi, pos, *tables_, scales_, p_chunk=pc_, k_tile=kt_,
                                                live=live_)
                    want = sm_mod.sparse_fdl_mac_reference(ring_, fr, fi, pos, *tables_, scales_, p_chunk=pc_,
                                                           k_tile=kt_)
                    dense = mac_mod.fdl_mac(ring_, fr, fi, scales_)
                    torch.cuda.synchronize()
                    d, r = rel_err(torch.cat(got).cpu(), torch.cat(want).cpu())
                    assert r < TOL[storage], f"sparse_fdl_mac K={k_} {key} pos={pos}: rel err {r}"
                    worst = max(worst, (d, r), key=lambda x: x[1])
                    vs_dense = max(vs_dense, rel_err(torch.cat(got).cpu(), torch.cat(dense).cpu())[0])
                assert vs_dense == 0.0, f"sparse_fdl_mac K={k_} {key}: differs from fdl_mac by {vs_dense}"
                s_n, _, vec = mac_mod.mac_geometry(ring_, fr, fi)
                ms = device_ms(lambda: sm_mod.sparse_fdl_mac(ring_, fr, fi, pos, *tables_, scales_, p_chunk=pc_,
                                                             k_tile=kt_, live=live_), 20)
                pairs, rows = headline.tile_live(*(t[pos].cpu() for t in tables_), pc_, kt_, k_)
                return {"max_abs_err": worst[0], "rel_err": worst[1], "max_abs_diff_vs_fdl_mac": vs_dense,
                        "splits": s_n, "vec": vec, "ms": ms,
                        **bound_of(headline.sparse_fdl_mac_work(storage, c, k_, pairs, rows, tre.shape[1]), ms),
                        "fdl_mac_ms": device_ms(lambda: mac_mod.fdl_mac(ring_, fr, fi, scales_), 20),
                        "ms_back_to_back": cuda_ms(lambda: sm_mod.sparse_fdl_mac(
                            ring_, fr, fi, pos, *tables_, scales_, p_chunk=pc_, k_tile=kt_, live=live_), 20)}

            for form, (tre, tim) in filters.items():
                row[form] = b4_row(ring, scales, tre, tim, tables, live, pc, k_tile, b)
                fr, fi = tre[: P], tim[: P]  # position P - 1
                row[form]["plain_ms"] = cuda_ms(lambda: sm_mod.sparse_fdl_mac_reference(
                    ring, fr, fi, P - 1, *tables, scales, p_chunk=pc, k_tile=k_tile), 3)
            del rnd, filters
            # B4 on a non-packed K = 513 ring (a ragged third k-tile)
            if storage in ("split", "int16"):
                prm_u = cv.filter_params(cv.PartitionedConfig(BLOCK, P, c, storage=storage, packed=False),
                                         parts_pad, sparsity=mask, device=dev)
                if storage in INT_MAX:
                    ring_u = torch.randint(-32767, 32768, (2, P, c, k), device=dev, generator=gen).to(sdt)
                else:
                    ring_u = torch.randn((2, P, c, k), device=dev, generator=gen).mul_(10)
                kt_u, pc_u = mac_mod.choose_chunks(sdt, P, c, k)
                tables_u = (prm_u["sp_k_idx"], prm_u["sp_p_idx"], prm_u["sp_flags"])
                row["unpacked_k513"] = {"k_tile": kt_u, "p_chunk": pc_u, **b4_row(
                    ring_u, scales, prm_u["filt_re"], prm_u["filt_im"], tables_u, prm_u["tile_live"], pc_u, kt_u, k)}
                fr_p, fi_p = prm_u["filt_re"][:P], prm_u["filt_im"][:P]  # position P - 1
                row["unpacked_k513"]["plain_ms"] = cuda_ms(lambda: sm_mod.sparse_fdl_mac_reference(
                    ring_u, fr_p, fi_p, P - 1, *tables_u, scales, p_chunk=pc_u, k_tile=kt_u), 3)
                if storage == "split" and mname == "band30":  # the bounds phase's K = 513 row
                    fr_u, fi_u = prm_u["filt_re"][:P], prm_u["filt_im"][:P]
                    xc_u = torch.complex(ring_u[0], ring_u[1])
                    fc_u = torch.complex(fr_u[:, 0], fi_u[:, 0])
                    k513_lib = {"library_ms": cuda_ms(lambda: torch.einsum("pck,pk->ck", xc_u, fc_u), 20),
                                "library_call": "torch.einsum('pck,pk->ck') over the band30-masked K = 513 "
                                                "filter (dense; inputs built outside)"}
                    k513_work = headline.sparse_fdl_mac_work(
                        "split", c, k, *headline.tile_live(*(t[P - 1].cpu() for t in tables_u), pc_u, kt_u, k))
                    del xc_u, fc_u
                del prm_u, ring_u
            sp_sum["sparse_fdl_mac"][key] = row
            emit(phase="kernel_vs_plain", kernel="sparse_fdl_mac", storage=storage, mask=mname,
                 tol=TOL[storage], positions=[0, P // 2 + 1, P - 1], **row, **card)

            # B2 with the chunk schedule at three positions, against its
            # plain version and against the dense B2 on the same masked filter
            sched = (prm["sp_c_idx"], prm["sp_c_flags"])
            rim = prm["filt_rim"]
            cs, ab = mb.packed_mats(n, mdt, dev)
            worst, vs_dense = (0.0, 0.0), 0.0
            for pos in (0, P // 2 + 1, P - 1):
                frame = torch.from_numpy(rng.uniform(-1, 1, (c, n)).astype(np.float32)).to(dev)
                dcfix = torch.from_numpy(rng.standard_normal((2, c)).astype(np.float32)).to(dev)
                rings = [ring.clone() for _ in range(3)]
                scl = [None if scales is None else scales.clone() for _ in range(3)]
                ky = fs_mod.fused_block_step(frame, rings[0], rim, pos, dcfix, cs, ab, scl[0], sched)[0]
                py = fs_mod.fused_block_step_reference(frame, rings[1], rim, pos, dcfix, cs, ab, scl[1], sched)[0]
                dy = fs_mod.fused_block_step(frame, rings[2], rim, pos, dcfix, cs, ab, scl[2])[0]
                torch.cuda.synchronize()
                d, r = rel_err(ky.cpu(), py.cpu())
                assert r < TOL[storage], f"fused_block_step sched {key} pos={pos}: rel err {r}"
                check_ring(storage, rings[0], rings[1], scl[0], scl[1], f"fused_block_step sched {key}",
                           exact_ring(fs_mod.fused_block_step_reference, frame, ring, rim, pos, dcfix, cs, ab,
                                      scales, sched=sched))
                assert torch.equal(rings[0], rings[2]), f"fused_block_step sched {key}: ring differs from dense"
                worst = max(worst, (d, r), key=lambda x: x[1])
                vs_dense = max(vs_dense, rel_err(ky.cpu(), dy.cpu())[0])
            k_ring = rings[0]
            k_scl = scl[0]
            sp_sum["fused_block_step_sched"][key] = {
                "max_abs_err": worst[0], "rel_err": worst[1], "max_abs_diff_vs_dense_kernel": vs_dense,
                "stages_us": stage_us(lambda: fs_mod.fused_block_step(frame, k_ring, rim, 3, dcfix, cs, ab, k_scl,
                                                                      sched), b2_need + ("sched_widths",)),
                "ms": cuda_ms(lambda: fs_mod.fused_block_step(frame, k_ring, rim, 3, dcfix, cs, ab, k_scl, sched), 20),
                "dense_ms": cuda_ms(lambda: fs_mod.fused_block_step(frame, k_ring, rim, 3, dcfix, cs, ab, k_scl), 20),
                "plain_ms": cuda_ms(lambda: fs_mod.fused_block_step_reference(frame, k_ring, rim, 3, dcfix, cs, ab,
                                                                              k_scl, sched), 3)}
            emit(phase="kernel_vs_plain", kernel="fused_block_step", sched=True, storage=storage, mask=mname,
                 tol=TOL[storage], positions=[0, P // 2 + 1, P - 1], **sp_sum["fused_block_step_sched"][key],
                 **card)
            del rings, scl

            # B3 with the chunk schedule over 64 blocks from P-5 (wraps)
            nb, pos0 = 64, P - 5
            cs2, abt = mb.packed_stream_mats(n, mdt, dev)
            sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(dev)
            dcfix_all = torch.from_numpy(rng.standard_normal((nb, 2, c)).astype(np.float32)).to(dev)
            rings = [ring.clone() for _ in range(3)]
            scl = [None if scales is None else scales.clone() for _ in range(3)]
            ko = fs_mod.fused_stream(sigpad, rings[0], rim, pos0, dcfix_all, cs2, abt, scl[0], sched)[0]
            po = fs_mod.fused_stream_reference(sigpad, rings[1], rim, pos0, dcfix_all, cs2, abt, scl[1], sched)[0]
            do = fs_mod.fused_stream(sigpad, rings[2], rim, pos0, dcfix_all, cs2, abt, scl[2])[0]
            torch.cuda.synchronize()
            d, r = rel_err(ko.cpu(), po.cpu())
            assert r < TOL[storage], f"fused_stream sched {key}: rel err {r}"
            check_ring(storage, rings[0], rings[1], scl[0], scl[1], f"fused_stream sched {key}",
                       exact_ring(fs_mod.fused_stream_reference, sigpad, ring, rim, pos0, dcfix_all, cs2, abt,
                                  scales, sched=sched))
            assert torch.equal(rings[0], rings[2]), f"fused_stream sched {key}: ring differs from dense"
            k_ring, k_scl = rings[0], scl[0]
            s_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl,
                                                       sched), 3)
            d_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl), 3)
            # the schedule's width table against its plain version
            pcf = fs_mod.fused_chunk_rows(sdt, P, c, b)
            tab = fs_mod.sched_widths(sched, b, pcf)
            assert torch.equal(tab, fs_mod.sched_widths_reference(sched, b, pcf)), f"sched_widths {key}"
            b3s_stages = stage_us(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt,
                                                              k_scl, sched), b3_need + ("sched_widths",))
            widths_ms = (b3s_stages["sched_widths"] / 1e3 if "sched_widths" in b3s_stages  # else timed alone
                         else device_ms(lambda: fs_mod.sched_widths(sched, b, pcf), 20))
            stages["sched_widths"][key] = {
                "max_abs_err": 0.0, "rel_err": 0.0, "ms": widths_ms,
                "plain_ms": cuda_ms(lambda: fs_mod.sched_widths_reference(sched, b, pcf), 1),
                "table": list(tab.shape)}
            sp_sum["fused_stream_sched"][key] = {
                "max_abs_err": d, "rel_err": r, "max_abs_diff_vs_dense_kernel": rel_err(ko.cpu(), do.cpu())[0],
                "stages_us": b3s_stages,
                "ms": s_ms, "dense_ms": d_ms, "blocks": nb, "us_per_block": 1e3 * s_ms / nb,
                "dense_us_per_block": 1e3 * d_ms / nb,
                "plain_ms": cuda_ms(lambda: fs_mod.fused_stream_reference(sigpad, k_ring, rim, pos0, dcfix_all,
                                                                          cs2, abt, k_scl, sched), 1)}
            emit(phase="kernel_vs_plain", kernel="fused_stream", sched=True, storage=storage, mask=mname,
                 tol=TOL[storage], pos0=pos0, **sp_sum["fused_stream_sched"][key], **card)
            del ring, scales, rings, scl, prm, k_ring
            torch.cuda.empty_cache()

    # ---- 4. the main path: UPOLS process per storage
    sig_np = np.random.default_rng(1).uniform(-1, 1, (CHANNELS, NB_MAIN * BLOCK)).astype(np.float32)
    sig = torch.from_numpy(sig_np).to(dev)

    t_len = NB_MAIN * BLOCK
    nfft = 1 << int(np.ceil(np.log2(t_len + ir.size)))
    x64 = sig_np[:SNR_CH].astype(np.float64)
    oracle = np.fft.irfft(np.fft.rfft(x64, nfft) * np.fft.rfft(ir.astype(np.float64), nfft)[None], nfft)[:, :t_len]

    def window(a, start):
        return np.asarray(a[:SNR_CH, start * BLOCK : (start + SNR_BLOCKS) * BLOCK], np.float64)

    kernels.reset_launch_counts()
    snrs = {}
    for storage in STORAGES:
        before = fs_mod.fused_stream.launches
        cvl = conv.Convolver(storage=storage, device=dev)
        cvl.filter(parts)
        assert cvl.config.num_partitions == P and cvl.config.channels == 1
        t0 = time.perf_counter()
        out = cvl.process(sig)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert tuple(out.shape) == (CHANNELS, t_len) and bool(torch.isfinite(out).all())
        assert fs_mod.fused_stream.launches > before, "process did not run fused_stream"
        assert cvl.state["pos"] == NB_MAIN % P
        snr = snr_db(window(out.cpu().numpy(), SNR_START), window(oracle, SNR_START))
        snrs[storage] = snr
        cls = SNR_CLASS_DB.get(storage)
        emit(phase="main_path", entry="Convolver.process", scheme="upols", storage=storage,
             channels=CHANNELS, partitions=P, block=BLOCK, blocks=NB_MAIN,
             snr_db_vs_f64=snr, snr_class_db=cls, first_call_s=dt, **card)
        if cls is not None:
            assert snr >= cls, f"{storage}: SNR {snr:.1f} dB below its {cls} dB class"
        del cvl, out
    torch.cuda.empty_cache()

    # ---- 5. the other entry points at the headline configuration
    nb5 = 32
    sig5 = sig[:, : nb5 * BLOCK].contiguous()
    for storage in ("split", "int8"):
        def fresh(scheme="upols"):
            v = conv.Convolver(scheme=scheme, storage=storage, device=dev)
            v.filter(parts)
            return v

        ref = fresh().process(sig5)
        results = {}

        a = fresh()
        blocks = torch.cat([a(sig5[:, i * BLOCK : (i + 1) * BLOCK]) for i in range(nb5)], dim=-1)
        results["__call__"] = rel_err(blocks.cpu(), ref.cpu())

        f = fresh()
        chunks, off, sizes = [], 0, (100, 700, 3, 512, 1000, 211, 0, 1537, 64)
        i = 0
        while off < sig5.shape[1]:
            k = sizes[i % len(sizes)]
            chunks.append(f(sig5[:, off : off + k]))
            off += k
            i += 1
        chunks.append(f.flush())
        got = torch.cat(chunks, dim=-1)
        want = torch.cat([torch.zeros((CHANNELS, BLOCK - 1), device=dev), ref], dim=-1)
        assert got.shape == want.shape and f.latency == BLOCK - 1
        results["fifo_flush"] = rel_err(got.cpu(), want.cpu())

        u = fresh()
        cfg_u = dataclasses.replace(u.config, channels=CHANNELS, fused=False)
        _, out_u = cv.process(cfg_u, u.params, cv.init_state(cfg_u, dev), sig5)
        results["fused=False"] = rel_err(out_u.cpu(), ref.cpu())

        for name, (d, r) in results.items():
            emit(phase="entry_point", entry=name, storage=storage, max_abs_err=d, rel_err=r,
                 tol=TOL[storage], against="process")
            assert r < TOL[storage], f"{name} ({storage}) disagrees with process: {r}"

        # UPOLA over P + 16 blocks (B2 per block) against UPOLS, both held
        # to the oracle on the steady-state window [P, P + 16)
        nbu = P + 16
        sigu = sig[:, : nbu * BLOCK].contiguous()
        out_a = fresh("upola").process(sigu).cpu().numpy()
        out_s = fresh().process(sigu).cpu().numpy()
        snr_a = snr_db(window(out_a, P), window(oracle, P))
        snr_s = snr_db(window(out_s, P), window(oracle, P))
        d, r = rel_err(out_a, out_s)
        emit(phase="entry_point", entry="upola.process", storage=storage, blocks=nbu,
             snr_db_vs_f64=snr_a, upols_snr_db_vs_f64=snr_s, max_abs_err=d, rel_err=r)
        if storage in SNR_CLASS_DB:
            assert snr_a >= SNR_CLASS_DB[storage] and r < TOL[storage], f"UPOLA {storage}: {snr_a} dB, {r}"
        else:
            assert abs(snr_a - snr_s) <= 3.0, f"UPOLA {storage}: {snr_a:.1f} vs UPOLS {snr_s:.1f} dB"

    windows = {}

    def read_window(path, expect, counts=None):
        """Read the launch counts of one main path (or take the ones given)
        and require each kernel of that path to have launched."""
        counts = kernels.launch_counts() if counts is None else counts
        windows[path] = counts
        emit(phase="launch_counts", path=path, **counts)
        for name in expect:
            assert counts[name] > 0, f"{name} was not launched on the {path} path"

    b3_stage_names = ("window_forward", "quantize_rows", "stream_mac", "ring_writeback", "window_inverse")
    b2_stage_names = ("window_forward", "quantize_rows", "ring_writeback", "step_mac", "step_reduce",
                      "window_inverse")
    read_window("perblock", ("fdl_mac", "fused_block_step", "fused_stream", *b3_stage_names, *b2_stage_names))

    # ---- 5b. the sparse main path: masked process per storage and mask,
    # SNR against an f64 UPOLS oracle over the masked spectra
    def masked_oracle(mask):
        """out_i = irfft(sum_p X_{i-p} H_p)[B:] over the SNR window, f64:
        X_j = rfft([block j-1 | block j], N), H_p the masked spectra."""
        h = parts[0].astype(np.complex128) * mask[:P_REAL]  # [P_REAL, K]
        j0 = SNR_START - P_REAL + 1
        x = np.concatenate([np.zeros((SNR_CH, BLOCK)), sig_np[:SNR_CH].astype(np.float64)], axis=1)
        frames = np.stack([x[:, j * BLOCK : (j + 2) * BLOCK] for j in range(j0, SNR_START + SNR_BLOCKS)], 1)
        spec = np.fft.rfft(frames, n)  # [SNR_CH, blocks, K]
        outs = []
        for i in range(SNR_START, SNR_START + SNR_BLOCKS):
            y = np.einsum("cpk,pk->ck", spec[:, i - j0 - np.arange(P_REAL)], h)
            outs.append(np.fft.irfft(y, n)[:, BLOCK:])
        return np.concatenate(outs, axis=1)

    kernels.reset_launch_counts()
    sparse_snrs = {}
    for mname, mask in masks.items():
        oracle_m = masked_oracle(mask)
        sparse_snrs[mname] = {}
        for storage in STORAGES:
            before = fs_mod.fused_stream.sched_launches
            cvl = conv.sparse_upols_convolver(sparsity=mask, storage=storage, device=dev)
            cvl.filter(parts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cvl.process(sig)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert tuple(out.shape) == (CHANNELS, t_len) and bool(torch.isfinite(out).all())
            assert fs_mod.fused_stream.sched_launches > before, "sparse process did not run fused_stream + sched"
            assert cvl.config.channels == CHANNELS and "sp_c_idx" in cvl.params
            snr = snr_db(window(out.cpu().numpy(), SNR_START), oracle_m)
            sparse_snrs[mname][storage] = snr
            cls = SNR_CLASS_DB.get(storage)
            emit(phase="main_path", entry="sparse_upols_convolver.process", mask=mname, storage=storage,
                 channels=CHANNELS, partitions=P, block=BLOCK, blocks=NB_MAIN, snr_db_vs_masked_f64=snr,
                 snr_class_db=cls, first_call_s=dt, **card)
            if cls is not None:
                assert snr >= cls, f"sparse {mname} {storage}: SNR {snr:.1f} dB below its {cls} dB class"
            del cvl, out
        torch.cuda.empty_cache()

    # the sparse convolver's other entry points (band30), each against process
    for storage in ("split", "int8"):
        mask = masks["band30"]

        def fresh_sparse():
            v = conv.sparse_upols_convolver(sparsity=mask, storage=storage, device=dev)
            v.filter(parts)
            return v

        ref_c = fresh_sparse()
        ref = ref_c.process(sig5)
        results = {}
        a = fresh_sparse()
        blocks = torch.cat([a(sig5[:, i * BLOCK : (i + 1) * BLOCK]) for i in range(nb5)], dim=-1)
        results["__call__"] = rel_err(blocks.cpu(), ref.cpu())
        cfg_u = dataclasses.replace(ref_c.config, fused=False)
        _, out_u = cv.process(cfg_u, ref_c.params, cv.init_state(cfg_u, dev), sig5)
        results["fused=False"] = rel_err(out_u.cpu(), ref.cpu())
        cfg_np = cv.PartitionedConfig(BLOCK, P, CHANNELS, storage=storage, packed=False)
        prm_np = cv.filter_params(cfg_np, parts_pad, sparsity=mask, device=dev)
        _, out_np = cv.process(cfg_np, prm_np, cv.init_state(cfg_np, dev), sig5)
        results["packed=False"] = rel_err(out_np.cpu(), ref.cpu())
        for name, (d, r) in results.items():
            emit(phase="entry_point", entry=f"sparse {name}", mask="band30", storage=storage, max_abs_err=d,
                 rel_err=r, tol=TOL[storage], against="sparse process")
            assert r < TOL[storage], f"sparse {name} ({storage}) disagrees with process: {r}"
        del ref_c, a, prm_np
    read_window("sparse", ("fused_stream_sched", "fused_block_step_sched", "sparse_fdl_mac", "sched_widths",
                           *b3_stage_names, *b2_stage_names))

    # ---- 6. the nested and hybrid main paths, SNR per storage
    sig2_np = np.random.default_rng(2).uniform(-1, 1, (CHANNELS, NB_NESTED * BLOCK)).astype(np.float32)
    sig2 = torch.from_numpy(sig2_np).to(dev)
    t2 = NB_NESTED * BLOCK
    nfft2 = 1 << int(np.ceil(np.log2(t2 + ir.size)))
    oracle2 = np.fft.irfft(np.fft.rfft(sig2_np[:SNR_CH].astype(np.float64), nfft2)
                           * np.fft.rfft(ir.astype(np.float64), nfft2)[None], nfft2)[:, :t2]
    engines = {
        "nested": (ne.nested_filter_params, ne.nested_init_state, ne.process_nested, S_NESTED, NB_NESTED),
        "hybrid": (hy.hybrid_filter_params, hy.hybrid_init_state, hy.process_hybrid, S_HYBRID, NB_HYBRID),
    }
    engine_snrs = {}
    outs_main = {}
    for name, (build, init, run, s_e, nb_e) in engines.items():
        kernels.reset_launch_counts()
        engine_snrs[name] = {}
        for storage in STORAGES:
            cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
            params = build(cfg, parts, s_e, device=dev)
            state = init(cfg, params)
            x = sig2[:, : nb_e * BLOCK]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = run(cfg, params, state, x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert tuple(out.shape) == (CHANNELS, nb_e * BLOCK) and bool(torch.isfinite(out).all())
            out_np = out.cpu().numpy()
            snr = snr_db(window(out_np, SNR_START), window(oracle2, SNR_START))
            engine_snrs[name][storage] = snr
            cls = ENGINE_SNR_CLASS_DB[storage]
            extra = {}
            if name == "nested":
                extra["meta_ring"] = list(state["fdl"].shape)
            else:
                extra["meta_ring"] = list(state["meta_fdl"].shape)
                extra["fused_head"] = "head_dcny" in state
            emit(phase="main_path", entry=f"process_{name}", storage=storage, chunk_blocks=s_e,
                 channels=CHANNELS, partitions=P_REAL, block=BLOCK, blocks=nb_e, snr_db_vs_f64=snr,
                 snr_class_db=cls, first_call_s=dt, **extra, **card)
            assert snr >= cls, f"{name} {storage}: SNR {snr:.1f} dB below its {cls} dB class"
            if storage in ("split", "int8") and name == "hybrid":
                outs_main[storage] = out
            del params, state, out
        torch.cuda.empty_cache()
        read_window(name, ("nested_mac",) if name == "nested" else ("nested_mac", "fused_stream", "fdl_mac",
                                                                    *b3_stage_names))

    # ---- 7. the hybrid's and nested's other entry points
    kernels.reset_launch_counts()
    x = sig2[:, : NB_HYBRID * BLOCK]
    for storage in ("split", "int8"):
        cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
        params = hy.hybrid_filter_params(cfg, parts, S_HYBRID, device=dev)
        unfused = {key: v for key, v in params.items() if key != "head_packed"}
        _, ref_u = hy.process_hybrid(cfg, unfused, hy.hybrid_init_state(cfg, unfused), x)
        stream = hy.HybridStream(cfg, params)
        got = torch.cat([stream(x[:, i * BLOCK : (i + 1) * BLOCK]) for i in range(NB_HYBRID)], dim=-1)
        torch.cuda.synchronize()
        d_u, _ = rel_err(got.cpu(), ref_u.cpu())
        d_f, r_f = rel_err(got.cpu(), outs_main[storage].cpu())
        emit(phase="entry_point", entry="HybridStream.__call__", storage=storage, blocks=NB_HYBRID,
             max_abs_err_vs_unfused=d_u, tol_abs=STREAM_TOL[storage],
             rel_err_vs_fused=r_f, tol_rel=FUSED_HEAD_TOL[storage], against="process_hybrid")
        assert d_u < STREAM_TOL[storage], f"HybridStream {storage} vs unfused process_hybrid: {d_u}"
        assert r_f < FUSED_HEAD_TOL[storage], f"HybridStream {storage} vs fused process_hybrid: {r_f}"
        del stream, got, ref_u
    del outs_main
    cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage="int8")
    params = ne.nested_filter_params(cfg, parts, S_NESTED, device=dev)
    _, one = ne.process_nested(cfg, params, ne.nested_init_state(cfg, params), sig2)
    half = NB_NESTED // 2 * BLOCK
    st, a = ne.process_nested(cfg, params, ne.nested_init_state(cfg, params), sig2[:, :half])
    _, b2 = ne.process_nested(cfg, params, st, sig2[:, half:])
    d, r = rel_err(torch.cat([a, b2], dim=-1).cpu(), one.cpu())
    emit(phase="entry_point", entry="process_nested (state carried across two calls)", storage="int8",
         max_abs_err=d, rel_err=r, tol=1e-6, against="one call")
    assert r < 1e-6, f"process_nested across two calls differs from one call: {r}"
    del params, one, a, b2, st
    torch.cuda.empty_cache()
    read_window("hybrid_stream", ("fdl_mac", "nested_mac"))

    # ---- 7c-7e. the chunked engine's main path (no kernel of the port: its
    # product is torch.bmm, so its window expects none), make_engine over
    # the four engines, and convolve's seven methods
    kernels.reset_launch_counts()
    chunked_sum = run_chunked(dev, card, parts, sig2, oracle2, sig, masked_oracle, masks["perc30"], cuda_ms,
                              (peak_b, peak_f, harness.bf16_peak_flops_per_sec()))
    read_window("chunked", ())
    kernels.reset_launch_counts()
    make_engine_sum = run_engines(dev, card, parts, sig2)
    read_window("make_engine", ("fused_stream", "nested_mac", *b3_stage_names))
    kernels.reset_launch_counts()
    convolve_sum = run_convolve(dev, card, cuda_ms)
    # block 2048 (the 24 000-tap IR) is above B3's 1024: UPOLS and UPOLA step block by block through B1
    read_window("convolve", ("fdl_mac",))

    # ---- 7f-7h. the WAV-convolver CLI (its seven runs' reported calls
    # summed into one window), the real-time example's callback and
    # executor paths, and the fft/core/ops surface with a checkpoint
    cli_sum = run_cli(dev, card)
    read_window("cli", ("fused_stream", "fused_block_step", "nested_mac", "fdl_mac", "fused_stream_sched",
                        *b3_stage_names, *b2_stage_names), cli_sum["launches"])
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    executor_sum = run_executor(dev, card)
    read_window("executor", ("fdl_mac", "nested_mac"))
    kernels.reset_launch_counts()
    surface_sum = run_surface(dev, card)
    read_window("surface", ("fused_stream", *b3_stage_names))
    torch.cuda.empty_cache()

    # ---- 7i. the distributed engines: D0 (one NCCL rank here), D1 (two
    # gloo ranks of worker processes on this card), each path's launch
    # counts read in the rank that ran it and summed over the ranks
    dist_sum = run_dist(dev, card)
    for path, counts in dist_sum["windows"].items():
        read_window(path, DIST_EXPECT[path], counts)
    torch.cuda.empty_cache()

    # ---- 7j. the sweep tools' smoke grids (each tool's window summed into
    # one), each kernel call they made held against its plain version
    tools_sum = run_tools(dev, card, cuda_ms, device_ms, bound_of)
    read_window("tools", ("fdl_mac", "nested_mac", "fused_stream", "fused_stream_sched", *b3_stage_names),
                tools_sum["launches"])
    torch.cuda.empty_cache()

    # ---- 7b. probes T1 and T2 against their plain versions, the measurement
    # path in its own launch window, a profiler trace, and every kernel's bound
    emit(phase="probes", peaks={"hbm_bytes_per_s": peak_b, "f32_flops_per_s": peak_f, "note": no_peaks})
    probe_sum = {"probe_ring_read": run_ring_read(dev, card, rng, cuda_ms, device_ms, bound_of), "probe_stream": {}}
    nb = 64
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(dev)
    for mname, mdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cs2, abt = mb.packed_stream_mats(n, mdt, dev)
        tol = TOL["split" if mdt == torch.float32 else "bf16"]
        for mode in pr_mod.PROBE_MODES:
            got = pr_mod.probe_stream(sigpad, cs2, abt, mode)
            want = pr_mod.probe_stream_reference(sigpad, cs2, abt, mode)
            torch.cuda.synchronize()
            extra = {}
            if mode == "empty":
                d = r = float(got.abs().max())
                assert d == 0.0, f"probe_stream empty/{mname} wrote {d}"
            else:
                if mdt == torch.bfloat16:
                    # the transforms compute in f32 with f32 twiddles, more
                    # exactly than bf16 matrices (ROADMAP §C): T2 is held
                    # at its rounding points (frames, spectrum to bf16) on
                    # the f32 matrices; the bf16-matrix plain version's
                    # distance is printed beside
                    extra["rel_err_vs_bf16_matrix_plain"] = rel_err(got.cpu(), want.cpu())[1]
                    cs32, abt32 = mb.packed_stream_mats(n, torch.float32, dev)
                    spec = sigpad.to(mdt).double().unfold(1, n, b)[:, :nb] @ cs32.double()
                    want = (spec[..., :b] + spec[..., b:] if mode == "win_fwd"
                            else spec.float().to(mdt).double() @ abt32.double()).float().reshape(c, nb * b)
                    del spec
                d, r = rel_err(got.cpu(), want.cpu())
                assert r < tol, f"probe_stream {mode}/{mname}: rel err {r}"
            row = {"max_abs_err": d, "rel_err": r, **extra, "blocks": nb,
                   "ms": cuda_ms(lambda: pr_mod.probe_stream(sigpad, cs2, abt, mode), 5),
                   "plain_ms": cuda_ms(lambda: pr_mod.probe_stream_reference(sigpad, cs2, abt, mode), 2)}
            row["us_per_block"] = 1e3 * row["ms"] / nb
            probe_sum["probe_stream"][f"{mode}/{mname}"] = row
            emit(phase="probes", kernel="probe_stream", mode=mode, matrices=mname, tol=tol, **row, **card)
    del sigpad, got, want
    torch.cuda.empty_cache()

    # the measurement path: the tools' own rows at 64 and 256 iterations/blocks
    kernels.reset_launch_counts()
    short = (64, 256)
    meas = {}
    for storage in ("split", "bf16"):
        meas.update(roofline_cal.ring_rows(storage, short))
    for mode, mats in (("empty", ("float32",)), ("win_fwd", ("float32", "bfloat16")),
                       ("win_fwd_inv", ("float32", "bfloat16"))):
        for mat in mats:
            meas[f"{mode}/{mat}"] = {"us_per_block": fused_probe.probe_row(mode, mat, short)}
    for key, (p_row, zero) in (("b3/split/P960", (P, False)), ("b3_zero_sched/split/P960", (P, True)),
                               ("b3/split/P32", (32, False))):
        meas[key] = {"us_per_block": fused_probe.b3_row("split", p_row, short, zero_sched=zero)}
    torch.cuda.empty_cache()
    for key, row in meas.items():
        emit(phase="measurement", row=key, lengths=list(short), **row, **card)
    read_window("measurement", ("probe_ring_read", "probe_stream", "fdl_mac", "fused_stream",
                                "fused_stream_sched", *b3_stage_names, "sched_widths"))

    # a torch.profiler trace of one process call (bench.profile.trace)
    v = conv.Convolver(storage="split", device=dev)
    v.filter(parts)
    v.process(sig[:, :BLOCK])  # binds the 64 channels
    x = sig[:, : 64 * BLOCK].contiguous()
    with tempfile.TemporaryDirectory() as tmp:
        with bench_profile.trace(tmp) as prof:
            v.process(x)
            torch.cuda.synchronize()
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    per_key = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        per_key[e.key] = float(us if us is not None else getattr(e, "self_cuda_time_total", 0.0))
    dev_us = sum(per_key.values())
    emit(phase="profile", entry="Convolver.process", storage="split", blocks=64, trace_bytes=trace_bytes,
         device_time_us=dev_us, top=sorted(per_key.items(), key=lambda kv: -kv[1])[:4],
         note=None if dev_us > 0 else "key_averages shows no device time; the times here are CUDA events",
         **card)
    del v, x, prof

    # every kernel: bytes and operations, bound, share, one library call
    gen = torch.Generator(dev).manual_seed(21)
    lib = {}
    ring = torch.randn((2, P, c, b), device=dev, generator=gen)
    fr, fi = (torch.randn((P, 1, b), device=dev, generator=gen) for _ in range(2))
    xc, fc = torch.complex(ring[0], ring[1]), torch.complex(fr[:, 0], fi[:, 0])
    k_re, k_im = mac_mod.fdl_mac(ring, fr, fi)
    ein = torch.einsum("pck,pk->ck", xc, fc)
    lib["fdl_mac"] = {"library_ms": cuda_ms(lambda: torch.einsum("pck,pk->ck", xc, fc), 20),
                      "library_call": "torch.einsum('pck,pk->ck') on complex64 (inputs built outside)",
                      "library_rel_diff": rel_err(torch.cat([ein.real, ein.imag]).cpu(),
                                                  torch.cat([k_re, k_im]).cpu())[1]}
    m_dev = torch.from_numpy(masks["band30"][:, :b]).to(dev)
    fcm = fc * m_dev
    lib["sparse_fdl_mac"] = {"library_ms": cuda_ms(lambda: torch.einsum("pck,pk->ck", xc, fcm), 20),
                             "library_call": "torch.einsum('pck,pk->ck') over the band30-masked filter "
                                             "(dense: no sparse library call of this shape)"}
    del ring, xc, fc, fcm, ein, k_re, k_im
    p2n, kb = -(-P_REAL // S_NESTED), BLOCK + 1  # the nested meta ring [2, 8, 64, 513, 256]
    planes = torch.randn((2, p2n, c, kb, 2 * S_NESTED), device=dev, generator=gen)
    tre, tim = (torch.randn((p2n, kb, 2 * S_NESTED), device=dev, generator=gen) for _ in range(2))
    pc_, tc_ = torch.complex(planes[0], planes[1]), torch.complex(tre, tim)
    lib["nested_mac"] = {"library_ms": cuda_ms(lambda: torch.einsum("pckm,pkm->ckm", pc_, tc_), 10),
                         "library_call": "torch.einsum('pckm,pkm->ckm') on complex64 (inputs built outside)"}
    del planes, tre, tim, pc_, tc_
    torch.cuda.empty_cache()
    # the stage kernels' yardsticks at B3's window of 64 blocks (split, f32 matrices)
    cs_l, abt_l = mb.packed_stream_mats(n, torch.float32, dev)
    sig_l = torch.randn((c, 65 * b), device=dev, generator=gen)
    frames = sig_l.unfold(1, n, b)[:, :64].transpose(0, 1).reshape(64 * c, n).contiguous()
    acc_l = torch.randn((64 * c, n), device=dev, generator=gen)
    spec_l = torch.complex(acc_l[:, : b + 1], acc_l[:, 1 : b + 2]).contiguous()  # B+1 bins, built outside
    lib["window_forward"] = {"library_ms": device_ms(lambda: torch.fft.rfft(frames, dim=-1), 20),
                             "library_call": "torch.fft.rfft (cuFFT) of the window's frames [4096, 1024] f32, "
                                             "built outside the timed region",
                             "matmul_ms": device_ms(lambda: torch.matmul(frames, cs_l), 20),
                             "matmul_call": "torch.matmul of the same frames and cs [1024, 1024], f32 "
                                            "(allow_tf32 False)"}
    lib["window_inverse"] = {"library_ms": device_ms(lambda: torch.fft.irfft(spec_l, n=n, dim=-1), 20),
                             "library_call": "torch.fft.irfft (cuFFT) of [4096, 513] complex64 bins, built "
                                             "outside the timed region, to all 1024 samples",
                             "matmul_ms": device_ms(lambda: torch.matmul(acc_l, abt_l), 20),
                             "matmul_call": "torch.matmul of the accumulators [4096, 1024] and abt [1024, 512], "
                                            "f32"}
    ring_l = torch.randn((2, P, c, b), device=dev, generator=gen)
    x_l = torch.randn((2, 64, c, b), device=dev, generator=gen)
    idx_l = (P - 5 + torch.arange(64, device=dev)) % P
    lib["ring_writeback"] = {"library_ms": cuda_ms(lambda: ring_l.index_copy_(1, idx_l, x_l), 20),
                             "library_call": "Tensor.index_copy_ of 64 staged rows into the ring's slots"}
    lib["step_mac"] = {"library_ms": lib["fdl_mac"]["library_ms"],
                       "library_call": "the B1 row's complex einsum: the same MAC over the same ring (one "
                                       "sum; the kernel's P splits are summed by step_reduce)"}
    del cs_l, abt_l, sig_l, frames, acc_l, spec_l, ring_l, x_l
    # stream_mac: per lane the Toeplitz product T_k H_k, one batched complex
    # matmul (Cf = 1, split), first held against the plain version at a
    # small shape so that it computes the same function
    r_s, x_s = (torch.randn(shape, device=dev, generator=gen) for shape in ((2, 24, 3, 32), (10, 2, 3, 32)))
    rim_s = torch.randn((48, 1, 64), device=dev, generator=gen)
    t_s, h_s = stream_mac_toeplitz(r_s, x_s, rim_s, 20)
    want = fs_mod.stream_mac_reference(r_s, None, x_s, None, rim_s, torch.zeros((10, 2, 3), device=dev), 20)
    with ieee_float32():
        got = torch.matmul(t_s, h_s).permute(1, 2, 0)  # [wc, C, B]
    yard_err = rel_err(torch.cat([got.real[..., 1:], got.imag[..., 1:]], -1).cpu(),
                       torch.cat([want[..., 1:32], want[..., 33:]], -1).cpu())[1]  # lane 0 is dcfix's
    assert yard_err < 1e-5, f"stream_mac's yardstick is not its function: {yard_err}"
    ring_l = torch.randn((2, P, c, b), device=dev, generator=gen)
    x_l = torch.randn((64, 2, c, b), device=dev, generator=gen)
    rim_l = torch.randn((2 * P, 1, n), device=dev, generator=gen) * 0.05
    t_l, h_l = stream_mac_toeplitz(ring_l, x_l, rim_l, P - 5)
    del ring_l, x_l, rim_l
    with ieee_float32():
        lib["stream_mac"] = {"library_ms": device_ms(lambda: torch.matmul(t_l, h_l), 10),
                             "library_call": "torch.matmul of T [512, 64, 1023] by H [512, 1023, 64], complex64, "
                                             "IEEE f32 (core.device.ieee_float32): per lane the Toeplitz matrix "
                                             "of the rim rows each block meets (untiled rim) by the history, "
                                             "built outside the timed region",
                             "library_rel_diff_small": yard_err}
    del t_l, h_l, r_s, x_s, rim_s, t_s, h_s
    torch.cuda.empty_cache()
    for name, note in (("quantize_rows", "a peak scale, rint and clamp per row are several calls"),
                       ("step_reduce", "sum, lane-0 overwrite and rounding are several calls"),
                       ("sched_widths", "a scatter-max of the chunk tables: no one call")):
        lib[name] = {"library_ms": None, "library_note": note}
    no_lib = "no single PyTorch call computes the fused block (DFT, ring insert, MAC, inverse DFT)"
    for name in ("fused_block_step", "fused_stream", "fused_block_step_sched", "fused_stream_sched"):
        lib[name] = {"library_ms": None, "library_note": no_lib}
    lib["probe_ring_read"] = {"library_ms": None,
                              "library_note": "a probe: no PyTorch call computes its two outputs"}
    lib["probe_stream"] = {"library_ms": None,
                           "library_note": "a probe: no single PyTorch call computes a window, packed DFT "
                                           "and rounded tail-half inverse"}

    prm_b30 = cv.filter_params(cv.PartitionedConfig(BLOCK, P, c, storage="split"), parts_pad,
                               sparsity=masks["band30"], device="cpu")
    k_tile, pc_t = mac_mod.choose_chunks(torch.float32, P, c, b)
    live_b4, rows_b4 = headline.tile_live(prm_b30["sp_k_idx"][P - 1], prm_b30["sp_p_idx"][P - 1],
                                          prm_b30["sp_flags"][P - 1], pc_t, k_tile, b)
    pcf = fs_mod.fused_chunk_rows(torch.float32, P, c, b)
    c_tabs = (prm_b30["sp_c_idx"].numpy(), prm_b30["sp_c_flags"].numpy())
    live_b2 = headline.chunk_visits(*c_tabs, 3, 1, pcf, b)[2][0]
    visits_b3 = headline.chunk_visits(*c_tabs, P - 5, 64, pcf, b)
    works = {  # at the shapes the kernel ms were timed at (split; sparse: band30)
        "fdl_mac": headline.fdl_mac_work("split", P, c, b),
        "fused_block_step": headline.fused_block_step_work("split", P, c, b),
        "fused_stream": headline.fused_stream_work("split", P, c, b, 64, pos0=P - 5),
        "nested_mac": headline.nested_mac_work("split", p2n, c, kb, 2 * S_NESTED),
        "sparse_fdl_mac": headline.sparse_fdl_mac_work("split", c, b, live_b4, rows_b4),
        "fused_block_step_sched": headline.fused_block_step_work("split", P, c, b, live=live_b2),
        "fused_stream_sched": headline.fused_stream_work("split", P, c, b, 64, pos0=P - 5, visits=visits_b3),
        "probe_ring_read": headline.ring_read_work("split", P, c, b, probe_sum["probe_ring_read"]["split"]["p_chunk"]),
        "probe_stream": headline.stream_probe_work(4, c, b, 64, "win_fwd_inv"),
        # the stage kernels: B3's window of 64 blocks, B2's block (split; sched_widths: band30)
        "window_forward": headline.transform_work(64 * c, n, c * 65 * b * 4, n),
        "quantize_rows": headline.quantize_work("split", 64 * c, b),
        "stream_mac": headline.stream_mac_work("split", P, c, b, 64),
        "ring_writeback": headline.writeback_work("split", 64, c, b),
        "window_inverse": headline.transform_work(64 * c, n, 64 * c * n * 4, b),
        "step_mac": headline.step_mac_work("split", P, c, b, mac_mod.step_geometry(P, c, b, 4)[0]),
        "step_reduce": headline.step_reduce_work(c, b, mac_mod.step_geometry(P, c, b, 4)[0]),
        "sched_widths": headline.sched_widths_work(P, c_tabs[0].shape[1], P // pcf),
        # B1 at the hybrid head's ring [2, 64, 64, 513], B4 at K = 513 (split; band30)
        "fdl_mac/hybrid_head": headline.fdl_mac_work("split", S_HYBRID, c, BLOCK + 1),
        "sparse_fdl_mac/k513": k513_work,
        # B1 at the block-4096 grid's largest ring [2, 32, 64, 4096] (split)
        "fdl_mac/grid4096": headline.fdl_mac_work("split", GRID_RING[1], c, GRID_RING[3]),
    }
    kernel_ms = {
        "fdl_mac": summary["fdl_mac"]["split"]["ms"],
        "fused_block_step": summary["fused_block_step"]["split"]["ms"],
        "fused_stream": summary["fused_stream"]["split"]["ms"],
        "nested_mac": summary["nested_mac"]["nested"]["split"]["ms"],
        "sparse_fdl_mac": sp_sum["sparse_fdl_mac"]["split/band30"]["shared"]["ms"],
        "fused_block_step_sched": sp_sum["fused_block_step_sched"]["split/band30"]["ms"],
        "fused_stream_sched": sp_sum["fused_stream_sched"]["split/band30"]["ms"],
        "probe_ring_read": probe_sum["probe_ring_read"]["split"]["ms"],
        "probe_stream": probe_sum["probe_stream"]["win_fwd_inv/float32"]["ms"],
        **{name: row["split"]["ms"] for name, row in stages.items() if name != "sched_widths"},
        "sched_widths": stages["sched_widths"]["split/band30"]["ms"],
        "fdl_mac/hybrid_head": summary["fdl_mac_head"]["split"]["ms"],
        "sparse_fdl_mac/k513": sp_sum["sparse_fdl_mac"]["split/band30"]["unpacked_k513"]["ms"],
        "fdl_mac/grid4096": tools_sum["grid_b1"]["ms"],
    }
    lib["fdl_mac/hybrid_head"] = head_lib
    lib["sparse_fdl_mac/k513"] = k513_lib
    lib["fdl_mac/grid4096"] = {k: tools_sum["grid_b1"][k] for k in ("library_ms", "library_call")}
    bounds = {}
    for name, work in works.items():
        row = {"bytes": work.bytes, "flops": work.flops, "bound_ms": None, "bound_by": None,
               "share_of_bound": None, "bound_note": no_peaks}
        if no_peaks is None:
            t, by = headline.bound(work, peak_b, peak_f)
            row.update(bound_ms=1e3 * t, bound_by=by, share_of_bound=1e3 * t / kernel_ms[name])
        bounds[name] = row | lib[name]
    # B3 block by block: the ring read every block (bench.py's fused bytes model)
    if no_peaks is None:
        pb = headline.perblock_bytes(cv.PartitionedConfig(BLOCK, P, c, storage="split", fused=True), P,
                                     fused=True)
        t_blk = max(pb / peak_b, works["fused_stream"].flops / 64 / peak_f)
        bounds["fused_stream"].update(block_by_block_bound_ms=64e3 * t_blk,
                                      block_by_block_share=64e3 * t_blk / kernel_ms["fused_stream"])
    for name, row in bounds.items():
        emit(phase="bounds", kernel=name, ms=kernel_ms[name], **row, **card)

    # ---- 8. times: kernel route vs the plain torch route
    nbt, nbp = 256, 32
    sig_t = sig[:, : nbt * BLOCK].contiguous()
    sig_p = sig[:, : nbp * BLOCK].contiguous()

    def median_s(fn, runs):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    times = {}
    for storage in STORAGES:
        v = conv.Convolver(storage=storage, device=dev)
        v.filter(parts)
        cfg_k = dataclasses.replace(v.config, channels=CHANNELS)
        cfg_p = dataclasses.replace(cfg_k, mac_backend="torch")
        st_k = cv.init_state(cfg_k, dev)
        st_p = cv.init_state(cfg_p, dev)
        s_k = median_s(lambda: cv.process(cfg_k, v.params, st_k, sig_t), 5) / nbt
        s_p = median_s(lambda: cv.process(cfg_p, v.params, st_p, sig_p), 3) / nbp
        times[storage] = {"kernel_us_per_block": 1e6 * s_k, "plain_us_per_block": 1e6 * s_p,
                          "kernel_samples_per_s": CHANNELS * BLOCK / s_k,
                          "plain_samples_per_s": CHANNELS * BLOCK / s_p}
        emit(phase="times", entry="process", storage=storage, kernel_blocks=nbt, plain_blocks=nbp,
             plain_route="mac_backend='torch' (cuFFT + tensor-op MAC)", **times[storage], **card)
        del v, st_k, st_p
        torch.cuda.empty_cache()

    # sparse process per storage and mask beside the dense process on the
    # unmasked filter (kernel routes), and the plain torch route with the mask
    sparse_times = {}
    for storage in STORAGES:
        routes = {"dense": None, **masks}
        sparse_times[storage] = {}
        for name, mask in routes.items():
            v = conv.sparse_upols_convolver(sparsity=mask, storage=storage, device=dev) if mask is not None \
                else conv.Convolver(storage=storage, device=dev)
            v.filter(parts)
            v.process(sig[:, :BLOCK])  # binds the 64 channels (and rebuilds the schedule)
            cfg_k = v.config
            st_k = cv.init_state(cfg_k, dev)
            row = {"kernel_us_per_block": 1e6 * median_s(lambda: cv.process(cfg_k, v.params, st_k, sig_t), 5) / nbt}
            if mask is not None:
                cfg_p = dataclasses.replace(cfg_k, mac_backend="torch")
                st_p = cv.init_state(cfg_p, dev)
                row["plain_us_per_block"] = 1e6 * median_s(lambda: cv.process(cfg_p, v.params, st_p, sig_p), 3) / nbp
                del st_p
            sparse_times[storage][name] = row
            del v, st_k
            torch.cuda.empty_cache()
        for name in masks:
            sparse_times[storage][name]["vs_dense"] = (sparse_times[storage][name]["kernel_us_per_block"]
                                                       / sparse_times[storage]["dense"]["kernel_us_per_block"])
        emit(phase="times", entry="sparse process", storage=storage, kernel_blocks=nbt, plain_blocks=nbp,
             plain_route="mac_backend='torch' (cuFFT + tensor-op MAC over the masked filter)",
             **sparse_times[storage], **card)

    # nested (10 chunks) and hybrid (4 chunks): µs per block, channel-samples/s
    engine_times = {}
    for name, (build, init, run, s_e, _) in engines.items():
        nb_t = {"nested": NB_NESTED, "hybrid": 4 * S_HYBRID}[name]
        x = sig2[:, : nb_t * BLOCK]
        engine_times[name] = {}
        for storage in STORAGES:
            cfg_k = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
            cfg_p = dataclasses.replace(cfg_k, mac_backend="torch")
            params = build(cfg_k, parts, s_e, device=dev)
            st_k, st_p = init(cfg_k, params), init(cfg_p, params)
            s_k = median_s(lambda: run(cfg_k, params, st_k, x), 3) / nb_t
            s_p = median_s(lambda: run(cfg_p, params, st_p, x), 3) / nb_t
            row = {"kernel_us_per_block": 1e6 * s_k, "plain_us_per_block": 1e6 * s_p,
                   "kernel_samples_per_s": CHANNELS * BLOCK / s_k,
                   "plain_samples_per_s": CHANNELS * BLOCK / s_p}
            engine_times[name][storage] = row
            emit(phase="times", entry=f"process_{name}", storage=storage, chunk_blocks=s_e, blocks=nb_t,
                 fused_head="head_dcny" in st_k if name == "hybrid" else None,
                 plain_route="mac_backend='torch' (cuFFT + tensor-op MACs)", **row, **card)
            del params, st_k, st_p
            torch.cuda.empty_cache()

    # HybridStream: per-callback latency, host clock around each callback
    # ending in a synchronize; the chunk-boundary callbacks carry the tail
    # refresh (meta-FFT, B5, inverse). Deadline: one block, 10 667 us.
    stream_lat = {}
    x = sig2[:, : NB_HYBRID * BLOCK]
    for storage in ("split", "int8"):
        cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
        stream = hy.HybridStream(cfg, hy.hybrid_filter_params(cfg, parts, S_HYBRID, device=dev))
        blocks = [x[:, i * BLOCK : (i + 1) * BLOCK].contiguous() for i in range(NB_HYBRID)]
        for blk in blocks[: 2 * S_HYBRID]:  # warm-up: two chunks
            stream(blk)
        stream.reset()
        lat = []
        for blk in blocks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream(blk)
            torch.cuda.synchronize()
            lat.append(1e6 * (time.perf_counter() - t0))
        lat = np.asarray(lat)
        boundary = (np.arange(NB_HYBRID) % S_HYBRID) == S_HYBRID - 1

        def stats(v):
            return {"p50_us": float(np.percentile(v, 50)), "p99_us": float(np.percentile(v, 99)),
                    "max_us": float(v.max()), "n": int(v.size)}

        stream_lat[storage] = {"block": stats(lat[~boundary]), "chunk_boundary": stats(lat[boundary])}
        emit(phase="times", entry="HybridStream.__call__", storage=storage, deadline_us=1e6 * BLOCK / SR,
             callbacks_over_deadline=int((lat > 1e6 * BLOCK / SR).sum()), **stream_lat[storage], **card)
        del stream, blocks

    # ---- 9. kernels summary and the final line
    sources = {
        "fdl_mac": ("neojax_torch/csrc/fdl_mac.cu", "neojax/kernels/fdl_mac.py:111"),
        "fused_block_step": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:330"),
        "fused_stream": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "nested_mac": ("neojax_torch/csrc/nested_mac.cu", "neojax/kernels/nested_mac.py:82"),
        "sparse_fdl_mac": ("neojax_torch/csrc/fdl_mac.cu", "neojax/kernels/sparse_mac.py:246"),
        "fused_block_step_sched": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:330"),
        "fused_stream_sched": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "probe_ring_read": ("neojax_torch/csrc/probes.cu", "tools/roofline_cal.py:143"),
        "probe_stream": ("neojax_torch/csrc/probes.cu", "tools/fused_probe.py:116"),
        # B2/B3's stage kernels (B3's lines; B2 runs the shared ones too)
        "window_forward": ("neojax_torch/csrc/transform.cu", "neojax/kernels/fused_step.py:791"),
        "quantize_rows": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "stream_mac": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "ring_writeback": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "window_inverse": ("neojax_torch/csrc/transform.cu", "neojax/kernels/fused_step.py:791"),
        "sched_widths": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "step_mac": ("neojax_torch/csrc/step_mac.cuh", "neojax/kernels/fused_step.py:330"),
        "step_reduce": ("neojax_torch/csrc/step_mac.cuh", "neojax/kernels/fused_step.py:330"),
    }
    by_storage = dict(summary)
    by_storage["fdl_mac"] = summary["fdl_mac"] | {"hybrid_head": summary["fdl_mac_head"]}
    by_storage["fused_stream"] = summary["fused_stream"] | {"acc_add_hybrid_head": summary["fused_stream_acc_add"]}
    heads = {name: summary[name]["split"] for name in ("fdl_mac", "fused_block_step", "fused_stream")}
    heads["nested_mac"] = summary["nested_mac"]["nested"]["split"]
    heads["sparse_fdl_mac"] = sp_sum["sparse_fdl_mac"]["split/band30"]["shared"]
    heads["fused_block_step_sched"] = sp_sum["fused_block_step_sched"]["split/band30"]
    heads["fused_stream_sched"] = sp_sum["fused_stream_sched"]["split/band30"]
    heads["probe_ring_read"] = probe_sum["probe_ring_read"]["split"]
    heads["probe_stream"] = probe_sum["probe_stream"]["win_fwd_inv/float32"]
    heads.update({name: row["split/band30" if name == "sched_widths" else "split"] for name, row in stages.items()})
    by_storage.update(stages)
    by_storage.update(sp_sum)
    by_storage.update(probe_sum)
    rows = []
    for name, (src, repl) in sources.items():
        head = heads[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "launches": sum(w[name] for w in windows.values()),
                     "launches_by_path": {path: w[name] for path, w in windows.items()},
                     "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
                     **bounds[name],
                     "storage": "split", "mask": "band30" if name in sp_sum or name == "sched_widths" else None,
                     "by_storage": by_storage[name]})
    for row in rows:
        if row["name"] == "probe_stream":
            row.update(mode="win_fwd_inv, f32 matrices", replaces_also="tools/fused_probe.py:65")
        if row["name"] == "probe_ring_read":  # T1: step_mac.cuh's probe mode on B1's grid
            t1 = heads["probe_ring_read"]
            row.update(kernel_body="neojax_torch/csrc/step_mac.cuh", splits=t1["splits"], vec=t1["vec"],
                       vs_fdl_mac=t1["vs_fdl_mac"], device_ms=t1["device_ms"])
        if row["name"] in ("fdl_mac", "sparse_fdl_mac"):  # B1/B4 run the partition MAC of step_mac.cuh
            other = "fdl_mac/hybrid_head" if row["name"] == "fdl_mac" else "sparse_fdl_mac/k513"
            row.update(kernel_body="neojax_torch/csrc/step_mac.cuh",
                       splits=heads[row["name"]]["splits"], vec=heads[row["name"]]["vec"],
                       other_shape={"shape": other.split("/")[1], "ms": kernel_ms[other], **bounds[other]})
            if row["name"] == "fdl_mac":  # the block-4096 grid's largest ring, launched by the tools
                g = tools_sum["grid_b1"]
                row["grid_shape"] = {"shape": "grid4096", "ring": g["ring"], "launches": g["launches"],
                                     "launches_of_the_tools_check": g["launches_of_the_tools_check"],
                                     "ms": g["ms"], "ms_again": g["ms_again"], "plain_ms": g["plain_ms"],
                                     "max_abs_err": g["max_abs_err"], "clocks_before": g["clocks_before"],
                                     "clocks_after": g["clocks_after"],
                                     **bounds["fdl_mac/grid4096"]}
        if row["name"] in stages:
            if not row["name"].startswith("step_"):  # B2 runs these stages too
                row["replaces_also"] = "neojax/kernels/fused_step.py:330"
            row["shape"] = ("band30 chunk tables" if row["name"] == "sched_widths" else
                            "B2's block" if row["name"].startswith("step_") else "B3's window of 64 blocks")
    emit(phase="summary", snr_db_vs_f64=snrs, engine_snr_db_vs_f64=engine_snrs,
         sparse_snr_db_vs_masked_f64=sparse_snrs, sparse_times=sparse_times, sparse_masks=mask_stats,
         times=times, measurement=meas, stages=stages, transform_shapes=transforms,
         engine_times=engine_times, hybrid_stream_latency=stream_lat, chunked=chunked_sum,
         make_engine=make_engine_sum, convolve=convolve_sum, cli=cli_sum["runs"],
         executor={k: executor_sum[k] for k in ("callback_path", "executor_path")}, surface=surface_sum,
         tools={k: v["wall_s"] for k, v in tools_sum["tools"].items()},
         dist=dist_sum["summary"], total_s=time.perf_counter() - t_start, **card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        rank_, world_, port_, outdir_, stage_ = sys.argv[2:7]
        sys.exit(dist_worker(int(rank_), int(world_), int(port_), outdir_, stage_))
    sys.exit(main(dist_only="--dist-only" in sys.argv[1:]))
