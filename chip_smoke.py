#!/usr/bin/env python3
"""Drive neojax_torch's engines end to end on one CUDA card: the per-block
convolver (dense and sparse), the nested (two-level FDL) engine and the
hybrid real-time engine.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
NVIDIA Hopper card (the kernels are built for sm_90a) and nvcc; it exits
non-zero without a card and never falls back to the CPU.

Configuration: the repo's headline (``bench.py``, BASELINE.json config
#3) — 64 channels, a 10 s shared decaying-noise IR at 48 kHz (938
partitions; the per-block convolver pads them to P = 960), block B = 512,
transform N = 1024. The nested engine runs at S = 128 blocks a chunk
(meta ring [2, 8, 64, 513, 256]), the hybrid at S = 64 (head ring of 64
partitions, tail meta ring [2, 14, 64, 513, 128]), as ``bench.py:192-225``.
The sparse convolver runs two keep-masks of that IR: ``band30``, the first
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
     unfused head's K = 513 bins (P = 64, split and int16)
 3c. the sparse kernels at the headline shapes, all four storages and both
     masks: B4 on the packed K = 512 ring (shared and per-channel filter,
     three positions) and on a non-packed K = 513 ring (split, int16), B2
     with the chunk schedule at three positions and B3 with it over 64
     blocks from P-5, each against its plain version and against the dense
     kernel on the same masked filter (B4 against B1)
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
  7b. probes: T1 (``probe_ring_read``, bf16 and split) at the
     [2, 960, 64, 512] ring, both outputs, and T2 (``probe_stream``, its
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
     where there is one (``library_ms``)
  8. times: per-block ``process``, ``process_nested`` and
     ``process_hybrid`` per storage, kernel route against the plain torch
     route (``mac_backend="torch"``: cuFFT transforms + tensor-op MAC), and
     ``HybridStream``'s per-callback latency (chunk-boundary callbacks
     apart); sparse ``process`` per storage and mask beside the dense
     ``process`` on the unmasked filter and the plain torch route
  9. the kernels summary, then the final ``{"ok": true, ...}`` line

Launch counters are zeroed right before each main path (phases 4+5, 5b,
the nested and the hybrid halves of 6, 7, and 7b's measurement path) and
read right after it; each kernel of that path must have launched in its
window (B2 and B3 with the chunk schedule counted apart).
"""

from __future__ import annotations

import dataclasses
import json
import os
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
DEVICE = "cuda"


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def snr_db(out: np.ndarray, ref: np.ndarray) -> float:
    err = np.asarray(out, np.float64) - ref
    den = float(np.sum(err**2))
    return float("inf") if den == 0 else 10.0 * np.log10(float(np.sum(ref**2)) / den)


def rel_err(a, b) -> tuple[float, float]:
    """(max|a - b|, max|a - b| / max|b|) in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = float(np.abs(a - b).max())
    return d, d / max(1e-30, float(np.abs(b).max()))


def main() -> int:
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
    emit(phase="build", seconds=time.perf_counter() - t0, built=info["built"],
         library=os.path.relpath(info["path"], os.path.dirname(os.path.abspath(__file__))),
         ptxas=ptxas)

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

    # ---- 3. each kernel against its plain version at the headline shapes
    rng = np.random.default_rng(7)
    c, b, n = CHANNELS, BLOCK, 2 * BLOCK
    summary = {"fdl_mac": {}, "fused_block_step": {}, "fused_stream": {}, "nested_mac": {}}

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

    def check_ring(storage, k_ring, p_ring, k_scl, p_scl, what):
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
            row[form] = {"max_abs_err": d, "rel_err": r,
                         "ms": cuda_ms(lambda: mac_mod.fdl_mac(ring, fr, fi, scales), 20),
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
            check_ring(storage, k_ring, p_ring, k_scl, p_scl, f"fused_block_step {storage} pos={pos}")
            worst = max(worst, (d, r), key=lambda x: x[1])
        step_ms = cuda_ms(lambda: fs_mod.fused_block_step(frame, k_ring, rim, 3, dcfix, cs, ab, k_scl), 20)
        step_plain = cuda_ms(lambda: fs_mod.fused_block_step_reference(frame, p_ring, rim, 3, dcfix, cs, ab, p_scl), 3)
        summary["fused_block_step"][storage] = {"max_abs_err": worst[0], "rel_err": worst[1],
                                                "ms": step_ms, "plain_ms": step_plain}
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
        check_ring(storage, k_ring, p_ring, k_scl, p_scl, f"fused_stream {storage}")
        s_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl), 3)
        s_plain = cuda_ms(lambda: fs_mod.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix_all, cs2, abt, p_scl), 1)
        summary["fused_stream"][storage] = {"max_abs_err": d, "rel_err": r, "ms": s_ms, "plain_ms": s_plain,
                                            "blocks": nb, "us_per_block": 1e3 * s_ms / nb}
        emit(phase="kernel_vs_plain", kernel="fused_stream", storage=storage, tol=TOL[storage],
             pos0=pos0, **summary["fused_stream"][storage], **card)
        del ring, scales, k_ring, p_ring
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

    # B3 with acc_add and B1 on the hybrid head (P = S = 64): the head's
    # storages are split and int16 (int8 keeps an int16 head)
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
        check_ring(storage, k_ring, p_ring, k_scl, p_scl, f"fused_stream acc_add {storage}")
        s_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl,
                                                   acc_add=seed), 3)
        s_plain = cuda_ms(lambda: fs_mod.fused_stream_reference(sigpad, p_ring, rim, pos0, dcfix_all, cs2,
                                                                abt, p_scl, acc_add=seed), 1)
        summary["fused_stream_acc_add"][storage] = {"max_abs_err": d, "rel_err": r, "ms": s_ms,
                                                    "plain_ms": s_plain, "blocks": nb,
                                                    "us_per_block": 1e3 * s_ms / nb}
        emit(phase="kernel_vs_plain", kernel="fused_stream", acc_add=True, storage=storage, partitions=ph,
             tol=TOL[storage], pos0=pos0, **summary["fused_stream_acc_add"][storage], **card)

        # B1 on the unfused head's non-packed bins: [2, 64, 64, 513]
        if storage in INT_MAX:
            hring = torch.from_numpy(rng.integers(-32767, 32768, (2, ph, c, k), dtype=np.int32)).to(dev, sdt)
        else:
            hring = torch.from_numpy((10 * rng.standard_normal((2, ph, c, k))).astype(np.float32)).to(dev)
        fr = torch.from_numpy((0.05 * rng.standard_normal((ph, 1, k))).astype(np.float32)).to(dev)
        fi = torch.from_numpy((0.05 * rng.standard_normal((ph, 1, k))).astype(np.float32)).to(dev)
        k_re, k_im = mac_mod.fdl_mac(hring, fr, fi, scales)
        p_re, p_im = mac_mod.fdl_mac_reference(hring, fr, fi, scales)
        torch.cuda.synchronize()
        d, r = rel_err(torch.cat([k_re, k_im]).cpu(), torch.cat([p_re, p_im]).cpu())
        assert r < TOL[storage], f"fdl_mac head K={k} {storage}: rel err {r}"
        summary["fdl_mac_head"][storage] = {
            "max_abs_err": d, "rel_err": r,
            "ms": cuda_ms(lambda: mac_mod.fdl_mac(hring, fr, fi, scales), 50),
            "plain_ms": cuda_ms(lambda: mac_mod.fdl_mac_reference(hring, fr, fi, scales), 5)}
        emit(phase="kernel_vs_plain", kernel="fdl_mac", shapes="hybrid_head", storage=storage,
             ring=list(hring.shape), tol=TOL[storage], **summary["fdl_mac_head"][storage], **card)
        del ring, hring, k_ring, p_ring
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
            m_dev = torch.from_numpy(mask[:, :b]).to(dev)[:, None, :]
            rnd = [torch.randn((P, c, b), device=dev, generator=gen).mul_(0.05).mul_(m_dev) for _ in range(2)]
            filters = {"shared": (prm["filt_re"], prm["filt_im"]),
                       "per_channel": tuple(torch.cat([f.flip(0)] * 2) for f in rnd)}
            row = {"k_tile": k_tile, "p_chunk": pc}
            for form, (tre, tim) in filters.items():
                worst, vs_dense = (0.0, 0.0), 0.0
                for pos in (0, P // 2 + 1, P - 1):
                    fr, fi = tre[P - 1 - pos : 2 * P - 1 - pos], tim[P - 1 - pos : 2 * P - 1 - pos]
                    got = sm_mod.sparse_fdl_mac(ring, fr, fi, pos, *tables, scales, p_chunk=pc, k_tile=k_tile)
                    want = sm_mod.sparse_fdl_mac_reference(ring, fr, fi, pos, *tables, scales, p_chunk=pc,
                                                           k_tile=k_tile)
                    dense = mac_mod.fdl_mac(ring, fr, fi, scales)
                    torch.cuda.synchronize()
                    d, r = rel_err(torch.cat(got).cpu(), torch.cat(want).cpu())
                    assert r < TOL[storage], f"sparse_fdl_mac {key} {form} pos={pos}: rel err {r}"
                    worst = max(worst, (d, r), key=lambda x: x[1])
                    vs_dense = max(vs_dense, rel_err(torch.cat(got).cpu(), torch.cat(dense).cpu())[0])
                row[form] = {"max_abs_err": worst[0], "rel_err": worst[1], "max_abs_diff_vs_fdl_mac": vs_dense,
                             "ms": cuda_ms(lambda: sm_mod.sparse_fdl_mac(ring, fr, fi, pos, *tables, scales,
                                                                         p_chunk=pc, k_tile=k_tile), 20),
                             "fdl_mac_ms": cuda_ms(lambda: mac_mod.fdl_mac(ring, fr, fi, scales), 20),
                             "plain_ms": cuda_ms(lambda: sm_mod.sparse_fdl_mac_reference(
                                 ring, fr, fi, pos, *tables, scales, p_chunk=pc, k_tile=k_tile), 3)}
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
                worst, vs_dense = (0.0, 0.0), 0.0
                for pos in (0, P // 2 + 1, P - 1):
                    fr = prm_u["filt_re"][P - 1 - pos : 2 * P - 1 - pos]
                    fi = prm_u["filt_im"][P - 1 - pos : 2 * P - 1 - pos]
                    got = sm_mod.sparse_fdl_mac(ring_u, fr, fi, pos, *tables_u, scales, p_chunk=pc_u, k_tile=kt_u)
                    want = sm_mod.sparse_fdl_mac_reference(ring_u, fr, fi, pos, *tables_u, scales, p_chunk=pc_u,
                                                           k_tile=kt_u)
                    dense = mac_mod.fdl_mac(ring_u, fr, fi, scales)
                    torch.cuda.synchronize()
                    d, r = rel_err(torch.cat(got).cpu(), torch.cat(want).cpu())
                    assert r < TOL[storage], f"sparse_fdl_mac K={k} {key} pos={pos}: rel err {r}"
                    worst = max(worst, (d, r), key=lambda x: x[1])
                    vs_dense = max(vs_dense, rel_err(torch.cat(got).cpu(), torch.cat(dense).cpu())[0])
                row["unpacked_k513"] = {
                    "max_abs_err": worst[0], "rel_err": worst[1], "max_abs_diff_vs_fdl_mac": vs_dense,
                    "k_tile": kt_u, "p_chunk": pc_u,
                    "ms": cuda_ms(lambda: sm_mod.sparse_fdl_mac(ring_u, fr, fi, pos, *tables_u, scales,
                                                                p_chunk=pc_u, k_tile=kt_u), 20),
                    "fdl_mac_ms": cuda_ms(lambda: mac_mod.fdl_mac(ring_u, fr, fi, scales), 20)}
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
                check_ring(storage, rings[0], rings[1], scl[0], scl[1], f"fused_block_step sched {key}")
                assert torch.equal(rings[0], rings[2]), f"fused_block_step sched {key}: ring differs from dense"
                worst = max(worst, (d, r), key=lambda x: x[1])
                vs_dense = max(vs_dense, rel_err(ky.cpu(), dy.cpu())[0])
            k_ring = rings[0]
            k_scl = scl[0]
            sp_sum["fused_block_step_sched"][key] = {
                "max_abs_err": worst[0], "rel_err": worst[1], "max_abs_diff_vs_dense_kernel": vs_dense,
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
            check_ring(storage, rings[0], rings[1], scl[0], scl[1], f"fused_stream sched {key}")
            assert torch.equal(rings[0], rings[2]), f"fused_stream sched {key}: ring differs from dense"
            k_ring, k_scl = rings[0], scl[0]
            s_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl,
                                                       sched), 3)
            d_ms = cuda_ms(lambda: fs_mod.fused_stream(sigpad, k_ring, rim, pos0, dcfix_all, cs2, abt, k_scl), 3)
            sp_sum["fused_stream_sched"][key] = {
                "max_abs_err": d, "rel_err": r, "max_abs_diff_vs_dense_kernel": rel_err(ko.cpu(), do.cpu())[0],
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

    def read_window(path, expect):
        """Read the launch counts of one main path and require each kernel
        of that path to have launched."""
        counts = kernels.launch_counts()
        windows[path] = counts
        emit(phase="launch_counts", path=path, **counts)
        for name in expect:
            assert counts[name] > 0, f"{name} was not launched on the {path} path"

    read_window("perblock", ("fdl_mac", "fused_block_step", "fused_stream"))

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
    read_window("sparse", ("fused_stream_sched", "fused_block_step_sched", "sparse_fdl_mac"))

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
        read_window(name, ("nested_mac",) if name == "nested" else ("nested_mac", "fused_stream", "fdl_mac"))

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

    # ---- 7b. probes T1 and T2 against their plain versions, the measurement
    # path in its own launch window, a profiler trace, and every kernel's bound
    peak_b, peak_f = harness.hbm_peak_bytes_per_sec(), harness.f32_peak_flops_per_sec()
    no_peaks = None if peak_b and peak_f else f"the harness has no data-sheet peaks for {card['card']}"
    emit(phase="probes", peaks={"hbm_bytes_per_s": peak_b, "f32_flops_per_s": peak_f, "note": no_peaks})
    probe_sum = {"probe_ring_read": {}, "probe_stream": {}}
    for storage in ("split", "bf16"):
        sdt = cv.fdl_lib.STORAGE_DTYPES[storage]
        ring = torch.from_numpy((10 * rng.standard_normal((2, P, c, b))).astype(np.float32)).to(dev, sdt)
        tiled = torch.from_numpy((0.05 * rng.standard_normal((2 * P, b))).astype(np.float32)).to(dev)
        fr = tiled[P - 8 : 2 * P - 8]  # the rotated filter of ring position 7
        _, pc = mac_mod.choose_chunks(sdt, P, c, b)
        got = pr_mod.probe_ring_read(ring, fr, pc)
        want = pr_mod.probe_ring_read_reference(ring, fr, pc)
        torch.cuda.synchronize()
        errs = [rel_err(g.cpu(), w.cpu()) for g, w in zip(got, want)]
        for (_, r), out_name in zip(errs, ("out0", "out1")):
            assert r < TOL[storage], f"probe_ring_read {storage} {out_name}: rel err {r}"
        fr1 = fr[:, None]
        row = {"max_abs_err": max(e[0] for e in errs), "rel_err": max(e[1] for e in errs), "p_chunk": pc,
               "ms": cuda_ms(lambda: pr_mod.probe_ring_read(ring, fr, pc), 20),
               "plain_ms": cuda_ms(lambda: pr_mod.probe_ring_read_reference(ring, fr, pc), 3),
               "fdl_mac_ms_same_shape": cuda_ms(lambda: mac_mod.fdl_mac(ring, fr1, fr1), 20)}
        probe_sum["probe_ring_read"][storage] = row
        emit(phase="probes", kernel="probe_ring_read", storage=storage, ring=list(ring.shape),
             tol=TOL[storage], **row, **card)
        del ring, got, want
    nb = 64
    sigpad = torch.from_numpy(rng.uniform(-1, 1, (c, (nb + 1) * b)).astype(np.float32)).to(dev)
    for mname, mdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cs2, abt = mb.packed_stream_mats(n, mdt, dev)
        tol = TOL["split" if mdt == torch.float32 else "bf16"]
        for mode in pr_mod.PROBE_MODES:
            got = pr_mod.probe_stream(sigpad, cs2, abt, mode)
            want = pr_mod.probe_stream_reference(sigpad, cs2, abt, mode)
            torch.cuda.synchronize()
            if mode == "empty":
                d = r = float(got.abs().max())
                assert d == 0.0, f"probe_stream empty/{mname} wrote {d}"
            else:
                d, r = rel_err(got.cpu(), want.cpu())
                assert r < tol, f"probe_stream {mode}/{mname}: rel err {r}"
            row = {"max_abs_err": d, "rel_err": r, "blocks": nb,
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
        meas[f"dma_only/{storage}"] = roofline_cal.dma_only_row(storage, short)
        meas[f"mac_kernel/{storage}"] = roofline_cal.mac_kernel_row(storage, short)
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
                                "fused_stream_sched"))

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
    }
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
        "sparse_fdl_mac": ("neojax_torch/csrc/sparse_mac.cu", "neojax/kernels/sparse_mac.py:246"),
        "fused_block_step_sched": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:330"),
        "fused_stream_sched": ("neojax_torch/csrc/fused_step.cu", "neojax/kernels/fused_step.py:791"),
        "probe_ring_read": ("neojax_torch/csrc/probes.cu", "tools/roofline_cal.py:143"),
        "probe_stream": ("neojax_torch/csrc/probes.cu", "tools/fused_probe.py:116"),
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
                     "storage": "split", "mask": "band30" if name in sp_sum else None,
                     "by_storage": by_storage[name]})
    rows[-1]["mode"] = "win_fwd_inv, f32 matrices"  # probe_stream's head row
    rows[-1]["replaces_also"] = "tools/fused_probe.py:65"
    emit(phase="summary", snr_db_vs_f64=snrs, engine_snr_db_vs_f64=engine_snrs,
         sparse_snr_db_vs_masked_f64=sparse_snrs, sparse_times=sparse_times, sparse_masks=mask_stats,
         times=times, measurement=meas,
         engine_times=engine_times, hybrid_stream_latency=stream_lat,
         total_s=time.perf_counter() - t_start, **card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
