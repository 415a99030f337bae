"""WAV convolver CLI (``neojax.cli``) — counterpart of the reference's
``neo_convolver`` (``extra/cli/src/convolver.cpp:60-148``): load signal +
impulse WAVs, resample a mismatched impulse to the signal's rate, normalize
the impulse, uniformly partition it, optionally thin it with the perceptual
mask, stream the signal through a partitioned convolver on the card, report
wall time + real-time factor, write the result.

Usage:
    neojax_torch-convolver signal.wav impulse.wav out.wav \\
        [--block 4096] [--engine upols|upola|chunked|nested|hybrid] \\
        [--storage dense|split|bf16|int16|int8] [--threshold-db DB] \\
        [--device cuda|cpu]

(or ``python -m neojax_torch.cli ...``). ``--device`` is the counterpart of
the JAX CLI's platform: ``cuda`` by default (it raises without a card),
``cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="neojax_torch-convolver", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("signal")
    ap.add_argument("impulse")
    ap.add_argument("output")
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument(
        "--engine", default="upols",
        choices=["upols", "upola", "chunked", "nested", "hybrid"],
        help="chunked = Toeplitz-product throughput mode; nested = two-level-FDL "
        "throughput mode (per-channel capable) — both offline with S-block "
        "latency; hybrid = two-stage real-time mode (single-block latency at "
        "near-throughput speed).",
    )
    ap.add_argument("--chunk-blocks", type=int, default=32)
    ap.add_argument(
        "--storage",
        default=None,
        choices=["dense", "split", "bf16", "int16", "int8"],
        help="FDL storage (default: device-appropriate)",
    )
    ap.add_argument(
        "--threshold-db",
        type=float,
        default=None,
        help="enable perceptual sparsification at this threshold (dB)",
    )
    ap.add_argument("--bits", type=int, default=16, choices=[16, 32])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from neojax_torch import conv
    from neojax_torch.conv.sparse import perceptual_mask
    from neojax_torch.core.device import resolve_device
    from neojax_torch.io.wav import read_wav, write_wav

    dev = torch.device(args.device)
    if dev.type == "cuda":
        resolve_device()  # no card: the RuntimeError naming device="cpu"

    sig, sr = read_wav(args.signal)
    ir, ir_sr = read_wav(args.impulse)
    if ir_sr != sr:
        # Reference parity: IRs are resampled to the signal's rate before the
        # convolver is built (extra/plugin/src/dsp/AudioFile.cpp:22-27).
        from neojax_torch.io.resample import resample

        ir = resample(ir, ir_sr, sr)
        print(f"impulse resampled {ir_sr} Hz -> {sr} Hz", file=sys.stderr)

    print(f"signal: {sig.shape[0]} ch x {sig.shape[1]} frames @ {sr} Hz")
    print(f"impulse: {ir.shape[0]} ch x {ir.shape[1]} frames")

    ir = conv.normalize_impulse(ir).numpy()  # host filter prep
    parts = conv.uniform_partition(ir, args.block)

    # Match channel counts: broadcast a mono IR, or error on mismatch.
    if parts.shape[0] == 1 and sig.shape[0] > 1:
        pass  # shared filter
    elif parts.shape[0] != sig.shape[0]:
        print(f"error: {sig.shape[0]} signal channels vs {parts.shape[0]} impulse channels",
              file=sys.stderr)
        return 2

    sparsity = None
    if args.threshold_db is not None:
        sparsity = perceptual_mask(parts, float(sr), args.threshold_db)
        density = float(np.mean(sparsity))
        print(f"perceptual mask: {density * 100:.1f}% bins kept")

    t0 = time.perf_counter()
    signal = torch.from_numpy(sig).to(dev)
    if args.engine in ("chunked", "nested", "hybrid"):
        from neojax_torch.conv.convolver import PartitionedConfig

        storage = args.storage or ("dense" if dev.type == "cpu" else "bf16")
        if storage == "dense":
            storage = "split"  # the throughput modes are split-native
        cfg = PartitionedConfig(args.block, parts.shape[1], channels=sig.shape[0], storage=storage)
        if args.engine == "chunked" and parts.shape[0] != 1:
            # The Toeplitz form would need a [K, C, 2S, 2M] operand; nested
            # covers per-channel IRs at full speed, so the CLI routes there
            # instead of erroring.
            print("chunked is shared-IR only; using nested for the "
                  f"{parts.shape[0]}-channel IR")
            args.engine = "nested"
        if args.engine == "hybrid":
            from neojax_torch.conv import hybrid

            hparams = hybrid.hybrid_filter_params(cfg, parts, args.chunk_blocks, mask=sparsity, device=dev)
            hstate = hybrid.hybrid_init_state(cfg, hparams)
            _, out = hybrid.process_hybrid(cfg, hparams, hstate, signal)
        elif args.engine == "nested":
            from neojax_torch.conv import nested

            nparams = nested.nested_filter_params(cfg, parts, args.chunk_blocks, mask=sparsity, device=dev)
            nstate = nested.nested_init_state(cfg, nparams)
            _, out = nested.process_nested(cfg, nparams, nstate, signal)
        else:
            from neojax_torch.conv import chunked

            cparams = chunked.chunked_filter_params(cfg, parts, args.chunk_blocks, mask=sparsity, device=dev)
            cstate = chunked.chunked_init_state(cfg, cparams)
            _, out = chunked.process_chunked(cfg, cparams, cstate, signal, args.chunk_blocks)
    else:
        c = conv.make_convolver(args.engine, args.storage, device=dev)
        c.filter(parts, sparsity=sparsity)
        out = c.process(signal)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0

    out_seconds = sig.shape[1] / sr
    print(f"processed {out_seconds:.2f} s in {dt:.3f} s "
          f"-> real-time factor {out_seconds / dt:.1f}x "
          f"({sig.shape[0] * sig.shape[1] / dt / 1e6:.1f} M samples/s)")

    peak = np.max(np.abs(out))
    if peak > 1.0:
        out = out / peak
        print(f"normalized output peak {peak:.3f} -> 1.0")

    write_wav(args.output, out, sr, bits=args.bits)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
