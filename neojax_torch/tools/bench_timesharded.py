"""The time-sharded stream's warm-up overhead on the card.

Port of ``tools/bench_timesharded.py``. The sequence-parallel stream
(``dist.timesharded``) gives each rank its predecessor's last P blocks
as a halo and rebuilds the convolver state from it in one batched warm-up
(``dist.timesharded._warmup``), so a rank's efficiency is about
``eff(m) = m t_step / (m t_step + t_warmup)`` for m blocks a rank. At the
headline configuration (bf16, P = 960, 64 channels, block 512,
``mac_backend="pallas"``, 400 blocks), CUDA-event elapsed times around
the host-driven calls, host gaps included (``bench.harness.cuda_seconds``,
minimum of 3):

  - ``t_step``: the per-block convolver's ``process`` (B3), a block;
  - ``t_insert``: a loop of ``conv.convolver.insert_only_step``, a block
    (the warm-up as P - 1 sequential pushes);
  - ``t_warmup``: one ``_warmup`` call on a [C, P B] halo;
  - the halo's bytes (P B samples x channels x 4) and eff(m) for m in
    {P, 2P, 4P, 16P, 64P}.

The JAX tool's 8-device virtual mesh check has no counterpart on one
card: instead ``timesharded_process`` runs at world size 1 (NCCL, the
halo a fresh start) against one ``process`` call over P blocks, bit for
bit. Its multi-rank checks are the ``dist`` tests'.

Run on the card: ``python -m neojax_torch.tools.bench_timesharded
[--out PATH] [--smoke]``. ``--smoke``: 64 blocks. Without a card it
raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as tdd

from neojax_torch.bench import harness
from neojax_torch.conv import convolver as cv
from neojax_torch.dist import timesharded as ts
from neojax_torch.dist.mesh import Mesh
from neojax_torch.dist.multihost import free_port, init_distributed
from neojax_torch.tools.common import finish, note, parse

B, C = 512, 64
P = -(-int(np.ceil(10.0 * 48000 / B)) // 32) * 32  # 960
STORAGE = "bf16"
NB = 400
SMOKE_NB = 64


def setup(device, p: int = P, channels: int = C, block: int = B, nb: int = NB, storage: str = STORAGE):
    """(config, params, signal [C, nb B], halo [C, P B]) drawn as the JAX
    tool draws them (one generator, seed 0), on ``device``."""
    cfg = cv.PartitionedConfig(block, p, channels, storage=storage, mac_backend="pallas")
    rng = np.random.default_rng(0)
    parts = (rng.standard_normal((1, p, cfg.num_bins)) + 1j * rng.standard_normal((1, p, cfg.num_bins))
             ).astype(np.complex64) * 0.05
    params = cv.filter_params(cfg, parts, device=device)
    sig = torch.from_numpy(rng.uniform(-1, 1, (channels, nb * block)).astype(np.float32)).to(device)
    halo = torch.from_numpy(rng.uniform(-1, 1, (channels, p * block)).astype(np.float32)).to(device)
    return cfg, params, sig, halo


def insert_loop(cfg, state: dict, sig: torch.Tensor) -> dict:
    """``insert_only_step`` over every block of ``sig``."""
    for blk in sig.reshape(sig.shape[0], -1, cfg.block_size).unbind(1):
        state = cv.insert_only_step(cfg, state, blk)
    return state


def efficiency_model(t_step: float, t_warmup: float, p: int) -> dict:
    """eff(m) = m t_step / (m t_step + t_warmup) for m in {P, 2P, 4P, 16P,
    64P} blocks a rank, keyed by m."""
    return {str(m): m * t_step / (m * t_step + t_warmup) for m in (p, 2 * p, 4 * p, 16 * p, 64 * p)}


def timesharded_vs_process(cfg, params: dict, sig: torch.Tensor, backend: str = "nccl") -> dict:
    """``timesharded_process`` over a "time" axis of one rank against one
    ``process`` call on ``sig`` (at least P blocks), in a world of one
    (started here when no process group is up, and ended after)."""
    own = not tdd.is_initialized()
    if own:
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout_secs=60, backend=backend)
    try:
        mesh = Mesh(("time",), (1,), device=sig.device)
        out = ts.timesharded_process(cfg, params, sig, mesh)
        _, ref = cv.process(cfg, params, cv.init_state(cfg, sig.device), sig)
        world = {"backend": tdd.get_backend(), "world": tdd.get_world_size()}
    finally:
        if own:
            tdd.destroy_process_group()
    diff = float((out - ref).abs().max())
    return {**world, "blocks": sig.shape[-1] // cfg.block_size, "bit_equal_vs_process": bool(torch.equal(out, ref)),
            "max_abs_diff_vs_process": diff, "rel_diff_vs_process": diff / float(ref.abs().max())}


def measure(nb: int = NB, device="cuda") -> dict:
    cfg, params, sig, halo = setup(device, P, C, B, nb)
    state = cv.init_state(cfg, device)
    t_step = harness.cuda_seconds(lambda: cv.process(cfg, params, state, sig)) / nb
    ins = cv.init_state(cfg, device)
    t_insert = harness.cuda_seconds(lambda: insert_loop(cfg, ins, sig)) / nb
    t_warm = harness.cuda_seconds(lambda: ts._warmup(cfg, params, halo))
    note(f"t_step {1e6 * t_step:.2f} us, t_insert {1e6 * t_insert:.2f} us, t_warmup {1e6 * t_warm:.1f} us")
    whole = torch.cat([sig] * -(-P // nb), dim=-1)[:, : P * B]  # one rank's shard of P blocks
    check = timesharded_vs_process(cfg, params, whole)
    return {"config": {"block": B, "channels": C, "partitions": P, "storage": STORAGE, "blocks": nb},
            "t_step_us": 1e6 * t_step, "t_warmup_batched_us": 1e6 * t_warm, "t_insert_us": 1e6 * t_insert,
            "warmup_speedup_vs_insert_loop": (P - 1) * t_insert / t_warm, "halo_mbytes": C * P * B * 4 / 1e6,
            "scaling_efficiency_vs_blocks_per_device": efficiency_model(t_step, t_warm, P),
            "timesharded_world1": check,
            "note": "eff(m) = m*t_step / (m*t_step + t_warmup_batched); the insert-loop model would be "
                    "m*t_step / (m*t_step + (P-1)*t_insert). On one card there is no halo transfer."}


def main(argv=None) -> int:
    args = parse(__doc__, argv)
    harness._require_card()
    res = measure(SMOKE_NB if args.smoke else NB)
    finish({"metric": "timesharded_warmup_overhead", "card": harness.card_line(), "smoke": args.smoke,
            "protocol": "CUDA-event elapsed time of one warm call, host gaps included (min of 3)", **res}, args.out)
    return 0 if res["timesharded_world1"]["bit_equal_vs_process"] else 1


if __name__ == "__main__":
    sys.exit(main())
