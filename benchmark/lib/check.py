"""What decides ``correct``: the output blocks the window kept, held
against the plain reference computed from the same inputs and filter.

Two numbers, over all kept blocks and channels:

- ``rel_rms_err``: the RMS of the difference over the RMS of the reference;
- ``max_err_over_rms``: the largest difference of one sample over the RMS
  of the reference (a fault in a few samples moves this one).

Each must be at most its limit in the configuration's ``limits``; besides,
at least one block must have been kept and no call may have raised or
returned another shape (``runner.run_cell``). A late callback is late,
not wrong: it counts as failed, not against ``correct``.
"""

from __future__ import annotations

import torch

from benchmark.reference import upols

__all__ = ["numbers", "judge", "passed"]


def numbers(kept: dict, refs: dict) -> dict:
    """The two numbers of kept outputs ``{g: [C, B]}`` against reference
    blocks ``{g: [C, B] float64}``."""
    num = den = 0.0
    worst = 0.0
    count = 0
    for g, ref in refs.items():
        y = kept[g].detach().to("cpu", torch.float64)
        d = y - ref
        num += float((d * d).sum())
        den += float((ref * ref).sum())
        worst = max(worst, float(d.abs().max()))
        count += ref.numel()
    rms = (den / count) ** 0.5 if count else 0.0
    if rms == 0.0:
        return {"rel_rms_err": float("inf"), "max_err_over_rms": float("inf")}
    return {"rel_rms_err": (num / den) ** 0.5, "max_err_over_rms": worst / rms}


def judge(kept: dict, stream, filt, config: dict, device, stand_in: str | None = None) -> dict:
    """``{name: {"value", "limit"}}`` of the kept outputs against the
    float64 reference. ``stand_in`` (a precision of
    ``reference.upols.output_blocks``): judge the reference computed at it
    in the program's place instead."""
    refs = upols.output_blocks(stream.segment, filt.reference, sorted(kept), config["block"], device=device)
    if stand_in is not None:
        kept = upols.output_blocks(stream.segment, filt.reference, sorted(kept), config["block"],
                                   precision=stand_in, device=device)
    vals = numbers(kept, refs) if kept else {k: float("inf") for k in config["limits"]}
    return {k: {"value": vals[k], "limit": config["limits"][k]} for k in config["limits"]}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
