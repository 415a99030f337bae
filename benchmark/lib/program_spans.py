"""What the metric readers read of the program's own spans
(``neojax_torch.trace``): host seconds from its totals, and, in the traced
stretch, host time a call and the device's idle time by the program span
the host was in. Each returns None where the program opens no such span
(a checkout without ``neojax_torch.trace``), so the harness leaves the
metric out."""

from __future__ import annotations

from benchmark.lib.trace import union
from benchmark.lib.traffic import STRETCH_SPAN

__all__ = ["CALL", "host_seconds", "least_us_per_block", "idle_pct_in"]

# the program's span around each call of the closed loop, by default
# (``Convolver.process``'s; a reader of another engine names its own)
CALL = "conv.process"


def host_seconds(names) -> float | None:
    """Host seconds in the program's spans ``names``, summed over the
    process, from ``neojax_torch.trace.totals()``."""
    try:
        from neojax_torch import trace
    except ImportError:
        return None
    totals = trace.totals()
    found = [totals[n]["host_s"] for n in names if n in totals]
    return sum(found) if found else None


def _covered(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def least_us_per_block(run, name: str, less: str | None = None, call: str = CALL) -> float | None:
    """The least, over the traced calls (the program's ``call`` spans), of
    the host time a call spends in ``name`` spans less the part ``less``
    spans cover, in µs a block."""
    t = run.trace
    if t is None:
        return None
    calls, inner = t.spans_named(call), union(t.spans_named(name))
    if not calls or not inner:
        return None
    minus = union(t.spans_named(less)) if less else []
    least = min(_covered(inner, a, b) - _covered(minus, a, b) for a, b in calls)
    return 1e6 * least / run.traffic["call_blocks"]


def idle_pct_in(run, labels) -> float | None:
    """The device's idle time in the traced stretch (the one
    ``device.idle.render`` reads) while the host's innermost span is one of
    ``labels``, as a share of the stretch, in percent."""
    t = run.trace
    stretch = STRETCH_SPAN[run.traffic["loop"]]
    if t is None or not t.device_ops or not t.spans_named(stretch):
        return None
    if not any(n in labels for n, _, _ in t.spans):
        return None
    a, b = t.window(stretch)
    gaps = t.breakdown(a, b, top=len(t.spans) + 1)["idle_gaps"]
    return 100.0 * sum(s for label, s in gaps if label in labels) / (b - a)
