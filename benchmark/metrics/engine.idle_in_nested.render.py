"""Device idle time in the traced stretch while the host's innermost span is
the nested engine's own (``nested.process``, ``nested.forward``,
``nested.push`` or ``nested.inverse``: not B5's wrapper), as a share of the
stretch, in percent."""

from benchmark.lib.program_spans import idle_pct_in

SPANS = ("nested.process", "nested.forward", "nested.push", "nested.inverse")


def read(run):
    return idle_pct_in(run, SPANS)
