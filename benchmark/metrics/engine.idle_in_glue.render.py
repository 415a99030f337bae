"""Device idle time in the traced stretch while the host's innermost span is
the program's ``conv.process`` or ``conv.dcfix``, as a share of the
stretch, in percent."""

from benchmark.lib.program_spans import idle_pct_in


def read(run):
    return idle_pct_in(run, ("conv.process", "conv.dcfix"))
