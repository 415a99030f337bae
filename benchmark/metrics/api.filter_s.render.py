"""Host seconds the program spends installing the filter at the stream's
channel count (its ``conv.filter`` and ``conv.bind`` spans, once each in
set-up), from the program's span totals."""

from benchmark.lib.program_spans import host_seconds


def read(run):
    return host_seconds(("conv.filter", "conv.bind"))
