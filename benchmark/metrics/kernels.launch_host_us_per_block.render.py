"""Host time of a traced process call inside B3's wrapper (the program's
``kernels.fused_stream`` span: checks, staging and the stage launches), the
least over the traced calls, per block."""

from benchmark.lib.program_spans import least_us_per_block


def read(run):
    return least_us_per_block(run, "kernels.fused_stream")
