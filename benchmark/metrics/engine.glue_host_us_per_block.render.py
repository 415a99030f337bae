"""Host time of a traced process call outside B3's wrapper (the program's
``conv.process`` span less its ``kernels.fused_stream`` span: the float64
DC/Nyquist fix, the input pad and cat, the output slice), the least over
the traced calls, per block."""

from benchmark.lib.program_spans import least_us_per_block


def read(run):
    return least_us_per_block(run, "conv.process", less="kernels.fused_stream")
