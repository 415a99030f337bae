"""Host time of a traced process call of the nested engine outside B5's
wrapper (the program's ``nested.process`` span less its
``kernels.nested_mac`` spans: the forward transforms and the meta window's
cats, the int push, the inverse transforms, the output stack), the least
over the traced calls, per block."""

from benchmark.lib.program_spans import least_us_per_block


def read(run):
    return least_us_per_block(run, "nested.process", less="kernels.nested_mac", call="nested.process")
