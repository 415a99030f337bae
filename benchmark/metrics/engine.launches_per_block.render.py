"""Device kernels per block over the traced process calls (an exact count
from the trace)."""

from benchmark.lib.readers import launches_per_block


def read(run):
    return launches_per_block(run)
