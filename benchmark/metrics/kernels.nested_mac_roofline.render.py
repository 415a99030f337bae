"""B5's share of its roofline over the traced stretch, in percent: its
launches there times the least bytes of one launch
(``benchmark/lib/work_nested.py``) at the card's HBM rate, over the summed
device time of the trace's ``nested_mac_kernel`` operations. None where the
configuration has no nested meta ring or the trace holds no B5 launch."""

from benchmark.lib.work_nested import least_bytes_per_launch

KERNEL = "nested_mac_kernel"


def read(run):
    t = run.trace
    if t is None or not run.hbm_bytes_per_s or not run.config.get("chunk_blocks"):
        return None
    b5 = [e - s for name, cat, s, e in t.device_ops if cat == "kernel" and KERNEL in name]
    if not b5 or not sum(b5):
        return None
    return 100.0 * len(b5) * least_bytes_per_launch(run.config) / run.hbm_bytes_per_s / sum(b5)
