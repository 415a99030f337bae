"""The least-work counts on hand-worked shapes."""

import numpy as np

from benchmark.lib import work


def test_dense_call_without_onchip_room():
    live = np.ones((3, 5), bool)  # P = 3 partitions, K = 5 bins (B = 4)
    got = work.least_bytes(channels=2, block=4, call_blocks=10, live=live, storage="split", onchip_bytes=0)
    io = 2 * 2 * 10 * 4 * 4  # in and out, float32
    filt = 15 * 8  # complex float32 entries
    state = 2 * (3 * 4 - 1) * 4  # 11 samples of history a channel, read and written
    assert got == io + filt + 2 * state


def test_state_on_chip_is_free_and_write_is_capped_by_new_samples():
    live = np.zeros((8, 5), bool)
    live[:6, :2] = True  # trailing partitions dropped: P_live = 6
    base = dict(channels=1, block=4, live=live, storage="bf16")
    state = (6 * 4 - 1) * 2
    assert work.least_bytes(call_blocks=1, onchip_bytes=state, **base) == 2 * 4 * 4 + 12 * 4
    # one block a call writes 4 new bf16 samples of the 46 off-chip bytes
    assert work.least_bytes(call_blocks=1, onchip_bytes=0, **base) == 2 * 4 * 4 + 12 * 4 + state + 4 * 2


def test_headline_shapes():
    """The cells' counts: split, 938 live partitions of 513 bins, 64 channels."""
    live = np.ones((938, 513), bool)
    onchip = work.PEAKS["NVIDIA H100 80GB HBM3"]["onchip_bytes"]
    state = 64 * (938 * 512 - 1) * 4
    off = state - onchip
    render = work.least_bytes(64, 512, 1024, live, "split", onchip)
    assert render == 2 * 64 * 1024 * 512 * 4 + 938 * 513 * 8 + 2 * off
    live_call = work.least_bytes(64, 512, 1, live, "split", onchip)
    assert live_call == 2 * 64 * 512 * 4 + 938 * 513 * 8 + off + 64 * 512 * 4
