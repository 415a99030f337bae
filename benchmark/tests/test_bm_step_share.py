"""The reader of the program's MAC step counters
(``kernels.mac_step_share.render``): the share of the dense walk's steps
run, from ``neojax_torch.trace.snapshot()``; nothing where the program
keeps no such counter or counted nothing."""

import pytest

import neojax_torch
from benchmark.tests.test_bm_readers import _run, read

NAME = "kernels.mac_step_share.render"


@pytest.mark.parametrize("counters,want", [
    ({"stream_mac.steps_run": 25, "stream_mac.steps_dense": 125}, 20.0),
    ({"stream_mac.steps_run": 64, "stream_mac.steps_dense": 64}, 100.0),
    ({"stream_mac.steps_run": 0, "stream_mac.steps_dense": 0}, None),  # no MAC on the card
    (None, None),  # a program without the counters
])
def test_step_share_reads_the_program_counters(monkeypatch, counters, want):
    snap = {"spans": {}, "launches": {}}
    if counters is not None:
        snap["counters"] = counters
    monkeypatch.setattr(neojax_torch.trace, "snapshot", lambda: snap)
    got = read(NAME, _run("closed", None, 0, 4))
    assert got == (None if want is None else pytest.approx(want))
