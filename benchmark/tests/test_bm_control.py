"""Each configuration's control must come out not correct: the reference in
TF32 in the program's place for the float32 configuration, the program's
own int8 storage for the bf16 one."""

import pytest

from benchmark.tests import tiny


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_control_fails(mix, device):
    res = tiny.run(mix, 2**31 + 5, device, control=True)
    assert res["correct"] is False, res["checks"]
