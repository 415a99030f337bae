"""The listed configurations read the same inputs, references and least
work as before ``ir.per_channel`` existed: the digests of ``make_filter``'s
spectra, mask and reference at full size, each cell's least bytes, B5's
least bytes a launch, and the digests of the small sizes' reference blocks
(float64, and the stand-in control's precision where the configuration has
one) at one seed. The pinned values were read from the tree before the
filter could be per channel."""

import hashlib

import numpy as np
import pytest

from benchmark.lib import inputs, spec, work, work_nested
from benchmark.reference import upols
from benchmark.tests import tiny

SEED = 2**31 + 27
BLOCKS = [0, 23, 31, 40, 95]
ONCHIP = work.PEAKS["NVIDIA H100 80GB HBM3"]["onchip_bytes"]

FILTER = {
    "ambi64_10s_split": ("f3b8bc28b85c57fc7c360a10", None, "f3b8bc28b85c57fc7c360a10"),
    "ambi64_room10s_perc60_bf16": ("65fa9b3dfa8052e9e92ec8a9", "62c6f8c13773cea0e0d4f883", "e57df590e5d37528f201415b"),
    "ambi64_10s_int8": ("f3b8bc28b85c57fc7c360a10", None, "f3b8bc28b85c57fc7c360a10"),
}
LEAST_BYTES = {"ambi64_10s_split": 351_681_360, "ambi64_room10s_perc60_bf16": 268_608_624}
TINY_REFERENCE = {
    "ambi64_10s_split": {"f64": "cf0bdc4054f691c400a14ce2", "tf32": "2b972d2630dbd520ccb12b5a"},
    "ambi64_room10s_perc60_bf16": {"f64": "aae90c22a36beb217f068785"},
    "ambi64_10s_int8": {"f64": "db3f0b88d476e8c9344e4059", "int4": "33dd7a00b1027ce7859c9ca3"},
}


def digest(a) -> str | None:
    """A digest of an array's dtype, shape and bytes; None for None."""
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()[:24]


def _config(name):
    return spec.load_json(spec.config_file(name))


@pytest.mark.parametrize("name", sorted(FILTER))
def test_the_filter_is_pinned(name):
    filt = inputs.make_filter(_config(name))
    assert (digest(filt.spectra), digest(filt.mask), digest(filt.reference)) == FILTER[name]


@pytest.mark.parametrize("name", sorted(LEAST_BYTES))
def test_a_cells_least_bytes_are_pinned(name):
    config = _config(name)
    call_blocks = spec.load_json(spec.PKG / "traffic" / "render.json")["call_blocks"]
    got = work.least_bytes(config["channels"], config["block"], call_blocks, inputs.make_filter(config).live,
                           config["storage"], ONCHIP)
    assert got == LEAST_BYTES[name]


def test_b5_least_bytes_a_launch_are_pinned():
    assert work_nested.least_bytes_per_launch(_config("ambi64_10s_int8")) == 277_364_736


@pytest.mark.parametrize("name", sorted(TINY_REFERENCE))
def test_the_small_reference_blocks_are_pinned(name):
    cell = spec.cell_for(name, "render")
    ov = tiny.overrides(cell)
    config, traffic = {**cell["config"], **ov["config"]}, {**cell["traffic"], **ov["traffic"]}
    filt = inputs.make_filter(config)
    stream = inputs.make_stream(config, traffic, SEED, None, "cpu")
    got = {}
    for precision in TINY_REFERENCE[name]:
        refs = upols.output_blocks(stream.segment, filt.reference, BLOCKS, config["block"], precision=precision)
        got[precision] = digest(np.stack([refs[g].numpy() for g in BLOCKS]))
    assert got == TINY_REFERENCE[name]
