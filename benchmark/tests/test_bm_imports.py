"""What a run may load, and how it ends without a card or without the
program: each in a fresh interpreter, so nothing of this test process
(pytest's plugins) counts."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.lib import runner, spec

ROOT = str(spec.ROOT)

DRY_RUN = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests import tiny
tiny.run({mix!r}, 5, traced={traced}, seconds=0.3)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _run(code, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_a_dry_run_loads_no_jax_nor_the_jax_package():
    for mix, traced in ((("ambi64_room10s_perc60_bf16", "render"), True), (("ambi64_10s_split", "live"), False)):
        res = _run(DRY_RUN.format(root=ROOT, mix=mix, traced=traced))
        assert res.returncode == 0, res.stderr
        loaded = set(eval(res.stdout.strip().splitlines()[-1]))
        assert "neojax_torch" in loaded
        assert not loaded & runner.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    res = _run(f"import sys; sys.path.insert(0, {ROOT!r}); import benchmark.reference.upols; "
               "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & (runner.FORBIDDEN | {"neojax_torch"})


def test_forbidden_names_are_compared_whole():
    sys.modules["neojax_torch_lookalike"] = sys.modules["json"]
    try:
        assert "neojax" not in runner.forbidden_modules()
    finally:
        del sys.modules["neojax_torch_lookalike"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ambi64_10s_split.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ambi64_10s_split.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "neojax_torch" in res.stderr
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["benchmark"]
