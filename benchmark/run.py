"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 benchmark/run.py --config <file> --traffic <mix> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The second form runs a configuration file that
``BENCHMARK.json`` does not list yet under a traffic mix, on one card, as
``spec.cell_for`` resolves it. Set-up (imports, the kernel library's load or
first build, inputs, filter, one warm-up call) counts as ``setup_s``; the
window then runs for ``--seconds``; after it the kept outputs are held
against the plain reference. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number
compared beside its limit); the numbers compared are also the last lines
of standard error. With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones, read from a
profiled stretch of the window.

Exits non-zero, printing no result, without a CUDA card, and when JAX or
the JAX package (``jax``, ``jaxlib``, ``flax``, ``neojax``, by whole
top-level module name) is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from benchmark.lib import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    spec.add_cell_arguments(ap)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import runner, system

    try:
        system.require()
    except ImportError as e:
        print(f"no result: the program is not in this checkout ({e})", file=sys.stderr)
        return 4
    cell = spec.cell_of(args)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(runner.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
