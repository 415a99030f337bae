"""The readings a cell's limits are set from, in one process on the card:
the program's numbers over many seeds (the lower readings) and its
control's over a few (the upper readings), each through the cell's own
traffic at its own size, with a window just long enough to keep as many
outputs as a run does.

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 --seconds <s> [--out FILE]
    python3 benchmark/limits.py --config <file> --traffic <mix> --seeds ... \
        --control-seeds ... --seconds <s> [--out FILE]

The second form reads a configuration file that ``BENCHMARK.json`` does
not list yet (``spec.cell_for``), any engine it names included.

The control is the configuration's ``control`` (``runner.run_cell``).
Prints one JSON line per run and a summary (largest program reading,
smallest control reading, per number).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    from benchmark.lib import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    spec.add_cell_arguments(ap)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import runner

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell_of(args)
    rows = []
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",")):
            res = runner.run_cell(cell, seed, args.seconds, False, time.perf_counter(), control=side == "control")
            row = {"side": side, "seed": seed, "correct": res["correct"], "failed": res["failed"],
                   **{k: c["value"] for k, c in res["checks"].items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    names = list(res["checks"])
    summary = {"workload": cell["workload"]["name"], "control": cell["config"]["control"],
               "lower": {k: max(r[k] for r in rows if r["side"] == "program") for k in names},
               "upper": {k: min(r[k] for r in rows if r["side"] == "control") for k in names}}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0 if not runner.forbidden_modules() else 3


if __name__ == "__main__":
    sys.exit(main())
