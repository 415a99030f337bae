"""A cell of ``BENCHMARK.json`` resolved by name into its configuration,
its traffic mix and the metrics it reports. Configurations, traffic mixes,
generators and metric readers are files found by the names the JSON
gives, so a new cell or metric is new files and entries, not an edit.

Keys of a configuration file that route it (``lib/system.py`` builds it):

- ``engine`` (optional): ``"convolver"`` (the default) is
  ``neojax_torch.conv.Convolver``; ``"perblock"``, ``"nested"``,
  ``"chunked"`` and ``"hybrid"`` are ``neojax_torch.conv.make_engine``'s
  engines. These have no per-block entry, so they take only mixes that
  call ``process``;
- ``chunk_blocks``: the chunk of S blocks of the ``nested``, ``chunked``
  and ``hybrid`` engines, required there. Their ``process`` carries its
  state exactly across calls of whole chunks only, so a mix's
  ``call_blocks`` must be a multiple of it;
- ``scheme``, ``storage``, ``block``, ``channels``, ``ring_partitions``
  (the filter is zero-padded to as many partitions), ``ir``, ``mask``,
  ``control`` and ``limits``, as every configuration has;
- ``ir.per_channel`` (optional, default false): one IR a channel, each
  made in turn by the ``ir.generator`` from the one ``ir.seed``
  (``lib/inputs.py``), in place of one IR that every channel shares. It
  takes no ``mask``: a mask is made for one shared filter;
- ``tiny`` (optional): the small sizes of the CPU tests
  (``benchmark/tests/tiny.py``), merged over theirs.

A configuration is named by its ``BENCHMARK.json`` entry, or by the path
of its file (one not yet listed: the CPU tests' fixtures, or one being
sized with ``limits.py`` and ``run.py --config``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "benchmark"

# make_engine's engines, beside the default Convolver
ENGINES = ("convolver", "perblock", "nested", "chunked", "hybrid")
# the engines that process in chunks of ``chunk_blocks`` blocks
CHUNKED = ("nested", "chunked", "hybrid")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config_file(config: str) -> Path:
    """The file of a configuration: its ``BENCHMARK.json`` entry's, or
    ``config`` itself where it names a ``.json`` file."""
    if config.endswith(".json"):
        path = Path(config)
        return path if path.is_absolute() else ROOT / path
    entry = next((c for c in benchmark()["configs"] if c["name"] == config), None)
    if entry is None:
        raise KeyError(f"no configuration {config!r} in BENCHMARK.json")
    return ROOT / entry["file"]


def traffic_names() -> list[str]:
    return sorted(p.stem for p in (PKG / "traffic").glob("*.json"))


def engine(config: dict) -> str:
    return config.get("engine", "convolver")


def pairing_error(config: dict, traffic: dict) -> str | None:
    """Why a configuration cannot run a traffic mix (at the sizes given),
    or None where it can."""
    if config["ir"].get("per_channel") and config.get("mask"):
        return "ir.per_channel and mask: a mask is made for one shared filter, not one a channel"
    kind = engine(config)
    if kind not in ENGINES:
        return f"unknown engine {kind!r} (have {list(ENGINES)})"
    if kind == "convolver":
        return None
    if traffic["entry"] != "process":
        return f"engine {kind!r} has no per-block entry, so it takes no {traffic['entry']!r} mix"
    if kind in CHUNKED:
        s = config.get("chunk_blocks")
        if not s:
            return f"engine {kind!r} needs chunk_blocks"
        if traffic["call_blocks"] % s:
            return (f"call_blocks {traffic['call_blocks']} is not a multiple of chunk_blocks {s}: "
                    f"engine {kind!r} carries its state exactly only across calls of whole chunks")
    return None


def check_pairing(config: dict, traffic: dict, what: str) -> None:
    """Raise ValueError, naming ``what``, where the configuration cannot
    run the traffic mix."""
    err = pairing_error(config, traffic)
    if err is not None:
        raise ValueError(f"{what}: {err}")


def mixes(config: str) -> list[str]:
    """The traffic mixes (``benchmark/traffic/*.json``) a configuration
    takes."""
    cfg = load_json(config_file(config))
    return [t for t in traffic_names() if pairing_error(cfg, load_json(PKG / "traffic" / f"{t}.json")) is None]


def cell(workload: str) -> dict:
    """``{"workload", "config", "traffic", "end_to_end", "per_layer"}`` of
    the cell named ``workload``; raises KeyError for an unknown name and
    ValueError for a configuration that cannot run its traffic mix."""
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    return _resolve(cells[workload])


def cell_for(config: str, traffic: str) -> dict:
    """The cell of a configuration (a name, or the path of its file) under
    a traffic mix, whether or not ``BENCHMARK.json`` lists it (the CPU
    tests drive every mix). An unlisted cell reports the metrics that the
    listed cells of its traffic mix report."""
    for w in benchmark()["workloads"]:
        if (w["config"], w["traffic"]) == (config, traffic):
            return _resolve(w)
    name = load_json(config_file(config))["name"] if config.endswith(".json") else config
    return _resolve({"name": f"{name}.{traffic}", "config": config, "traffic": traffic, "chips": 1})


def add_cell_arguments(ap) -> None:
    """A command's choice of cell: ``--workload <cell>``, or ``--config
    <file> --traffic <mix>``."""
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload", help="a cell of BENCHMARK.json")
    which.add_argument("--config", help="a configuration file, listed or not, with --traffic")
    ap.add_argument("--traffic", help="the traffic mix of --config")


def cell_of(args) -> dict:
    """The cell that :func:`add_cell_arguments`' arguments name."""
    if args.workload is not None:
        if args.traffic is not None:
            raise ValueError("--traffic goes with --config, not --workload")
        return cell(args.workload)
    if args.traffic is None:
        raise ValueError("--config needs --traffic")
    return cell_for(args.config, args.traffic)


def _resolve(w: dict) -> dict:
    bench = benchmark()
    listed = {v["name"] for v in bench["workloads"]}
    peers = {v["name"] for v in bench["workloads"] if v["traffic"] == w["traffic"]}

    def applies(m):
        if "workloads" not in m:
            return True
        return w["name"] in m["workloads"] if w["name"] in listed else bool(peers & set(m["workloads"]))

    config = load_json(config_file(w["config"]))
    traffic = load_json(PKG / "traffic" / f"{w['traffic']}.json")
    check_pairing(config, traffic, f"cell {w['name']}")
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (irs, masks, signals)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_reader(name: str):
    """The ``read(run) -> float | None`` of ``benchmark/metrics/<name>.py``
    (metric names hold dots, so the file is loaded by path)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
