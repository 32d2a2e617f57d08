"""Finding a cell's pieces by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration, traffic mix and metrics. Each piece is a file of its own
under the benchmark's folder, found by its name alone:
- `configs/<config>.json`: the network's sizes as run;
- `traffic/<traffic>.json`: the mix's parameters, read by the one cell runner;
- `metrics/<metric>.py`: a reader of one per-layer metric, a function
  `read(rec)` that returns the number or None where it finds nothing;
- `limits/<cell>.json`: the limit of each number the correctness check
  compares in that cell;
- `reference/trunks/<trunk_block_type>.py`: the plain reference of the
  configuration's trunk, its parameters and their draws, and its
  operation count (the interface is in `reference/network.py`).
Adding a cell adds files and entries, of any trunk type the program
builds; no file here, and no file of the harness, changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_names(root: str = ROOT) -> List[str]:
    return [w["name"] for w in load_benchmark(root)["workloads"]]


def _metric_applies(metric: dict, cell: str, e2e_here: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_here


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` with its configuration, traffic, metrics and limits."""
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(by_name)}")
    w = by_name[name]
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    with open(os.path.join(bench_dir, "configs", w["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", name + ".json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _metric_applies(m, name, names)]
    return {"name": name, "workload": w, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer, "limits": limits,
            "bench_dir": bench_dir}


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`read` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    return _load(path, "portbench_metric_" + name.replace(".", "_")).read


def trunk_module(config: dict, bench_dir: str = BENCH_DIR):
    """reference/trunks/<trunk_block_type>.py of the configuration; "btl"
    where it names none, as the program's `ModelConfig` defaults."""
    kind = config.get("trunk_block_type", "btl")
    path = os.path.join(bench_dir, "reference", "trunks", kind + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no reference trunk for trunk_block_type {kind!r}: {path} is missing")
    return _load(path, "portbench_trunk_" + kind)


def read_metrics(cell: dict, rec) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in cell["per_layer"]:
        value = metric_reader(m["name"], cell["bench_dir"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
