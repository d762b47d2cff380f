"""Finding a cell's parts by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file; a traffic mix, read from ``traffic/<name>.json``;
and the limits of its correctness check, ``limits/<cell>.json``. Each
per-layer metric is ``metrics/<name>.py``. Adding any of them is adding a
file and an entry: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def metric_module(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hsgd_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: Dict, root: Path = ROOT) -> Dict:
    """Everything one run of cell ``name`` reads."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    work = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    here = root / "hsgd_bench"
    per_layer: List[Dict] = [m for m in bench["per_layer"]
                             if name in m.get("workloads", [name])]
    return {
        "workload": work,
        "config": load_json(root / conf["file"]),
        "traffic": load_json(here / "traffic" / f"{work['traffic']}.json"),
        "limits": load_json(here / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [dict(m, module=metric_module(m["name"], here)) for m in per_layer],
    }
