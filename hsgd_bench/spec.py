"""Finding a cell's parts by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file; a traffic mix, read from ``traffic/<name>.json``;
and the limits of its correctness check, ``limits/<cell>.json``. The
configuration file names its plain reference under ``"reference"``:
``reference/<name>.py``, ``model`` when the key is absent, a module holding
every function of ``REFERENCE_CONTRACT`` (``reference/model.py`` states what
each does), loaded by its path. Each per-layer metric is
``metrics/<name>.py``. Adding any of them is adding a file and an entry:
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REFERENCE_CONTRACT = ("check_supported", "param_layout", "tower", "loss", "backbone_flops",
                      "tower_flops", "in_proj_flops", "backbone_scans", "tower_scans")
MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, here: Path = HERE):
    return _load(f"hsgd_bench.metrics.{name}", here / "metrics" / f"{name}.py")


def reference_module(name, here: Path = HERE):
    """``reference/<name>.py``, checked for every function of the contract."""
    path = here / "reference" / f"{name}.py"
    if not (isinstance(name, str) and MODULE.fullmatch(name) and path.is_file()):
        raise SystemExit(f"configuration key 'reference' = {name!r}: no module {path}")
    mod = _load(f"hsgd_bench.reference.{name}", path)
    missing = [f for f in REFERENCE_CONTRACT if not callable(getattr(mod, f, None))]
    if missing:
        raise SystemExit(f"configuration key 'reference': {path} lacks {', '.join(missing)} "
                         f"of the reference contract")
    return mod


def load_cell(name: str, bench: Dict, root: Path = ROOT) -> Dict:
    """Everything one run of cell ``name`` reads."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    work = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    here = root / "hsgd_bench"
    config = load_json(root / conf["file"])
    per_layer: List[Dict] = [m for m in bench["per_layer"]
                             if name in m.get("workloads", [name])]
    return {
        "workload": work,
        "config": config,
        "reference": reference_module(config.get("reference", "model"), here),
        "traffic": load_json(here / "traffic" / f"{work['traffic']}.json"),
        "limits": load_json(here / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [dict(m, module=metric_module(m["name"], here)) for m in per_layer],
    }
