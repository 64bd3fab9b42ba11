"""`BENCHMARK.json` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its correctness limits ``limits/<cell>.json``,
and each metric has a reader ``metrics/<metric>.py`` whose ``read(run)``
gives the number or None. The traffic's ``kind`` names the module
``loops/<kind>.py`` that makes the mix's inputs (``make``) and runs the cell
(``run``), and the configuration's ``reference`` its plain reference,
``reference/<reference>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _read(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = dict(cells[name])
    w["cfg"] = _read("configs", f"{w['config']}.json")
    w["limits"] = _read("limits", f"{name}.json")
    return w


def metrics_for(name: str, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    without trace, its per-layer metrics with."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traffic_kind(name) -> str:
    return (_read("traffic", f"{name}.json") if isinstance(name, str) else name)["kind"]


def reference(cfg: Dict):
    return importlib.import_module(f"bench_h100.reference.{cfg['reference']}")


def loop(kind: str):
    return importlib.import_module(f"bench_h100.loops.{kind}")
