"""`BENCHMARK.json` against the benchmark's contract, and the harness's
imports."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from bench_h100 import manifest

ROOT = manifest.ROOT
BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cdsegnet_tpu"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24 and 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128 and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(ROOT, p))
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", METRICS + BENCH["workloads"] + BENCH["configs"],
                         ids=lambda e: e["name"])
def test_names_units_and_keys(entry):
    assert NAME.match(entry["name"])
    if entry in METRICS:
        allowed = {"name", "unit", "better", "source"} | (
            {"bound"} if entry in BENCH["end_to_end"] else {"layer", "moves"})
        assert set(entry) - {"workloads"} == allowed
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    elif entry in BENCH["workloads"]:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    else:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    for key in ("why", "layer", "source"):
        if key in entry and entry is not None:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(len(BENCH["workloads"]) // 4, 1)


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_set_up_another_end_to_end_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(cell, m) for m in BENCH["per_layer"])


def test_moves_names_an_end_to_end_metric_of_every_cell_that_reports_the_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "workloads" in m and set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            assert _reports(cell, e2e[m["moves"]]), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(len(v) >= 1 for v in layers.values())


def test_every_name_has_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"] == f"bench_h100/configs/{c['name']}.json"
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        manifest.reference(cfg)
    for w in BENCH["workloads"]:
        cell = manifest.cell(w["name"])
        assert set(cell["limits"]) and manifest.loop(manifest.traffic_kind(w["traffic"]))
    for m in METRICS:
        assert callable(manifest.reader(m["name"]))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    base = os.path.join(manifest.HERE, sub)
    for d, _, files in os.walk(base):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "cdsegnet_torch", (path, name)


def test_only_the_program_module_imports_the_port():
    for path in _sources():
        if os.path.basename(path) == "program.py" or "/tests/" in path:
            continue
        for name in _imports(path):
            assert name.split(".")[0] != "cdsegnet_torch", (path, name)
