"""BENCHMARK.json and every file it names: present, loadable, and written
to the benchmark's contract (names, units, keys, limits)."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.lib import cells
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = cells.HERE
BENCH = tiny.bench()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_keys(key, entry):
    assert NAME.match(entry["name"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[key]
    assert set(entry) <= allowed
    texts = {"configs": ("why", "source"), "workloads": ("why",),
             "per_layer": ("layer",), "end_to_end": ()}[key]
    for text in texts:
        assert 1 <= len(entry[text]) <= 200
        assert "\n" not in entry[text] and "\t" not in entry[text]
    if key in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    if key == "end_to_end":
        assert entry["source"] in ("device_trace", "host_clock")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "workloads":
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(workload):
    cell = cells.find(BENCH, workload, tiny.REPO)
    assert cell.entry().Entry is not None
    verts, tris = cell.mesh()
    assert verts.dtype.name == "float32" and tris.dtype.name == "uint32"
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_configs_are_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(tiny.REPO, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["name"] == c["name"]
        assert "assumed" in conf and "sdf_config" in conf
    for c in BENCH["configs"]:
        assert not c["reduced"]


def test_per_layer_metrics_have_cells_and_layers():
    names = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= names
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", names))
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py"))


def test_every_file_name_is_made_of_name_characters():
    for base, _, files in os.walk(HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), HERE)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
