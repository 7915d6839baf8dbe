"""A new configuration (with a new mesh kind), traffic mix, entry and
per-layer metric are new files plus new entries in ``BENCHMARK.json``:
added to a copy of the benchmark's folder, they run without an edit to
any file that is there."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import torch

from benchmark import run
from benchmark.lib import cells
from benchmark.tests import tiny

TETRA = '''
import numpy as np


def make(size=1.0):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    t = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.uint32)
    return v * np.float32(size), t
'''
ENTRY = '''
from benchmark.entries.generate import Entry as Generate


class Entry(Generate):
    """The generate loop, one mesh of the pool judged twice as often."""
'''
READER = '''
def read(record):
    spans = record.get("spans")
    return None if spans is None else float(len(spans.ms.get("bin", [])))
'''


def _digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, folder)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(text)


def test_new_cell_from_new_files_only(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(cells.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tiny.tiny_bench(str(tmp_path))   # cuts the configurations' sizes
    before = _digests(str(here))
    conf = json.load(open(os.path.join(cells.HERE, "configs",
                                       "box36_256.json")))
    conf.update(name="tetra_16", triangles=4,
                mesh={"kind": "tetra", "params": {"size": 1.5}},
                grid={"mode": "2a", "nx": 16, "padding": 1})
    _write(str(tmp_path / "benchmark/configs/tetra_16.json"),
           json.dumps(conf))
    _write(str(here / "meshes/tetra.py"), TETRA)
    traffic = json.load(open(os.path.join(cells.HERE, "traffic",
                                          "generate.json")))
    traffic.update(entry="generate_twice", pool=2, judged_calls=1)
    _write(str(here / "traffic/generate_small.json"), json.dumps(traffic))
    _write(str(here / "entries/generate_twice.py"), ENTRY)
    _write(str(here / "metrics/bin_calls.generate_small.py"), READER)
    limits = json.load(open(os.path.join(cells.HERE, "limits",
                                         "sphere82k_256.generate.json")))
    _write(str(here / "limits/tetra_16.generate_small.json"),
           json.dumps(limits))
    b["configs"].append({"name": "tetra_16", "source": "a test",
                         "file": "benchmark/configs/tetra_16.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tetra_16.generate_small",
                           "config": "tetra_16", "traffic": "generate_small",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "voxels_per_s", "unit": "Mvoxels/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tetra_16.generate_small"]})
    b["per_layer"].append({"name": "bin_calls.generate_small",
                           "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "host work",
                           "moves": "voxels_per_s",
                           "workloads": ["tetra_16.generate_small"]})
    for traced in (False, True):
        line = run.run_cell(b, "tetra_16.generate_small", 3, 0.3, traced,
                            torch.device("cpu"), root=str(tmp_path),
                            here=str(here))
        assert line["correct"] is True, line["checks"]
        assert line["attempted"] > 0
        if traced:
            assert line["metrics"]["bin_calls.generate_small"]["value"] \
                == line["attempted"]
        else:
            assert {"voxels_per_s", "setup_s"} <= set(line["metrics"])
    after = _digests(str(here))
    assert {k: after[k] for k in before} == before
