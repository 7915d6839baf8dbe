"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

Each piece lives in a file of its own under the benchmark's folder, so a
new configuration, traffic mix, entry, metric or mesh kind is a new file
and a new entry in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the mesh
  (``mesh.kind`` names ``meshes/<kind>.py`` and ``mesh.params`` its
  arguments), the grid (``grid.nx``, ``grid.padding``: the upstream's mode
  2a), the program's ``sdf_config`` and the seeded jitter of its meshes;
- ``traffic/<traffic>.json``: the mix's parameters, and ``entry``, which
  names ``entries/<entry>.py``, the code that drives it;
- ``limits/<workload>.json``: each number the check compares, with its
  limit and the readings it was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: str):
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    here: str = HERE

    def entry(self):
        name = self.traffic["entry"]
        return load_module(os.path.join(self.here, "entries", f"{name}.py"),
                           f"benchmark_entry_{name}")

    def mesh(self):
        """(verts float32 (N, 3), tris uint32 (M, 3)) of the configuration."""
        spec = self.config["mesh"]
        gen = load_module(os.path.join(self.here, "meshes",
                                       f"{spec['kind']}.py"),
                          f"benchmark_mesh_{spec['kind']}")
        return gen.make(**spec.get("params", {}))

    def reader(self, metric: str):
        return load_module(os.path.join(self.here, "metrics", f"{metric}.py"),
                           f"benchmark_metric_{metric}")


def _reports(metric: dict, workload: str) -> bool:
    """Whether `workload` reports `metric`: a metric without ``workloads``
    is every cell's (its reader returns nothing where it finds nothing)."""
    return workload in metric.get("workloads", [workload])


def find(bench: dict, workload: str, root: str, here: str = HERE) -> Cell:
    """The cell named `workload` of `bench` (``BENCHMARK.json`` read), its
    files under `root` (the checkout) and `here` (the benchmark's folder)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(here, "limits", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, here)
