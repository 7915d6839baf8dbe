"""``tiny.py``'s copy of ``BENCHMARK.json`` with the sharded configuration
cut too: icosphere(3) (1,280 triangles, so the binned path) at a mode-2a
grid of 64^3, whose (2, 2) blocks of 64 x 32 x 32 are multiples of the 8^3
tile and whose boundary planes are j, k in {31, 32}."""

from __future__ import annotations

import json
import os

from benchmark.tests import tiny

CONFIG = "sphere82k_1024"
WORKLOAD = "sphere82k_1024.sharded4"
TINY = {"mesh": {"kind": "icosphere",
                 "params": {"subdivisions": 3, "radius": 1.0}},
        "triangles": 1280,
        "grid": {"mode": "2a", "nx": 64, "padding": 1,
                 "shape": [64, 64, 64]}}


def tiny_bench(tmp: str) -> dict:
    """``tiny.tiny_bench(tmp)`` with the sharded configuration's file, under
    `tmp`, cut to ``TINY``."""
    b = tiny.tiny_bench(tmp)
    conf_file = {c["name"]: c["file"] for c in b["configs"]}[CONFIG]
    path = os.path.join(tmp, conf_file)
    with open(path) as fh:
        conf = json.load(fh)
    conf.update(TINY)
    with open(path, "w") as fh:
        json.dump(conf, fh)
    return b
