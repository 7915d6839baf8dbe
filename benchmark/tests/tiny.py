"""A copy of ``BENCHMARK.json`` whose configurations are cut to a size the
CPU runs in seconds (the program's plain-torch twins), for the tests."""

from __future__ import annotations

import copy
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {"sphere82k_256": {"mesh": {"kind": "icosphere",
                                   "params": {"subdivisions": 3,
                                              "radius": 1.0}},
                          "grid": {"mode": "2a", "nx": 24, "padding": 1}},
        "box36_256": {"grid": {"mode": "2a", "nx": 20, "padding": 1}}}


# A cell left out of BENCHMARK.json for now (its rate swings with the copy
# back's first touch of the result); its check and limits stay tested.
DEFERRED = [{"name": "box36_256.generate", "config": "box36_256",
             "traffic": "generate", "chips": 1,
             "why": "generate_sdf back to back on the dense path"}]


def bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def tiny_bench(tmp: str, deferred: bool = False) -> dict:
    """BENCHMARK.json with each configuration's file replaced by a small
    copy written under `tmp` (which then serves as the checkout's root);
    with `deferred`, the cells of ``DEFERRED`` added."""
    b = copy.deepcopy(bench())
    if deferred:
        b["workloads"] += copy.deepcopy(DEFERRED)
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            conf = json.load(fh)
        conf.update(copy.deepcopy(TINY.get(c["name"], {})))
        path = os.path.join(tmp, c["file"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(conf, fh)
    return b
