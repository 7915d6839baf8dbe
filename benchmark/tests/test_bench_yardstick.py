"""The yardstick's frozen pieces: the meshes and grids of the
configurations, the seeded pools, and K3's bytes."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.lib import cells, pool, pyramid, sizing
from benchmark.tests import tiny

BENCH = tiny.bench()


@pytest.mark.parametrize("name,tris,shape", [
    ("sphere82k_256", 81920, (256, 256, 256)),
    ("box36_256", 36, (256, 341, 425))])
def test_configuration_mesh_and_grid(name, tris, shape):
    w = next(w["name"] for w in BENCH["workloads"] if w["config"] == name)
    cell = cells.find(BENCH, w, tiny.REPO)
    verts, t = cell.mesh()
    assert len(t) == tris == cell.config["triangles"]
    g = cell.config["grid"]
    _, _, got = sizing.mode2a(verts.min(0), verts.max(0), g["nx"],
                              g["padding"])
    assert got == shape == tuple(g["shape"])


@pytest.mark.parametrize("name", ["sphere82k_256", "box36_256"])
def test_pool_meshes_stay_inside_the_padding(name):
    w = next(w["name"] for w in BENCH["workloads"] if w["config"] == name)
    cell = cells.find(BENCH, w, tiny.REPO)
    verts, _ = cell.mesh()
    g = cell.config["grid"]
    origin, dx, shape = sizing.mode2a(verts.min(0), verts.max(0), g["nx"],
                                      g["padding"])
    # moved towards the origin by 0.05 to 0.5 cells; a rotation of the
    # sphere reaches no further than its radius
    lo = verts.min(0) - 0.51 * dx
    hi = verts.max(0) - 0.04 * dx
    ps = pool.pool(verts, dx, 8, 2**31 + 17, cell.config["jitter"], 0.5)
    again = pool.pool(verts, dx, 8, 2**31 + 17, cell.config["jitter"], 0.5)
    for a, b in zip(ps, again):
        assert np.array_equal(a, b)
        assert (a.min(0) >= lo).all() and (a.max(0) <= hi).all()
    assert not np.array_equal(ps[0], ps[1])


def test_k3_rounds_and_bytes_at_256():
    # 256^3: levels 256^3, 128^3, 64^3 (64 > 48, three levels at most);
    # the coarsest runs the ladder 32, 16, 8, 4, 2, 1 and one stride-1
    # round (7), the middle level 5, the finest 5 + 2 polish: 19 rounds
    got = pyramid.rounds((256, 256, 256))
    assert got == [((64, 64, 64), 7), ((128, 128, 128), 5),
                   ((256, 256, 256), 7)]
    want = 40 * (7 * 64**3 + 5 * 128**3 + 7 * 256**3)
    assert want == 5_190_451_200
    assert pyramid.k3_bytes((256, 256, 256)) == want


def test_k3_rounds_of_the_box_grid():
    # 256 x 341 x 425 is permuted to (256, 341, 425) -> levels halve to
    # (64, 86, 107): ladder of max 107 = 64 .. 1 (7) + 1
    got = pyramid.rounds((256, 341, 425))
    assert [n for _, n in got] == [8, 5, 7]
    assert sum(n for _, n in got) == 20


def test_traced_rate_counts_every_call_over_their_walls():
    from benchmark.lib import trace

    reader = cells.find(BENCH, "sphere82k_256.generate",
                        tiny.REPO).reader("voxels_per_s.generate")
    spans = trace.Spans()
    for ms in (100.0, 300.0):
        spans.add("call", ms)
    # 1000 cells, two calls in 0.4 s: 5000 cells a second
    got = reader.read({"spans": spans, "shape": (10, 10, 10)})
    assert got == pytest.approx(5000 / 1e6)
    assert reader.read({"spans": None, "shape": (10, 10, 10)}) is None
