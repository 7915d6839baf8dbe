"""The sharded cell, ``sphere82k_1024.sharded4``: its configuration's grid,
its entry end to end on CPU devices from a cut copy of the configuration
(``tiny_sharded.py``), its check's border cells, its per-layer readers on
made-up spans, and ``lib/cards.py``'s per-card summary on made-up events
over two devices."""

from __future__ import annotations

import itertools
import types

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.lib import cards, cells, sizing, spans
from benchmark.tests import tiny, tiny_sharded
from sdfgenfast_tpu_torch.tracing import Record

BENCH = tiny.bench()
SEED = 2**31 + 303


def test_configuration_is_the_full_grid():
    cell = cells.find(BENCH, tiny_sharded.WORKLOAD, tiny.REPO)
    verts, tris = cell.mesh()
    g = cell.config["grid"]
    _, dx, shape = sizing.mode2a(verts.min(0), verts.max(0), g["nx"],
                                 g["padding"])
    assert len(tris) == cell.config["triangles"] == 81920
    assert shape == (1024, 1024, 1024) == tuple(g["shape"])
    assert dx == pytest.approx(0.0019569, abs=5e-8)
    assert cell.config["device_mesh"] == [2, 2] and cell.chips == 4
    blocks = (shape[0], shape[1] // 2, shape[2] // 2)
    assert all(b % 8 == 0 for b in blocks)


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("root"))
    return tiny_sharded.tiny_bench(root), root


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_end_to_end_on_cpu_devices(tiny_cell, traced):
    b, root = tiny_cell
    line = run.run_cell(b, tiny_sharded.WORKLOAD, SEED, 0.3, traced,
                        torch.device("cpu"), root=root)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["count"] == 4
    five = {"band_err_dx", "far_mean_dx", "over_dx", "under_dx", "sign_err"}
    limits = cells.find(b, tiny_sharded.WORKLOAD, root).limits
    assert five < set(line["checks"]) == set(limits)
    assert {f"border_{k}" for k in five} <= (set(line["checks"])
                                             | set(line["readings"]))
    if not traced:
        assert "setup_s" in line["metrics"]


def test_border_cells_lie_on_the_boundary_planes(tiny_cell):
    b, root = tiny_cell
    cell = cells.find(b, tiny_sharded.WORKLOAD, root)
    entry = cell.entry().Entry(cell, SEED, torch.device("cpu"))
    entry.setup()
    assert entry.border_planes(1) == entry.border_planes(2) == [31, 32]
    flat = entry.border(5)
    assert len(flat) == cell.traffic["check_cells_border"]
    i, j, k = np.unravel_index(flat, entry.shape)
    assert (np.isin(j, (31, 32)) | np.isin(k, (31, 32))).all()
    again = entry.border(5)
    assert np.array_equal(flat, again)
    all_, mask = entry.cells_of(5)
    assert np.isin(flat, all_).all() and mask.sum() == len(np.unique(flat))
    # half of them near the surface: within the reach of its trace in the
    # plane (an offset of up to the reach on both axes of the plane)
    centre = np.asarray(entry.shape) / 2
    r = np.sqrt((i - centre[0]) ** 2 + (j - centre[1]) ** 2
                + (k - centre[2]) ** 2)
    radius = 1.0 / entry.dx
    reach = cell.traffic["border_reach_cells"] * np.sqrt(2) + 2
    assert (np.abs(r - radius) <= reach).sum() >= len(flat) // 2


# -- the readers --------------------------------------------------------------

# each reader's median over the three calls (scales 3, 1, 2) below
WANT = {"shard_bin_ms.sharded4": 4.0, "shard_upload_ms.sharded4": 2.4,
        "halo_ms.sharded4": 6.0, "halo_gb.sharded4": 12.0,
        "card_ms.sharded4": 46.0, "assemble_ms.sharded4": 20.0,
        "launches.sharded4": 240}
DEVICE = {"card_ms.sharded4"}


def _calls(device: bool = True):
    """Spans of three sharded calls of two meshes on four cards, scaled 3,
    1, 2, as the program records them under each call's root."""
    ids = itertools.count(1)
    out = []

    def add(name, host, dev=None, parent=None, launches=0, counts=None):
        i = next(ids)
        root = i if parent is None else parent.root
        r = Record(name, i, None if parent is None else parent.id, root, 0,
                   int(host * 1e6), dev if device else None, launches,
                   counts or {})
        out.append(r)
        return r

    for c, s in enumerate((3, 1, 2)):
        top = add("sdf.generate_sdf_batch", 100 * s,
                  launches=[250, 230, 240][c])
        for m in range(2):
            b = add("sdf.sharded.bin", 1 * s, parent=top)
            add("sdf.bin.parity", 0.5 * s, parent=b)
            f = add("sdf.sharded.fields", 5 * s, parent=top)
            for card in range(4):
                add("sdf.sharded.card", 5 * s, (8 + card + m) * s, parent=f)
            for _ in range(3):
                add("sdf.sharded.upload", 0.2 * s, parent=f)
            add("sdf.sharded.halo", 0.5 * s, parent=f,
                counts={"bytes": int(1e9) * s})
            add("sdf.sharded.halo", 1.0 * s, parent=f,
                counts={"bytes": int(2e9) * s})
            add("sdf.sharded.assemble", 5 * s, parent=top)
            t = add("sdf.to_host", 4 * s, parent=top)
            add("sdf.to_host.touch", 3 * s, parent=t)
    return out


def _read(name, monkeypatch, got):
    monkeypatch.setattr(spans, "records", lambda: got)
    cell = cells.find(BENCH, tiny_sharded.WORKLOAD, tiny.REPO)
    return cell.reader(name).read({"platform": "gpu"})


def test_the_cell_reports_these_readers():
    cell = cells.find(BENCH, tiny_sharded.WORKLOAD, tiny.REPO)
    assert {m["name"] for m in cell.per_layer} == set(WANT)
    assert {m["name"] for m in cell.end_to_end} == {"peak_mem_mib",
                                                    "setup_s"}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_median(name, monkeypatch):
    assert _read(name, monkeypatch, _calls()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing(name, monkeypatch):
    assert _read(name, monkeypatch, []) is None
    no_device = _read(name, monkeypatch, _calls(device=False))
    if name in DEVICE:
        assert no_device is None
    else:
        assert no_device == pytest.approx(WANT[name])


# -- lib/cards.py ---------------------------------------------------------------


def _event(name, kind, start, end, index=-1):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=getattr(DeviceType, kind), device_index=index,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_cards_busy_is_the_per_card_mean():
    events = [
        _event("bench.slice", "CPU", 0, 100),
        _event("bench.call", "CPU", 0, 100),
        _event("bench.call", "CUDA", 0, 100, 0),       # an annotation
        _event("sdf.sharded.halo", "CPU", 40, 60),
        _event("sdf.sharded.halo", "CUDA", 40, 60, 1),  # an annotation
        # card 0: 10-30 and 20-50 overlap (40 busy); card 1: 0-10, 90-110
        # (clipped to 100: 20 busy); card 2 is not in the slice
        _event("vdt_round_kernel", "CUDA", 10, 30, 0),
        _event("vdt_round_kernel", "CUDA", 20, 50, 0),
        _event("Memcpy DtoH", "CUDA", 0, 10, 1),
        _event("vdt_round_kernel", "CUDA", 90, 110, 1),
        _event("vdt_round_kernel", "CUDA", 0, 100, 2),
    ]
    got = cards.summary(events, 2, [0, 1])
    assert got["cards"] == {0: 40, 1: 20}
    assert got["busy_us"] == 30 and got["window_us"] == 100
    assert got["calls"] == 2
    assert got["kernels"] == {"vdt_round_kernel": 20 + 30 + 20,
                              "Memcpy DtoH": 10}
    # the idle time of both cards, each gap named by the host's range at
    # its middle and summed over the cards
    assert got["gaps"] == {"bench.call": 10 + 50,
                           "bench.call > sdf.sharded.halo": 80}
    assert cards.summary(events[:5], 2, [0, 1]) is None
