"""The readers of the program's spans (``lib/spans.py`` and the metrics
that use it): each gives the median it should from a synthetic set of
spans, three calls or steps of known times, and None from an empty set
and from spans without device times where it reads device times."""

from __future__ import annotations

import itertools

import pytest

from benchmark.lib import cells, spans
from benchmark.tests import tiny
from sdfgenfast_tpu_torch.tracing import Record

BENCH = tiny.bench()
WORKLOAD = {m["name"]: m["workloads"][0] for m in BENCH["per_layer"]}

# each reader's median over the three calls (scales 1, 2, 3) below
WANT = {"parity_ms.generate": 8.0, "band_bin_ms.generate": 6.0,
        "blob_up_ms.generate": 1.0, "band_dev_ms.generate": 4.0,
        "glue_ms.generate": 6.0, "link_ms.generate": 4.0,
        "touch_ms.generate": 12.0, "launches.generate": 21,
        "table_host_ms.train": 1.0, "table_dev_ms.train": 0.5}
DEVICE = {"band_dev_ms.generate", "glue_ms.generate", "link_ms.generate",
          "table_dev_ms.train"}


def _calls(mix: str, device: bool = True):
    """Spans of three calls of `mix` ("generate" or "train"), scaled 3, 1,
    2: each generate call's bin_mesh, make_level_set3 and to_host are
    roots of their own, as in the traced run's calls, and so are each
    step's forward and backward."""
    ids = itertools.count(1)
    out = []

    def add(name, host, dev=None, parent=None, launches=0):
        i = next(ids)
        root = i if parent is None else parent.root
        r = Record(name, i, None if parent is None else parent.id, root,
                   0, int(host * 1e6), dev if device else None, launches)
        out.append(r)
        return r

    for c, s in enumerate((3, 1, 2)):
        if mix == "train":
            f = add("sdf.make_level_set3", 2 * s, 3 * s)
            add("sdf.dense.table", 0.5 * s, 0.25 * s, parent=f)
            add("sdf.dense.k1", 0.1, 1 * s, parent=f)
            add("sdf.recompute.backward", 0.1, 1 * s)
            continue
        b = add("sdf.bin_mesh", 10 * s)
        add("sdf.bin.parity", 4 * s, parent=b)
        add("sdf.bin.band", 2 * s, parent=b)
        add("sdf.bin.csr", 1 * s, parent=b)
        add("sdf.bin.upload", 0.5 * s, parent=b)
        m = add("sdf.make_level_set3", 1 * s, 10 * s,
                launches=[22, 20, 21][c])
        add("sdf.band", 0.1, 2 * s, parent=m)
        f = add("sdf.far_field", 0.5, 6 * s, parent=m)
        add("sdf.k3", 0.1, 2 * s, parent=f)
        add("sdf.k3", 0.1, 1 * s, parent=f)
        add("sdf.chamfer", 0.1, 0.2 * s, parent=m)
        t = add("sdf.to_host", 9 * s)
        for _ in range(2):
            add("sdf.to_host.link", 0.01, 1 * s, parent=t)
            add("sdf.to_host.touch", 3 * s, parent=t)
    return out


def _mix(name: str) -> str:
    return name.rsplit(".", 1)[1]


def _read(name, monkeypatch, got):
    monkeypatch.setattr(spans, "records", lambda: got)
    cell = cells.find(BENCH, WORKLOAD[name], tiny.REPO)
    return cell.reader(name).read({"platform": "gpu"})


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_median(name, monkeypatch):
    got = _read(name, monkeypatch, _calls(_mix(name)))
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing(name, monkeypatch):
    assert _read(name, monkeypatch, []) is None
    no_device = _read(name, monkeypatch, _calls(_mix(name), device=False))
    if name in DEVICE:
        assert no_device is None
    else:
        assert no_device == pytest.approx(WANT[name])


def test_every_span_reader_is_in_the_benchmark():
    names = {m["name"] for m in BENCH["per_layer"]
             if m["source"] in ("program_span", "program_counter")}
    assert names == set(WANT)


def test_records_reads_the_program_ring():
    from sdfgenfast_tpu_torch import tracing

    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("sdf.bin.parity"):
            pass
    finally:
        tracing.disable()
    got = spans.records()
    tracing.clear()
    assert [r.name for r in got] == ["sdf.bin.parity"]
    assert spans.median({"sdf.bin.parity"}, spans.host_ms, got) >= 0
