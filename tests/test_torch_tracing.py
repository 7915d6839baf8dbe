"""The port's tracer (``sdfgenfast_tpu_torch/tracing.py``) on the CPU.

Off, a span is one check: with the span class, ``record_function``,
``torch.cuda.Event`` and the launch counters' reader made to raise, every
entry point still runs and nothing is recorded. On, by ``enable()`` or
under ``torch.profiler``, the spans of a binned and of a dense call form
one tree under one root, host times nested in their parents; only the
host ranges enter the profiler's trace. Results are bit-equal on and off.
The launch delta, the registry of kernel wrappers it sums, self time, the
ring's bound and explicit parents on a worker thread are checked on their
own."""

import importlib
import threading

import numpy as np
import pytest
import torch

import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import tracing, upload
from sdfgenfast_tpu_torch.kernels import build
from sdfgenfast_tpu_torch.models import SDFGenerator
from sdfgenfast_tpu_torch.ops import dense as dense_ops
from sdfgenfast_tpu_torch.ops import vdt_kernel
from sdfgenfast_tpu_torch.tools import micro_bench  # noqa: F401

CPU = torch.device("cpu")

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

N = 16
GRID = P.GridSpec((-1.4,) * 3, 2.8 / N, (N,) * 3)

# each span's parent, by name, in one generate_sdf call
BINNED_TREE = {
    "sdf.generate_sdf": None,
    "sdf.bin_mesh": "sdf.generate_sdf",
    "sdf.bin.parity": "sdf.bin_mesh",
    "sdf.bin.band": "sdf.bin_mesh",
    "sdf.bin.csr": "sdf.bin_mesh",
    "sdf.bin.upload": "sdf.bin_mesh",
    "sdf.upload.pack": "sdf.bin.upload",
    "sdf.make_level_set3": "sdf.generate_sdf",
    "sdf.band": "sdf.make_level_set3",
    "sdf.far_field": "sdf.make_level_set3",
    "sdf.k3": "sdf.far_field",
    "sdf.chamfer": "sdf.make_level_set3",
    "sdf.sign": "sdf.make_level_set3",
    "sdf.to_host": "sdf.generate_sdf",
    "sdf.to_host.touch": "sdf.to_host",
}
DENSE_TREE = {
    "sdf.generate_sdf": None,
    "sdf.bin_mesh": "sdf.generate_sdf",
    "sdf.bin.parity": "sdf.bin_mesh",
    "sdf.bin.upload": "sdf.bin_mesh",
    "sdf.upload.pack": "sdf.bin.upload",
    "sdf.make_level_set3": "sdf.generate_sdf",
    "sdf.dense.table": "sdf.make_level_set3",
    "sdf.dense.k1": "sdf.make_level_set3",
    "sdf.sign": "sdf.make_level_set3",
    "sdf.to_host": "sdf.generate_sdf",
    "sdf.to_host.touch": "sdf.to_host",
}
RANGES = {"sdf.bin.parity", "sdf.bin.band", "sdf.bin.csr",
          "sdf.upload.pack", "sdf.to_host.touch"}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _mesh(kind):
    if kind == "binned":
        return P.icosphere(3, radius=1.0, center=(0.05, -0.02, 0.03))
    return P.box_mesh()


def _generate(mesh):
    return P.generate_sdf(mesh.verts, mesh.tris, GRID.origin, GRID.dx,
                          *GRID.shape, backend="cpu")


def _level_set(mesh):
    return upload.to_host(P.make_level_set3(mesh, GRID, device=CPU))


def _train(mesh):
    model = SDFGenerator(mesh, GRID, device="cpu")
    target = model.forward(model.params * 0.95).detach()
    new, loss = model.train_step(model.params, target, lr=1e-2)
    return np.concatenate([new.detach().numpy().ravel(),
                           [float(loss.detach())]])


CALLS = {"generate_sdf": _generate, "make_level_set3": _level_set,
         "train_step": _train}
CASES = [("binned", "generate_sdf"), ("binned", "make_level_set3"),
         ("dense", "generate_sdf"), ("dense", "train_step")]


def _raise(*a, **k):
    raise AssertionError("touched while tracing is off")


@pytest.mark.parametrize("kind,call", CASES)
def test_off_records_nothing_and_touches_nothing(kind, call, monkeypatch):
    mesh = _mesh(kind)
    want = CALLS[call](mesh)
    monkeypatch.setattr(tracing, "_Span", _raise)
    monkeypatch.setattr(tracing, "launch_count", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    got = CALLS[call](mesh)
    assert tracing.span("sdf.x") is tracing._OFF
    assert tracing.begin("sdf.x") is None
    assert tracing.spans() == []
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,call", CASES)
def test_results_bit_equal_on_and_off(kind, call):
    mesh = _mesh(kind)
    off = CALLS[call](mesh)
    tracing.enable()
    on = CALLS[call](mesh)
    tracing.disable()
    assert tracing.spans()
    assert off.dtype == on.dtype and off.tobytes() == on.tobytes()


def _tree(records):
    by_id = {r.id: r for r in records}
    return {r.name: (None if r.parent is None else by_id[r.parent].name)
            for r in records}, by_id


@pytest.mark.parametrize("kind,want", [("binned", BINNED_TREE),
                                       ("dense", DENSE_TREE)])
def test_enabled_call_is_one_tree(kind, want):
    tracing.enable()
    _generate(_mesh(kind))
    recs = tracing.spans()
    tree, by_id = _tree(recs)
    assert tree == want
    root = [r for r in recs if r.parent is None]
    assert len(root) == 1 and all(r.root == root[0].id for r in recs)
    for r in recs:
        assert r.device_ms is None and r.launches == 0
        assert r.end_ns >= r.start_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert sum(r.name == "sdf.to_host.touch" for r in recs) >= 1
    assert sum(r.name == "sdf.k3" for r in recs) == (kind == "binned")


def test_train_step_spans_and_backward_root():
    model = SDFGenerator(_mesh("dense"), GRID, device="cpu")
    verts = model.params
    target = model.forward(verts * 0.95).detach()
    tracing.enable()
    model.train_step(verts, target, lr=1e-2)
    recs = tracing.spans()
    tree, _ = _tree(recs)
    assert tree == {"sdf.make_level_set3": None,
                    "sdf.dense.table": "sdf.make_level_set3",
                    "sdf.dense.k1": "sdf.make_level_set3",
                    "sdf.sign": "sdf.make_level_set3",
                    "sdf.recompute.forward": "sdf.make_level_set3",
                    "sdf.recompute.backward": None}
    # the parity decoded once, for R1 and R1b: no signed field is built
    assert sum(r.name == "sdf.sign" for r in recs) == 1


def test_profiler_turns_tracing_on_and_sees_only_host_ranges():
    from torch.profiler import ProfilerActivity, profile

    mesh = _mesh("binned")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(mesh)
    names = {e.name for e in prof.events()}
    recorded = {r.name for r in tracing.spans()}
    assert recorded == set(BINNED_TREE)
    assert RANGES <= names
    assert not (recorded - RANGES) & names
    assert not any(n.startswith("bench.") for n in recorded)
    tracing.clear()
    _generate(mesh)
    assert tracing.spans() == []


def test_launch_delta_from_patched_counters(monkeypatch):
    monkeypatch.setattr(dense_ops.dense_stream, "launches", 5)
    monkeypatch.setattr(vdt_kernel.round_phase, "launches", 7)
    tracing.enable()
    with tracing.span("sdf.outer"):
        dense_ops.dense_stream.launches += 1
        with tracing.span("sdf.inner"):
            vdt_kernel.round_phase.launches += 3
    with tracing.span("sdf.after"):
        pass
    got = {r.name: r.launches for r in tracing.spans()}
    assert got == {"sdf.inner": 3, "sdf.outer": 4, "sdf.after": 0}


# the program's kernel wrappers, by the module that defines each
WRAPPERS = {"sep_table": "dense", "dense_stream": "dense",
            "band_coefs": "band_kernel", "band_rows": "band_kernel",
            "round_phase": "vdt_kernel", "chamfer": "vdt_kernel",
            "recompute_terms": "recompute", "recompute_forward": "recompute",
            "recompute_backward": "recompute", "parity_sign": "sign_kernel"}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_registered_where_defined(name, monkeypatch):
    """The registry (``kernels.build.counted``) holds exactly the ten
    wrappers, each the function its module defines (the probes of
    ``tools.micro_bench``, imported here, stay out), and a launch counted
    by one moves ``launch_count`` by one."""
    assert sorted(f.__name__ for f in build.COUNTED) == sorted(WRAPPERS)
    module = importlib.import_module(
        f"sdfgenfast_tpu_torch.ops.{WRAPPERS[name]}")
    fn = getattr(module, name)
    assert fn in build.COUNTED and fn.__module__ == module.__name__
    monkeypatch.setattr(fn, "launches", 2)
    before = tracing.launch_count()
    fn.launches += 1
    assert tracing.launch_count() == before + 1


def _rec(i, parent, a, b, dev=None, name="s"):
    return tracing.Record(name, i, parent, 1, int(a * 1e6), int(b * 1e6),
                          dev, 0)


def test_self_time_on_a_synthetic_tree():
    top = _rec(1, None, 0, 10, 10.0)
    recs = [top, _rec(2, 1, 1, 3, 3.0), _rec(3, 1, 2, 5, 4.0),
            _rec(4, 1, 7, 8), _rec(5, 4, 7.2, 7.9, 9.0),
            _rec(6, 1, 9.5, 12), _rec(7, None, 3, 4, 1.0)]
    # children cover [1, 5] + [7, 8] + [9.5, 10] of [0, 10]
    assert tracing.self_ms(top, recs) == pytest.approx(4.5)
    assert tracing.self_ms(top, recs, device=True) == pytest.approx(3.0)
    assert tracing.self_ms(recs[3], recs, device=True) is None
    assert tracing.self_ms(recs[4], recs) == pytest.approx(0.7)


def test_ring_keeps_the_newest():
    tracing.enable()
    extra = 5
    for i in range(tracing.RING + extra):
        with tracing.span(f"s{i}"):
            pass
    recs = tracing.spans()
    assert len(recs) == tracing.RING
    assert recs[0].name == f"s{extra}"
    assert recs[-1].name == f"s{tracing.RING + extra - 1}"


@pytest.mark.parametrize("on", [True, False])
def test_worker_spans_take_the_parent_passed(on):
    src = torch.arange(1000, dtype=torch.float32)
    out = np.empty(1000, np.float32)
    pieces = upload._pieces((1000,), 4, 1024)
    slots = [torch.empty(1024, dtype=torch.uint8) for _ in range(2)]
    if on:
        tracing.enable()
    top = tracing.begin("sdf.to_host")
    tracing.disable()  # the worker records under `top` alone

    def work():
        upload._staged(src.view(torch.uint8), pieces, out, slots,
                       parent=top)
        with tracing.span("sdf.bare"):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join(60)
    assert not t.is_alive()
    np.testing.assert_array_equal(out, src.numpy())
    recs = tracing.spans()
    if not on:
        assert top is None and recs == []
        return
    top.end()
    recs = tracing.spans()
    names = [r.name for r in recs]
    assert names.count("sdf.to_host.link") == len(pieces) == 4
    assert names.count("sdf.to_host.touch") == len(pieces)
    assert "sdf.bare" not in names
    for r in recs:
        if r.name != "sdf.to_host":
            assert r.parent == top.id and r.root == top.root


def test_download_span_ends_at_result():
    tracing.enable()
    with tracing.span("sdf.outer") as outer:
        d = upload.to_host_async(torch.ones(3, 4))
        with tracing.span("sdf.between"):
            pass
    assert {r.name for r in tracing.spans()} == {
        "sdf.to_host.touch", "sdf.between", "sdf.outer"}
    d.result()
    d.result()
    recs = {r.name: r for r in tracing.spans()}
    assert recs["sdf.to_host"].parent == outer.id
    assert recs["sdf.between"].parent == outer.id
    assert recs["sdf.to_host.touch"].parent == recs["sdf.to_host"].id
    assert len(tracing.spans()) == 4
