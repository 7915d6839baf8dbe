"""The sharded path's spans and counters (``parallel/sharded.py``,
``api.generate_sdf_batch``) on the CPU.

One traced ``generate_sdf_batch`` of two meshes on a (2, 2) mesh of CPU
devices records every span of the sharded path under the call's root
``sdf.generate_sdf_batch``; the ``bytes`` count of ``sdf.sharded.halo``
equals what the block shapes and the pyramid's strides give; the root's
launch count equals the shards' schedule (the plain-torch twins made to
count as their kernels do); off, nothing is recorded or touched.
"""

import numpy as np
import pytest
import torch

import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import tracing
from sdfgenfast_tpu_torch.ops import band_kernel, vdt, vdt_kernel
from sdfgenfast_tpu_torch.parallel import make_device_mesh

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

N = 64
DIMS = (2, 2)
MESH = P.icosphere(3, radius=1.0, center=(0.05, -0.02, 0.03))
GRID = P.GridSpec((-1.4,) * 3, 2.8 / N, (N,) * 3)
MESHES = [(MESH.verts, MESH.tris), (MESH.verts * np.float32(0.98),
                                    MESH.tris)]

# each span's parent, by name, in one sharded call
TREE = {
    "sdf.generate_sdf_batch": None,
    "sdf.sharded.bin": "sdf.generate_sdf_batch",
    "sdf.bin.parity": "sdf.sharded.bin",
    "sdf.bin.band": "sdf.sharded.bin",
    "sdf.bin.csr": "sdf.sharded.bin",
    "sdf.sharded.fields": "sdf.generate_sdf_batch",
    "sdf.sharded.card": "sdf.sharded.fields",
    "sdf.sharded.upload": "sdf.sharded.fields",
    "sdf.sharded.halo": "sdf.sharded.fields",
    "sdf.k3": "sdf.sharded.fields",
    "sdf.sharded.assemble": "sdf.generate_sdf_batch",
    "sdf.to_host": "sdf.generate_sdf_batch",
    "sdf.to_host.touch": "sdf.to_host",
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _call():
    dm = make_device_mesh(["cpu"] * 4, DIMS)
    return P.generate_sdf_batch(MESHES, GRID.origin, GRID.dx, *GRID.shape,
                                backend="cpu", device_mesh=dm)


def _traced():
    tracing.enable()
    out = _call()
    tracing.disable()
    return out, tracing.spans()


def test_every_span_under_the_root():
    out, recs = _traced()
    by_id = {r.id: r for r in recs}
    tree = {r.name: None if r.parent is None else by_id[r.parent].name
            for r in recs}
    assert tree == TREE
    root = [r for r in recs if r.parent is None]
    assert len(root) == 1 and all(r.root == root[0].id for r in recs)
    count = {n: sum(r.name == n for r in recs) for n in TREE}
    # one a mesh: the binning, the fields, the assembly, the copies (one a
    # block); one card span a device (the CPU, repeated) a mesh
    for name in ("sdf.sharded.bin", "sdf.sharded.fields",
                 "sdf.sharded.card", "sdf.sharded.assemble"):
        assert count[name] == len(MESHES)
    assert count["sdf.to_host"] == 4 * len(MESHES)
    for r in recs:
        assert r.device_ms is None and r.end_ns >= r.start_ns
        if r.parent is not None and r.name != "sdf.to_host":
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert [o.shape for o in out] == [GRID.shape] * len(MESHES)


def test_results_bit_equal_on_and_off():
    off = _call()
    on, recs = _traced()
    assert recs
    for a, b in zip(off, on):
        assert a.tobytes() == b.tobytes()


def _halo_bytes():
    """Bytes the extensions write in one call, from the blocks' shapes:
    every block extended on j (one edge plane filled, a (2, 2) mesh has
    one neighbour a side), then the j-extended block on k; the pyramid's
    state (5 float32 channels) at every repair round of the descent, then
    the chamfer's phi `passes` deep. On one device no plane is copied."""
    ni, nj, nk = GRID.shape
    nj_l, nk_l = nj // DIMS[0], nk // DIMS[1]
    shapes = vdt.pyramid_level_shapes(GRID.shape)
    rounds = [(lvl, s) for lvl in range(len(shapes) - 2, -1, -1)
              for s in (vdt.PYRAMID_COARSE_ROUNDS if lvl
                        else vdt.PYRAMID_LEVEL_ROUNDS + (1, 1))]

    def ext(channels, ni, nj, nk, d):
        j_out = channels * ni * (nj + 2 * d) * nk
        j_fill = channels * ni * d * nk
        k_out = channels * ni * (nj + 2 * d) * (nk + 2 * d)
        k_fill = channels * ni * (nj + 2 * d) * d
        return 4 * 4 * (j_out + j_fill + k_out + k_fill)

    state = sum(ext(5, shapes[lvl][0], nj_l >> lvl, nk_l >> lvl, s)
                for lvl, s in rounds)
    return state + ext(1, ni, nj_l, nk_l, 2), 2 * len(rounds) + 2


def test_halo_bytes_from_the_block_shapes():
    _, recs = _traced()
    want, extends = _halo_bytes()
    fields = [r for r in recs if r.name == "sdf.sharded.fields"]
    for f in fields:
        halos = [r for r in recs
                 if r.name == "sdf.sharded.halo" and r.parent == f.id]
        assert len(halos) == extends
        assert sum(r.counts["bytes"] for r in halos) == want
    assert all(not r.counts for r in recs if r.name != "sdf.sharded.halo")


def _counting(monkeypatch):
    """The twins count launches as their kernels would: K2 two (the
    coefficient pass and the rows), K3 one a stride, K4 one a chunk of
    passes."""
    rows, rounds, cham = (band_kernel.band_rows_reference,
                          vdt_kernel.round_phase_reference,
                          vdt_kernel.chamfer_reference)

    def k2(*a, **k):
        band_kernel.band_coefs.launches += 1
        band_kernel.band_rows.launches += 1
        return rows(*a, **k)

    def k3(state, dx, strides, *a, **k):
        vdt_kernel.round_phase.launches += len(strides)
        return rounds(state, dx, strides, *a, **k)

    def k4(phi, dx, passes=2):
        vdt_kernel.chamfer.launches += len(vdt_kernel.chamfer_chunks(passes))
        return cham(phi, dx, passes)

    monkeypatch.setattr(band_kernel, "band_rows_reference", k2)
    monkeypatch.setattr(vdt_kernel, "round_phase_reference", k3)
    monkeypatch.setattr(vdt_kernel, "chamfer_reference", k4)


def test_root_launches_are_the_shards_schedule(monkeypatch):
    _counting(monkeypatch)
    _, recs = _traced()
    shapes = vdt.pyramid_level_shapes(GRID.shape)
    # a shard: K2 2; K3 the coarsest ladder's strides <= 8 (the longer run
    # in torch) and every repair round of the descent; K4 1
    k3 = sum(1 for s in vdt.stride_ladder(max(shapes[-1]), extra_rounds=1)
             if s <= 8)
    k3 += sum(len(vdt.PYRAMID_COARSE_ROUNDS) if lvl
              else len(vdt.PYRAMID_LEVEL_ROUNDS) + 2
              for lvl in range(len(shapes) - 1))
    shard = 2 + k3 + 1
    root = next(r for r in recs if r.parent is None)
    assert root.launches == len(MESHES) * 4 * shard
    for f in (r for r in recs if r.name == "sdf.sharded.fields"):
        assert f.launches == 4 * shard


def _raise(*a, **k):
    raise AssertionError("touched while tracing is off")


def test_off_records_nothing_and_touches_nothing(monkeypatch):
    want = _call()
    monkeypatch.setattr(tracing, "_Span", _raise)
    monkeypatch.setattr(tracing, "launch_count", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    got = _call()
    assert tracing.spans() == []
    for a, b in zip(want, got):
        assert a.tobytes() == b.tobytes()
