"""The port's multi-process path (``sdfgenfast_tpu_torch.parallel.multihost``)
on the CPU: two real processes, each owning four ``"cpu"`` shards of an
eight-shard mesh, joined by gloo on loopback, as tests/test_multihost.py
runs the JAX package's.

One pair of workers runs every case (this file, run as a script), so the
start-up is paid once: the JAX package's four cases (dense shards, the
capped ladder, the pyramid at 64^3 whose descent runs halo rounds, the
device sign) and eikonal, all through ``sharded_sdf_multihost`` and
``fetch_global``; the capped ladder on a (4, 2) mesh, where some of a
process's j neighbours are its own and some the other process's; and a
``generate_sdf_batch`` of two meshes with the global mesh; and
``make_global_array``'s uploads. Bars: every
grid bit-equal to the single-process run of the same mesh shape on
``["cpu"] * 8`` (the same stages on the same blocks, only the transport
differs), both processes' grids equal, and ``far_field="propagate"``
rejected with the JAX package's NotImplementedError. Each worker runs
under a deadline and is killed when it passes it.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DEADLINE_S = 240

ICO2 = dict(subdivisions=2, radius=1.0, center=(0.05, -0.02, 0.03))
BIN = dict(tile2d_shape=(8, 8), dense_max_tris=0)

# name: (grid n, SDFConfig knobs, mesh shape)
CASES = {
    "dense": (32, dict(tile2d_shape=(8, 8), vdt_max_hop=4), (2, 4)),
    "capped": (32, dict(BIN, vdt_max_hop=4), (2, 4)),
    "pyramid-64": (64, BIN, (2, 4)),
    "device-sign": (32, dict(BIN, vdt_max_hop=4, sign_mode="device"), (2, 4)),
    "eikonal": (32, dict(BIN, far_field="eikonal"), (2, 4)),
    "capped-4x2": (32, dict(BIN, vdt_max_hop=4), (4, 2)),
}
BATCH_N = 32


def _inputs(name):
    import sdfgenfast_tpu_torch as P

    n, knobs, dims = CASES[name]
    return (P.icosphere(**ICO2), P.GridSpec((-1.4,) * 3, 2.8 / n, (n,) * 3),
            P.SDFConfig(**knobs), dims)


def _batch_args():
    import sdfgenfast_tpu_torch as P

    meshes = [(m.verts, m.tris) for m in (
        P.icosphere(**ICO2), P.icosphere(3, radius=0.9,
                                         center=(0.02, 0.01, -0.03)))]
    return meshes, (-1.4,) * 3, 2.8 / BATCH_N, BATCH_N, BATCH_N, BATCH_N


def _worker(rank: int, port: int, out_dir: str) -> None:
    """One process of the pair: every case through the multi-process
    path, the grids saved to ``out_dir/rank{rank}.npz``."""
    import torch

    import sdfgenfast_tpu_torch as P
    from sdfgenfast_tpu_torch.parallel import bin_mesh_sharded
    from sdfgenfast_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    mh.initialize(f"tcp://127.0.0.1:{port}", 2, rank, "gloo")
    out = {}
    for name in CASES:
        mesh, grid, cfg, dims = _inputs(name)
        dm = mh.global_device_mesh(["cpu"] * 4, dims)
        assert dm.ranks.tolist() == (np.arange(8) // 4).reshape(dims).tolist()
        blocks = mh.sharded_sdf_multihost(
            bin_mesh_sharded(mesh, grid, dims, cfg), dm, mesh.verts)
        assert sum(b is not None for row in blocks for b in row) == 4
        out[name] = mh.assemble_blocks(mh.fetch_global(blocks, dm))
    dm = mh.global_device_mesh(["cpu"] * 4, (2, 4))
    # each process uploads its own shards' slices of a replicated array
    mesh, grid, cfg, dims = _inputs("capped")
    ids = bin_mesh_sharded(mesh, grid, dims, cfg).band_ids
    mine = mh.make_global_array(ids, dm)
    out["global_array"] = np.array([
        -1 if b is None else int(np.array_equal(b.numpy(), ids[dj, dk]))
        for dj, row in enumerate(mine) for dk, b in enumerate(row)])
    for i, phi in enumerate(P.generate_sdf_batch(
            *_batch_args(), backend="cpu", device_mesh=dm)):
        out[f"batch-{i}"] = phi
    mesh, grid, cfg, dims = _inputs("eikonal")
    cfg = P.SDFConfig(**dict(BIN, far_field="propagate"))
    try:
        mh.sharded_sdf_multihost(bin_mesh_sharded(mesh, grid, dims, cfg), dm,
                                 mesh.verts)
        out["propagate"] = np.array("no error")
    except NotImplementedError as e:
        out["propagate"] = np.array(str(e))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    print("WORKER_OK", rank, flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process():
    """Every case on one process's ``["cpu"] * 8`` mesh."""
    import torch

    import sdfgenfast_tpu_torch as P
    from sdfgenfast_tpu_torch.parallel import (bin_mesh_sharded,
                                               make_device_mesh, sharded_sdf)

    torch.set_num_threads(1)
    want = {}
    for name in CASES:
        mesh, grid, cfg, dims = _inputs(name)
        want[name] = sharded_sdf(bin_mesh_sharded(mesh, grid, dims, cfg),
                                 make_device_mesh(["cpu"] * 8, dims),
                                 verts=mesh.verts).numpy()
    for i, phi in enumerate(P.generate_sdf_batch(
            *_batch_args(), backend="cpu",
            device_mesh=make_device_mesh(["cpu"] * 8, (2, 4)))):
        want[f"batch-{i}"] = phi
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two workers' grids and the single-process ones (computed while
    the workers run)."""
    out_dir = str(tmp_path_factory.mktemp("multihost"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port),
                               out_dir], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(2)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        want = _single_process()
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    got = []
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"rank{r}.log")) as fh:
            log = fh.read()
        assert p.returncode == 0 and "WORKER_OK" in log, \
            f"worker {r} (rc {p.returncode}):\n{log[-3000:]}"
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            got.append({k: z[k] for k in z.files})
    return got, want


@pytest.mark.parametrize("name", list(CASES) + ["batch-0", "batch-1"])
def test_two_processes_equal_one_process(runs, name):
    got, want = runs
    assert got[0][name].shape == want[name].shape == (
        (BATCH_N,) * 3 if name.startswith("batch") else (CASES[name][0],) * 3)
    for g in got:
        np.testing.assert_array_equal(g[name].view(np.int32),
                                      want[name].view(np.int32))


def test_make_global_array_uploads_own_shards(runs):
    got, _ = runs
    for rank, g in enumerate(got):
        want = np.where(np.arange(8) // 4 == rank, 1, -1)
        np.testing.assert_array_equal(g["global_array"], want)


def test_propagate_is_rejected(runs):
    got, _ = runs
    for g in got:
        assert str(g["propagate"]) == ("sharded pipeline supports "
                                       "far_field='exact' and 'eikonal'")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
