"""Batch throughput on one card: ``generate_sdf_batch`` against the same
meshes run strictly one after another.

Counterpart of ``tools/batch_bench.py``. N distinct meshes (default 6):
icosphere(6) (81,920 triangles) with every vertex jittered by a normal
sigma 0.003 from ``numpy.random.default_rng(0)``, on one 256^3 grid with
origin (-1.3, -1.3, -1.3) and dx 2.6 / 256. ``generate_sdf_batch`` bins and
uploads mesh k+1 while mesh k computes and copies back; the sequential run
calls it with one mesh at a time, so nothing overlaps. The tool reports the
aggregate voxels per second, the wall per mesh and the overlap gain
(sequential over batch), checks that both ways give the same grids bit for
bit, and publishes nothing. Run on a machine with a card::

    python3 -m sdfgenfast_tpu_torch.tools.batch_bench [N]

It prints one JSON line, and raises, naming CUDA, when there is no card and
no ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..api import generate_sdf_batch
from ..mesh import icosphere
from .timing import card_line, tool_device

__all__ = ["jittered_spheres", "measure", "main"]

N = 256
ORIGIN = (-1.3, -1.3, -1.3)
DX = 2.6 / N


def jittered_spheres(n_meshes: int, subdivisions: int = 6, sigma=0.003,
                     seed: int = 0):
    """`n_meshes` (vertices, triangles) pairs: icosphere(`subdivisions`)
    with each vertex moved by a normal `sigma` (the JAX tool's batch)."""
    rng = np.random.default_rng(seed)
    m = icosphere(subdivisions, radius=1.0)
    return [(m.verts + rng.normal(0, sigma, m.verts.shape).astype(np.float32),
             m.tris) for _ in range(n_meshes)]


def measure(meshes, origin, dx: float, shape, device) -> dict:
    """The batch of `meshes` on the (ni, nj, nk) `shape` grid against the
    same meshes one call each, after one warm call; raises AssertionError
    if a batch grid differs from its sequential one."""
    device = torch.device(device)
    backend = "gpu" if device.type == "cuda" else "cpu"
    kw = dict(backend=backend, device=device)
    t0 = time.perf_counter()
    generate_sdf_batch(meshes[:1], origin, dx, *shape, **kw)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = generate_sdf_batch(meshes, origin, dx, *shape, **kw)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = [generate_sdf_batch([pair], origin, dx, *shape, **kw)[0]
           for pair in meshes]
    t_seq = time.perf_counter() - t0
    if len(out) != len(meshes) or any(
            not np.array_equal(a.view(np.int32), b.view(np.int32))
            for a, b in zip(out, seq)):
        raise AssertionError("generate_sdf_batch differs from the meshes run "
                             "one at a time")
    cells = int(np.prod(shape))
    n = len(meshes)
    return {
        "workload": f"{n} x {len(meshes[0][1])}-triangle meshes @ "
                    f"{'x'.join(str(s) for s in shape)}",
        "warm_s": round(warm, 3), "batch_s": round(t_batch, 4),
        "sequential_s": round(t_seq, 4),
        "per_mesh_ms": round(t_batch / n * 1e3, 2),
        "sequential_per_mesh_ms": round(t_seq / n * 1e3, 2),
        "mvoxels_per_sec": round(cells * n / t_batch / 1e6, 1),
        "overlap_gain": round(t_seq / t_batch, 3),
        "batch_equals_sequential": True,
        "inside_frac": round(float((out[0] < 0).mean()), 3),
        "card": card_line(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=6,
                    help="number of meshes (default 6)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain twins (default: the card)")
    a = ap.parse_args(argv)
    device = tool_device(a.device)
    if a.n < 1:
        raise ValueError(f"need at least one mesh, got {a.n}")
    row = measure(jittered_spheres(a.n), ORIGIN, DX, (N, N, N), device)
    print(f"batch of {a.n}: {row['batch_s']:.3f} s, one at a time "
          f"{row['sequential_s']:.3f} s", file=sys.stderr, flush=True)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
