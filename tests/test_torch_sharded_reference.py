"""The sharded path against the benchmark's plain reference on the CPU.

``generate_sdf_batch(..., device_mesh=...)`` on a (2, 2) mesh of CPU
devices (the shards' plain-torch twins), icosphere(3) (1,280 triangles, so
the binned exact path) on a mode-2a grid of 64^3 whose 64 x 32 x 32 blocks
are multiples of the 8^3 tile, every mesh jittered from a seed as the
benchmark's pool jitters it. Each grid is judged against
``benchmark/reference/sdf.py`` (float64, brute force, winding-number signs)
at uniform cells, cells near the surface and cells on the shards' boundary
planes (j or k in {31, 32}), with the numbers of ``entries/generate.py``
(``grid_numbers``) held to the sphere cell's limits: no sign flip off the
surface, the band, and the over- and under-estimates.

Two planted faults of the halo exchange: halos zero-filled (a halo buffer
never written) break the limits; halos filled with FAR (the neighbours'
planes never sent) move far-field cells but leave a valid field, within
the limits, since every shard gathers the pyramid's coarsest level whole.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.entries import generate
from benchmark.lib import pool, sizing
from benchmark.meshes import icosphere
from benchmark.reference import sdf as ref
from sdfgenfast_tpu_torch import api
from sdfgenfast_tpu_torch.parallel import make_device_mesh
from sdfgenfast_tpu_torch.parallel import sharded as sh

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "limits",
                       "sphere82k_256.generate.json")) as fh:
    LIMITS = {k: v["limit"] for k, v in json.load(fh).items()}
HELD = ("sign_err", "band_err_dx", "over_dx", "under_dx")
JITTER = {"rotate": True, "radial_inward_cells": 0.25}
CHECK = {"band_cells": 1.0, "sign_margin_cells": 1e-4}
SEEDS = [2**31 + 11, 2**33 + 7]
DIMS = (2, 2)
CPU = torch.device("cpu")


def _case(seed):
    verts, tris = icosphere.make(3, 1.0)
    origin, dx, shape = sizing.mode2a(verts.min(0), verts.max(0), 64, 1)
    meshes = pool.pool(verts, dx, 2, seed, JITTER, 0.5)
    return meshes, tris, origin, dx, shape


def _sharded(meshes, tris, origin, dx, shape):
    dm = make_device_mesh([CPU] * 4, DIMS)
    return api.generate_sdf_batch([(v, tris) for v in meshes], origin, dx,
                                  *shape, backend="cpu", device_mesh=dm)


def _cells(seed, verts, tris, origin, dx, shape):
    """Flat indices of the judged cells: uniform, near the surface, and on
    the boundary planes."""
    r = pool.rng(seed, 9)
    n = int(np.prod(shape))
    uniform = r.integers(0, n, 1024)
    tri = verts.astype(np.float64)[tris[r.integers(0, len(tris), 1024)]]
    u, v = r.uniform(size=(2, len(tri), 1))
    fold = (u + v) > 1
    u, v = np.where(fold, 1 - u, u), np.where(fold, 1 - v, v)
    p = (tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])
         + r.uniform(-1.5, 1.5, size=(len(tri), 3)) * dx)
    ijk = np.clip(np.rint((p - np.asarray(origin)) / dx).astype(np.int64),
                  0, np.asarray(shape) - 1)
    near = np.ravel_multi_index(tuple(ijk.T), shape)
    i, j, k = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    on_plane = np.isin(j, (31, 32)) | np.isin(k, (31, 32))
    border = r.choice(np.flatnonzero(on_plane.reshape(-1)), 2048,
                      replace=False)
    return np.unique(np.concatenate([uniform, near, border])), border


def _numbers(grids, meshes, tris, origin, dx, shape, seed):
    """The worst numbers over the grids, over all judged cells and over
    the boundary planes' cells alone (``border_``)."""
    worst = {}
    t64 = torch.from_numpy(tris.astype(np.int64))
    for g, (grid, verts) in enumerate(zip(grids, meshes)):
        flat, border = _cells(seed + g, verts, tris, origin, dx, shape)
        pts = ref.grid_points(origin, dx, shape, torch.from_numpy(flat))
        want, _ = ref.signed_distance(
            pts, ref.triangles(torch.from_numpy(verts).double(), t64))
        got = torch.from_numpy(grid.reshape(-1)[flat]).double()
        on = torch.from_numpy(np.isin(flat, border))
        nums = generate.grid_numbers(got, want, dx, CHECK)
        nums.update((f"border_{k}", v) for k, v in generate.grid_numbers(
            got[on], want[on], dx, CHECK).items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


@pytest.fixture(scope="module")
def sound():
    out = {}
    for seed in SEEDS:
        case = _case(seed)
        grids = _sharded(*case)
        out[seed] = (grids, _numbers(grids, *case[:2], *case[2:], seed))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_sharded_within_the_sphere_limits(sound, seed):
    grids, nums = sound[seed]
    assert all(g.shape == (64, 64, 64) and g.dtype == np.float32
               for g in grids)
    for name in HELD:
        assert nums[name] <= LIMITS[name], (name, nums)
        assert nums[f"border_{name}"] <= LIMITS[name], (name, nums)


def _planted(monkeypatch, halo):
    """Every neighbour's halo planes replaced by `halo(plane)` in the
    transport's extension."""
    real = sh._halo_plane

    def planted(x, axis, depth, step):
        return halo(real(x, axis, depth, step))

    monkeypatch.setattr(sh, "_halo_plane", planted)


@pytest.mark.parametrize("seed", SEEDS)
def test_zero_filled_halos_break_the_limits(sound, seed, monkeypatch):
    _planted(monkeypatch, torch.zeros_like)
    case = _case(seed)
    nums = _numbers(_sharded(*case), *case[:2], *case[2:], seed)
    assert any(nums[n] > LIMITS[n] for n in HELD), nums
    assert nums["border_under_dx"] > LIMITS["under_dx"], nums


@pytest.mark.parametrize("seed", SEEDS)
def test_far_filled_halos_change_only_the_far_field(sound, seed,
                                                    monkeypatch):
    _planted(monkeypatch,
             lambda p: torch.full_like(p, float(np.float32(3e18))))
    case = _case(seed)
    grids = _sharded(*case)
    nums = _numbers(grids, *case[:2], *case[2:], seed)
    sound_grids, _ = sound[seed]
    moved = [g != s for g, s in zip(grids, sound_grids)]
    assert sum(int(m.sum()) for m in moved) > 0
    for m, g, s in zip(moved, grids, sound_grids):
        # the band (exact, from K2's global candidates) and the signs hold
        assert (np.abs(s[m]) > 3 * case[3]).all()
        assert ((g < 0) == (s < 0)).all()
    # the far field stays valid: every shard holds the pyramid's coarsest
    # level whole, so a missing halo costs only the repair rounds' reach
    for name in HELD:
        assert nums[name] <= LIMITS[name], (name, nums)
