"""The ``sharded`` mix: one caller turning batches of meshes into grids
sharded over a device mesh, calls back to back (a closed loop), as a
preprocessing job on a multi-GPU node does.

Each call is ``api.generate_sdf_batch(meshes, origin, dx, nx, ny, nz,
device_mesh=...)`` over `batch` meshes of the pool, mesh arrays in and one
NumPy grid a mesh out; the device mesh (the configuration's
``device_mesh`` shape) is made of the cell's cards, ``cuda:0`` up to
``cuda:<chips - 1>`` (on the CPU, the one CPU device repeated). Call c
takes the pool's meshes c * batch, ..., c * batch + batch - 1 (modulo the
pool). Set-up makes the pool from the seed (``lib/pool.py``) on the
configuration's grid and calls until every mesh of the pool has run once.
A traced run times every call on the host clock and profiles a slice of
`profile_calls` calls over every card (``lib/cards.py``); the program
records its own spans inside the slice.

The check judges the grids of `judged_calls` calls, drawn from the seed
over every call of the window (a reservoir). A judged call's cells are
sampled as soon as it returns and only their values are kept: the cells
of ``entries/generate.py`` (uniform over the grid and near the surface)
and `check_cells_border` cells on the shards' boundary planes (the last
and the first plane of each block on the sharded axes j and k), half
uniform over those planes and half within `border_reach_cells` cells of
the surface's trace on them, where a wrong halo shows. The numbers are
``generate.grid_numbers`` over all of a grid's cells, and again over its
border cells alone (``border_`` before their names).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.entries import generate
from benchmark.lib import cards
from benchmark.lib import pool as pools
from benchmark.lib import program, sizing, trace
from benchmark.reference import sdf as ref


class Entry(generate.Entry):
    def __init__(self, cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        self.devices = ([torch.device("cuda", i) for i in range(cell.chips)]
                        if self.cuda else [device] * cell.chips)

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from sdfgenfast_tpu_torch import api
        from sdfgenfast_tpu_torch.parallel import make_device_mesh

        self._api = api
        verts, self.tris = self.cell.mesh()
        g = self.cell.config["grid"]
        self.origin, self.dx, self.shape = sizing.mode2a(
            verts.min(axis=0), verts.max(axis=0), g["nx"], g["padding"])
        self.cells = int(np.prod(self.shape))
        self.cfg = program.sdf_config(self.cell.config["sdf_config"])
        self.dims = tuple(int(v) for v in self.cell.config["device_mesh"])
        self.device_mesh = make_device_mesh(self.devices, self.dims)
        self.batch = int(self.traffic["batch"])
        self.pool = pools.pool(verts, self.dx, self.traffic["pool"],
                               self.seed, self.cell.config.get("jitter", {}),
                               self.traffic["translate_cells"])
        for c in range(-(-len(self.pool) // self.batch)):
            self._call(c)
        self._sync()

    def _meshes(self, call: int):
        """The pool's indices of call `call`'s meshes."""
        return [(call * self.batch + m) % len(self.pool)
                for m in range(self.batch)]

    def _call(self, call: int):
        return self._api.generate_sdf_batch(
            [(self.pool[p], self.tris) for p in self._meshes(call)],
            self.origin, self.dx, *self.shape,
            exact_band=self.cfg.exact_band, far_field=self.cfg.far_field,
            backend="gpu" if self.cuda else "cpu",
            device_mesh=self.device_mesh, config=self.cfg)

    def _sync(self):
        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, traced: bool):
        """Calls until `seconds` have passed; the last call ends the
        window. Each card's peak memory over the window is logged."""
        keep = self.traffic["judged_calls"]
        pick = pools.rng(self.seed, 2)
        self.kept = []  # [(call, [(mesh, cells, border mask, values)])]
        self.times = []
        self.attempted = self.failed = 0
        self.spans = trace.Spans() if traced else None
        self.profile = None
        if self.cuda:
            for d in self.devices:
                torch.cuda.reset_peak_memory_stats(d)
        prof_at = seconds * self.traffic["profile_from"]
        prof_calls = self.traffic["profile_calls"]
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            if traced and self.profile is None and self.cuda \
                    and t_end - t0 >= prof_at:
                with cards.Slice(self.devices) as sl:
                    for _ in range(prof_calls):
                        t_end = self._one(pick, keep)
                        sl.calls += 1
                self.profile = sl.summary()
                continue
            t_end = self._one(pick, keep)
        self._sync()
        self.window_s = t_end - t0
        if self.cuda:
            peaks = [torch.cuda.max_memory_allocated(d) for d in self.devices]
            self.card_peaks = dict(zip((str(d) for d in self.devices), peaks))
            print(f"card peaks (bytes allocated, window): {self.card_peaks}",
                  file=sys.stderr, flush=True)
        if self.profile is not None:
            print(f"card busy (us, profiled slice of "
                  f"{self.profile['window_us']:.0f} us): "
                  f"{self.profile['cards']}", file=sys.stderr, flush=True)

    def _one(self, pick, keep) -> float:
        i = self.attempted
        t = time.perf_counter()
        self.attempted += 1
        try:
            outs = self._call(i)
        except Exception as exc:  # counted, and the run is not correct
            self.failed += 1
            self.error = repr(exc)
            return time.perf_counter()
        done = time.perf_counter()
        self.times.append((done - t) * 1e3)
        if self.spans is not None:
            self.spans.add("call", (done - t) * 1e3)
        slot = i if i < keep else int(pick.integers(0, i + 1))
        if slot < keep:
            judged = (i, [self._values(i * self.batch + m, out)
                          for m, out in enumerate(outs)])
            if i < keep:
                self.kept.append(judged)
            else:
                self.kept[slot] = judged
        return done

    def _values(self, mesh: int, grid: np.ndarray):
        """(mesh index, sampled cells, border mask, the grid's values at
        them) of the batch's mesh `mesh` (counted over the window)."""
        flat, border = self.cells_of(mesh)
        return mesh, flat, border, np.ascontiguousarray(
            grid.reshape(-1)[flat])

    def end_to_end(self) -> dict:
        return {}

    def release(self):
        """The program holds nothing on the devices between calls; only
        the judged cells' values stay, on the host."""

    # -- the check ------------------------------------------------------
    def border_planes(self, axis: int):
        """The grid indices along `axis` (1: j, 2: k) of the blocks' edge
        planes: the last and the first plane of every two blocks that
        meet."""
        n = self.shape[axis] // self.dims[axis - 1]
        return [p for b in range(1, self.dims[axis - 1])
                for p in (b * n - 1, b * n)]

    def border(self, mesh: int) -> np.ndarray:
        """Flat indices of the border cells judged in mesh `mesh`."""
        t = self.traffic
        r = pools.rng(self.seed, 4, mesh)
        planes = [(a, p) for a in (1, 2) if self.dims[a - 1] > 1
                  for p in self.border_planes(a)]
        n = int(t["check_cells_border"])
        if not planes or n == 0:
            return np.zeros(0, np.int64)
        verts = self.pool[mesh % len(self.pool)].astype(np.float64)
        tri = ((verts - np.asarray(self.origin)) / self.dx)[
            self.tris.astype(np.int64)]                  # corners in cells
        crossing = [_crossing(tri, a, p) for a, p in planes]
        reach = float(t["border_reach_cells"])
        shape = np.asarray(self.shape)
        out = np.empty(n, np.int64)
        for s in range(n):
            q = int(r.integers(0, len(planes)))
            axis, plane = planes[q]
            ijk = r.uniform(0, 1, 3) * shape
            if s % 2 and len(crossing[q]):
                corners = tri[crossing[q][int(r.integers(0,
                                                         len(crossing[q])))]]
                ijk = _meet(corners, axis, plane, r.uniform()) \
                    + r.uniform(-reach, reach, 3)
            ijk[axis] = plane
            ijk = np.clip(np.rint(ijk).astype(np.int64), 0, shape - 1)
            out[s] = np.ravel_multi_index(tuple(ijk), self.shape)
        return out

    def cells_of(self, mesh: int):
        """(flat indices, border mask) of the cells judged in mesh `mesh`:
        ``generate.Entry.sample``'s and the border cells."""
        border = self.border(mesh)
        flat = np.unique(np.concatenate([self.sample(mesh), border]))
        return flat, np.isin(flat, border)

    def check(self, control: bool = False) -> dict:
        """The numbers compared, the worst over the judged grids. With
        `control`, the reference computed in bfloat16 stands in the
        program's place."""
        dev = self.device
        tris = torch.from_numpy(self.tris.astype(np.int64)).to(dev)
        t = self.traffic
        worst = {}
        if not self.kept or len(self.kept) < min(
                t["judged_calls"], self.attempted):
            return {}
        for _, judged in self.kept:
            for mesh, flat, border, values in judged:
                idx = torch.from_numpy(flat).to(dev)
                verts = torch.from_numpy(
                    self.pool[mesh % len(self.pool)]).to(dev)
                tri64 = ref.triangles(verts.double(), tris)
                pts = ref.grid_points(self.origin, self.dx, self.shape, idx)
                want, _ = ref.signed_distance(pts, tri64)
                if control:
                    low = torch.bfloat16
                    got, _ = ref.signed_distance(
                        ref.grid_points(self.origin, self.dx, self.shape,
                                        idx, low),
                        ref.triangles(verts.to(low), tris))
                    got = got.double()
                else:
                    got = torch.from_numpy(values).to(dev).double()
                mask = torch.from_numpy(border).to(dev)
                numbers = generate.grid_numbers(got, want, self.dx, t)
                if bool(mask.any()):
                    numbers.update(
                        (f"border_{k}", v) for k, v in generate.grid_numbers(
                            got[mask], want[mask], self.dx, t).items())
                for k, v in numbers.items():
                    worst[k] = max(worst.get(k, v), v)
        return worst


def _crossing(tri: np.ndarray, axis: int, plane: float) -> np.ndarray:
    """Indices of the triangles of `tri` ((M, 3, 3) corners in cells)
    that cross the plane ``x[axis] = plane``."""
    c = tri[:, :, axis]
    lo, hi = c.min(axis=1), c.max(axis=1)
    return np.flatnonzero((lo <= plane) & (hi >= plane) & (hi > lo))


def _meet(corners: np.ndarray, axis: int, plane: float, u: float):
    """The point a share `u` along the segment where a triangle
    (`corners`, (3, 3) in cells) that crosses the plane ``x[axis] =
    plane`` meets it."""
    ends = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        ca, cb = corners[a, axis], corners[b, axis]
        if (ca - plane) * (cb - plane) <= 0 and ca != cb:
            ends.append(corners[a] + (plane - ca) / (cb - ca)
                        * (corners[b] - corners[a]))
    return ends[0] + u * (ends[-1] - ends[0])
