"""The ``generate`` mix: one caller turning meshes into grids, calls back
to back (a closed loop), as a preprocessing job over a dataset does.

Each call is ``api.generate_sdf(verts, tris, origin, dx, nx, ny, nz)``,
mesh arrays in and a NumPy grid out. Set-up makes a pool of meshes from the
seed (``lib/pool.py``) on the configuration's grid and calls once on each;
the window cycles through the pool. A traced run makes the same three calls
that ``generate_sdf`` makes, ``bin_mesh(device=)``, ``make_level_set3
(binned=)`` and ``upload.to_host``, and times each: the host clock around
the first and the last, CUDA events around the second.

The check judges the grids of `judged_calls` calls, drawn from the seed
over every call of the window (a reservoir), at a sample of cells drawn
from the seed: uniform over the grid, and near the surface (points on
random triangles moved by up to `surface_cells` cells). At each sampled
cell the reference (``reference/sdf.py``, float64) gives the exact
distance to the call's mesh and the winding number's sign.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import pool as pools
from benchmark.lib import program, sizing, trace
from benchmark.reference import sdf as ref


class Entry:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = cell.traffic
        self.cuda = device.type == "cuda"

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from sdfgenfast_tpu_torch import api, pipeline, upload
        from sdfgenfast_tpu_torch.grid import GridSpec
        from sdfgenfast_tpu_torch.mesh import Mesh

        self._api, self._pipeline, self._upload = api, pipeline, upload
        self._Mesh = Mesh
        verts, self.tris = self.cell.mesh()
        g = self.cell.config["grid"]
        self.origin, self.dx, self.shape = sizing.mode2a(
            verts.min(axis=0), verts.max(axis=0), g["nx"], g["padding"])
        self.grid = GridSpec(self.origin, self.dx, self.shape)
        self.cells = int(np.prod(self.shape))
        self.cfg = program.sdf_config(self.cell.config["sdf_config"])
        self.pool = pools.pool(verts, self.dx, self.traffic["pool"],
                               self.seed, self.cell.config.get("jitter", {}),
                               self.traffic["translate_cells"])
        for v in self.pool:
            self._call(v)

    def _call(self, verts):
        return self._api.generate_sdf(
            verts, self.tris, self.origin, self.dx, *self.shape,
            exact_band=self.cfg.exact_band, far_field=self.cfg.far_field,
            backend="gpu" if self.cuda else "cpu", device=self.device,
            config=self.cfg)

    def _traced_call(self, verts, spans):
        from torch.profiler import record_function

        mesh = self._Mesh(verts, self.tris)
        t0 = time.perf_counter()
        with record_function("bench.bin_mesh"):
            b = self._pipeline.bin_mesh(mesh, self.grid, self.cfg,
                                        device=self.device)
        t1 = time.perf_counter()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        with record_function("bench.make_level_set3"):
            phi = self._pipeline.make_level_set3(mesh, self.grid, self.cfg,
                                                 b, device=self.device)
        if self.cuda:
            end.record()
            end.synchronize()
        t2 = time.perf_counter()
        with record_function("bench.to_host"):
            out = self._upload.to_host(phi)
        t3 = time.perf_counter()
        spans.add("bin", (t1 - t0) * 1e3)
        spans.add("device", start.elapsed_time(end) if self.cuda
                  else (t2 - t1) * 1e3)
        spans.add("copy_back", (t3 - t2) * 1e3)
        return out

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, traced: bool):
        """Calls until `seconds` have passed; the last call ends the
        window."""
        keep = self.traffic["judged_calls"]
        pick = pools.rng(self.seed, 2)
        self.kept = []          # [(call index, pool index, grid)]
        self.times = []
        self.attempted = self.failed = 0
        self.spans = trace.Spans() if traced else None
        self.profile = None
        prof_at = seconds * self.traffic["profile_from"]
        prof_calls = self.traffic["profile_calls"]
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            if traced and self.profile is None and self.cuda \
                    and t_end - t0 >= prof_at:
                with trace.Slice(self.device) as sl:
                    for _ in range(prof_calls):
                        t_end = self._one(pick, keep)
                        sl.calls += 1
                self.profile = sl.summary()
                continue
            t_end = self._one(pick, keep)
        self.window_s = t_end - t0

    def _one(self, pick, keep) -> float:
        i = self.attempted
        p = i % len(self.pool)
        t = time.perf_counter()
        self.attempted += 1
        try:
            out = (self._traced_call(self.pool[p], self.spans)
                   if self.spans is not None else self._call(self.pool[p]))
        except Exception as exc:  # counted, and the run is not correct
            self.failed += 1
            self.error = repr(exc)
            return time.perf_counter()
        done = time.perf_counter()
        self.times.append((done - t) * 1e3)
        if self.spans is not None:
            self.spans.add("call", (done - t) * 1e3)
        if i < keep:
            self.kept.append((i, p, out))
        else:
            j = int(pick.integers(0, i + 1))
            if j < keep:
                self.kept[j] = (i, p, out)
        return done

    def end_to_end(self) -> dict:
        done = len(self.times)
        return {"voxels_per_s": self.cells * done / self.window_s / 1e6}

    def release(self):
        """The program holds nothing on the device between calls; the
        judged grids stay on the host."""

    # -- the check ------------------------------------------------------
    def sample(self, call: int) -> np.ndarray:
        """Flat indices of the cells judged in call `call`'s grid."""
        t = self.traffic
        r = pools.rng(self.seed, 3, call)
        uniform = r.integers(0, self.cells, t["check_cells_uniform"])
        verts = self.pool[call % len(self.pool)].astype(np.float64)
        tri = verts[self.tris[r.integers(0, len(self.tris),
                                         t["check_cells_surface"])]]
        u, v = r.uniform(size=(2, len(tri), 1))
        fold = (u + v) > 1
        u, v = np.where(fold, 1 - u, u), np.where(fold, 1 - v, v)
        p = (tri[:, 0] + u * (tri[:, 1] - tri[:, 0])
             + v * (tri[:, 2] - tri[:, 0])
             + r.uniform(-1, 1, size=(len(tri), 3))
             * t["surface_cells"] * self.dx)
        ijk = np.rint((p - np.asarray(self.origin)) / self.dx).astype(np.int64)
        ijk = np.clip(ijk, 0, np.asarray(self.shape) - 1)
        near = np.ravel_multi_index(tuple(ijk.T), self.shape)
        return np.unique(np.concatenate([uniform, near]))

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
        for i, p, grid in self.kept:
            flat = self.sample(i)
            idx = torch.from_numpy(flat).to(dev)
            verts = torch.from_numpy(self.pool[p]).to(dev)
            tri64 = ref.triangles(verts.double(), tris)
            pts = ref.grid_points(self.origin, self.dx, self.shape, idx)
            want, _ = ref.signed_distance(pts, tri64)
            if control:
                low = torch.bfloat16
                got, _ = ref.signed_distance(
                    ref.grid_points(self.origin, self.dx, self.shape, idx,
                                    low), ref.triangles(verts.to(low), tris))
                got = got.double()
            else:
                got = torch.from_numpy(
                    np.ascontiguousarray(grid.reshape(-1)[flat])).to(
                        dev).double()
            for k, v in grid_numbers(got, want, self.dx, t).items():
                worst[k] = max(worst.get(k, v), v)
        return worst


def grid_numbers(got, want, dx: float, traffic: dict) -> dict:
    """The numbers one judged grid gives: `got` the answer and `want` the
    reference's signed distance at the same cells (float64 tensors)."""
    d_got, d_want = got.abs(), want.abs()
    band = d_want <= traffic["band_cells"] * dx
    far = ~band
    err = (d_got - d_want) / dx
    signed = d_want > traffic["sign_margin_cells"] * dx
    flips = ((got < 0) != (want < 0)) & signed
    return {
        "band_err_dx": float(err[band].abs().max()) if band.any() else 0.0,
        "far_mean_dx": float(err[far].abs().mean()) if far.any() else 0.0,
        "over_dx": float(err.max()),
        "under_dx": float((-err).max()),
        "sign_err": float(flips.sum()),
    }
