"""The ``train`` mix: fitting a mesh's vertices to a target field, a closed
loop of ``models.SDFGenerator.train_step(verts, target_phi, lr)`` steps on
the binning made in set-up, each step feeding the next its vertices and
reading its loss to the host, as a fitting loop that checks convergence
does. There is no ``commit`` (no rebinning) in the window.

Set-up moves each vertex of the configuration's mesh by a seeded offset of
at most `start_offset_cells` cells (the mesh fitted: off the exact ties of
a regular mesh, where the loss has no gradient and two correct programs
may break the tie apart), moves each of those by another offset of at
most `target_offset_cells` cells and computes that mesh's field with the
program (the target), builds one ``SDFGenerator``, and runs its first
`first_steps` steps through the window's own call, keeping each step's
loss and vertices; the window goes on from there with the same object.
The step size is `lr_per_vertex` times the vertex count: the loss is a
mean over the grid's cells, so a vertex's gradient shrinks as the cells
are shared among more vertices.

A traced run makes the step's own calls (``model.loss``, then
``torch.autograd.grad``, then the update, as ``models.flagship.sgd_step``)
and times the forward and the backward by CUDA events.

The check: the reference (``reference/sdf.py``, float64, every cell of the
grid) follows the first `reference_steps` steps from the same vertices and
target mesh (two of the three set-up runs, so that it takes less time
than the window), each cell keeping the sign it has at the start, as the
program keeps the set-up binning's signs until ``commit``; the program's
losses, its first gradient (worked out from the vertices after one step)
and its change of the vertices over those steps are compared with the
reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import pool as pools
from benchmark.lib import program, sizing, trace
from benchmark.reference import sdf as ref

CELLS_PER_CHUNK = 1 << 20


class Entry:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = cell.traffic
        self.cuda = device.type == "cuda"

    def setup(self):
        from sdfgenfast_tpu_torch import pipeline, upload
        from sdfgenfast_tpu_torch.grid import GridSpec
        from sdfgenfast_tpu_torch.mesh import Mesh
        from sdfgenfast_tpu_torch.models import SDFGenerator

        t = self.traffic
        self.verts, self.tris = self.cell.mesh()
        g = self.cell.config["grid"]
        self.origin, self.dx, self.shape = sizing.mode2a(
            self.verts.min(axis=0), self.verts.max(axis=0), g["nx"],
            g["padding"])
        grid = GridSpec(self.origin, self.dx, self.shape)
        cfg = program.sdf_config(self.cell.config["sdf_config"])
        r = pools.rng(self.seed, 1)
        self.verts = (self.verts + pools.offsets(
            len(self.verts), self.dx, t["start_offset_cells"], r)).astype(
                np.float32)
        self.target_verts = (self.verts + pools.offsets(
            len(self.verts), self.dx, t["target_offset_cells"], r)).astype(
                np.float32)
        self.target = pipeline.make_level_set3(
            Mesh(self.target_verts, self.tris), grid, cfg,
            device=self.device)
        self.model = SDFGenerator(Mesh(self.verts, self.tris), grid, cfg,
                                  device=self.device)
        self.lr = float(t["lr_per_vertex"]) * len(self.verts)
        v = self.model.params
        self.first_verts = [upload.to_host(v)]
        self.first_loss = []
        for _ in range(t["first_steps"]):
            v, loss = self.model.train_step(v, self.target, self.lr)
            self.first_loss.append(float(loss))
            self.first_verts.append(upload.to_host(v))
        self.v = v

    def _step(self):
        self.v, loss = self.model.train_step(self.v, self.target, self.lr)
        return float(loss)

    def _traced_step(self):
        from torch.profiler import record_function

        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if self.cuda else None
        marks = [time.perf_counter()]
        with record_function("bench.forward"):
            v = self.v.detach().requires_grad_(True)
            if events:
                events[0].record()
            loss = self.model.loss(v, self.target)
            if events:
                events[1].record()
        marks.append(time.perf_counter())
        with record_function("bench.backward"):
            (grad,) = torch.autograd.grad(loss, v)
            if events:
                events[2].record()
        marks.append(time.perf_counter())
        with record_function("bench.update"):
            self.v = (v - float(np.float32(self.lr)) * grad).detach()
            out = float(loss.detach())
        if events:
            self.spans.add("forward", events[0].elapsed_time(events[1]))
            self.spans.add("backward", events[1].elapsed_time(events[2]))
        else:
            self.spans.add("forward", (marks[1] - marks[0]) * 1e3)
            self.spans.add("backward", (marks[2] - marks[1]) * 1e3)
        return out

    def window(self, seconds: float, traced: bool):
        self.attempted = self.failed = 0
        self.spans = trace.Spans() if traced else None
        self.profile = None
        prof_at = seconds * self.traffic["profile_from"]
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            if traced and self.profile is None and self.cuda \
                    and t_end - t0 >= prof_at:
                with trace.Slice(self.device) as sl:
                    for _ in range(self.traffic["profile_calls"]):
                        t_end = self._one(True)
                        sl.calls += 1
                self.profile = sl.summary()
                continue
            t_end = self._one(traced)
        self.window_s = t_end - t0

    def _one(self, traced: bool) -> float:
        self.attempted += 1
        try:
            loss = self._traced_step() if traced else self._step()
            if not np.isfinite(loss):
                self.failed += 1
        except Exception as exc:  # counted, and the run is not correct
            self.failed += 1
            self.error = repr(exc)
        return time.perf_counter()

    def end_to_end(self) -> dict:
        done = self.attempted - self.failed
        return {"step_ms": self.window_s * 1e3 / done if done else None}

    def release(self):
        del self.model, self.target, self.v

    # -- the check ------------------------------------------------------
    def _points(self, lo: int, hi: int, dtype):
        idx = torch.arange(lo, hi, device=self.device)
        return ref.grid_points(self.origin, self.dx, self.shape, idx, dtype)

    def _search(self, verts, lo: int, hi: int, dtype, sign: bool = True):
        """(points in `dtype`, closest triangle, inside or None) of cells
        lo..hi; the search in `dtype`, at most in float32 (see
        ``follow``), the winding number only where `sign` is asked."""
        low = torch.float32 if dtype == torch.float64 else dtype
        with torch.no_grad():
            tri = ref.triangles(verts.detach().to(low), self._tris)
            pts = self._points(lo, hi, low)
            _, j = ref.closest(pts, tri)
            inside = ref.winding(pts, tri) > 0.5 if sign else None
        return self._points(lo, hi, dtype), j, inside

    def _field(self, verts, dtype):
        """The reference's signed distance of every cell to `verts`."""
        n = int(np.prod(self.shape))
        out = []
        for lo in range(0, n, CELLS_PER_CHUNK):
            pts, j, inside = self._search(verts, lo, min(
                n, lo + CELLS_PER_CHUNK), dtype)
            d = ref.distance_to(pts, ref.triangles(verts, self._tris[j]))
            out.append(torch.where(inside, -d, d))
        return torch.cat(out)

    def _loss_grad(self, verts, target, dtype, held=None):
        """(loss, gradient, inside masks) of the mean squared gap to
        `target` at `verts`: each cell's closest triangle found anew, its
        distance differentiated in the triangle's corners, and its sign
        that of `held` (the masks of an earlier call) or, without it, the
        winding number's at `verts`."""
        leaf = verts.detach().clone().requires_grad_(True)
        n = int(np.prod(self.shape))
        total = 0.0
        masks = []
        for c, lo in enumerate(range(0, n, CELLS_PER_CHUNK)):
            hi = min(n, lo + CELLS_PER_CHUNK)
            pts, j, inside = self._search(leaf, lo, hi, dtype, held is None)
            if held is not None:
                inside = held[c]
            masks.append(inside)
            d = ref.distance_to(pts, ref.triangles(leaf, self._tris[j]))
            phi = torch.where(inside, -d, d)
            part = ((phi - target[lo:hi]) ** 2).sum() / n
            part.backward()
            total += float(part.detach())
        return total, leaf.grad.detach(), masks

    def follow(self, dtype):
        """The reference's first `reference_steps` steps in `dtype`:
        (losses, vertices). Each cell keeps the sign it has at the first
        step's vertices, as the program keeps the signs of the binning
        made in set-up until ``commit``, which the mix never calls. Each
        cell's closest triangle and the first step's winding number are
        searched in float32 over every triangle (in `dtype` where that is
        lower), and its distance, the loss and the gradient are computed
        in `dtype` on the triangle found: a triangle the float32 search
        takes in place of a float64 one lies within float32 rounding of
        it, so the distance is the same to that rounding, and the search
        costs half the bytes."""
        self._tris = torch.from_numpy(self.tris.astype(np.int64)).to(
            self.device)
        target = self._field(torch.from_numpy(self.target_verts).to(
            self.device, dtype), dtype)
        v = torch.from_numpy(self.verts).to(self.device, dtype)
        losses, verts, held = [], [v], None
        for _ in range(self.traffic["reference_steps"]):
            loss, g, masks = self._loss_grad(v, target, dtype, held)
            held = masks if held is None else held
            v = (v - self.lr * g).detach()
            losses.append(loss)
            verts.append(v)
        return losses, verts

    def check(self, control: bool = False) -> dict:
        want_loss, want_v = self.follow(torch.float64)
        if control:
            got_loss, got_v = self.follow(torch.bfloat16)
            got_v = [v.double() for v in got_v]
        else:
            k = self.traffic["reference_steps"]
            got_loss = self.first_loss[:k]
            got_v = [torch.from_numpy(v).to(self.device).double()
                     for v in self.first_verts[:k + 1]]
        return train_numbers(got_loss, got_v, want_loss, want_v, self.lr)


def train_numbers(got_loss, got_v, want_loss, want_v, lr: float) -> dict:
    """Each step's loss gap, the first gradient's norm gap and the norm gap
    of the vertices' change over the steps, each relative to the
    reference's value. The vertices are one leaf; the first gradient is
    worked out from the vertices after one step."""
    def gap(a, b):
        return abs(a - b) / abs(b) if b else float("inf")

    g_got = float(torch.linalg.norm((got_v[0] - got_v[1]) / lr))
    g_want = float(torch.linalg.norm((want_v[0] - want_v[1]) / lr))
    c_got = float(torch.linalg.norm(got_v[-1] - got_v[0]))
    c_want = float(torch.linalg.norm(want_v[-1] - want_v[0]))
    return {
        "loss_gap": max(gap(a, b) for a, b in zip(got_loss, want_loss)),
        "grad_gap": gap(g_got, g_want),
        "change_gap": gap(c_got, c_want),
    }
