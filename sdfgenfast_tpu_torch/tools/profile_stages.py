"""Per-stage breakdown of the default path on one card, read from the
program's own spans.

Counterpart of ``tools/profile_stages.py``. :func:`profile` makes the
user's call, ``api.generate_sdf`` with ``SDFConfig()``, under
``tracing.enable()``: one warm-up, then `repeats` (3) calls. Each call is
split by the spans under its root, ``sdf.generate_sdf``, and each stage is
the median over the calls of its spans summed a call:

- host stages (host clock): :data:`HOST`, the call, ``bin_mesh`` and its
  parts, ``to_host`` and its writes into the result;
- device stages (CUDA events): :data:`DEVICE`, ``make_level_set3``, the
  band (gather, K2, untile, freeze), the far field, its K3 calls and
  ``glue`` (the far field less its K3 spans, the benchmark's ``glue_ms``),
  K4; the dense path's table and K1; the sign; the copies back. A device
  span is timed inside the production call, not alone after a sync; on the
  CPU it has no device time and reads "not measured".

Each stage carries its spans' ``launches`` and their count; the launches
of :data:`SPLIT`, the stages that split a call without overlap, sum to the
root's. K2's row fills, coefficient pass and walk and the glue's parts have
no span: only :func:`device_profile` splits them, by kernel
(``band_coefs_kernel``, ``band_rows_kernel``, torch's ops by name), with
the device's busy share, over one more warm end-to-end call
(``make_level_set3`` on one ``pipeline.bin_mesh`` kept on the device,
synchronised; its min of 3 is the end-to-end time). That binning gives A,
K and P (active tiles, the largest CSR segment, the CSR's length).

Meshes: ``sphere`` (icosphere(6), 81,920 triangles), ``torus``
(``torus_mesh()``, 100,352) and ``box``: ``bench``'s 36-triangle box
(``testing.box36``; the JAX tool's has 12), on
``sizing_mode2a_proportional(mn, mx, Nx, 1)``. On a machine with a card::

    python3 -m sdfgenfast_tpu_torch.tools.profile_stages [Nx ...] [sphere|torus|box]

It prints each stage on stderr and one JSON line on stdout, and raises,
naming CUDA, when there is no card and no ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time

import numpy as np
import torch

from .. import api, pipeline, tracing
from ..grid import sizing_mode2a_proportional
from ..mesh import icosphere, torus_mesh
from ..testing import box36
from .timing import card_line, sync, tool_device

__all__ = ["MESHES", "HOST", "DEVICE", "SPLIT", "device_profile", "profile",
           "main"]

MESHES = {"box": box36, "sphere": lambda: icosphere(6, radius=1.0),
          "torus": torus_mesh}

ROOT = "sdf.generate_sdf"
# the stages by clock, in the order a call runs them
HOST = (ROOT, "sdf.bin_mesh", "sdf.bin.parity", "sdf.bin.band",
        "sdf.bin.csr", "sdf.bin.upload", "sdf.to_host", "sdf.to_host.touch")
DEVICE = ("sdf.make_level_set3", "sdf.band", "sdf.far_field", "sdf.k3",
          "glue", "sdf.chamfer", "sdf.dense.table", "sdf.dense.k1",
          "sdf.sign", "sdf.to_host.link")
# the stages that split a call without overlap
SPLIT = ("sdf.bin_mesh", "sdf.band", "sdf.k3", "glue", "sdf.chamfer",
         "sdf.dense.table", "sdf.dense.k1", "sdf.sign", "sdf.to_host")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _call_stages(records, root) -> dict:
    """The call under `root` (a ``tracing.Record``): stage -> (ms, launches,
    spans), summed over the stage's spans (ms None without device time)."""
    out = {}
    for r in records:
        if r.root == root.id and r.name in HOST + DEVICE:
            ms = r.host_ms if r.name in HOST else r.device_ms
            old, launches, n = out.get(r.name, (0.0, 0, 0))
            out[r.name] = (None if None in (ms, old) else old + ms,
                           launches + r.launches, n + 1)
    if "sdf.far_field" in out:
        (far, far_n, _), (k3, k3_n, _) = (out["sdf.far_field"],
                                          out.get("sdf.k3", (0.0, 0, 0)))
        out["glue"] = (None if None in (far, k3) else far - k3,
                       far_n - k3_n, 1)
    return out


def _stages(mesh, grid, device, repeats: int) -> dict:
    """One warm-up and `repeats` ``generate_sdf`` calls under tracing:
    stage -> (median ms or "not measured", launches, spans)."""
    backend = "cpu" if device.type == "cpu" else "gpu"
    tracing.clear()
    tracing.enable()
    try:
        for i in range(repeats + 1):
            api.generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                             *grid.shape, backend=backend, device=device)
            if i == 0:
                tracing.clear()
        records = tracing.spans()
    finally:
        tracing.disable()
        tracing.clear()
    calls = [_call_stages(records, r) for r in records if r.name == ROOT]
    if len(calls) != repeats:
        raise AssertionError(f"{len(calls)} {ROOT} spans, {repeats} calls")
    out = {}
    for name in HOST + DEVICE:
        if all(name in c for c in calls):
            ms, launches, spans = zip(*(c[name] for c in calls))
            out[name] = ("not measured" if None in ms
                         else round(statistics.median(ms), 4),
                         statistics.median_low(launches),
                         statistics.median_low(spans))
    return out


def device_profile(fn, device) -> dict:
    """torch.profiler over one call of `fn` (work that ends synchronised):
    the device's busy share of the call's wall (the union of the device
    activity intervals over the host clock's window) and each kernel's
    device time by name ("not measured" where the profiler records no device
    activity, and on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"busy_share": "not measured", "kernels": "not measured"}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    sync(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and e.time_range.end > e.time_range.start]
    if not spans:
        return {"busy_share": "not measured", "kernels": "not measured"}
    busy = union_us(spans)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            k = kernels.setdefault(_short(e.key), {"ms": 0.0, "calls": 0})
            k["ms"] += us / 1e3
            k["calls"] += e.count
    return {"busy_share": round(busy / wall_us, 4),
            "device_busy_ms": round(busy / 1e3, 4),
            "wall_ms": round(wall_us / 1e3, 4),
            "kernels": {name: {"ms": round(k["ms"], 4), "calls": k["calls"]}
                        for name, k in sorted(kernels.items(),
                                              key=lambda kv: -kv[1]["ms"])}}


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    spans = sorted(spans)
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + hi - lo


def _short(name: str) -> str:
    """A kernel's name without its arguments and, past 60 characters,
    without its template arguments but the functor or kernel they name
    (torch's names run to a thousand characters)."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    head = name.split("(")[0]
    if len(head) <= 60:
        return head
    outer = head.split("<")[0]
    inner = re.findall(r"\w*(?:Functor|Copy|_kernel|_impl)\w*",
                       head[len(outer):])
    return f"{outer}<{inner[-1]}>" if inner else head[:60] + "..."


def profile(mesh_name: str, nx: int, device, repeats: int = 3) -> dict:
    """The breakdown of `mesh_name` (a key of MESHES) at `nx`: the stages
    of `repeats` ``generate_sdf`` calls, then the warm end-to-end call and
    its profile (see the module docstring)."""
    device = torch.device(device)
    mesh = MESHES[mesh_name]()
    grid = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
    log(f"== Nx={nx} ({mesh_name}, {mesh.num_tris} tris): grid={grid.shape},"
        f" cells={grid.num_cells / 1e6:.2f}M ==")
    stages = _stages(mesh, grid, device, repeats)
    binned = pipeline.bin_mesh(mesh, grid, device=device)
    csr = binned.band_csr
    binning = None if csr is None else {
        "A": int((csr["ids"] < int(np.prod(binned.tiles_dim))).sum()),
        "K": int(csr["cnt"].max()), "P": int(len(csr["pair"]))}

    def e2e():
        sync(device)
        t0 = time.perf_counter()
        pipeline.make_level_set3(mesh, grid, binned=binned, device=device)
        sync(device)
        return (time.perf_counter() - t0) * 1e3

    e2e_ms = min(e2e() for _ in range(repeats))
    for name, (ms, launches, spans) in stages.items():
        log(f"  {name:22s} {ms:>12}  launches {launches}, spans {spans}")
    log(f"  {'end-to-end (warm)':22s} {e2e_ms:12.4f}  (ms)")
    prof = device_profile(e2e, device)
    log(f"  device busy share of the end-to-end call: {prof['busy_share']}")
    k3, glue = (stages.get(n, (None, 0, 0)) for n in ("sdf.k3", "glue"))
    return {"mesh": mesh_name, "nx": nx, "grid": list(grid.shape),
            "tris": int(mesh.num_tris), "cells": grid.num_cells,
            "binning": binning,
            "stages_ms": dict({n: s[0] for n, s in stages.items()},
                              **{"end-to-end (warm)": round(e2e_ms, 4)}),
            "launches": {n: s[1] for n, s in stages.items()},
            "spans": {n: s[2] for n, s in stages.items()},
            "k3_rounds": k3[1], "k3_ms": k3[0], "glue_ms": glue[0],
            "e2e_mvoxels_per_sec": round(grid.num_cells / e2e_ms / 1e3, 2),
            "profile": prof}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*",
                    help="Nx values (default 256) and one of "
                         + ", ".join(MESHES) + " (default box)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain twins (default: the card)")
    a = ap.parse_args(argv)
    device = tool_device(a.device)
    names = [x for x in a.args if not x.isdigit()]
    if any(n not in MESHES for n in names) or len(names) > 1:
        raise ValueError(f"give at most one mesh of {sorted(MESHES)}, got "
                         f"{names}")
    sizes = [int(x) for x in a.args if x.isdigit()] or [256]
    runs = [profile(names[0] if names else "box", nx, device) for nx in sizes]
    line = {"card": card_line(device), "runs": runs}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
