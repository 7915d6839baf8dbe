"""Per-stage breakdown of the default path on one card, with the stages
composed from the functions the pipeline calls.

Counterpart of ``tools/profile_stages.py``. :func:`staged` runs the
pipeline's steps one at a time, in ``pipeline.make_level_set3``'s order,
each timed by CUDA events around its own launches (the median of 3 after a
warm-up), and returns the field and ids it built; :func:`profile` checks
them bit for bit against the production call, so the breakdown is a
breakdown of the path users run. Stages:

- the binned path (``pipeline.exact_core``): ``bin_mesh`` (host, min of 3;
  A active tiles, K the largest CSR segment, P the CSR's length), the upload
  (``upload.pack_device_blob``), the vertex gather, K2's row fills,
  coefficient pass and tile walk (``pipeline._band_k2``), the untile, the
  freeze mask, the pyramid (``ops/vdt.vdt_pyramid_far_field``) split into
  its K3 rounds (summed, with their count) and its glue (``seed_state``,
  ``_downsample2``, ``_upsample_merge``, ``finish_state``) and the axis
  permutation around it, K4, the sign apply (``ops/sign_kernel.
  parity_sign``: the parity decoded and phi signed in one kernel);
- the dense path (``pipeline.dense_sign_core``): the upload, K1's table
  (``ops/dense.sep_table``, the vertex gather inside it), K1, the sign
  apply;
- then the copy back (``upload.to_host``, host clock) and the warm
  end-to-end call (``make_level_set3`` on a binning kept on the device,
  synchronised; the min of 3, as the JAX tool takes it).

``torch.profiler`` over one more warm end-to-end call gives the device's
busy share of that call's wall (the union of its kernels' and copies'
intervals) and the time of each kernel by name; where the profiler records
no device time the line says "not measured".

Meshes: ``sphere`` (icosphere(6), 81,920 triangles), ``torus``
(``torus_mesh()``, 100,352) and ``box``: ``bench``'s 36-triangle box
(``testing.box36``), where the JAX tool's box is the 12-triangle one, so
that the stages are those of ``bench``'s rows. Grids:
``sizing_mode2a_proportional(mn, mx, Nx, 1)``. Run on a machine with a
card::

    python3 -m sdfgenfast_tpu_torch.tools.profile_stages [Nx ...] [sphere|torus|box]

It prints each stage on stderr and one JSON line on stdout, and raises,
naming CUDA, when there is no card and no ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np
import torch

from .. import pipeline, upload
from ..grid import sizing_mode2a_proportional
from ..mesh import icosphere, torus_mesh
from ..ops import band_kernel, dense, sign_kernel, tiled, vdt, vdt_kernel
from ..pipeline import SDFConfig
from ..testing import box36
from .timing import Stages, card_line, sync, tool_device

__all__ = ["MESHES", "staged", "device_profile", "profile", "main"]

MESHES = {"box": box36, "sphere": lambda: icosphere(6, radius=1.0),
          "torus": torus_mesh}

# the pyramid's glue: the stage names :func:`staged` sums into "glue"
GLUE = ("pyramid seed_state", "pyramid downsample", "pyramid upsample_merge",
        "pyramid finish_state")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _check_default(config: SDFConfig) -> None:
    if not (config.far_field == "exact" and config.sign_mode == "host"
            and pipeline.ladder_schedule(config, (1, 1, 1)) is None
            and tuple(config.tile_shape) == (8, 8, 8)):
        raise ValueError("profile_stages times the default route: "
                         "far_field='exact', sign_mode='host', the pyramid, "
                         "8^3 tiles")


def _pyramid(st: Stages, cps, tid, phi_seed, dx: float, freeze, grid_shape):
    """``pipeline.exact_core``'s pyramid in the JAX package's axis
    permutation: ``vdt.vdt_pyramid_far_field``'s steps one by one, its
    rounds through ``vdt_kernel.round_phase``. Returns (phi, tid, K3
    launches)."""
    perm = pipeline._vdt_axis_perm(grid_shape)
    inv = tuple(int(v) for v in np.argsort(perm))

    def t(x):
        return x.permute(perm).contiguous()

    cpx, cpy, cpz, tid_p, phi_p, frz = st.run("pyramid permute", lambda: (
        t(cps[perm[0]]), t(cps[perm[1]]), t(cps[perm[2]]), t(tid),
        t(phi_seed), t(freeze)))
    shape = tuple(cpx.shape)
    dev = cpx.device
    state = st.run("pyramid seed_state",
                   lambda: vdt.seed_state(cpx, cpy, cpz, tid_p, dx))
    levels = [(state, vdt._level_pos_axes(shape, dx, 1, dev), 1)]
    for _ in range(len(vdt.pyramid_level_shapes(shape)) - 1):
        prev, _, scale = levels[-1]
        shape2 = tuple(-(-d // 2) for d in prev.shape[1:])
        levels.append((
            st.run("pyramid downsample",
                   lambda: vdt._downsample2(prev, dx, scale)),
            vdt._level_pos_axes(shape2, dx, scale * 2, dev), scale * 2))
    rounds = 0
    s, _, scale_c = levels[-1]
    strides = vdt.stride_ladder(max(s.shape[1:]), extra_rounds=1)
    s = st.run("pyramid K3 rounds", lambda: vdt_kernel.round_phase(
        s, dx, strides, scale_c))
    rounds += len(strides)
    for lvl in range(len(levels) - 2, -1, -1):
        fine, pos, scale_l = levels[lvl]
        s = st.run("pyramid upsample_merge",
                   lambda: vdt._upsample_merge(s, fine, *pos))
        strides = vdt.PYRAMID_COARSE_ROUNDS if lvl > 0 else (
            vdt.PYRAMID_LEVEL_ROUNDS + (1,) * 2)  # exact_core's extra_polish
        s = st.run("pyramid K3 rounds", lambda: vdt_kernel.round_phase(
            s, dx, strides, scale_l))
        rounds += len(strides)
    phi_o, tid_o = st.run("pyramid finish_state",
                          lambda: vdt.finish_state(s, tid_p, phi_p, frz))
    phi, tid = st.run("pyramid permute", lambda: (
        phi_o.permute(inv).contiguous(), tid_o.permute(inv).contiguous()))
    return phi, tid, rounds


def _band(st: Stages, tri9, d, dx: float, grid_shape, tiles_dim):
    """``pipeline._band_k2``: K2's rows (on the card: the row fills, the
    coefficient pass and the tile walk, as ``band_kernel.band_rows`` runs
    them), then the untile. Returns (phi0, tid0, cps)."""
    T = int(np.prod(tiles_dim))
    pair, ids, off, cnt = (d[k].contiguous()
                           for k in ("pair", "ids", "off", "cnt"))
    if tri9.device.type == "cuda":
        rows = st.run("K2 row fills", lambda: band_kernel._filled_rows(
            T, band_kernel._upper(grid_shape, dx), tri9.device))
        coef = st.run("K2 coefficient pass",
                      lambda: band_kernel.band_coefs(tri9))
        st.run("K2 tile walk", lambda: band_kernel._launch_rows(
            rows, coef, pair, ids, off, cnt, dx, tiles_dim, ids, tiles_dim,
            grid_shape))
    else:
        rows = st.run("K2 tile walk", lambda: band_kernel.band_rows(
            tri9, pair, ids, off, cnt, dx, tiles_dim=tiles_dim,
            grid_shape=grid_shape))
    phi0, tid0, *cps = st.run("untile", lambda: [
        tiled.untile_rows(r[:T], (8, 8, 8), tiles_dim, grid_shape)
        for r in rows])
    return phi0, tid0, cps


def staged(mesh, grid, config: SDFConfig, device, repeats: int = 3):
    """The default path of `mesh` on `grid`, one stage at a time on
    `device` (see the module docstring). Returns (phi, tid, info): the
    signed field and ids on the device, as ``make_level_set3(...,
    return_tid=True)`` gives them, and info holds "stages" (name -> ms),
    "counts" (name -> calls), "binning" (A, K, P; None on the dense path),
    "k3_rounds" and "exact" (the band cells the binning marks exact, the
    freeze mask; None on the dense path)."""
    _check_default(config)
    device = torch.device(device)
    st = Stages(device, repeats)
    binned = st.host("bin_mesh (host)",
                     lambda: pipeline.bin_mesh(mesh, grid, config))
    dense_path = pipeline.use_dense(config, len(mesh.tris))
    blob = st.run("upload", lambda: upload.pack_device_blob(
        pipeline._blob_arrays(binned, mesh.verts), device))
    d = blob.arrays
    dx = float(np.float32(grid.dx))
    ni = grid.shape[0]
    info = {"binning": None, "k3_rounds": 0, "exact": None}
    parity_data = d["parity"] if "parity" in d else d["crossings"]
    if dense_path:
        coef = st.run("K1 table", lambda: dense.sep_table(
            d["verts"], d["origin"], d["tris"]))
        phi, tid = st.run("K1", lambda: dense.dense_stream(
            coef, dx, grid_shape=grid.shape))
    else:
        csr = binned.band_csr
        T = int(np.prod(binned.tiles_dim))
        info["binning"] = {"A": int((csr["ids"] < T).sum()),
                           "K": int(csr["cnt"].max()),
                           "P": int(len(csr["pair"]))}
        tri9 = st.run("vertex gather", lambda: (
            d["verts"][d["tris"].long()] - d["origin"]).reshape(-1, 9)
            .contiguous())
        phi0, tid0, cps = _band(st, tri9, d, dx, grid.shape, binned.tiles_dim)
        seed = min(max(config.exact_band, 3), binned.seed_band)
        freeze = st.run("freeze mask", lambda: (tid0 >= 0) & (
            phi0 <= float(np.float32(seed) * np.float32(dx))))
        phi, tid, info["k3_rounds"] = _pyramid(st, cps, tid0, phi0, dx,
                                               freeze, grid.shape)
        if config.chamfer_passes > 0:
            phi = st.run("K4 chamfer", lambda: vdt_kernel.chamfer(
                phi, dx, config.chamfer_passes))
        info["exact"] = freeze
    # into a fresh tensor: a stage runs more than once
    phi = st.run("sign apply",
                 lambda: sign_kernel.parity_sign(parity_data, ni, phi))
    info["stages"], info["counts"] = st.ms, st.calls
    return phi, tid, info


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


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def profile(mesh_name: str, nx: int, device, repeats: int = 3) -> dict:
    """The breakdown of `mesh_name` (a key of MESHES) at `nx`: the staged
    run's stages, checked bit for bit (phi and ids) against
    ``make_level_set3(..., return_tid=True)`` on the same binning, then the
    copy back, the warm end-to-end call and the profile. Raises
    AssertionError if the staged run differs."""
    device = torch.device(device)
    mesh = MESHES[mesh_name]()
    grid = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
    cfg = SDFConfig()
    log(f"== Nx={nx} ({mesh_name}, {mesh.num_tris} tris): grid={grid.shape},"
        f" cells={grid.num_cells / 1e6:.2f}M ==")
    phi, tid, info = staged(mesh, grid, cfg, device, repeats)
    want, want_tid = pipeline.make_level_set3(mesh, grid, cfg, device=device,
                                              return_tid=True)
    if not (torch.equal(_bits(phi), _bits(want))
            and torch.equal(tid, want_tid)):
        raise AssertionError(f"{mesh_name} {grid.shape}: the staged run "
                             f"differs from make_level_set3")
    del want, want_tid, info["exact"]
    st = Stages(device, repeats)
    st.host("copy back (to_host)", lambda: upload.to_host(phi))
    del phi, tid
    binned = pipeline.bin_mesh(mesh, grid, cfg, device=device)

    def e2e():
        pipeline.make_level_set3(mesh, grid, cfg, binned, device=device)
        sync(device)

    st.host("end-to-end (warm)", e2e)
    stages = dict(info["stages"], **st.ms)
    k3 = stages.get("pyramid K3 rounds")
    glue = sum(stages[k] for k in GLUE if k in stages)
    for name, ms in stages.items():
        calls = info["counts"].get(name, 1)
        log(f"  {name:28s} {ms:9.3f} ms"
            + (f" ({calls} calls)" if calls > 1 else ""))
    if k3 is not None:
        log(f"  pyramid: K3 {k3:.3f} ms over {info['k3_rounds']} rounds, "
            f"glue {glue:.3f} ms")
    prof = device_profile(e2e, device)
    log(f"  device busy share of the end-to-end call: {prof['busy_share']}")
    e2e_ms = stages["end-to-end (warm)"]
    return {"mesh": mesh_name, "nx": nx, "grid": list(grid.shape),
            "tris": int(mesh.num_tris), "cells": grid.num_cells,
            "binning": info["binning"],
            "stages_ms": {k: round(v, 4) for k, v in stages.items()},
            "k3_rounds": info["k3_rounds"],
            "k3_ms": None if k3 is None else round(k3, 4),
            "glue_ms": None if k3 is None else round(glue, 4),
            "e2e_mvoxels_per_sec": round(grid.num_cells / e2e_ms / 1e3, 2),
            "bit_equal": True, "profile": prof}


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
