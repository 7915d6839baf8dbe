#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sdfgenfast_tpu_torch``) on one GPU.

Run from anywhere with ``python3 chip_smoke.py`` on a machine with an NVIDIA
Hopper card, nvcc and a C++ compiler. Phases (each raises on failure):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (nvcc, one process per source) and the native
     host library (make);
  3. each kernel against its plain-torch twin on the card, at the shapes the
     main path gives it (K1 the dense kernel, with the share of pairs its
     cull evaluates; K2 band rows and their coefficient pass, on the main
     path's CSR and on hand-made segments; K3 jump-flood round, K4 chamfer,
     the probes P1-P4; R1/R1b in phase 4d);
  4. the main path, both halves. Binned: ``generate_from_file`` on the
     81,920-triangle sphere at 256^3 and 512^3, held against the reference
     binary's sparse goldens (bars of tests/test_parity_golden.py). Dense:
     the CLI (``python -m sdfgenfast_tpu_torch.cli``) on the three box
     goldens, box36 at 256 x 341 x 425 and a 1024-triangle torus at
     256 x 256 x 75 (K1 at the dense cap) held against the binned path, and
     a small ``generate_sdf_batch``. The probe tool
     (``tools.micro_bench.run``, with the SASS instruction counts of its
     loops, and of K1's and K2's inner loops). The differentiable path: one
     ``models.SDFGenerator.train_step`` on sphere82k at 256^3 (binned) and
     box36 (dense, K1), R1/R1b against their twins and a finite difference
     of the loss. Each path's launch counters are set to 0 just before it
     and must have moved just after;
  5. wall time per call (median and min of warm calls, host work and the
     copy back included), each kernel's time next to its twin's, and the
     differentiable step's forward and forward+backward next to the same
     step with R1/R1b swapped for their twins.

Prints one JSON line of per-kernel results, then the card line, then, as the
last line, ``{"ok": true, "device": {...}}``. Exits non-zero on any failure.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RESOURCES = os.path.join(ROOT, "tests", "resources")
GOLDENS = os.path.join(ROOT, "tests", "goldens")
WARM_CALLS = 5


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over `reps` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps):
    """Mean device time of fn() over `reps` back-to-back calls: the calls are
    queued behind a ~1 ms spin of the card, so the host's launch overhead
    (larger than a small round's kernel) does not leave gaps between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits(torch, x):
    return x.contiguous().view(torch.int32)


def abs_err(got, want):
    """Largest |got - want| over float values, taken in float64."""
    return float((got.double() - want.double()).abs().max())


def seeded_state(torch, shape, dx, seed, device, n_seed=20000):
    """A (5, ni, nj, nk) VDT state on `device`: FAR everywhere except
    `n_seed` random cells holding a closest point near the cell, a random id
    and its d2."""
    from sdfgenfast_tpu_torch.ops import vdt

    rng = np.random.default_rng(seed)
    ni, nj, nk = shape
    st = torch.full((5, ni, nj, nk), float(vdt.FAR), dtype=torch.float32,
                    device=device)
    ii, jj, kk = (torch.from_numpy(rng.integers(0, n, n_seed)).to(device)
                  for n in shape)
    cp = (rng.normal(size=(3, n_seed)).astype(np.float32) * 0.3
          + np.stack([a.cpu().numpy() for a in (ii, jj, kk)]).astype(
              np.float32) * np.float32(dx))
    for c in range(3):
        st[c, ii, jj, kk] = torch.from_numpy(cp[c]).to(device)
    st[3, ii, jj, kk] = torch.from_numpy(rng.integers(
        0, 1 << 24, n_seed).astype(np.int32).view(np.float32)).to(device)
    px, py, pz = vdt._level_pos_axes(shape, dx, 1, device)
    st[4] = vdt._dist2(px, py, pz, st[0], st[1], st[2])
    return st


# Peak rates of one H100 SXM (NVIDIA's data sheet, at the 700 W limit) for
# the bounds: FP32 outside the tensor cores and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per unit of work, by count of each kernel's formula: a
# (cell, triangle) pair of the separable dense distance, a (cell,
# candidate) pair of the band kernel, a triangle of its coefficient pass
# (band_coefs_kernel's sums, products, clamps, two divisions and rsqrt), a
# donor of a jump-flood round (3 subtractions, 3 products, 2 sums, 1
# compare), an offset of a chamfer pass (1 add, 1 min), a cell of R1 and of
# R1b.
OPS_DENSE_PAIR = 45
# the dense pair's plane test alone, for a pair the cull skips: h = (cx*x +
# (cy*y + c0)) + cz*z, h*h and the compare with the cell's best
OPS_DENSE_PLANE = 8
OPS_BAND_PAIR = 90
OPS_BAND_COEF = 150
OPS_VDT_DONOR = 9
OPS_CHAMFER_OFFSET = 2
OPS_R1_CELL = 110
OPS_R1B_CELL = 330


def bound_ms(ops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take for
    `ops` FP32 operations and `nbytes` of device-memory traffic."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_bound(shape):
    """K3's bound for one round: each cell's 20 B read once and written once,
    26 donors of arithmetic."""
    cells = int(np.prod(shape))
    return bound_ms(cells * 26 * OPS_VDT_DONOR, cells * 40)


def k2_compare(label, got, want, rows):
    """K2 rows against the twin's at `rows`: phi and cp within rtol 3e-6
    (atol 1e-6 for cells on the surface), ids equal except at exact d2
    ties. Returns (max_abs_err, number of id mismatches)."""
    g = [x[rows].cpu().numpy() for x in got]
    w = [x[rows].cpu().numpy() for x in want]
    err = 0.0
    for name, a, b in zip(("phi", "tid", "cpx", "cpy", "cpz"), g, w):
        if name == "tid":
            continue
        np.testing.assert_allclose(a, b, rtol=3e-6, atol=1e-6,
                                   err_msg=f"{label} {name}")
        err = max(err, float(np.abs(a - b).max()))
    mism = g[1] != w[1]
    if mism.any():
        # a different id is only allowed where the two distances tie
        np.testing.assert_allclose(g[0][mism], w[0][mism], rtol=3e-6,
                                   atol=1e-6, err_msg=f"{label} tid at non-tie")
        if mism.mean() > 1e-4:
            raise AssertionError(f"{label}: {int(mism.sum())} tid mismatches")
    return err, int(mism.sum())


def check_k2(torch, device, mesh, grid):
    """K2 vs its twin: the coefficient pass within rtol 3e-6 of
    ``_band_coefs``; the rows on the main path's CSR and on hand-made
    segments (testing.k2_segments) within the bars of k2_compare. Times the two
    launches alone (coefficient pass + tile walk) and the five row fills
    apart. Returns a dict of errors, times and bounds."""
    from sdfgenfast_tpu_torch import testing
    from sdfgenfast_tpu_torch.ops import band_kernel
    from sdfgenfast_tpu_torch.pipeline import bin_mesh

    binned = bin_mesh(mesh, grid)
    csr = binned.band_csr
    dx = float(np.float32(grid.dx))
    T = int(np.prod(binned.tiles_dim))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    verts = dev(mesh.verts)
    origin = dev(np.asarray(grid.origin, np.float32))
    tri9 = (verts[dev(binned.tris).long()] - origin).reshape(-1, 9).contiguous()
    coef = band_kernel.band_coefs(tri9)
    want_coef = band_kernel._band_coefs(tri9)
    torch.cuda.synchronize()
    np.testing.assert_allclose(coef.cpu().numpy(), want_coef.cpu().numpy(),
                               rtol=3e-6, atol=1e-6, err_msg="K2 coefficients")
    coef_err = abs_err(coef, want_coef)
    coef_bits = int((bits(torch, coef) != bits(torch, want_coef)).sum())

    args = (tri9, dev(csr["pair"]), dev(csr["ids"]), dev(csr["off"]),
            dev(csr["cnt"]), dx)
    kw = dict(tiles_dim=binned.tiles_dim, grid_shape=grid.shape)
    got = band_kernel.band_rows(*args, **kw)
    want = band_kernel.band_rows_reference(*args, **kw)
    torch.cuda.synchronize()
    active = csr["ids"][csr["ids"] < T]
    err, mism = k2_compare("K2", got, want, dev(active).long())
    print(f"K2 band_rows vs twin: A={len(active)} active tiles, "
          f"P={len(csr['pair'])}, tid mismatches {mism}, max|err| "
          f"{err:.3e}; coefficient table max|err| {coef_err:.3e} "
          f"({coef_bits} of {coef.numel()} words not bit-equal)", flush=True)

    hand = testing.k2_segments(tri9.reshape(-1, 3, 3).cpu().numpy(), dx,
                       binned.tiles_dim, active, (1, 129, 20))
    hargs = (*(dev(a) for a in hand), dx)
    got = band_kernel.band_rows(*hargs, **kw)
    want = band_kernel.band_rows_reference(*hargs, **kw)
    torch.cuda.synchronize()
    tiles = dev(hand[2][:-1]).long()
    herr, hmism = k2_compare("K2 hand-made", got, want, tiles)
    for x, y in zip(got, want):  # the padded slot's junk row and the rest
        if not torch.equal(bits(torch, x[T]), bits(torch, y[T])):
            raise AssertionError("K2 hand-made: the padded slot's row differs")
    print(f"K2 hand-made segments (1, 129 in three chunks, 20 + two "
          f"zero-area, 40 on the far corner tile {T - 1}; a padded slot) vs "
          f"twin: "
          f"tid mismatches {hmism}, max|err| {herr:.3e}", flush=True)
    err = max(err, herr, coef_err)

    upper = band_kernel._upper(grid.shape, dx)
    rows = band_kernel._filled_rows(T, upper, device)
    pair, ids, off, cnt = args[1:5]
    # queued behind a spin of the card: the host's launch overhead is
    # longer than the coefficient pass
    times = {
        "coefs": queued_ms(torch, lambda: band_kernel.band_coefs(tri9), 20),
        "walk": queued_ms(torch, lambda: band_kernel._launch_rows(
            rows, coef, pair, ids, off, cnt, dx, binned.tiles_dim,
            grid.shape), 20),
        "fills": queued_ms(torch, lambda: band_kernel._filled_rows(
            T, upper, device), 20),
        "whole": queued_ms(torch, lambda: band_kernel.band_rows(*args, **kw),
                           10),
        "plain": cuda_ms(torch, lambda: band_kernel.band_rows_reference(
            *args, **kw), 2),
        "coefs_plain": cuda_ms(torch, lambda: band_kernel._band_coefs(tri9),
                               10),
    }
    # the bounds: every (cell, real candidate) pair of the active tiles; the
    # table rows, the CSR arrays and the five output rows of each tile; the
    # coefficient pass reads 36 B and writes 160 B per triangle
    M = len(binned.tris)
    real = sum(int((csr["pair"][o:o + c] < M).sum())
               for t, o, c in zip(csr["ids"], csr["off"], csr["cnt"]) if t < T)
    bounds = {
        "walk": bound_ms(real * 512 * OPS_BAND_PAIR,
                         160 * M + 4 * len(csr["pair"]) + 12 * len(csr["ids"])
                         + 20 * 512 * len(active)),
        "coefs": bound_ms(M * OPS_BAND_COEF, 196 * M),
    }
    print(f"K2 at {grid.shape}: {real} (tile, candidate) pairs, "
          f"{real * 512} (cell, candidate) pairs", flush=True)
    return dict(err=err, times=times, bounds=bounds, pairs=real)


K3_STRIDES = (1, 2, 3, 4, 8, 16, 32, 64)


def check_k3(torch, device, shapes=((128, 128, 128), (48, 41, 75),
                                     (37, 29, 70), (130, 5, 66))):
    """K3 vs its twin: bit-equal on all five channels for every stride
    (64 takes the three-run halo in k) and scale, at >= 128^3 and shapes
    that end mid-tile on every axis, and over a multi-round phase. Returns
    the largest error over the float channels (0 when bit-equal)."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    dx = float(np.float32(0.02))
    n, err = 0, 0.0
    floats = [0, 1, 2, 4]  # channel 3 holds id bits
    for shape in shapes:
        st = seeded_state(torch, shape, dx, sum(shape), device)
        for scale in (1, 2, 4):
            for stride in K3_STRIDES:
                got = vdt_kernel.round_phase(st, dx, (stride,), scale)
                want = vdt_kernel.round_phase_reference(st, dx, (stride,),
                                                        scale)
                if not torch.equal(bits(torch, got), bits(torch, want)):
                    bad = (bits(torch, got) != bits(torch, want)).sum().item()
                    raise AssertionError(
                        f"K3 {shape} stride {stride} scale {scale}: "
                        f"{bad} words differ")
                err = max(err, abs_err(got[floats], want[floats]))
                n += 1
        # a whole multi-round phase, as the pyramid runs it
        got = vdt_kernel.round_phase(st, dx, (8, 4, 2, 2, 1, 1, 1), 1)
        want = vdt_kernel.round_phase_reference(st, dx, (8, 4, 2, 2, 1, 1, 1), 1)
        if not torch.equal(bits(torch, got), bits(torch, want)):
            raise AssertionError(f"K3 {shape}: multi-round phase differs")
        err = max(err, abs_err(got[floats], want[floats]))
    print(f"K3 round_phase vs twin: {n} single rounds (strides {K3_STRIDES}, "
          f"scales 1, 2, 4, shapes {shapes}) + {len(shapes)} phases "
          f"bit-equal", flush=True)
    return err


def time_k3(torch, device, card, shape, plain=False):
    """K3's time per stride on a seeded state of `shape`, beside its bound.
    Returns {stride: ms} (and the twin's stride-1 time when `plain`)."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    dx = float(np.float32(0.02))
    st = seeded_state(torch, shape, dx, 1, device,
                      n_seed=int(np.prod(shape)) // 40)
    bound, by = k3_bound(shape)
    times = {}
    for stride in K3_STRIDES:
        times[stride] = queued_ms(
            torch, lambda: vdt_kernel.round_phase(st, dx, (stride,), 1), 10)
        print(f"[{card}] K3 round {shape} stride {stride}: "
              f"{times[stride]:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / times[stride]:.1%} of the bound", flush=True)
    if plain:
        times["plain"] = cuda_ms(torch, lambda: vdt_kernel.round_phase_reference(
            st, dx, (1,), 1), 3)
    return times


def k3_call_time(torch, device, card, mesh_path, nx):
    """The summed K3 device time of one generate_from_file call: every phase
    the pyramid runs is recorded, then each of its rounds is replayed alone
    on the round's own input and timed (queued_ms). Returns (ms, launches,
    per-level list)."""
    from sdfgenfast_tpu_torch import generate_from_file
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    real = vdt_kernel.round_phase
    phases = []

    def record(state, dx, strides, scale=1):
        phases.append((state.clone(), dx, tuple(strides), scale))
        return real(state, dx, strides, scale)

    # round_phase counts on the module's name, which is `record` meanwhile
    record.launches = real.launches
    vdt_kernel.round_phase = record
    try:
        generate_from_file(mesh_path, nx=nx, device=device)
    finally:
        vdt_kernel.round_phase = real
        real.launches = record.launches
    total, launches, levels = 0.0, 0, []
    for state, dx, strides, scale in phases:
        ms = []
        for stride in strides:
            ms.append(queued_ms(
                torch, lambda: real(state, dx, (stride,), scale), 10))
            state = real(state, dx, (stride,), scale)
        levels.append((tuple(state.shape[1:]), strides, ms))
        total += sum(ms)
        launches += len(strides)
    del phases
    for shape, strides, ms in levels:
        print(f"[{card}] K3 in the call, level {shape}: strides {strides}, "
              + ", ".join(f"{t:.4f}" for t in ms) + f" ms (sum "
              f"{sum(ms):.4f})", flush=True)
    print(f"[{card}] K3 summed over one call ({launches} launches): "
          f"{total:.4f} ms", flush=True)
    return total, launches, levels


def check_k4(torch, device, full_shape,
             shapes=((128, 128, 128), (48, 41, 75))):
    """K4 vs its twin: bit-equal at >= 128^3 and a ragged shape, passes=2.
    Returns (max_abs_err, ms, plain_ms), the times at the main path's grid."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    rng = np.random.default_rng(1)
    dx = float(np.float32(0.02))
    err = 0.0
    for shape in shapes:
        phi = torch.from_numpy(
            np.abs(rng.normal(size=shape)).astype(np.float32)).to(device)
        got = vdt_kernel.chamfer(phi, dx, 2)
        want = vdt_kernel.chamfer_reference(phi, dx, 2)
        if not torch.equal(bits(torch, got), bits(torch, want)):
            raise AssertionError(f"K4 {shape}: chamfer differs from its twin")
        err = max(err, abs_err(got, want))
    print(f"K4 chamfer vs twin: bit-equal at {shapes}", flush=True)
    phi = torch.from_numpy(
        np.abs(rng.normal(size=full_shape)).astype(np.float32)).to(device)
    ms = cuda_ms(torch, lambda: vdt_kernel.chamfer(phi, dx, 2), 10)
    plain = cuda_ms(torch, lambda: vdt_kernel.chamfer_reference(phi, dx, 2), 3)
    return err, ms, plain


def tri_local(torch, device, mesh, origin):
    """(M, 3, 3) float32 grid-local triangle vertices on the card."""
    tv = mesh.verts[mesh.tris.astype(np.int64)] - np.asarray(origin, np.float32)
    return torch.from_numpy(np.ascontiguousarray(tv, np.float32)).to(device)


def check_dense(torch, device, label, kernel, twin, table, tris, dx,
                grid_shape, ijk_offset=(0, 0, 0)):
    """K1 / K1b vs its twin: phi within rtol 3e-6 / atol 1e-6; ids equal
    except where the two ids' distances tie to that bar; at most 1e-4 of
    the cells differ at all. Returns max |err|."""
    from sdfgenfast_tpu_torch.ops.geometry import point_triangle_distance_sq_soa

    kw = dict(grid_shape=grid_shape, ijk_offset=ijk_offset)
    gp, gt = kernel(table, dx, **kw)
    wp, wt = twin(table, dx, **kw)
    torch.cuda.synchronize()
    gp, gt, wp, wt = (x.cpu().numpy() for x in (gp, gt, wp, wt))
    if not np.isfinite(gp).all():
        raise AssertionError(f"{label}: non-finite distances")
    np.testing.assert_allclose(gp, wp, rtol=3e-6, atol=1e-6,
                               err_msg=f"{label} phi")
    mism = gt != wt
    differ = mism | (gp.view(np.int32) != wp.view(np.int32))
    if mism.any():
        # both ids' distances at those cells, in the twins' arithmetic
        n = np.flatnonzero(mism)
        ijk = np.stack(np.unravel_index(n, grid_shape), 1) + np.asarray(
            ijk_offset)
        p = torch.from_numpy(ijk.astype(np.float32) * np.float32(dx)).to(device)
        pts = tuple(p[:, i] for i in range(3))

        def dist(ids):
            t = tris[torch.from_numpy(ids.astype(np.int64)).to(device)]
            return torch.sqrt(point_triangle_distance_sq_soa(
                pts, *(tuple(t[:, v, i] for i in range(3))
                       for v in range(3)))).cpu().numpy()

        np.testing.assert_allclose(dist(gt.reshape(-1)[n]),
                                   dist(wt.reshape(-1)[n]), rtol=3e-6,
                                   atol=1e-6, err_msg=f"{label} tid at non-tie")
    if differ.sum() > 1e-4 * differ.size:
        raise AssertionError(f"{label}: {int(differ.sum())} cells differ")
    err = abs_err(torch.from_numpy(gp), torch.from_numpy(wp))
    print(f"{label} vs twin: {grid_shape}, M={table.shape[1]}, cells "
          f"differing {int(differ.sum())} of {differ.size} (tid "
          f"{int(mism.sum())}), max|err| {err:.3e}", flush=True)
    return err


def box36(Mesh, box_mesh):
    """The reference's 36-triangle benchmark box (bench.py): the 3x4x5 box
    with each face triangle split 1->3 at its centroid."""
    m = box_mesh((3, 4, 5), (-1, -1, -1))
    cent = m.verts[m.tris].mean(axis=1).astype(np.float32)
    nv = len(m.verts)
    tris = []
    for i, (a, b, c) in enumerate(m.tris):
        tris += [(a, b, nv + i), (b, c, nv + i), (c, a, nv + i)]
    return Mesh(np.concatenate([m.verts, cent]), np.asarray(tris, np.uint32))


def k1_counted(torch, table, dx, grid_shape):
    """K1's counting build (sdf_dense_stream_counted: the same walk, which
    also counts the (warp, triangle) steps the cull does not skip). Not a
    main-path launch: dense_stream's counter is untouched. Returns (phi,
    tid, evaluated steps, all steps)."""
    from sdfgenfast_tpu_torch.kernels import build

    phi = torch.empty(grid_shape, dtype=torch.float32, device=table.device)
    tid = torch.empty(grid_shape, dtype=torch.int32, device=table.device)
    evaluated = torch.zeros(1, dtype=torch.int64, device=table.device)
    build.check(build.library().sdf_dense_stream_counted(
        table.data_ptr(), table.shape[1], *grid_shape, 0, 0, 0, float(dx),
        phi.data_ptr(), tid.data_ptr(), evaluated.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "sdf_dense_stream_counted")
    ni, nj, nk = grid_shape
    steps = ni * -(-nj // 8) * -(-nk // 16) * table.shape[1]
    return phi, tid, int(evaluated.item()), steps


def k1_bound(cells, m, share):
    """K1's bound at this run's cull: a share `share` of the (cell,
    triangle) pairs takes the whole formula (OPS_DENSE_PAIR), the rest only
    its plane test (OPS_DENSE_PLANE); the table read once, phi and the id
    written once."""
    pairs = cells * m
    return bound_ms(pairs * (share * OPS_DENSE_PAIR
                             + (1 - share) * OPS_DENSE_PLANE),
                    160 * m + 8 * cells)


def check_k1(torch, device, box, box_grid, torus, torus_grid):
    """K1 (dense_stream) vs its twin dense_sep_reference. On a table of one
    chunk (at most 128 triangles, staged once per block): box36 on its full
    256-class grid, icosphere(1) (80 triangles) 1000 units from the world
    origin on a ragged grid with an index offset, zero-area triangles, and
    M = 128 (a full chunk). On a streamed table: M = 129 (a one-triangle
    second chunk), icosphere(2) (320: two full chunks and a half one) at
    1000 with an offset, M = 385 (three full chunks and a one-triangle one),
    all on ragged grids with index offsets, and the 1024-triangle torus on
    its 256-class grid and on a ragged grid. Times box36 and torus1024
    beside the twin; counts the share of (warp, triangle) steps the cull
    evaluates on both with the counting build, which must write the same
    bits as the kernel. Returns a dict."""
    from sdfgenfast_tpu_torch.mesh import Mesh, icosphere
    from sdfgenfast_tpu_torch.ops import dense

    def case(label, tris, dx, shape, off=(0, 0, 0)):
        table = dense._sep_coefs(tris).contiguous()
        return check_dense(torch, device, label, dense.dense_stream,
                           dense.dense_sep_reference, table, tris, dx, shape,
                           off), table

    dx = float(np.float32(box_grid.dx))
    err, table = case("K1 box36", tri_local(torch, device, box,
                                            box_grid.origin), dx,
                      box_grid.shape)
    far_origin = (998.6, 998.7, 998.65)
    for level in (1, 2):
        sphere = icosphere(level, radius=1.0, center=(1000.03, 999.98, 1000.05))
        err = max(err, case(f"K1 icosphere({level}) at 1000", tri_local(
            torch, device, sphere, far_origin), 0.05, (37, 29, 53),
            (5, 3, 7))[0])
    degen = Mesh(np.asarray([[0.5, 0.5, 0.5], [0.2, 0.3, 0.4],
                             [0.9, 0.3, 0.4], [0.1, 0.9, 0.2],
                             [0.8, 0.7, 0.9]], np.float32),
                 np.asarray([[0, 0, 0], [1, 2, 2], [1, 3, 4]], np.uint32))
    err = max(err, case("K1 zero-area", tri_local(torch, device, degen,
                                                  (0, 0, 0)),
                        0.05, (24, 20, 31))[0])
    ico = icosphere(3, radius=1.0, center=(0.02, -0.01, 0.03))
    for m in (128, 129, 385):
        e = case(f"K1 icosphere(3)[:{m}]", tri_local(
            torch, device, Mesh(ico.verts, ico.tris[:m]), (-1.2, -1.15, -1.1)),
            0.04, (37, 61, 45), (9, 2, 7))[0]
        err = max(err, e)
    tdx = float(np.float32(torus_grid.dx))
    tris = tri_local(torch, device, torus, torus_grid.origin)
    terr, ttable = case("K1 torus1024", tris, tdx, torus_grid.shape)
    terr = max(terr, case("K1 torus1024 ragged", tris, tdx, (45, 38, 29),
                          (60, 90, 20))[0])

    # the share of (warp, triangle) steps that the cull evaluates
    shares = {}
    for label, tab, d, shape in (("box36", table, dx, box_grid.shape),
                                 ("torus1024", ttable, tdx, torus_grid.shape)):
        phi, tid, n_eval, steps = k1_counted(torch, tab, d, shape)
        want_phi, want_tid = dense.dense_stream(tab, d, grid_shape=shape)
        if not (torch.equal(bits(torch, phi), bits(torch, want_phi))
                and torch.equal(tid, want_tid)):
            raise AssertionError(f"K1 {label}: the counting build differs")
        shares[label] = n_eval / steps
        print(f"K1 {label}: the cull evaluated {n_eval} of {steps} (warp, "
              f"triangle) steps ({shares[label]:.1%}); a warp covers 128 "
              f"cells; the counting build wrote the kernel's bits",
              flush=True)
    kw = dict(grid_shape=box_grid.shape)
    tkw = dict(grid_shape=torus_grid.shape)
    return dict(
        err=err, torus_err=terr, evaluated_share=shares["box36"],
        torus_evaluated_share=shares["torus1024"],
        ms=cuda_ms(torch, lambda: dense.dense_stream(table, dx, **kw), 10),
        plain=cuda_ms(torch, lambda: dense.dense_sep_reference(
            table, dx, **kw), 2),
        torus_ms=cuda_ms(torch, lambda: dense.dense_stream(ttable, tdx, **tkw),
                         10),
        torus_plain=cuda_ms(torch, lambda: dense.dense_sep_reference(
            ttable, tdx, **tkw), 2))


def golden_bars(phi, grid, golden_path):
    """The dense-golden bars of tests/test_parity_golden.py."""
    from sdfgenfast_tpu_torch.io import sdf_io

    golden, gmin, _ = sdf_io.read_sdf(golden_path)
    if phi.shape != golden.shape or phi.shape != grid.shape:
        raise AssertionError(f"grid {phi.shape} != golden {golden.shape}")
    np.testing.assert_allclose(grid.bounds_min, gmin,
                               atol=2e-6 * max(abs(gmin).max(), 1))
    surf = np.minimum(np.abs(phi), np.abs(golden)) < 1e-5
    mism = ((phi < 0) != (golden < 0)) & ~surf
    if mism.sum():
        raise AssertionError(f"{int(mism.sum())} sign mismatches")
    near = np.abs(golden) < 2 * grid.dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(golden)[near],
                               rtol=5e-5, atol=2e-6)
    far = float(np.abs(np.abs(phi) - np.abs(golden)).max())
    if not far < 0.2 * grid.dx:
        raise AssertionError(f"far-field divergence {far:.3e} >= 0.2*dx")
    return far / grid.dx


def cli_goldens():
    """The port's CLI, as subprocesses on the card, on the three box
    goldens' arguments (tests/goldens/manifest.json); each output .sdf is
    held to the golden bars and the reference's stdout lines."""
    import shutil

    from sdfgenfast_tpu_torch.grid import (sizing_mode1_legacy,
                                           sizing_mode2a_proportional,
                                           sizing_mode2b_manual)
    from sdfgenfast_tpu_torch.io import mesh_io, sdf_io

    with open(os.path.join(GOLDENS, "manifest.json")) as fh:
        manifest = json.load(fh)
    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = {k: v for k, v in os.environ.items() if k != "SDFGEN_TORCH_BACKEND"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    names = sorted(k for k in manifest if k.startswith("box_"))
    procs = {}
    try:
        for name in names:
            entry = manifest[name]
            shutil.copy(os.path.join(RESOURCES, entry["mesh"]), work)
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "sdfgenfast_tpu_torch.cli",
                 entry["mesh"], *entry["cli_args"]], cwd=work, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        outs = {name: p.communicate(timeout=300) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name in names:
        entry = manifest[name]
        out, err = outs[name]
        if procs[name].returncode != 0:
            raise AssertionError(f"CLI {name} exited {procs[name].returncode}:"
                                 f"\n{out[-2000:]}\n{err[-2000:]}")
        for line in entry["stdout"] + ["Hardware: CUDA GPU"]:
            if line not in out:
                raise AssertionError(f"CLI {name}: {line!r} not in stdout")
        mesh, mn, mx = mesh_io.load_mesh(os.path.join(RESOURCES, entry["mesh"]))
        cli = entry["cli_args"]
        if entry["mesh"].endswith(".stl"):
            if len(cli) >= 5:
                grid = sizing_mode2b_manual(mn, mx, *map(int, cli[:4]))
            else:
                grid = sizing_mode2a_proportional(mn, mx, int(cli[0]),
                                                  int(cli[1]))
        else:
            grid = sizing_mode1_legacy(mn, mx, float(cli[0]), int(cli[1]))
        phi, _, _ = sdf_io.read_sdf(os.path.join(
            work, entry["reference_output_name"]))
        far = golden_bars(phi, grid, os.path.join(GOLDENS, entry["golden"]))
        print(f"CLI {name} {phi.shape} on the card: golden bars met "
              f"(far field {far:.4f} dx)", flush=True)
    shutil.rmtree(work, ignore_errors=True)


def check_exact_sample(label, mesh, grid, phi, n=4096):
    """|phi| on `n` seeded random cells against the float64 exact distance
    (tests/oracle.py) from the same float32 grid-local triangles and cell
    positions the kernels use: the dense path is exact everywhere."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import point_triangle_distance_np

    idx = np.random.default_rng(0).integers(0, phi.size, n)
    ijk = np.stack(np.unravel_index(idx, grid.shape), 1)
    p = (ijk.astype(np.float32) * np.float32(grid.dx)).astype(np.float64)
    tl = (mesh.verts[mesh.tris.astype(np.int64)]
          - np.asarray(grid.origin, np.float32)).astype(np.float64)
    exact = np.concatenate([
        point_triangle_distance_np(p[s:s + 256, None], tl[None, :, 0],
                                   tl[None, :, 1], tl[None, :, 2]).min(axis=1)
        for s in range(0, n, 256)])
    np.testing.assert_allclose(np.abs(phi.reshape(-1)[idx]), exact,
                               rtol=2e-5, atol=2e-6, err_msg=f"{label} exact")


def check_dense_vs_binned(torch, device, label, mesh, grid, phi):
    """A dense-path field against the float64 exact distance on a sample
    of cells and against the binned path on the same grid: 0 sign
    mismatches off the surface, the near band (|phi| < 2 dx) equal to the
    golden band bar, and the binned far field never below the exact dense
    one and less than 0.2 dx above it (the golden far-field bar). Returns
    the largest gap in units of dx."""
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, make_level_set3

    if not np.isfinite(phi).all() or phi.shape != grid.shape:
        raise AssertionError(f"{label}: bad dense output")
    check_exact_sample(label, mesh, grid, phi)
    binned = make_level_set3(mesh, grid, SDFConfig(dense_max_tris=0),
                             device=device).cpu().numpy()
    a, b = np.abs(phi), np.abs(binned)
    mism = int((((phi < 0) != (binned < 0)) & (np.minimum(a, b) > 1e-5)).sum())
    if mism:
        raise AssertionError(f"{label}: {mism} sign mismatches")
    near = a < 2 * grid.dx
    np.testing.assert_allclose(b[near], a[near], rtol=5e-5, atol=2e-6,
                               err_msg=f"{label} near band")
    gap = b - a
    if (gap < -(2e-6 + 5e-5 * a)).any():
        raise AssertionError(f"{label}: the binned path undercuts the exact "
                             f"dense field by {-gap.min():.3e}")
    worst = float(gap.max()) / grid.dx
    if not worst < 0.2:
        raise AssertionError(f"{label}: binned far field {worst:.4f} dx above")
    print(f"{label} {grid.shape}: dense exact on a sample; vs the binned "
          f"path 0 sign mismatches, band equal, binned far field above the "
          f"exact one by at most {worst:.4f} dx (mean "
          f"{float(gap.mean()) / grid.dx:.5f} dx; "
          f"{int((gap > 0.05 * grid.dx).sum())} cells above 0.05 dx)",
          flush=True)
    return worst


def check_golden(phi, golden_path, far_key, stride, grid):
    """The bars of tests/test_parity_golden.py's sparse-golden tests."""
    g = np.load(golden_path)
    dims = tuple(int(v) for v in g["dims"])
    if phi.shape != dims:
        raise AssertionError(f"grid {phi.shape} != golden {dims}")
    np.testing.assert_allclose(grid.bounds_min, g["bmin"], atol=2e-6)
    if not np.isfinite(phi).all():
        raise AssertionError("non-finite values in the SDF")
    flat = phi.reshape(-1)
    ref_neg = np.unpackbits(g["packed_signs"])[: flat.size].astype(bool)
    mism = (ref_neg != (flat < 0)) & ~(np.abs(flat) < 1e-5)
    if mism.sum():
        raise AssertionError(f"{int(mism.sum())} sign mismatches")
    np.testing.assert_allclose(np.abs(flat[g["band_idx"]]),
                               np.abs(g["band_val"]), rtol=5e-5, atol=2e-6)
    ours = phi[::stride, ::stride, ::stride]
    far = float(np.abs(np.abs(ours) - np.abs(g[far_key])).max())
    if not far < 0.2 * float(g["dx"]):
        raise AssertionError(f"far-field divergence {far:.3e} >= 0.2*dx")
    return far / float(g["dx"])


def kernel_name(mangled):
    """A kernel's name (with its bool template arguments) from its mangled
    symbol: the length-prefixed identifier that ends in ``_kernel``."""
    # the innermost name is the last one; a hash's digits may precede its
    # length, so every suffix of a run of digits is tried
    for m in reversed(list(re.finditer(r"\d+", mangled))):
        for k in reversed(range(len(m.group(0)))):
            n = int(m.group(0)[k:])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                t = re.match(r"I((?:Lb[01]E)+)E", mangled[m.end() + n:])
                if t is None:
                    return name
                return name + "<" + ", ".join(
                    "true" if b == "1" else "false"
                    for b in re.findall(r"Lb([01])E", t.group(1))) + ">"
    return mangled


def sass_text(lib_path):
    """The library's SASS (cuobjdump -sass), or None without cuobjdump."""
    import shutil

    tool = next((c for c in (os.path.join(os.environ.get("CUDA_HOME", ""),
                                          "bin", "cuobjdump"),
                             "/usr/local/cuda/bin/cuobjdump")
                 if os.path.isfile(c)), shutil.which("cuobjdump"))
    if tool is None:
        return None
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr[-2000:]}")
    return r.stdout


def sass_functions(text):
    """{short kernel name: [(address, instruction)], {label: index}} of
    every function in a SASS listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs[kernel_name(m.group(1))] = ([], {})
            continue
        if cur is None:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            cur[1][lab.group(1)] = len(cur[0])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins:
            cur[0].append((int(ins.group(1), 16), ins.group(2)))
    return funcs


def sass_counts(text):
    """FFMA / FMUL / FADD counts of each probe kernel's SASS: a folded loop
    would show a handful."""
    counts = {}
    for name, (ins, _) in sass_functions(text).items():
        if re.search(r"vpu_peak|vpu_mixed|scale2|add1", name):
            counts[name] = {op: sum(bool(re.search(rf"\b{op}\b", i))
                                    for _, i in ins)
                            for op in ("FFMA", "FMUL", "FADD")}
    return counts


def sass_inner_loops(text, pattern=r"dense_stream|band_rows"):
    """For each kernel matching `pattern`, its innermost loop (a backward
    branch's span that holds no other) with the most FP32 instructions:
    (instructions, FP32 arithmetic/compare/select instructions, LDS
    instructions). The walks load a candidate's ten float4 with ten LDS, so
    LDS / 10 is the candidates per trip of an unrolled loop."""
    out = {}
    fp = re.compile(r"^(@!?U?P[T\d]+\s+)?(FFMA|FMUL|FADD|FMNMX|FSETP|FSEL|"
                    r"FSET|FCHK|MUFU)\b")
    for name, (ins, labels) in sass_functions(text).items():
        if not re.search(pattern, name):
            continue
        index = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (_, op) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op)
            if not m:
                continue
            tgt = (labels.get(m.group(1)) if m.group(1)
                   else index.get(int(m.group(2), 16)))
            if tgt is not None and tgt <= i:
                loops.append((tgt, i))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        stats = [(hi - lo + 1,
                  sum(bool(fp.search(op)) for _, op in ins[lo:hi + 1]),
                  sum(bool(re.search(r"\bLDS\b", op))
                      for _, op in ins[lo:hi + 1])) for lo, hi in inner]
        out[name] = max(stats, key=lambda s: s[1], default=None)
    return out


def finite_err(torch, got, want):
    """Largest |got - want| where both are finite (0.0 if none)."""
    both = torch.isfinite(got) & torch.isfinite(want)
    if not both.any():
        return 0.0
    return float((got[both].double() - want[both].double()).abs().max())


def same_bits(torch, got, want):
    """Bit for bit, every NaN counted equal to every NaN."""
    eq = bits(torch, got) == bits(torch, want)
    return bool((eq | (torch.isnan(got) & torch.isnan(want))).all())


def check_probes(torch, device):
    """P1-P4 against their twins at the tool's shapes: ones (the tool's
    input) and a seeded input in [-1.5, 1.5]; P1/P2 also on a 4-step chain
    whose values stay finite. Bars: P1 without FMA, P2, P3 and P4 bit for
    bit, non-finite values included; P1 with FMA within 1 ulp of the twin
    that adds in float64 and rounds once, or both non-finite. Returns
    {name: (max_abs_err, plain_ms[, library_ms])}: the library call, timed
    for P3 and P4 only, is torch's own x * 2 and x + 1."""
    from sdfgenfast_tpu_torch.tools import micro_bench as mb

    rng = np.random.default_rng(3)

    def inputs(shape):
        return (torch.ones(shape, dtype=torch.float32, device=device),
                torch.from_numpy(rng.uniform(-1.5, 1.5, shape).astype(
                    np.float32)).to(device))

    out = {}
    for fma in (False, True):
        name = "vpu_peak_fma" if fma else "vpu_peak"
        err = 0.0
        for x in inputs(mb.VPU_SHAPE):
            for chain in (mb.PEAK_CHAIN, 4):
                got = mb.vpu_peak(x, chain, fma)
                want = mb.vpu_peak_reference(x, chain, fma)
                if fma:
                    fin = torch.isfinite(want)
                    if not torch.equal(torch.isfinite(got), fin):
                        raise AssertionError("P1 fma: finite patterns differ")
                    ulps = (bits(torch, got[fin]).long()
                            - bits(torch, want[fin]).long()).abs()
                    if ulps.numel() and int(ulps.max()) > 1:
                        raise AssertionError(f"P1 fma: {int(ulps.max())} ulps")
                elif not same_bits(torch, got, want):
                    raise AssertionError(f"P1 chain {chain}: differs from twin")
                err = max(err, finite_err(torch, got, want))
        x = inputs(mb.VPU_SHAPE)[0]
        plain = cuda_ms(torch, lambda: mb.vpu_peak_reference(
            x, mb.PEAK_CHAIN, fma), 2)
        out[name] = (err, plain)
    err = 0.0
    for x in inputs(mb.VPU_SHAPE):
        for chain in (mb.MIXED_CHAIN, 4):
            got = mb.vpu_mixed(x, chain)
            want = mb.vpu_mixed_reference(x, chain)
            if not same_bits(torch, got, want):
                raise AssertionError(f"P2 chain {chain}: differs from twin")
            err = max(err, finite_err(torch, got, want))
    x = inputs(mb.VPU_SHAPE)[0]
    out["vpu_mixed"] = (err, cuda_ms(torch, lambda: mb.vpu_mixed_reference(
        x, mb.MIXED_CHAIN), 2))
    for n_blocks, rows in mb.GRID_CASES:
        err = 0.0
        for x in inputs((n_blocks * rows, mb.GRID_COLS)):
            got = mb.grid_overhead(x, n_blocks)
            want = mb.grid_overhead_reference(x, n_blocks)
            if not same_bits(torch, got, want):
                raise AssertionError(f"P3 {n_blocks} blocks: differs")
            err = max(err, finite_err(torch, got, want))
        out[f"grid_overhead_b{rows}"] = (err, cuda_ms(
            torch, lambda: mb.grid_overhead_reference(x, n_blocks), 10),
            cuda_ms(torch, lambda: torch.mul(x, 2.0), 10))
    err = 0.0
    for x in inputs(mb.HBM_SHAPE):
        got = mb.hbm_stream(x)
        want = mb.hbm_stream_reference(x)
        if not same_bits(torch, got, want):
            raise AssertionError("P4: differs from its twin")
        err = max(err, finite_err(torch, got, want))
    out["hbm_stream"] = (err, cuda_ms(
        torch, lambda: mb.hbm_stream_reference(x), 10),
        cuda_ms(torch, lambda: torch.add(x, 1.0), 10))
    del x, got, want
    print("P1-P4 vs twins: P1 (both variants), P2, P3 (both block sizes) "
          "and P4 held at the tool's shapes (P1 fma within 1 ulp, the rest "
          "bit-equal, non-finite values included)", flush=True)
    return out


def vertex_grad(torch, tris, g_tri, n_verts):
    """(M, 3, 3) triangle-vertex gradient -> (N, 3) vertex gradient."""
    g = torch.zeros((n_verts, 3), dtype=torch.float64, device=g_tri.device)
    g.index_add_(0, tris.reshape(-1), g_tri.reshape(-1, 3).double())
    return g


def differentiable_half(torch, device, label, mesh, grid, counters):
    """The differentiable path through ``models.SDFGenerator`` on one mesh:
    target = forward of the 0.95-scaled vertices; counters set to 0, one
    ``train_step``, counters read. Then, on that step's ids and parity: R1
    against its twin (phi rtol 2e-6), R1b against its twin's autograd
    gradient (1e-4 of the largest vertex gradient), R1b run twice bit for
    bit, and a central finite difference of the float64-summed loss along
    u = g/|g| against <g, u> = |g|, ids frozen, away from the surface: rtol
    1e-3 through R1, 1e-4 in float64 through the twin (the full forward's
    is printed). Returns a dict of results and
    the step's tensors for the timings."""
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.ops import recompute as rc
    from sdfgenfast_tpu_torch.pipeline import _parity_device, make_level_set3

    t0 = time.perf_counter()
    model = SDFGenerator(mesh, grid, device=device)
    bin_s = time.perf_counter() - t0
    v0 = model.params
    with torch.no_grad():
        target = model.forward(v0 * 0.95)
    for fn in counters:
        fn.launches = 0
    new, loss = model.train_step(v0, target, lr=1e-2)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    loss = float(loss)
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError(f"{label}: loss {loss}")
    if not bool(torch.isfinite(new).all()) or torch.equal(new, v0):
        raise AssertionError(f"{label}: the step did not move the vertices")

    # the step's ids (the forward is deterministic), parity and gradient
    with torch.no_grad():
        _, tid = make_level_set3(mesh, grid, model.config, model.binned,
                                 device=device, return_tid=True)
    binned = model.binned
    parity = _parity_device(torch.from_numpy(
        binned.parity_packed if binned.parity_packed is not None
        else binned.parity_crossings).to(device), grid.shape[0])
    tris = torch.from_numpy(binned.tris.astype(np.int64)).to(device)
    origin = tuple(float(o) for o in np.asarray(grid.origin, np.float32))
    dx = float(np.float32(grid.dx))
    upper = float(np.float32(sum(grid.shape)) * np.float32(dx))
    tv = v0[tris].contiguous()
    n = tid.numel()

    phi = rc.recompute_forward(tv, tid, parity, origin, dx, upper)
    twin = rc.recompute_forward_reference(tv, tid, parity, origin, dx, upper)
    torch.cuda.synchronize()
    np.testing.assert_allclose(phi.cpu().numpy(), twin.cpu().numpy(),
                               rtol=2e-6, atol=0, err_msg=f"{label} R1")
    r1_err = abs_err(phi, twin)
    r1_bits = int((bits(torch, phi) != bits(torch, twin)).sum())
    gphi = ((2.0 / n) * (phi - target)).contiguous()
    g1 = rc.recompute_backward(tv, tid, parity, gphi, origin, dx, upper)
    g2 = rc.recompute_backward(tv, tid, parity, gphi, origin, dx, upper)
    gt = rc.recompute_backward_reference(tv, tid, parity, gphi, origin, dx,
                                         upper)
    torch.cuda.synchronize()
    if not torch.equal(bits(torch, g1), bits(torch, g2)):
        raise AssertionError(f"{label}: two R1b runs differ")
    if not bool(torch.isfinite(g1).all()):
        raise AssertionError(f"{label}: non-finite R1b gradient")
    gv, gvt = (vertex_grad(torch, tris, g, len(mesh.verts)) for g in (g1, gt))
    scale = float(gvt.abs().max())
    r1b_err = float((gv - gvt).abs().max())
    tri_rel = float((g1 - gt).abs().max()) / float(gt.abs().max())
    if not (scale > 0 and r1b_err <= 1e-4 * scale):
        raise AssertionError(f"{label} R1b: max err {r1b_err:.3e} vs "
                             f"1e-4 * {scale:.3e}")
    # which of the two float32 gradients the difference belongs to: both
    # against the twin's reverse mode taken in float64
    g64 = vertex_grad(torch, tris, rc.recompute_backward_reference(
        tv.double(), tid, parity, gphi, origin, dx, upper), len(mesh.verts))
    print(f"{label} R1 vs twin: {n} cells, max|err| {r1_err:.3e}, "
          f"{r1_bits} cells not bit-equal; R1b vs twin (autograd): vertex "
          f"gradient max|err| {r1b_err:.3e} = {r1b_err / scale:.2e} of "
          f"max|g| {scale:.3e} (triangle level {tri_rel:.2e}); against the "
          f"float64 reverse mode R1b {float((gv - g64).abs().max()) / scale:.2e}"
          f", twin {float((gvt - g64).abs().max()) / scale:.2e}; two R1b runs "
          f"bit-equal", flush=True)

    # The directional finite difference, with the ids frozen. phi = sign *
    # |d| has a kink at d = 0, where the float32 gradient is rounding noise
    # and a central difference reads ~0 (whole grid planes lie on box36's
    # faces), so the loss here counts the cells farther from the surface
    # than any vertex moves: |phi| > 2 * step, step = 0.01 dx.
    step = 0.01 * dx
    mask = (phi.abs() > 2 * step).to(torch.float32)
    v = v0.clone().requires_grad_()
    phi_v = rc.recompute_stage(v[tris], tid, parity, origin, dx)
    (g,) = torch.autograd.grad((mask * (phi_v - target) ** 2).mean(), v)
    gnorm = float(g.double().norm())
    if not (np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{label}: gradient norm {gnorm}")
    u = (g.double() / gnorm).float()
    eps = step / float(u.norm(dim=1).max())
    tgt64, mask64 = target.double(), mask.double()

    def loss64(phi_, m=mask64):
        return float((m * (phi_.double() - tgt64) ** 2).mean())

    with torch.no_grad():
        frozen = [loss64(rc.recompute_forward(
            (v0 + s * eps * u)[tris].contiguous(), tid, parity, origin, dx,
            upper)) for s in (1.0, -1.0)]
        # through the whole forward (ids recomputed, every cell counted):
        # reported, not held; the binned far field's ids may switch
        full = [loss64(model.forward(v0 + s * eps * u), 1.0)
                for s in (1.0, -1.0)]
        # the same function evaluated in float64 by the twin (positions
        # still rounded to float32 as the kernels take them): no rounding
        # noise, so a 100x shorter step keeps the kinks of the second
        # derivative (cells on region boundaries) out of the difference
        eps64 = eps / 100
        exact = [loss64(rc.recompute_forward_reference(
            (v0.double() + s * eps64 * u.double())[tris], tid, parity, origin,
            dx, upper)) for s in (1.0, -1.0)]
    (g_all,) = torch.autograd.grad(model.loss(v, target), v)
    fd = {"frozen": (frozen[0] - frozen[1]) / (2 * eps),
          "float64": (exact[0] - exact[1]) / (2 * eps64),
          "full": (full[0] - full[1]) / (2 * eps)}
    ref = {"frozen": gnorm, "float64": gnorm,
           "full": float((g_all.double() * u.double()).sum())}
    rel = {k: abs(fd[k] - ref[k]) / abs(ref[k]) for k in fd}
    print(f"{label} finite difference along g/|g| (step {eps:.2e}, cells "
          f"with |phi| > {2 * step:.2e}: {int(mask.sum())} of {n}): <g,u> "
          f"{gnorm:.6e}, ids frozen {fd['frozen']:.6e} (rel "
          f"{rel['frozen']:.2e}), in float64 through the twin "
          f"{fd['float64']:.6e} (rel {rel['float64']:.2e}); all cells through "
          f"the full forward {fd['full']:.6e} vs {ref['full']:.6e} (rel "
          f"{rel['full']:.2e})", flush=True)
    if not (rel["frozen"] < 1e-3 and rel["float64"] < 1e-4):
        raise AssertionError(f"{label}: finite difference off by {rel}")
    return dict(loss=loss, launches=launches, r1_err=r1_err,
                r1b_err=r1b_err, r1b_rel=r1b_err / scale, fd_rel=rel,
                bin_s=bin_s, model=model, v0=v0, target=target, tv=tv,
                tid=tid, parity=parity, gphi=gphi,
                args=(origin, dx, upper))


def time_differentiable(torch, r, card, label):
    """Forward and forward+backward of one step, each beside the same path
    with R1 / R1b swapped for their twins; R1 and R1b alone beside theirs."""
    from sdfgenfast_tpu_torch.ops import recompute as rc

    model, v0, target = r["model"], r["v0"], r["target"]
    tv, tid, parity, gphi = r["tv"], r["tid"], r["parity"], r["gphi"]
    origin, dx, upper = r["args"]

    def fwd():
        with torch.no_grad():
            model.forward(v0)

    def step():
        model.train_step(v0, target, lr=1e-2)

    kernels = (rc.recompute_forward, rc.recompute_backward)

    def as_twins():
        rc.recompute_forward = rc.recompute_forward_reference
        rc.recompute_backward = rc.recompute_backward_reference

    times = {}
    for key, fn in (("forward", fwd), ("step", step)):
        times[key] = cuda_ms(torch, fn, 5)
        as_twins()
        try:
            times[key + "_twin"] = cuda_ms(torch, fn, 2)
        finally:
            rc.recompute_forward, rc.recompute_backward = kernels
    times["r1"] = cuda_ms(torch, lambda: rc.recompute_forward(
        tv, tid, parity, origin, dx, upper), 10)
    times["r1_twin"] = cuda_ms(torch, lambda: rc.recompute_forward_reference(
        tv, tid, parity, origin, dx, upper), 2)
    times["r1b"] = cuda_ms(torch, lambda: rc.recompute_backward(
        tv, tid, parity, gphi, origin, dx, upper), 10)
    times["r1b_twin"] = cuda_ms(torch, lambda: rc.recompute_backward_reference(
        tv, tid, parity, gphi, origin, dx, upper), 2)
    print(f"[{card}] {label} differentiable step: forward {times['forward']:.3f}"
          f" ms (twin R1 {times['forward_twin']:.3f} ms), forward+backward "
          f"{times['step']:.3f} ms (twin R1/R1b {times['step_twin']:.3f} ms); "
          f"R1 {times['r1']:.3f} ms (twin {times['r1_twin']:.3f}), R1b "
          f"{times['r1b']:.3f} ms (twin {times['r1b_twin']:.3f})", flush=True)
    return times


def main():
    import torch

    from sdfgenfast_tpu_torch import (generate_from_file, generate_from_mesh,
                                      generate_sdf, generate_sdf_batch,
                                      load_mesh, require_cuda)
    from sdfgenfast_tpu_torch.grid import (sizing_mode2a_proportional,
                                           sizing_python_api)
    from sdfgenfast_tpu_torch.io import native
    from sdfgenfast_tpu_torch.kernels import build
    from sdfgenfast_tpu_torch.mesh import Mesh, box_mesh, torus_mesh
    from sdfgenfast_tpu_torch.ops import band_kernel, dense, recompute, vdt_kernel
    from sdfgenfast_tpu_torch.tools import micro_bench as mb
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, make_level_set3

    # -- 1. the card ---------------------------------------------------------
    require_cuda()
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    if not native.available():
        raise RuntimeError("native host library (csrc/) failed to build")
    print(f"built {os.path.relpath(lib_path, ROOT)} and csrc/libsdfgenio.so "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(lib_path + ".log") as fh:
        for line in fh:
            if "Compiling entry function" in line:
                name = re.search(r"function '(\S+)'", line)
                print("  ptxas:", kernel_name(name.group(1)) if name
                      else line.strip(), flush=True)
            elif "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    # -- 3. kernels vs twins at main-path shapes ---------------------------
    cases = {
        256: ("icosphere6.stl", "sphere6_stl_256_mode2a.sparse.npz",
              "far_sample_stride4", 4),
        512: ("icosphere6_origin.stl", "sphere6_stl_512_mode2a.sparse.npz",
              "far_sample_stride8", 8),
    }
    grids = {}
    for n, (mesh_name, *_rest) in cases.items():
        v, t, bounds = load_mesh(os.path.join(RESOURCES, mesh_name))
        # nx = n - 2 plus one cell of padding per side: the golden's grid
        grids[n] = (Mesh(v, t), sizing_python_api(
            np.asarray(bounds[0], np.float32),
            np.asarray(bounds[1], np.float32), nx=n - 2))
    box = box36(Mesh, box_mesh)
    box_grid = sizing_mode2a_proportional(*box.bounds(), 256, 1)
    torus = torus_mesh(32, 16)  # 1024 triangles: K1's streamed table
    torus_grid = sizing_python_api(*torus.bounds(), nx=254)
    if box_grid.shape != (256, 341, 425) or torus_grid.shape != (256, 256, 75):
        raise AssertionError(f"dense grids {box_grid.shape} {torus_grid.shape}")
    k1 = check_k1(torch, device, box, box_grid, torus, torus_grid)
    k2 = check_k2(torch, device, *grids[256])
    k3_err = check_k3(torch, device)
    k4_err, k4_ms, k4_plain = check_k4(torch, device, grids[256][1].shape)
    probe_err = check_probes(torch, device)

    # -- 4a. the binned path against the reference binary's goldens --------
    binned_counters = (band_kernel.band_coefs, band_kernel.band_rows,
                       vdt_kernel.round_phase, vdt_kernel.chamfer)
    launches = {fn.__name__: 0 for fn in binned_counters}
    results = {}
    for n, (mesh_name, golden, far_key, stride) in cases.items():
        path = os.path.join(RESOURCES, mesh_name)
        for fn in binned_counters:
            fn.launches = 0
        t0 = time.perf_counter()
        sdf, meta = generate_from_file(path, nx=n - 2, device=device)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        call = {fn.__name__: fn.launches for fn in binned_counters}
        far = check_golden(sdf, os.path.join(GOLDENS, golden), far_key,
                           stride, grids[n][1])
        results[n] = {"cold_s": cold, "far_err_dx": far, "path": path}
        print(f"main path {sdf.shape}: golden bars met (0 sign mismatches, "
              f"exact band, far field {far:.4f} dx < 0.2 dx), cold call "
              f"{cold:.3f} s, launches {call}", flush=True)
        # the pyramid (ops/vdt.py): the coarsest level's ladder (7 rounds
        # at 64^3, 8 at 128^3), 5 at the middle level, 7 at full resolution;
        # 2 chamfer passes
        rounds = {256: 19, 512: 20}[n]
        if call != {"band_coefs": 1, "band_rows": 1, "round_phase": rounds,
                    "chamfer": 2}:
            raise AssertionError(f"sphere82k {n}^3 launches {call}")
        for k, v in call.items():
            launches[k] += v
    print(f"binned-path launches: {launches}", flush=True)

    # -- 4b. the dense path: CLI goldens, box36, torus1024, a batch ----------
    cli_goldens()
    dense.dense_stream.launches = 0
    t0 = time.perf_counter()
    box_phi = generate_sdf(box.verts, box.tris, box_grid.origin, box_grid.dx,
                           *box_grid.shape, device=device)
    box_cold = time.perf_counter() - t0
    dense_launches = {"box36": dense.dense_stream.launches}
    dense.dense_stream.launches = 0
    torus_phi, torus_meta = generate_from_mesh(torus.verts, torus.tris,
                                               nx=254, device=device)
    dense_launches["torus1024"] = dense.dense_stream.launches
    launches["dense_stream"] = sum(dense_launches.values())
    print(f"dense-path launches: K1 {dense_launches}; box36 cold call "
          f"{box_cold:.3f} s", flush=True)
    if dense_launches != {"box36": 1, "torus1024": 1}:
        raise AssertionError("box36 and torus1024 take one K1 launch each")
    if torus_meta["dx"] != torus_grid.dx or torus_phi.shape != torus_grid.shape:
        raise AssertionError("generate_from_mesh sized the torus differently")
    check_dense_vs_binned(torch, device, "box36", box, box_grid, box_phi)
    check_dense_vs_binned(torch, device, "torus1024", torus, torus_grid,
                          torus_phi)

    sphere = grids[256][0]
    batch = [box, torus, sphere]
    lo = np.min([m.bounds()[0] for m in batch], axis=0)
    hi = np.max([m.bounds()[1] for m in batch], axis=0)
    bgrid = sizing_mode2a_proportional(lo, hi, 128, 1)
    counters = (band_kernel.band_coefs, band_kernel.band_rows,
                vdt_kernel.round_phase, vdt_kernel.chamfer, dense.dense_stream)
    for fn in counters:
        fn.launches = 0
    got = generate_sdf_batch([(m.verts, m.tris) for m in batch],
                             bgrid.origin, bgrid.dx, *bgrid.shape,
                             device=device)
    batch_launches = [fn.launches for fn in counters]
    for m, phi in zip(batch, got):
        want = generate_sdf(m.verts, m.tris, bgrid.origin, bgrid.dx,
                            *bgrid.shape, device=device)
        if not np.array_equal(phi.view(np.int32), want.view(np.int32)):
            raise AssertionError("generate_sdf_batch differs from single calls")
    print(f"generate_sdf_batch [box36, torus1024, sphere82k] at {bgrid.shape}:"
          f" equal to single calls; launches K2 coefficients/K2/K3/K4/K1 "
          f"{batch_launches}",
          flush=True)
    # -- 4c. the probe tool's entry point ------------------------------------
    probes = (mb.vpu_peak, mb.vpu_mixed, mb.grid_overhead, mb.hbm_stream)
    for fn in probes:
        fn.launches = 0
    probe_res = mb.run(device)
    probe_launches = {fn.__name__: fn.launches for fn in probes}
    print(f"probe tool launches: {probe_launches}", flush=True)
    sass = sass_text(lib_path)
    if sass is None:
        print("cuobjdump not found: SASS counts not taken", flush=True)
    else:
        for name, c in sorted(sass_counts(sass).items()):
            print(f"  SASS {name}: FFMA {c['FFMA']}, FMUL {c['FMUL']}, "
                  f"FADD {c['FADD']}", flush=True)
        for name, c in sorted(sass_inner_loops(sass).items()):
            print(f"  SASS {name} inner loop: " + (
                "none found" if c is None else
                f"{c[0]} instructions, {c[1]} FP32, {c[2]} LDS"), flush=True)

    # -- 4d. the differentiable path: SDFGenerator.train_step, both halves --
    diff_counters = (band_kernel.band_coefs, band_kernel.band_rows,
                     vdt_kernel.round_phase, vdt_kernel.chamfer,
                     dense.dense_stream,
                     recompute.recompute_forward, recompute.recompute_backward)
    diff = {
        "sphere82k": differentiable_half(torch, device, "sphere82k 256^3",
                                         *grids[256], diff_counters),
        "box36": differentiable_half(torch, device, "box36 256x341x425", box,
                                     box_grid, diff_counters),
    }
    for label, r in diff.items():
        print(f"differentiable {label}: loss {r['loss']:.6e}, launches "
              f"{r['launches']}, SDFGenerator binning {r['bin_s']:.3f} s",
              flush=True)
    need = {"sphere82k": ("band_coefs", "band_rows", "round_phase",
                          "chamfer", "recompute_forward",
                          "recompute_backward"),
            "box36": ("dense_stream", "recompute_forward",
                      "recompute_backward")}
    checks = list(launches.items()) + list(dense_launches.items()) + list(zip(
        ("batch K2 coefficients", "batch K2", "batch K3", "batch K4",
         "batch K1"), batch_launches)) + list(probe_launches.items()) + [
        (f"{label} {k}", diff[label]["launches"][k])
        for label, keys in need.items() for k in keys]
    for name, count in checks:
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    # -- 5. timings ---------------------------------------------------------
    diff_times = {label: time_differentiable(torch, r, card, label)
                  for label, r in diff.items()}
    # keep the numbers only: the breakdowns below read peak device memory
    diff = {label: {k: r[k] for k in ("launches", "r1_err", "r1b_err")}
            for label, r in diff.items()}
    torch.cuda.empty_cache()
    for n, r in results.items():
        walls = []
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            generate_from_file(r["path"], nx=n - 2, device=device)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"[{card}] generate_from_file sphere82k {n}^3: median "
              f"{statistics.median(walls) * 1e3:.1f} ms, min "
              f"{min(walls) * 1e3:.1f} ms over {WARM_CALLS} warm calls "
              f"(host binning + device + copy back)", flush=True)
        # where the time goes: host binning, device pipeline (uploads,
        # kernels and glue, synchronised), copy back
        mesh, grid = grids[n]
        stages = {"host bin_mesh": [], "device make_level_set3": [],
                  "copy to host": []}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            binned = bin_mesh(mesh, grid)
            t1 = time.perf_counter()
            phi = make_level_set3(mesh, grid, binned=binned, device=device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            phi.cpu().numpy()
            t3 = time.perf_counter()
            for key, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[key].append(v)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{card}] {n}^3 breakdown (median of {WARM_CALLS}): " + ", ".join(
            f"{k} {statistics.median(v) * 1e3:.1f} ms" for k, v in stages.items())
            + f"; peak device memory {peak:.2f} GiB", flush=True)
    walls = []
    for _ in range(WARM_CALLS):
        t0 = time.perf_counter()
        generate_sdf(box.verts, box.tris, box_grid.origin, box_grid.dx,
                     *box_grid.shape, device=device)
        walls.append(time.perf_counter() - t0)
    print(f"[{card}] generate_sdf box36 {box_grid.shape}: median "
          f"{statistics.median(walls) * 1e3:.1f} ms, min "
          f"{min(walls) * 1e3:.1f} ms over {WARM_CALLS} warm calls "
          f"(host parity + device + copy back)", flush=True)
    stages = {"host bin_mesh (parity)": [], "device make_level_set3": [],
              "copy to host": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARM_CALLS):
        t0 = time.perf_counter()
        binned = bin_mesh(box, box_grid)
        t1 = time.perf_counter()
        phi = make_level_set3(box, box_grid, binned=binned, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phi.cpu().numpy()
        t3 = time.perf_counter()
        for key, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(v)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] box36 {box_grid.shape} breakdown (median of "
          f"{WARM_CALLS}): " + ", ".join(
              f"{k} {statistics.median(v) * 1e3:.1f} ms"
              for k, v in stages.items())
          + f"; peak device memory {peak:.2f} GiB", flush=True)
    # K3 per stride at the two full-resolution sizes, and summed over one
    # sphere82k call
    torch.cuda.empty_cache()
    k3_times = {n: time_k3(torch, device, card, (n, n, n), plain=n == 256)
                for n in (256, 512)}
    torch.cuda.empty_cache()
    k3_call_ms, k3_call_launches, _ = k3_call_time(
        torch, device, card, results[256]["path"], 254)
    if k3_call_launches != 19:
        raise AssertionError(f"K3: {k3_call_launches} rounds in one call")
    k3_ms, k3_plain = k3_times[256][1], k3_times[256]["plain"]

    # the bounds at the shapes timed (see bound_ms)
    n_box, n_torus = int(np.prod(box_grid.shape)), int(np.prod(torus_grid.shape))
    n_256 = int(np.prod(grids[256][1].shape))
    m_sphere = len(grids[256][0].tris)
    bounds = {
        # K1 at the share of pairs its cull evaluated in this run
        "dense_stream": k1_bound(n_box, len(box.tris), k1["evaluated_share"]),
        "dense_stream_torus1024": k1_bound(n_torus, len(torus.tris),
                                           k1["torus_evaluated_share"]),
        "band_coefs": k2["bounds"]["coefs"],
        "band_rows": k2["bounds"]["walk"],
        "vdt_round": k3_bound(grids[256][1].shape),
        "chamfer": bound_ms(2 * n_256 * 26 * OPS_CHAMFER_OFFSET, 2 * 8 * n_256),
        "recompute_phi": bound_ms(OPS_R1_CELL * n_256,
                                  36 * m_sphere + 9 * n_256),
        "recompute_vjp": bound_ms(OPS_R1B_CELL * n_256,
                                  72 * m_sphere + 9 * n_256),
    }
    n_vpu, n_hbm = int(np.prod(mb.VPU_SHAPE)), int(np.prod(mb.HBM_SHAPE))
    bounds.update(
        vpu_peak=bound_ms(n_vpu * mb.PEAK_CHAIN * 4, 8 * n_vpu),
        vpu_peak_fma=bound_ms(n_vpu * mb.PEAK_CHAIN * 4, 8 * n_vpu),
        vpu_mixed=bound_ms(n_vpu * mb.MIXED_CHAIN * 7, 8 * n_vpu),
        hbm_stream=bound_ms(n_hbm, 8 * n_hbm))
    for blocks, rows in mb.GRID_CASES:
        n = blocks * rows * mb.GRID_COLS
        bounds[f"grid_overhead_b{rows}"] = bound_ms(n, 8 * n)
    print(f"[{card}] K3 summed over one sphere82k 256^3 call: "
          f"{k3_call_ms:.4f} ms (19 rounds), bound "
          f"{7 * k3_bound((256,) * 3)[0] + 5 * k3_bound((128,) * 3)[0] + 7 * k3_bound((64,) * 3)[0]:.4f} ms",
          flush=True)
    for label, cells, m, share, ms in (
            ("box36", n_box, len(box.tris), k1["evaluated_share"], k1["ms"]),
            ("torus1024", n_torus, len(torus.tris),
             k1["torus_evaluated_share"], k1["torus_ms"])):
        formula = k1_bound(cells, m, 1.0)[0]
        culled = k1_bound(cells, m, share)[0]
        print(f"[{card}] K1 {label} bound: {culled:.4f} ms with {share:.1%} "
              f"of pairs evaluated ({culled / ms:.1%} of it), {formula:.4f} "
              f"ms if every pair took the whole formula ({formula / ms:.1%})",
              flush=True)
    k2t = k2["times"]
    for name, key, shape, ms, plain in (
            ("K1 dense_stream (box36)", "dense_stream", box_grid.shape,
             k1["ms"], k1["plain"]),
            ("K1 dense_stream (torus1024)", "dense_stream_torus1024",
             torus_grid.shape, k1["torus_ms"], k1["torus_plain"]),
            ("K2 coefficient pass", "band_coefs", "81,920 triangles",
             k2t["coefs"], k2t["coefs_plain"]),
            ("K2 band_rows tile walk", "band_rows", "256^3", k2t["walk"],
             k2t["plain"]),
            ("K3 round (stride 1)", "vdt_round", "256^3", k3_ms, k3_plain),
            ("K4 chamfer (2 passes)", "chamfer", "256^3", k4_ms, k4_plain)):
        b, by = bounds[key]
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms, "
              f"plain torch {plain:.3f} ms, bound {b:.4f} ms ({by}), "
              f"{b / ms:.1%} of the bound", flush=True)
    k2_bound = bounds["band_coefs"][0] + bounds["band_rows"][0]
    print(f"[{card}] K2 launches alone at 256^3 (coefficient pass + tile "
          f"walk): {k2t['coefs'] + k2t['walk']:.4f} ms, bound "
          f"{k2_bound:.4f} ms, {k2_bound / (k2t['coefs'] + k2t['walk']):.1%} "
          f"of the bound; the five row fills apart {k2t['fills']:.4f} ms; "
          f"the whole band_rows call {k2t['whole']:.4f} ms; K1 box36 cull "
          f"evaluated {k1['evaluated_share']:.1%} of (warp, triangle) steps",
          flush=True)
    grid_res = {g["rows"]: g for g in probe_res["grid_overhead"]}
    probe_ms = {"vpu_peak": probe_res["vpu_peak"]["ms"],
                "vpu_peak_fma": probe_res["vpu_peak_fma"]["ms"],
                "vpu_mixed": probe_res["vpu_mixed"]["ms"],
                "grid_overhead_b128": grid_res[128]["ms"],
                "grid_overhead_b1024": grid_res[1024]["ms"],
                "hbm_stream": probe_res["hbm_stream"]["ms"]}
    for name, ms in probe_ms.items():
        lib = probe_err[name][2] if len(probe_err[name]) > 2 else None
        print(f"[{card}] probe {name}: kernel {ms:.3f} ms, plain torch "
              f"{probe_err[name][1]:.3f} ms"
              + (f", torch's own call {lib:.3f} ms" if lib else ""),
              flush=True)

    probe_rows = (("vpu_peak", "vpu_peak", 62), ("vpu_peak_fma", "vpu_peak", 62),
                  ("vpu_mixed", "vpu_mixed", 93),
                  ("grid_overhead_b128", "grid_overhead", 129),
                  ("grid_overhead_b1024", "grid_overhead", 129),
                  ("hbm_stream", "hbm_stream", 150))
    sphere = diff["sphere82k"]
    kernels = [
        # one kernel for both of the JAX package's dense kernels: a row for
        # each, at the mesh that takes it (box36: _sep_kernel, the torus at
        # the cap: _dense_kernel), with that call's launches
        {"name": "dense_stream", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/dense.cu",
         "replaces": "sdfgenfast_tpu/ops/dense.py:141",
         "launches": dense_launches["box36"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain"]},
        {"name": "dense_stream_torus1024", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/dense.cu",
         "replaces": "sdfgenfast_tpu/ops/dense.py:254",
         "launches": dense_launches["torus1024"],
         "max_abs_err": k1["torus_err"], "ms": k1["torus_ms"],
         "plain_ms": k1["torus_plain"]},
        # K2's two launches: the coefficients the Pallas body builds per
        # candidate (band_pallas.py:76), then the walk
        {"name": "band_coefs", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/band_rows.cu",
         "replaces": "sdfgenfast_tpu/ops/band_pallas.py:76",
         "launches": launches["band_coefs"], "max_abs_err": k2["err"],
         "ms": k2t["coefs"], "plain_ms": k2t["coefs_plain"]},
        {"name": "band_rows", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/band_rows.cu",
         "replaces": "sdfgenfast_tpu/ops/band_pallas.py:76",
         "launches": launches["band_rows"], "max_abs_err": k2["err"],
         "ms": k2t["walk"], "plain_ms": k2t["plain"]},
        {"name": "vdt_round", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/vdt_round.cu",
         "replaces": "sdfgenfast_tpu/ops/vdt_pallas.py:75",
         "launches": launches["round_phase"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain},
        {"name": "chamfer", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/chamfer.cu",
         "replaces": "sdfgenfast_tpu/ops/vdt_pallas.py:272",
         "launches": launches["chamfer"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain},
    ] + [
        {"name": name, "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/probes.cu",
         "replaces": f"tools/micro_bench.py:{line}",
         "launches": probe_launches[wrapper],
         "max_abs_err": probe_err[name][0], "ms": probe_ms[name],
         "plain_ms": probe_err[name][1],
         "library_ms": (probe_err[name][2] if len(probe_err[name]) > 2
                        else None)}
        for name, wrapper, line in probe_rows
    ] + [
        # no Pallas counterpart: the JAX package differentiates jnp code
        {"name": "recompute_phi", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": sphere["launches"]["recompute_forward"],
         "max_abs_err": sphere["r1_err"],
         "ms": diff_times["sphere82k"]["r1"],
         "plain_ms": diff_times["sphere82k"]["r1_twin"]},
        {"name": "recompute_vjp", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": sphere["launches"]["recompute_backward"],
         "max_abs_err": sphere["r1b_err"],
         "ms": diff_times["sphere82k"]["r1b"],
         "plain_ms": diff_times["sphere82k"]["r1b_twin"]},
    ]
    for row in kernels:
        row["bound_ms"], row["bound_by"] = bounds[row["name"]]
        row.setdefault("library_ms", None)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
