#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sdfgenfast_tpu_torch``) on one GPU.

Run from anywhere with ``python3 chip_smoke.py`` on a machine with an NVIDIA
Hopper card, nvcc and a C++ compiler. Phases (each raises on failure):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (nvcc, one process per source) and the native
     host library (make);
  3. each kernel against its plain-torch twin on the card, at the shapes the
     main path gives it (K1 the dense kernel, with the share of pairs its
     cull evaluates; K1's table, byte-equal to the torch-op table on box36,
     icosphere(2) at 1000 with a zero-area triangle and torus1024, K1 on
     both tables byte-equal, and a box36 ``train_step``'s losses and
     vertices byte-equal on both, each table timed; K2 band rows and their coefficient pass, on the main
     path's CSR and on hand-made segments; K3 jump-flood round; K4 chamfer
     bit for bit at 1, 2, 3 and 5 passes on the main path's own
     pre-chamfer field, random and ragged fields and thin grids; R1 bit
     for bit in each of its forms on torus1024, a ragged grid with holes
     and degenerate triangles; R1b on both sides of its M = 1024 dispatch,
     the probes P1-P4, P3 and P4 also off the tool's shapes (one block,
     odd and unaligned tiles, ragged arrays, n = 0); R1/R1b on the step's
     own fields in phase 4d);
  4. the main path, both halves. Binned: ``generate_from_file`` on the
     81,920-triangle sphere at 256^3 and 512^3, held against the reference
     binary's sparse goldens (bars of tests/test_parity_golden.py). Dense:
     the CLI (``python -m sdfgenfast_tpu_torch.cli``) on the three box
     goldens, box36 at 256 x 341 x 425 and a 1024-triangle torus at
     256 x 256 x 75 (K1 at the dense cap) held against the binned path, and
     a small ``generate_sdf_batch``. The probe tool
     (``tools.micro_bench.run``: its launch counts, one CTA per TPU grid
     step in P3, the SASS instruction counts of its loops and the bulk
     copies, barriers and fences of P3 and P4, and K1's and K2's inner
     loops). The differentiable path: one
     ``models.SDFGenerator.train_step`` on sphere82k at 256^3 (binned) and
     box36 (dense, K1), R1/R1b against their twins and a finite difference
     of the loss. Each path's launch counters are set to 0 just before it
     and must have moved just after;
  5. wall time per call (median and min of warm calls, host work and the
     copy back included), each kernel's time next to its twin's (K4 and
     R1 queued behind a spin, min and median of three repeats:
     ``k4_r1_times``, which also times another checkout's package; P3 and
     P4 the same way beside torch's own x * 2 and x + 1, and one call at a
     time as the tool timed them before: ``probe_times``, which does too),
     and the differentiable step's forward and forward+backward next to the
     same step with R1/R1b swapped for their twins. Every kernel's time must
     be at least its bound;
  6. the non-default far fields and schedules, after the main path's
     timings: ``far_field="propagate"`` and ``"eikonal"``, the capped
     (``vdt_max_hop=8``) and flat (``vdt_extra_rounds=2``) ladders and
     4 x 4 x 16 band tiles through ``generate_from_file(far_field=,
     config=)`` on the sphere at 256^3 (the flat ladder with 4 rounds also
     at 512^3) against the goldens, each route's K2/K3/K4/R1 launches
     counted from 0 and checked exactly; every route on icosphere(4) at
     64^3 on the card and on the CPU twins; one ``train_step`` in propagate
     and in eikonal mode (R1/R1b, the gradient against the twins'); each
     route's wall per call split into host, device and copy back, the
     stream time of its torch modules and K3 summed over a call; every
     route, the default included, bit-equal card against CPU at 64^3;
  7. the device sign (``sign_mode="device"``, ``ops/sign.parity_field``),
     after every timing above: box36 at its main-path grid (dense),
     sphere82k at 256^3 and 512^3 (binned) and eikonal at 256^3 through
     the entry points, the device parity bit-equal to the host parity on
     every cell, the SDF bit-equal to host mode's with the same launches,
     the goldens' bars (and the box CLI golden in device mode); one
     ``train_step`` in each sign mode on box36 and sphere82k 256^3; the
     device parity's time beside the host parity's, each mode's wall split,
     the parity's peak memory;
  8. the sharded path (``parallel/sharded.py``) on ``["cuda:0"] * 4``, one
     card running the four shards one after another: K2 with coordinate
     ids, K3 at shard offsets (negative included), R1 and R1b at block
     offsets against their twins; sphere82k at 256^3 on (2, 2) and (1, 4)
     meshes and at 512^3 (against its golden), the capped ladder, the
     device sign and box36 on a 256^3 grid (dense shards), each bit-equal
     to its single-device run (phi and ids) with four times the launches
     the schedule gives a shard; ``SDFGenerator(device_mesh=...)`` on
     sphere82k and box36 (loss bit-equal, gradient within 1e-4, two runs
     bit-equal); the sharded walls beside the single-device ones, the halo
     exchange's device time and peak memory;
  9. the sharded sweep modes and the multi-process path: (a)
     ``far_field="eikonal"`` and ``"propagate"`` through ``sharded_sdf`` on
     sphere82k at 256^3 on (2, 2) x cuda:0, phi and ids bit-equal to the
     single-device run with the same pass count, R1 once a shard and
     K1-K4 never; on icosphere(4) at 64^3 on (1, 4), the card bit-equal to
     the CPU twins; a sharded train_step in each mode (gradient within
     1e-4); (b) two processes of this script (``--multihost-worker``)
     joined by gloo, two shards each of a (2, 2) mesh on cuda:0: phase 8's
     cases, eikonal and a ``generate_sdf_batch`` of two meshes through
     ``parallel.multihost``, each process's grid bit-equal to the
     single-process run, its launches twice a shard's schedule, 512^3
     against its golden; the multi-process walls beside the single-process
     sharded ones, the exchange's wall and each process's peak memory. A
     worker that fails or passes its deadline fails the smoke;
 10. the transfers (``upload.py``), after every timing above: the blob
     upload bit-equal to the per-array ``.to`` upload on box36 and
     sphere82k at 256^3 in both sign modes (the staging pinned, every view
     inside the one allocation); ``to_host``, ``to_host_async`` and every
     entry point (``generate_sdf``, ``generate_from_file``, the CLI in a
     fresh process, ``generate_sdf_batch`` of four meshes at 256^3, the
     one-process sharded batch) bit-equal to ``.cpu().numpy()``; the race
     check (the source overwritten, released and its memory reused while
     its copy is in flight); then new route beside old: the copy back
     split into the link and the host write (and a fresh pinned result),
     the upload, the walls of box36 and sphere82k at 256^3 and 512^3, the
     ``train_step`` with the cached blob and re-uploading, the batch of four
     against four single calls, the pinned memory held, a fresh process's
     import and CLI walls. ``transfer_walls`` times the entry points of
     another checkout's package with the same inputs;
 11. the flagship torus and the port's tools, after every phase above:
     (a) torus100k (``torus_mesh()``, 100,352 triangles) through
     ``generate_sdf`` on bench.py's grids at 256 x 256 x 75 and 512 x 512 x
     148, its launches exact (K1 0, K2 1 + 1, K3 the pyramid's schedule, K4
     1), held to the analytic torus (``testing.torus_bars``: 0 sign
     mismatches off the tessellation's gap, the exact band within the gap,
     never below the exact distance, within 0.2 dx above it); (b) box36
     at the box64 and box128 grids (dense) against the binned path; (c)
     ``tools.bench`` through its command line on all seven configurations
     (its JSON line), ``tools.profile_stages`` on box36 and sphere82k at
     256 and torus100k at 256 and 512, each run's stage launches summing to
     its call's, K3's the pyramid's schedule; (d) ``tools.batch_bench``
     with 4 meshes, the batch bit-equal to the meshes one at a time; (e)
     K2, K3 and K4 on the torus's own inputs at both grids against their
     twins, timed beside their bounds (from the torus's CSR), as
     kernel-table rows;
 12. the last of the JAX package's tools, after every phase above: (a)
     ``tools.stress_256`` through its command line (a fresh process): 10
     iterations of sphere82k at 256^3, each bit-identical to the first,
     the caching allocator's reserved and allocated bytes and the pinned
     memory flat from the second iteration; (b) ``tools.kernel_bench`` on
     the 12-triangle box at 64, 128 and 256, the queued outputs bit-equal
     to ``pipeline.dense_sign_core``, each stage on the host clock, CUDA
     events and queued behind a spin; (c) ``tools.scaling_bench`` at 128^3
     on 1, 2 and 4 shards of this card, each bit-equal to one shard and to
     the single-device call.

``python3 chip_smoke.py --four-cards`` (not run by default; four visible
GPUs) runs phases 1-2, then phase 9b's cases on ``["cuda:0", ...,
"cuda:3"]`` in one process and in four NCCL processes (one card each),
each bit-equal to the one-card run on ``["cuda:0"] * 4``; then
``tools.scaling_bench`` at 128^3 and 512^3 on 1, 2 and 4 shards of cuda:0
and on 1, 2 and 4 distinct cards, every count bit-equal to one card, and a
profile of one sharded call at 512^3 on four cards and on four shards of
cuda:0 (each card's busy share, the host's largest self times).

Prints one JSON line of per-kernel results, then the card line, then, as the
last line, ``{"ok": true, "device": {...}}``. Exits non-zero on any failure.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import dataclasses
import hashlib
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


def digest(x):
    """The SHA-256 of a grid's bytes (a tensor or an array): two runs
    compared without moving the grids between processes."""
    a = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


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


# Peak rates of one H100 SXM at the 700 W limit, for the bounds. FP32: the
# card issues at most 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 FP32
# instructions a second outside the tensor cores. The data sheet's 67
# TFLOP/s is that rate with an FMA counted as two operations; every port
# kernel is built --fmad=false, so each multiply and each add is its own
# instruction, and an operation below costs one. Bytes: HBM3 at 3.35 TB/s
# (data sheet).
PEAK_FP32_ISSUE = 33.5e12
PEAK_BYTES = 3.35e12
# FP32 operations (instructions) per unit of work, by count of each
# kernel's formula: a (cell, triangle) pair of the separable dense distance,
# a (cell, candidate) pair of the band kernel's walk and a (row of 8 cells,
# candidate) pair of its row halves, a triangle of its coefficient pass
# (band_coefs_kernel's sums, products, clamps, four divisions and the
# normal's square root and division), a donor of a jump-flood round (3
# subtractions, 3 products, 2 sums, 1 compare), an offset of a chamfer
# pass (1 add, 1 min), a triangle of R1's table and a cell of R1 and of
# R1b.
OPS_DENSE_PAIR = 45
# the dense pair's plane test alone, for a pair the cull skips: h = (cx*x +
# (cy*y + c0)) + cz*z, h*h and the compare with the cell's best
OPS_DENSE_PLANE = 8
# band_rows_kernel's walk (csrc/band_rows.cu), per (cell, candidate): the
# plane distance h (2), the two barycentric weights (4), the inside test (1
# subtraction, 3 compares), the z offsets to b and c (2), three edges of 13
# each (ez*z and the saturated add, p - x2 - s*w in 6, its square in 5), the
# cell's d2 (h*h or two minimums: 3, the choice between them made by
# predicating each side on the inside test, no select) and the compare and
# select against the best (2): 56. Per (row, candidate), shared by the
# row's 8 cells: row_halves' six affine row forms (24), the degenerate
# compare and select (2) and the x, y offsets (4): 30. So 8 x 56 + 30 =
# 478 per candidate and row; the walk's SASS inner loop, which the smoke
# prints beside it, holds 477 FP32 instructions (FMUL 212, FADD 184,
# FADD.SAT 24, FSETP 33, FMNMX 16, FSEL 8): one cell's select against the
# best issues as a predicated MOV.
OPS_BAND_PAIR = 56
OPS_BAND_ROW = 30
OPS_BAND_COEF = 151
# K1's table (sep_table_kernel), a triangle: the corners less the origin
# (9), each edge's w, |w|^2, clamp, 1/x, w/|w|^2 and e0 (3 x 19), x13 and
# x23 (6), m13, m23 and d (15), invdet (5), g23 and g31 (24), the cross
# product (9), its square, clamp and sqrt (7), the normal (3), h0, g23c and
# g31c (15), the degenerate compare (1). Bytes: 12 of indices and 36 of
# corners read, 160 written.
OPS_SEP_TABLE = 151
BYTES_SEP_TABLE = 208
OPS_VDT_DONOR = 9
OPS_CHAMFER_OFFSET = 2
# R1's table (recompute_terms_kernel): x13 and x23 (6), m13, m23 and d
# (15), invdet (5), each edge's dv and max(|dv|^2, 1e-30) (3 x 9).
OPS_R1_TERMS = 53
# R1: the operations each path of a cell needs, the triangle terms from the
# table. Every cell with a triangle: its position (6), the plane weights
# and inside test (26), sqrt(max(d2, 1e-30)) and the parity's sign (3). A
# plane-case cell adds p - projection and its d2 (23); an outside cell the
# case's two compares, its two segment distances (2 x 29, one division
# each) and their minimum (61). A plane-case cell is 58, an outside cell
# 96; the bound counts this run's cells on each path (r1b_paths without a
# gradient). Bytes set R1's bound on every mesh timed.
OPS_R1_CELL = 35
OPS_R1_PLANE = 23
OPS_R1_EDGES = 61
# R1b: the operations the function needs on each path of a cell, each
# value taken once (cell_vjp computes more: all three segment distances, and
# plane_vjp / seg_vjp compute their forward values again). Every cell with a
# gradient: its position (6), triangle_case's weights and inside test (52),
# the parity's sign, sqrt(max(d2, 1e-30)) and the gradient of d2 (7). A
# plane-case cell adds p - projection and its d2 (23) and plane_vjp's
# reverse steps (136); an outside cell the case's two compares, its two
# candidate segment distances (2 x 38) and the minimum with its backward
# (5), and for each segment it differentiates (one, two at a tie) seg_vjp's
# reverse steps (68). A plane-case cell is 224, a one-edge cell 216; the
# bound counts this run's cells on each path (r1b_paths).
OPS_R1B_CELL = 65
OPS_R1B_PLANE = 159
OPS_R1B_EDGES = 83
OPS_R1B_SEG = 68


def bound_ms(ops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take for
    `ops` FP32 operations (one instruction each) and `nbytes` of
    device-memory traffic."""
    t_ops = ops / PEAK_FP32_ISSUE * 1e3
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
    """K2 vs its twin: the coefficient pass bit-equal to ``_band_coefs``;
    the rows on the main path's CSR bit-equal to the twin's, on hand-made
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
    live = dev(active).long()
    err, mism = k2_compare("K2", got, want, live)
    # on the main path's CSR every word equals the twin's: each operation
    # rounds once on both sides (the normal's 1/sqrt included)
    rows_bits = sum(int((bits(torch, x[live]) != bits(torch, y[live])).sum())
                    for x, y in zip(got, want))
    print(f"K2 band_rows vs twin: A={len(active)} active tiles, "
          f"P={len(csr['pair'])}, tid mismatches {mism}, max|err| "
          f"{err:.3e}, {rows_bits} row words not bit-equal; coefficient "
          f"table max|err| {coef_err:.3e} ({coef_bits} of {coef.numel()} "
          f"words not bit-equal)", flush=True)
    if rows_bits or coef_bits:
        raise AssertionError(f"K2 vs twin on the main path: {rows_bits} row "
                             f"and {coef_bits} coefficient words differ")

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
            rows, coef, pair, ids, off, cnt, dx, binned.tiles_dim, ids,
            binned.tiles_dim, grid.shape), 20),
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
        "walk": bound_ms(real * (512 * OPS_BAND_PAIR + 64 * OPS_BAND_ROW),
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


def time_k3(torch, device, card, shape, plain=False, strides=K3_STRIDES):
    """K3's time per stride on a seeded state of `shape`, beside its bound.
    Returns {stride: ms} (and, when `plain`, the twin's stride-1 time and
    "err", the stride-1 round's largest error against the twin, which must
    be bit-equal)."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    dx = float(np.float32(0.02))
    st = seeded_state(torch, shape, dx, 1, device,
                      n_seed=int(np.prod(shape)) // 40)
    bound, by = k3_bound(shape)
    times = {}
    for stride in strides:
        times[stride] = queued_ms(
            torch, lambda: vdt_kernel.round_phase(st, dx, (stride,), 1), 10)
        print(f"[{card}] K3 round {shape} stride {stride}: "
              f"{times[stride]:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / times[stride]:.1%} of the bound", flush=True)
    if plain:
        times["plain"] = cuda_ms(torch, lambda: vdt_kernel.round_phase_reference(
            st, dx, (1,), 1), 3)
        got = vdt_kernel.round_phase(st, dx, (1,), 1)
        want = vdt_kernel.round_phase_reference(st, dx, (1,), 1)
        if not torch.equal(bits(torch, got), bits(torch, want)):
            raise AssertionError(f"K3 {shape} stride 1 differs from its twin")
        times["err"] = abs_err(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]])
    return times


def k3_call_time(torch, device, card, mesh_path, nx, config=None,
                 label="one call"):
    """The summed K3 device time of one generate_from_file call (with
    `config`, the pipeline's knobs): :func:`k3_replay_time` of that call.
    Returns (ms, launches, per-level list)."""
    from sdfgenfast_tpu_torch import generate_from_file

    return k3_replay_time(torch, card, lambda: generate_from_file(
        mesh_path, nx=nx, device=device, config=config,
        far_field=config.far_field if config else "exact"), label)


def k3_replay_time(torch, card, run, label):
    """The summed K3 device time of one call of `run`: every phase the far
    field runs is recorded, then each of its rounds is replayed alone on
    the round's own input and timed (queued_ms). Returns (ms, launches,
    per-level list of (level shape, strides, ms per round))."""
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
        run()
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
    if len(levels) > 3:  # a ladder: one phase a round
        print(f"[{card}] K3 in {label}: strides "
              f"{tuple(st for _, strides, _ in levels for st in strides)}, "
              + ", ".join(f"{t:.4f}" for _, _, ms in levels for t in ms)
              + " ms", flush=True)
    else:
        for shape, strides, ms in levels:
            print(f"[{card}] K3 in {label}, level {shape}: strides "
                  f"{strides}, " + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms (sum {sum(ms):.4f})", flush=True)
    print(f"[{card}] K3 summed over {label} ({launches} launches): "
          f"{total:.4f} ms", flush=True)
    return total, launches, levels


def main_path_chamfer_input(torch, device, mesh_path, nx):
    """The field and dx that the main path (``generate_from_file`` on
    `mesh_path` at `nx`) hands to ``vdt_kernel.chamfer``
    (pipeline.exact_core): :func:`chamfer_input` of that call."""
    from sdfgenfast_tpu_torch import generate_from_file

    return chamfer_input(lambda: generate_from_file(mesh_path, nx=nx,
                                                    device=device))


def chamfer_input(run):
    """The field and dx that one call of `run` hands to
    ``vdt_kernel.chamfer``, taken by wrapping the wrapper for the call."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    chamfer, seen = vdt_kernel.chamfer, []

    def capture(phi, dx, passes=2):
        seen.append((phi.clone(), dx))
        return chamfer(phi, dx, passes)

    # the wrapper counts its launches on the module's `chamfer`, here this
    capture.launches = 0
    vdt_kernel.chamfer = capture
    try:
        run()
    finally:
        vdt_kernel.chamfer = chamfer
    if len(seen) != 1:
        raise AssertionError(f"the main path called chamfer {len(seen)} times")
    return seen[0]


# K4 cases beside the main path's field: grids one cell thin with a
# negative dx, where a path through a cell outside the grid would be
# shorter than any path inside it (tests/test_torch_chamfer_tiles.py), so
# that a kernel keeping a relaxed value there instead of 3e38 would differ
K4_THIN = (((12, 1, 70), 2), ((9, 33, 1), 3), ((1, 40, 66), 2),
           ((5, 1, 1), 4))


def check_k4(torch, device, mesh_path):
    """K4 vs its twin, bit for bit, at passes 1, 2, 3 and 5: the main
    path's own pre-chamfer field at sphere82k 256^3, random fields at 128^3
    and 256^3 and at the ragged shapes (48, 41, 75), (130, 5, 66) and (17,
    40, 31), and the thin grids of K4_THIN with a negative dx. One launch
    per call for passes <= 4 (two at 5); the input is left as it was.
    Returns (max_abs_err, plain_ms): the twin's time on the main path's
    field."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    field, dx_main = main_path_chamfer_input(torch, device, mesh_path, 254)
    rng = np.random.default_rng(1)
    dx = float(np.float32(0.02))
    cases = [("sphere82k 256^3 main-path field", field, dx_main)] + [
        (f"random {shape}", torch.from_numpy(np.abs(rng.normal(
            size=shape)).astype(np.float32)).to(device), dx)
        for shape in ((128, 128, 128), (256, 256, 256), (48, 41, 75),
                      (130, 5, 66), (17, 40, 31))]
    err = 0.0
    for label, phi, d in cases:
        before = phi.clone()
        for passes in (1, 2, 3, 5):
            vdt_kernel.chamfer.launches = 0
            got = vdt_kernel.chamfer(phi, d, passes)
            launched = vdt_kernel.chamfer.launches
            want = vdt_kernel.chamfer_reference(phi, d, passes)
            if not torch.equal(bits(torch, got), bits(torch, want)):
                raise AssertionError(f"K4 {label}, {passes} passes: differs "
                                     f"from its twin")
            if launched != (1 if passes <= 4 else 2):
                raise AssertionError(f"K4 {passes} passes: {launched} "
                                     f"launches")
            err = max(err, abs_err(got, want))
        if not torch.equal(bits(torch, phi), bits(torch, before)):
            raise AssertionError(f"K4 {label}: the input was written")
    for shape, passes in K4_THIN:
        phi = torch.from_numpy(np.abs(rng.normal(size=shape)).astype(
            np.float32)).to(device)
        got = vdt_kernel.chamfer(phi, -0.5, passes)
        want = vdt_kernel.chamfer_reference(phi, -0.5, passes)
        if not torch.equal(bits(torch, got), bits(torch, want)):
            raise AssertionError(f"K4 thin {shape}, dx -0.5: differs from "
                                 f"its twin")
    print(f"K4 chamfer vs twin: bit-equal at passes 1, 2, 3, 5 on "
          f"{[c[0] for c in cases]} (one launch a call up to 4 passes, two "
          f"at 5, the input untouched), and on the thin grids {K4_THIN} "
          f"with dx -0.5", flush=True)
    plain = cuda_ms(torch, lambda: vdt_kernel.chamfer_reference(
        field, dx_main, 2), 3)
    return err, plain


def check_r1_cases(torch, device, box, torus, torus_grid):
    """R1's table (recompute_terms) bit-equal to its twin, and R1 in every
    form that the triangle count allows (R1_FORMS; the shared table up to
    R1_SHARED_CAP), four cells and one cell a thread
    (R1_CELLS_PER_THREAD), bit-equal to its twin: torus1024 on its
    256-class grid, box36 on a ragged grid with tid = -1 holes
    (r1b_inputs) passed as views that start off the 16-byte (ids) and
    4-byte (parity) alignment the kernel loads need, and degenerate
    triangles (a point, a segment, collinear vertices) beside the unit
    right triangle, whose weights are exact at a grid of 1/16 (w = 0
    boundaries), on a grid whose cell count is not a multiple of 4.
    Returns the table's largest difference from its twin (0)."""
    from sdfgenfast_tpu_torch.ops import recompute as rc

    rng = np.random.default_rng(9)
    cases = []
    for label, mesh, origin, dx, shape, holes in (
            ("torus1024", torus, torus_grid.origin, torus_grid.dx,
             torus_grid.shape, False),
            ("box36 ragged, holes, unaligned views", box,
             (-2.6, -3.1, -3.55), 0.09, (62, 73, 91), True)):
        tv, tid, parity, _, origin, dx, upper = r1b_inputs(
            torch, device, mesh, origin, dx, shape, rng, holes)
        if holes:
            tid, parity = tid[1:], parity[1:]
            if tid.data_ptr() % 16 == 0 or parity.data_ptr() % 4 == 0:
                raise AssertionError("the views are aligned")
        cases.append((label, tv, tid, parity, origin, dx, upper))
    special = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                        [[0.5, 0.25, 0.5]] * 3,
                        [[0, 0, 0.25], [0, 0, 0.25], [1, 0.5, 0.25]],
                        [[-0.5, 0, 0], [0, 0.5, 0], [0.5, 1.0, 0]]],
                       np.float32)
    tris = np.concatenate([special, (rng.normal(size=(60, 3, 3)) * 0.7)
                           .astype(np.float32)])
    shape = (37, 29, 43)
    n = int(np.prod(shape))
    tid = np.where(rng.random(n) < 0.5, rng.integers(0, 4, n),
                   rng.integers(0, len(tris), n)).astype(np.int32)
    tid[rng.random(n) < 0.05] = -1
    cases.append(("degenerate triangles", torch.from_numpy(tris).to(device),
                  torch.from_numpy(tid.reshape(shape)).to(device),
                  torch.from_numpy(rng.random(shape) < 0.5).to(device),
                  (-1.0, -1.0, -1.0), 0.0625,
                  float(np.float32(sum(shape)) * np.float32(0.0625))))
    terms_err = 0.0
    for label, tv, tid, parity, origin, dx, upper in cases:
        table = rc.recompute_terms(tv)
        table_want = rc.recompute_terms_reference(tv)
        if not torch.equal(bits(torch, table), bits(torch, table_want)):
            raise AssertionError(f"R1 table {label}: differs from the twin")
        terms_err = max(terms_err, abs_err(table, table_want))
        want = rc.recompute_forward_reference(tv, tid, parity, origin, dx,
                                              upper)
        m = tv.shape[0]
        forms = [f for f in rc.R1_FORMS
                 if f != "shared" or m <= rc.R1_SHARED_CAP]
        for form in forms:
            for vec in rc.R1_CELLS_PER_THREAD:
                got = rc.r1_launch(tv, tid, parity, origin, dx, upper, form,
                                   vec)
                if not torch.equal(bits(torch, got), bits(torch, want)):
                    bad = int((bits(torch, got) != bits(torch, want)).sum())
                    raise AssertionError(f"R1 {label} ({form}, {vec} cells a "
                                         f"thread): {bad} cells differ from "
                                         f"the twin")
        print(f"R1 {label} (M={m}, {tuple(tid.shape)}): table and phi "
              f"bit-equal to the twins in the forms {forms}, 1 and 4 cells a "
              f"thread", flush=True)
    return terms_err


def r1_step_inputs(torch, device, mesh, grid):
    """R1's arguments in a step on `mesh` at `grid`: the pipeline's ids
    (``make_level_set3(return_tid=True)``), the parity and the triangles'
    vertices, as ``make_level_set3(verts=...)`` passes them."""
    from sdfgenfast_tpu_torch.ops.sign_kernel import parity_sign
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, make_level_set3

    binned = bin_mesh(mesh, grid)
    with torch.no_grad():
        _, tid = make_level_set3(mesh, grid, binned=binned, device=device,
                                 return_tid=True)
    parity = parity_sign(torch.from_numpy(
        binned.parity_packed if binned.parity_packed is not None
        else binned.parity_crossings).to(device), grid.shape[0])
    tv = torch.from_numpy(mesh.verts[binned.tris.astype(np.int64)].astype(
        np.float32)).to(device)
    origin = tuple(float(o) for o in np.asarray(grid.origin, np.float32))
    dx = float(np.float32(grid.dx))
    upper = float(np.float32(sum(grid.shape)) * np.float32(dx))
    return tv, tid, parity, origin, dx, upper


def repeats_ms(torch, fn, reps=10, repeats=3):
    """(min, median) over `repeats` runs of queued_ms(fn, reps)."""
    ts = [queued_ms(torch, fn, reps) for _ in range(repeats)]
    return min(ts), statistics.median(ts)


def r1_tori():
    """(label, mesh, grid) of tori from 64 to 384 triangles (the shared
    table's capacity), torus_mesh(nu, nv) with 2 nu nv triangles, at their
    256-class grid (sizing_python_api, nx = 254): R1's form by M."""
    from sdfgenfast_tpu_torch.grid import sizing_python_api
    from sdfgenfast_tpu_torch.mesh import torus_mesh

    return [(f"torus{2 * nu * nv}", m, sizing_python_api(*m.bounds(), nx=254))
            for nu, nv in ((8, 4), (8, 8), (12, 8), (16, 8), (20, 8), (24, 8))
            for m in (torus_mesh(nu, nv),)]


def k4_r1_times(reps=10, repeats=3):
    """K4 (2 passes) on the main path's pre-chamfer field at sphere82k
    256^3, and R1 on the step's own inputs (r1_step_inputs) at sphere82k
    256^3, box36 256 x 341 x 425, the tori of r1_tori and torus1024 (256 x
    256 x 75 and the like): each timed by repeats_ms (queued behind the
    spin, `reps` calls, `repeats` times), R1 also in each of its forms (the
    shared table up to its capacity) and cells a thread where the package
    has them, and each launch of an R1 call alone (launch_device_ms). Uses
    only
    entry points that older versions of the package have too, so it times
    whichever package is first on the path; from another checkout's root:
    ``python3 -c "import runpy; runpy.run_path('<this file>')
    ['k4_r1_times']()"``. Prints a line per time; returns {key: (min,
    median)} and, per mesh, "r1_<label>_split": launch_device_ms."""
    import torch

    from sdfgenfast_tpu_torch import load_mesh
    from sdfgenfast_tpu_torch.grid import (sizing_mode2a_proportional,
                                           sizing_python_api)
    from sdfgenfast_tpu_torch.mesh import Mesh, torus_mesh
    from sdfgenfast_tpu_torch.ops import recompute as rc
    from sdfgenfast_tpu_torch.ops import vdt_kernel
    from sdfgenfast_tpu_torch.testing import box36

    device = torch.device("cuda", 0)
    card = card_line()
    sphere_path = os.path.join(RESOURCES, "icosphere6.stl")
    out = {}
    field, dx = main_path_chamfer_input(torch, device, sphere_path, 254)
    vdt_kernel.chamfer.launches = 0
    vdt_kernel.chamfer(field, dx, 2)
    launches = vdt_kernel.chamfer.launches
    out["k4"] = repeats_ms(torch, lambda: vdt_kernel.chamfer(field, dx, 2),
                           reps, repeats)
    print(f"[{card}] K4 sphere82k {tuple(field.shape)}, 2 passes, "
          f"{launches} launch(es) a call: min {out['k4'][0]:.4f} ms, median "
          f"{out['k4'][1]:.4f} ms over {repeats} x {reps} queued calls",
          flush=True)
    del field
    v, t, bounds = load_mesh(sphere_path)
    box, torus = box36(), torus_mesh(32, 16)
    meshes = (("sphere82k", Mesh(v, t), sizing_python_api(
                  np.asarray(bounds[0], np.float32),
                  np.asarray(bounds[1], np.float32), nx=254)),
              ("box36", box, sizing_mode2a_proportional(*box.bounds(), 256,
                                                        1)),
              *r1_tori(),
              ("torus1024", torus, sizing_python_api(*torus.bounds(),
                                                     nx=254)))
    # every (form, cells a thread) of R1 where the package has them
    configs = [(f, v) for f in getattr(rc, "R1_FORMS", ())
               for v in getattr(rc, "R1_CELLS_PER_THREAD", ())]
    shared_cap = getattr(rc, "R1_SHARED_CAP", 0)
    for label, mesh, grid in meshes:
        args = r1_step_inputs(torch, device, mesh, grid)
        m = args[0].shape[0]
        out[f"r1_{label}"] = repeats_ms(
            torch, lambda: rc.recompute_forward(*args), reps, repeats)
        out[f"r1_{label}_split"] = launch_device_ms(
            torch, lambda: rc.recompute_forward(*args), reps,
            r"recompute_(phi|terms)")
        line = (f"[{card}] R1 {label} (M={m}, {tuple(args[1].shape)}"
                + (f", default {rc.r1_config(m)}" if configs else "")
                + f"): min {out[f'r1_{label}'][0]:.4f} ms, median "
                f"{out[f'r1_{label}'][1]:.4f} ms")
        for form, vec in configs:
            if form == "shared" and m > shared_cap:
                continue
            key = f"r1_{label}_{form}_{vec}"
            out[key] = repeats_ms(torch, lambda: rc.r1_launch(
                *args, form, vec), reps, repeats)
            line += (f"; {form}, {vec} a thread {out[key][0]:.4f} / "
                     f"{out[key][1]:.4f}")
        print(line + f" (min / median over {repeats} x {reps} queued calls);"
              f" per launch: {split_text(out[f'r1_{label}_split'])}",
              flush=True)
        del args
    return out


def tri_local(torch, device, mesh, origin):
    """(M, 3, 3) float32 grid-local triangle vertices on the card."""
    tv = mesh.verts[mesh.tris.astype(np.int64)] - np.asarray(origin, np.float32)
    return torch.from_numpy(np.ascontiguousarray(tv, np.float32)).to(device)


def host_enqueue_ms(torch, fn, reps):
    """The host's time to enqueue one fn() call: the host clock around
    `reps` calls, before the synchronise that follows them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def check_sep_table(torch, device, card, box, box_grid, torus, torus_grid):
    """K1's table on the card (``ops/dense.sep_table``: sep_table_kernel,
    the vertex gather included) byte-equal to the torch-op table
    ``_sep_coefs(verts[tris] - origin)`` on the same card, in its
    gather-fused and its pre-gathered form, and K1's phi and ids on the two
    tables byte-equal: box36 on its main-path grid, icosphere(2) 1000 units
    from the world origin with a zero-area triangle (a ragged grid with an
    index offset), torus1024 (the cap) on its grid; a corner index outside
    the mesh gives its row NaN and leaves the rest. Times both tables on
    box36 and torus1024: the kernel's device time (torch.profiler), each
    table's time a call back to back (CUDA events; host-paced) and the
    host's enqueue a call. Returns {label: row}, each row with the measured
    max |kernel - _sep_coefs| (``max_abs_err``)."""
    from sdfgenfast_tpu_torch.mesh import icosphere
    from sdfgenfast_tpu_torch.ops import dense

    ico = icosphere(2, radius=1.0, center=(1000.03, 999.98, 1000.05))
    ico_tris = ico.tris.astype(np.int32)
    ico_tris[0] = ico_tris[0, 0]
    cases = (("box36", box.verts, box.tris, box_grid.origin, box_grid.dx,
              box_grid.shape, (0, 0, 0), True),
             ("icosphere(2) at 1000, zero-area", ico.verts, ico_tris,
              (998.6, 998.7, 998.65), 0.05, (37, 29, 53), (5, 3, 7), False),
             ("torus1024", torus.verts, torus.tris, torus_grid.origin,
              torus_grid.dx, torus_grid.shape, (0, 0, 0), True))
    out = {}
    for label, verts, tris, origin, dx, shape, off, timed in cases:
        v = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).to(device)
        t = torch.from_numpy(np.ascontiguousarray(tris, np.int32)).to(device)
        o = torch.from_numpy(np.asarray(origin, np.float32)).to(device)

        def kernel():
            return dense.sep_table(v, o, t)

        def torch_ops():
            return dense._sep_coefs(v[t.long()] - o).contiguous()

        before = dense.sep_table.launches
        got = kernel()
        if dense.sep_table.launches != before + 1:
            raise AssertionError(f"K1 table {label}: not one launch")
        want = torch_ops()
        err = 0.0
        for form, x in (("gather-fused", got),
                        ("pre-gathered", dense.sep_table(v[t.long()], o))):
            if not torch.equal(bits(torch, x), bits(torch, want)):
                n = int((bits(torch, x) != bits(torch, want)).sum())
                raise AssertionError(
                    f"K1 table {label} ({form}): {n} of {want.numel()} "
                    f"words differ from _sep_coefs")
            # max |kernel - _sep_coefs|, a NaN on both sides counted as 0
            diff = (x - want).abs()
            diff[torch.isnan(x) & torch.isnan(want)] = 0.0
            err = max(err, float(diff.max()))
        # a corner index outside [0, N) reads nothing: its triangle's row
        # is NaN, the other rows are as they were
        bad = t.clone()
        bad[1, 1] = len(v)
        bad[2, 2] = -1
        odd = dense.sep_table(v, o, bad)
        kept = torch.ones(len(t), dtype=torch.bool, device=device)
        kept[[1, 2]] = False
        if not (torch.isnan(odd[:, ~kept]).all() and torch.equal(
                bits(torch, odd[:, kept]), bits(torch, got[:, kept]))):
            raise AssertionError(f"K1 table {label}: an index outside the "
                                 f"mesh does not give its row NaN alone")
        kw = dict(grid_shape=tuple(shape), ijk_offset=off)
        dx32 = float(np.float32(dx))
        gp, gt = dense.dense_stream(got, dx32, **kw)
        wp, wt = dense.dense_stream(want, dx32, **kw)
        if not (torch.equal(bits(torch, gp), bits(torch, wp))
                and torch.equal(gt, wt)):
            raise AssertionError(f"K1 on the two tables of {label} differs")
        row = {"triangles": len(tris), "grid": list(shape),
               "max_abs_err": err}
        line = (f"K1 table {label}: M={len(tris)}, byte-equal to _sep_coefs "
                f"(both forms, max |diff| {err}), NaN rows for indices "
                f"outside the mesh, K1 phi and ids byte-equal on {shape}")
        if timed:
            traced = launch_device_ms(torch, kernel, 50, r"sep_table_kernel")
            row.update(
                kernel_ms=traced["sep_table_kernel"][0],
                kernel_unqueued_ms=cuda_ms(torch, kernel, 200),
                kernel_host_ms=host_enqueue_ms(torch, kernel, 200),
                torch_ops_unqueued_ms=cuda_ms(torch, torch_ops, 50),
                torch_ops_host_ms=host_enqueue_ms(torch, torch_ops, 50))
            row["bound_ms"], row["bound_by"] = bound_ms(
                OPS_SEP_TABLE * len(tris), BYTES_SEP_TABLE * len(tris))
            line += (f"; [{card}] kernel {row['kernel_ms']:.4f} ms (device, "
                     f"profiled), {row['kernel_unqueued_ms']:.4f} back to "
                     f"back, host {row['kernel_host_ms']:.4f}; torch ops "
                     f"{row['torch_ops_unqueued_ms']:.4f} back to back, host "
                     f"{row['torch_ops_host_ms']:.4f}; bound "
                     f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
        print(line, flush=True)
        out[label] = row
    return out


def sep_table_steps(torch, device, card, box, box_grid, steps=3, timed=300):
    """box36 ``SDFGenerator.train_step`` from one seeded start (the
    benchmark's train mix: vertices and target 0.25 cells off, lr 0.25 a
    vertex) on the kernel's table and on the torch-op table
    (``dense.sep_table`` swapped for ``_sep_coefs`` over the gathered
    corners): each of `steps` steps' loss and vertices byte-equal. Then the
    step's wall, loss read every step, `timed` steps a turn in the order
    torch ops, kernel, kernel, torch ops. Returns a dict."""
    from sdfgenfast_tpu_torch.mesh import Mesh
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.ops import dense
    from sdfgenfast_tpu_torch.pipeline import make_level_set3

    rng = np.random.default_rng(20)
    dx = float(box_grid.dx)
    verts = (box.verts + rng.uniform(-0.25, 0.25, box.verts.shape) * dx
             ).astype(np.float32)
    target_verts = (verts + rng.uniform(-0.25, 0.25, verts.shape) * dx
                    ).astype(np.float32)
    target = make_level_set3(Mesh(target_verts, box.tris), box_grid,
                             device=device)
    model = SDFGenerator(Mesh(verts, box.tris), box_grid, device=device)
    lr = 0.25 * len(verts)
    kernel_table = dense.sep_table

    def torch_ops_table(verts, origin, tris=None):
        tv = verts if tris is None else verts[tris.long()]
        return dense._sep_coefs(tv - origin).contiguous()

    torch_ops_table.launches = 0

    def run(table, n, read):
        dense.sep_table = table
        try:
            v, got = model.params, []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                v, loss = model.train_step(v, target, lr)
                got.append(read(v, loss))
            torch.cuda.synchronize()
            return got, (time.perf_counter() - t0) / n * 1e3
        finally:
            dense.sep_table = kernel_table

    def keep(v, loss):
        return bits(torch, loss.detach()).cpu(), bits(torch, v.detach()).cpu()

    old, _ = run(torch_ops_table, steps, keep)
    new, _ = run(kernel_table, steps, keep)
    for i, ((lo, vo), (ln, vn)) in enumerate(zip(old, new)):
        if not (torch.equal(lo, ln) and torch.equal(vo, vn)):
            raise AssertionError(f"box36 step {i}: loss or vertices differ "
                                 f"between the two tables")
    walls = {"torch_ops": [], "kernel": []}
    for name in ("torch_ops", "kernel", "kernel", "torch_ops"):
        table = kernel_table if name == "kernel" else torch_ops_table
        walls[name].append(run(table, timed, lambda v, loss: float(loss))[1])
    print(f"[{card}] box36 train_step: {steps} steps' losses and vertices "
          f"byte-equal on the two tables; step wall (ms, {timed} steps a "
          f"turn, loss read each step): torch-op table {walls['torch_ops']}, "
          f"kernel {walls['kernel']}", flush=True)
    return {"steps_byte_equal": steps, "step_ms": walls}


# the kernels table's row of the sign stage: box36's transport
SIGN_ROW = "box36 crossings (bin_mesh's)"


def sign_bytes(kind_rows, cells, ncols, mode):
    """Device-memory bytes of one sign-stage launch: the parity input
    (packed: a byte a column a byte row; crossings: 2 B a column a row;
    bool: a byte a cell), then 1 B a cell written (decode) or 4 B read and
    4 B written (sign)."""
    kind, rows = kind_rows
    inp = {"packed": rows * ncols, "crossings": 2 * rows * ncols,
           "bool": cells}[kind]
    return inp + (cells if mode == "decode" else 8 * cells)


def sign_kernel_cases(torch, device, box, box_grid, grids):
    """(label, parity data on the card, transport, unsigned phi) of
    :func:`check_sign_kernel`: box36 on its main-path grid and sphere82k at
    256^3 in the transport ``bin_mesh`` picks and the other one, phi the
    route's field (the signed call's absolute value, every 997th cell set
    to +0.0); a 1024 x 512 x 512 block of sphere82k's 1024^3 packed parity
    (a shard's block in the four-card cell) with a seeded phi."""
    from sdfgenfast_tpu_torch.grid import sizing_python_api
    from sdfgenfast_tpu_torch.ops import sign_host
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, make_level_set3

    sphere, sgrid = grids[256]
    for label, mesh, grid in (("box36", box, box_grid),
                              ("sphere82k 256^3", sphere, sgrid)):
        binned = bin_mesh(mesh, grid, device=device)
        phi = make_level_set3(mesh, grid, binned=binned,
                              device=device).abs()
        phi.view(-1)[::997] = 0.0
        ni = grid.shape[0]
        cross = sign_host.crossings_host(mesh.verts, mesh.tris, grid)
        forms = {"crossings": cross,
                 "packed": sign_host.packed_from_crossings(cross, ni)}
        picked = "packed" if binned.parity_packed is not None else "crossings"
        for name in (picked, *(n for n in forms if n != picked)):
            tag = " (bin_mesh's)" if name == picked else ""
            yield (f"{label} {name}{tag}", torch.from_numpy(
                forms[name]).to(device), name, phi)
    mn, mx = sphere.bounds()
    big = sizing_python_api(np.asarray(mn, np.float32),
                            np.asarray(mx, np.float32), nx=1022)
    if big.shape != (1024, 1024, 1024):
        raise AssertionError(f"sphere82k 1024^3 grid {big.shape}")
    packed = sign_host.parity_packed_host(sphere.verts, sphere.tris, big)
    block = torch.from_numpy(np.ascontiguousarray(
        packed[:, :512, :512])).to(device)
    gen = torch.Generator(device=device).manual_seed(22)
    phi = torch.rand((1024, 512, 512), generator=gen, device=device)
    phi.view(-1)[::997] = 0.0
    yield "sphere82k 1024^3 block (0, 0) packed", block, "packed", phi


def check_sign_kernel(torch, device, card, box, box_grid, grids, reps=20):
    """The sign stage's kernel (``ops/sign_kernel.parity_sign``,
    ``csrc/sign.cu``) on the card against its twins run on the same card
    (``parity_sign_reference``: the decode's torch ops, then
    ``torch.where(p, -phi, phi)``), on :func:`sign_kernel_cases`: the
    decode, the sign into a fresh tensor and in place, and the sign from
    the decoded bool field (the device sign's input), each byte-equal (-0.0
    where odd, so +0.0 cells are planted) and one launch. Times each launch
    (torch.profiler, `reps` calls) beside the twins (CUDA events) and
    against the byte bound (:func:`sign_bytes`). Returns {label: row}."""
    from sdfgenfast_tpu_torch.ops import sign_kernel as sk

    out = {}
    for label, data, name, phi in sign_kernel_cases(torch, device, box,
                                                    box_grid, grids):
        ni = phi.shape[0]
        want_p = sk.parity_sign_reference(data, ni)
        want = sk.parity_sign_reference(data, ni, phi)
        before = sk.parity_sign.launches
        got_p = sk.parity_sign(data, ni)
        got = sk.parity_sign(data, ni, phi)
        from_bool = sk.parity_sign(got_p, ni, phi)
        inplace = phi.clone()
        same = sk.parity_sign(data, ni, inplace, inplace=True)
        if sk.parity_sign.launches != before + 4 or same is not inplace:
            raise AssertionError(f"sign kernel {label}: launches "
                                 f"{sk.parity_sign.launches - before}")
        if not torch.equal(got_p, want_p):
            n = int((got_p != want_p).sum())
            raise AssertionError(f"sign kernel {label}: decode differs at "
                                 f"{n} of {want_p.numel()} cells")
        sign_err = 0.0
        for form, x in (("fresh", got), ("bool input", from_bool),
                        ("in place", same)):
            if not torch.equal(bits(torch, x), bits(torch, want)):
                n = int((bits(torch, x) != bits(torch, want)).sum())
                raise AssertionError(f"sign kernel {label} ({form}): {n} of "
                                     f"{want.numel()} words differ from "
                                     f"torch.where")
            sign_err = max(sign_err, abs_err(x, want))
        cells, ncols = phi.numel(), phi.shape[1] * phi.shape[2]
        rows = (name, data.shape[0])
        row = {"grid": list(phi.shape), "transport": name,
               "rows": int(data.shape[0]),
               "odd_cells": int(want_p.sum()),
               "decode_max_abs_err": float(
                   (got_p.int() - want_p.int()).abs().max()),
               "sign_max_abs_err": sign_err}
        for mode, fn in (("decode", lambda: sk.parity_sign(data, ni)),
                         ("sign", lambda: sk.parity_sign(data, ni, phi))):
            (ms, count), = launch_device_ms(torch, fn, reps,
                                            r"parity_sign_kernel").values()
            bound, _ = bound_ms(0, sign_bytes(rows, cells, ncols, mode))
            row[f"{mode}_ms"], row[f"{mode}_traced"] = ms, count
            row[f"{mode}_bound_ms"] = bound
            row[f"{mode}_share"] = bound / ms
        row["twin_decode_ms"] = cuda_ms(
            torch, lambda: sk.parity_sign_reference(data, ni), reps)
        row["twin_sign_ms"] = cuda_ms(
            torch, lambda: sk.parity_sign_reference(data, ni, phi), reps)
        print(f"[{card}] sign kernel {label} {tuple(phi.shape)} "
              f"({rows[1]} rows): decode, sign (fresh, in place, from the "
              f"bool field) byte-equal to the twins, one launch each; decode "
              f"{row['decode_ms']:.4f} ms (bound {row['decode_bound_ms']:.4f}"
              f", {row['decode_share']:.1%}), sign {row['sign_ms']:.4f} ms "
              f"(bound {row['sign_bound_ms']:.4f}, {row['sign_share']:.1%}); "
              f"twins: decode {row['twin_decode_ms']:.4f}, decode + where "
              f"{row['twin_sign_ms']:.4f} ms", flush=True)
        out[label] = row
    return out


def sign_kernel_steps(torch, device, card, box, box_grid, grids, steps=3,
                      timed=300):
    """The sign stage's kernel against its twins in the program, on the
    card: ``sign_kernel.parity_sign`` swapped for ``parity_sign_reference``
    (the torch ops) in the same package. box36 and sphere82k 256^3: the
    generate grid, and `steps` ``SDFGenerator.train_step``s from one seeded
    start (the benchmark's train mix: vertices and target 0.25 cells off,
    lr 0.25 a vertex), each step's loss and vertices, byte-equal; one
    launch a call and a step. Then box36's step wall (loss read every step,
    `timed` steps a turn: twins, kernel, kernel, twins). Returns a dict."""
    from sdfgenfast_tpu_torch import pipeline
    from sdfgenfast_tpu_torch.mesh import Mesh
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.ops import sign_kernel as sk

    kernel = sk.parity_sign

    def twin(parity, ni, phi=None, *, inplace=False):
        return sk.parity_sign_reference(parity, ni, phi)

    def run(sign, fn):
        pipeline.sign_kernel.parity_sign = sign
        try:
            before = kernel.launches
            got = fn()
            torch.cuda.synchronize()
            return got, kernel.launches - before
        finally:
            pipeline.sign_kernel.parity_sign = kernel

    out = {}
    for label, mesh, grid in (("box36", box, box_grid),
                              ("sphere82k 256^3", *grids[256])):
        rng = np.random.default_rng(20)
        dx = float(grid.dx)
        verts = (mesh.verts + rng.uniform(-0.25, 0.25, mesh.verts.shape) * dx
                 ).astype(np.float32)
        target_verts = (verts + rng.uniform(-0.25, 0.25, verts.shape) * dx
                        ).astype(np.float32)
        target = pipeline.make_level_set3(Mesh(target_verts, mesh.tris), grid,
                                          device=device)
        model = SDFGenerator(Mesh(verts, mesh.tris), grid, device=device)
        lr = 0.25 * len(verts)

        def generate():
            return bits(torch, pipeline.make_level_set3(
                model.mesh, grid, binned=model.binned, device=device)).cpu()

        def train(n=steps, read=None):
            v, got = model.params, []
            for _ in range(n):
                v, loss = model.train_step(v, target, lr)
                got.append((bits(torch, loss).cpu(), bits(torch, v).cpu())
                           if read is None else read(loss))
            return got

        for what, fn, per in (("generate grid", generate, 1),
                              ("train steps", train, steps)):
            (old, _), (new, n) = run(twin, fn), run(kernel, fn)
            if n != per:
                raise AssertionError(f"{label} {what}: {n} sign launches, "
                                     f"want {per}")
            same = (torch.equal(old, new) if what == "generate grid" else
                    all(torch.equal(a, b) and torch.equal(c, d)
                        for (a, c), (b, d) in zip(old, new)))
            if not same:
                raise AssertionError(f"{label} {what}: differs between the "
                                     f"kernel and the twins")
        row = {"byte_equal_steps": steps}
        if label == "box36":
            walls = {"twins": [], "kernel": []}
            for name in ("twins", "kernel", "kernel", "twins"):
                sign = kernel if name == "kernel" else twin
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(sign, lambda: train(timed, float))
                walls[name].append((time.perf_counter() - t0) / timed * 1e3)
            row["step_ms"] = walls
        print(f"[{card}] sign steps {label}: the generate grid and {steps} "
              f"train steps' losses and vertices byte-equal on the kernel and "
              f"the twins, one sign launch a call and a step"
              + (f"; step wall (ms, {timed} steps a turn): twins "
                 f"{row['step_ms']['twins']}, kernel "
                 f"{row['step_ms']['kernel']}" if "step_ms" in row else ""),
              flush=True)
        out[label] = row
    return out


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


def exact_sample(mesh, grid, n=4096, chunk=256):
    """(flat indices, float64 exact distances) of `n` seeded random cells
    (tests/oracle.py), from the same float32 grid-local triangles and cell
    positions the kernels use."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import point_triangle_distance_np

    idx = np.random.default_rng(0).integers(0, int(np.prod(grid.shape)), n)
    ijk = np.stack(np.unravel_index(idx, grid.shape), 1)
    p = (ijk.astype(np.float32) * np.float32(grid.dx)).astype(np.float64)
    tl = (mesh.verts[mesh.tris.astype(np.int64)]
          - np.asarray(grid.origin, np.float32)).astype(np.float64)
    step = max(1, min(chunk, (1 << 22) // len(tl)))
    exact = np.concatenate([
        point_triangle_distance_np(p[s:s + step, None], tl[None, :, 0],
                                   tl[None, :, 1], tl[None, :, 2]).min(axis=1)
        for s in range(0, n, step)])
    return idx, exact


def check_exact_sample(label, mesh, grid, phi, n=4096):
    """|phi| on `n` seeded random cells against the float64 exact distance
    (:func:`exact_sample`): the dense path is exact everywhere."""
    idx, exact = exact_sample(mesh, grid, n)
    np.testing.assert_allclose(np.abs(phi.reshape(-1)[idx]), exact,
                               rtol=2e-5, atol=2e-6, err_msg=f"{label} exact")


def check_never_below(label, phi, sample, dx):
    """|phi| on the cells of `sample` (:func:`exact_sample`) never below the
    float64 exact distance (the far field is an overestimate by
    construction). Returns the largest gap above it, in dx."""
    idx, exact = sample
    got = np.abs(phi.reshape(-1)[idx]).astype(np.float64)
    under = exact - got
    if (under > 2e-6 + 5e-5 * exact).any():
        raise AssertionError(f"{label}: {int((under > 0).sum())} sample "
                             f"cells below the exact distance (by up to "
                             f"{under.max():.3e})")
    return float((got - exact).max()) / dx


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


def check_golden(phi, golden_path, far_key, stride, grid, far_bar=0.2):
    """The bars of tests/test_parity_golden.py's sparse-golden tests, the
    far field below `far_bar` dx."""
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
    if not far < far_bar * float(g["dx"]):
        raise AssertionError(f"far-field divergence {far:.3e} >= "
                             f"{far_bar}*dx")
    return far / float(g["dx"])


def kernel_name(mangled):
    """A kernel's name (with its bool, int and unsigned template arguments)
    from its mangled symbol: the length-prefixed identifier that ends in
    ``_kernel``."""
    # the innermost name is the last one; a hash's digits may precede its
    # length, so every suffix of a run of digits is tried
    for m in reversed(list(re.finditer(r"\d+", mangled))):
        for k in reversed(range(len(m.group(0)))):
            n = int(m.group(0)[k:])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                t = re.match(r"I((?:Lb[01]E|Li\d+E|j|y)+)E",
                             mangled[m.end() + n:])
                if t is None:
                    return name
                names = {"Lb1E": "true", "Lb0E": "false", "j": "unsigned",
                         "y": "unsigned long long"}
                return name + "<" + ", ".join(
                    names.get(a) or a[2:-1] for a in re.findall(
                        r"Lb[01]E|Li\d+E|j|y", t.group(1))) + ">"
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
        if re.search(r"vpu_peak|vpu_mixed|tile_kernel", name):
            counts[name] = {op: sum(bool(re.search(rf"\b{op}\b", i))
                                    for _, i in ins)
                            for op in ("FFMA", "FMUL", "FADD")}
    return counts


FP32_OPS = re.compile(r"^(@!?U?P[T\d]+\s+)?(FFMA|FMUL|FADD|FMNMX|FSETP|FSEL|"
                      r"FSET|FCHK|MUFU)\b")


def sass_fp32(text, pattern):
    """{kernel: FP32 arithmetic/compare/select instructions in its SASS}
    for every kernel matching `pattern` (each instruction once, whatever
    path runs it)."""
    return {name: sum(bool(FP32_OPS.search(op)) for _, op in ins)
            for name, (ins, _) in sass_functions(text).items()
            if re.search(pattern, name)}


SASS_MEMORY = re.compile(r"^(?:@!?U?P[T\d]+\s+)?((?:UBLKCP|UTMA\w*|SYNCS|"
                         r"FENCE|LDG|STG|LDGSTS|DEPBAR|MEMBAR|BAR|ARRIVES)"
                         r"[.\w]*)")


def sass_memory(text, pattern):
    """{kernel: {instruction: count}} of the copy, barrier and fence
    instructions (bulk copies, mbarrier operations, proxy fences, global
    loads and stores) of every kernel matching `pattern`."""
    out = {}
    for name, (ins, _) in sass_functions(text).items():
        if re.search(pattern, name):
            counts = {}
            for _, op in ins:
                m = SASS_MEMORY.search(op)
                if m:
                    counts[m.group(1)] = counts.get(m.group(1), 0) + 1
            out[name] = dict(sorted(counts.items()))
    return out


def sass_inner_loops(text, pattern=r"dense_stream|band_rows"):
    """For each kernel matching `pattern`, its innermost loop (a backward
    branch's span that holds no other) with the most FP32 instructions:
    (instructions, FP32 arithmetic/compare/select instructions, LDS
    instructions). The walks load a candidate's ten float4 with ten LDS, so
    LDS / 10 is the candidates per trip of an unrolled loop."""
    out = {}
    fp = FP32_OPS
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
    that adds in float64 and rounds once, or both non-finite. P3 and P4's
    seeded input starts with special_values; then check_probe_edges. Returns {name: (max_abs_err,
    plain_ms)}."""
    from sdfgenfast_tpu_torch.tools import micro_bench as mb

    rng = np.random.default_rng(3)

    def inputs(shape, special=False):
        seeded = torch.from_numpy(rng.uniform(-1.5, 1.5, shape).astype(
            np.float32)).to(device)
        if special:
            special_values(torch, seeded.view(-1))
        return torch.ones(shape, dtype=torch.float32, device=device), seeded

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
        for x in inputs((n_blocks * rows, mb.GRID_COLS), special=True):
            got = mb.grid_overhead(x, n_blocks)
            want = mb.grid_overhead_reference(x, n_blocks)
            if not same_bits(torch, got, want):
                raise AssertionError(f"P3 {n_blocks} blocks: differs")
            if mb.grid_overhead.last_launch["grid"] != n_blocks:
                raise AssertionError(f"P3: {mb.grid_overhead.last_launch} for "
                                     f"{n_blocks} blocks")
            err = max(err, finite_err(torch, got, want))
        out[f"grid_overhead_b{rows}"] = (err, cuda_ms(
            torch, lambda: mb.grid_overhead_reference(x, n_blocks), 10))
    err = 0.0
    for x in inputs(mb.HBM_SHAPE, special=True):
        got = mb.hbm_stream(x)
        want = mb.hbm_stream_reference(x)
        if not same_bits(torch, got, want):
            raise AssertionError("P4: differs from its twin")
        err = max(err, finite_err(torch, got, want))
    out["hbm_stream"] = (err, cuda_ms(
        torch, lambda: mb.hbm_stream_reference(x), 10))
    del x, got, want
    print("P1-P4 vs twins: P1 (both variants), P2, P3 (both block sizes) "
          "and P4 held at the tool's shapes (P1 fma within 1 "
          "ulp, the rest bit-equal, non-finite values included)", flush=True)
    check_probe_edges(torch, device)
    return out


def special_values(torch, x):
    """`x` (flat view of a seeded input) with non-finite and edge values at
    its start: inf, -inf, NaN, -0.0, 3e38 (doubles to inf), a denormal."""
    vals = [float("inf"), float("-inf"), float("nan"), -0.0, 3e38, 1e-40]
    k = min(len(vals), x.numel())
    x[:k] = torch.tensor(vals[:k], dtype=torch.float32, device=x.device)
    return x


def check_probe_edges(torch, device):
    """P3 and P4 bit for bit against their twins off the tool's shapes. P4:
    n = 1, 3, 4, 17, one tile - 1, one tile, one tile + 1 (HBM_TILE
    floats, one stage), and a size whose last CTA gets a ragged tile that
    ends in a scalar tail; its refusal of an x not 16-byte aligned. P3: one
    block, an odd block_floats (one stage and the ring), blocks of 1 and 3
    floats, and views x[1:], x[2:], x[3:] of a flat buffer (tiles starting
    4-12 bytes past a 16-byte boundary). Both: n = 0 gives an empty tensor
    without a launch."""
    from sdfgenfast_tpu_torch.tools import micro_bench as mb

    rng = np.random.default_rng(5)

    def flat(n, lead=0):
        buf = torch.from_numpy(rng.uniform(-1.5, 1.5, n + lead).astype(
            np.float32)).to(device)
        return special_values(torch, buf[lead:])

    tile = mb.HBM_TILE
    sizes = (1, 3, 4, 17, tile - 1, tile, tile + 1, 3 * tile + 23)
    for n in sizes:
        x = flat(n)
        got = mb.hbm_stream(x)
        if not same_bits(torch, got, mb.hbm_stream_reference(x)):
            raise AssertionError(f"P4 n={n}: differs")
        if mb.hbm_stream.last_launch["grid"] != -(-n // tile):
            raise AssertionError(f"P4 n={n}: {mb.hbm_stream.last_launch}")
    try:
        mb.hbm_stream(flat(64, 1))
    except ValueError:
        pass
    else:
        raise AssertionError("P4 took an x that is not 16-byte aligned")
    cases = [(1, 6144, 0), (1, 49152, 0), (7, 6143, 0), (3, 49151, 0),
             (5, 1, 0), (9, 3, 1), (10, 6144, 1), (11, 6143, 2),
             (5, 49152, 3), (4, 49151, 1), (7, 6143, 1), (3, 49151, 2)]
    for n_blocks, bf, lead in cases:
        x = flat(n_blocks * bf, lead)
        if x.data_ptr() // 4 % 4 != lead:
            raise AssertionError("P3 case: the view's offset is not as meant")
        got = mb.grid_overhead(x, n_blocks)
        if not same_bits(torch, got, mb.grid_overhead_reference(x, n_blocks)):
            raise AssertionError(f"P3 {n_blocks} x {bf} at +{4 * lead} B: "
                                 f"differs")
        if mb.grid_overhead.last_launch["grid"] != n_blocks:
            raise AssertionError(f"P3: {mb.grid_overhead.last_launch}")
    before = (mb.grid_overhead.launches, mb.hbm_stream.launches)
    empty = torch.empty((0, mb.GRID_COLS), device=device)
    if (mb.grid_overhead(empty, 5).shape != empty.shape
            or mb.hbm_stream(empty).shape != empty.shape
            or (mb.grid_overhead.launches, mb.hbm_stream.launches) != before):
        raise AssertionError("P3/P4 at n = 0: not an empty tensor without a "
                             "launch")
    print(f"P3/P4 edge cases bit-equal to the twins: P4 at n = {sizes}, "
          f"unaligned x refused; P3 (blocks, floats, offset in floats) "
          f"{cases}; n = 0 without a launch", flush=True)


def single_ms(torch, fn, reps=10):
    """The probe tool's timing before it queued its launches: CUDA events
    around one call after a synchronize, the median of `reps`, after a
    warm-up; the host's launch work falls inside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe_times(reps=10, repeats=3):
    """P3 at both of the tool's sizes and P4 beside torch.mul(x, 2.0) and
    torch.add(x, 1.0) on the same inputs (the tool's: ones), each timed by
    repeats_ms (queued behind the spin, `reps` calls, `repeats` times) and,
    for the record of how the tool timed them before, by single_ms. Uses
    only entry points that older versions of the package have too, so it
    times whichever package is first on the path; from another checkout's
    root: ``python3 -c "import runpy;
    runpy.run_path('<this file>')['probe_times']()"``. Prints a line per
    time; returns {key: (min, median)} and {key + "_single": ms}."""
    import torch

    from sdfgenfast_tpu_torch.tools import micro_bench as mb

    device = torch.device("cuda", 0)
    card = card_line()
    out = {}

    def timed(key, fn, what):
        out[key] = repeats_ms(torch, fn, reps, repeats)
        out[key + "_single"] = single_ms(torch, fn, reps)
        what = what() if callable(what) else what
        print(f"[{card}] {what}: min {out[key][0]:.4f} ms, median "
              f"{out[key][1]:.4f} ms over {repeats} x {reps} queued calls; "
              f"{out[key + '_single']:.4f} ms one call at a time", flush=True)

    for n_blocks, rows in mb.GRID_CASES:
        x = torch.ones((n_blocks * rows, mb.GRID_COLS), dtype=torch.float32,
                       device=device)
        timed(f"p3_b{rows}", lambda: mb.grid_overhead(x, n_blocks),
              lambda: f"P3 grid_overhead {n_blocks} x ({rows}, "
              f"{mb.GRID_COLS}) {getattr(mb.grid_overhead, 'last_launch', '')}")
        timed(f"mul_b{rows}", lambda: torch.mul(x, 2.0),
              f"torch.mul(x, 2.0) on the same {tuple(x.shape)}")
        del x
    x = torch.ones(mb.HBM_SHAPE, dtype=torch.float32, device=device)
    timed("p4", lambda: mb.hbm_stream(x),
          lambda: f"P4 hbm_stream {tuple(x.shape)} "
          f"{getattr(mb.hbm_stream, 'last_launch', '')}")
    timed("add", lambda: torch.add(x, 1.0),
          f"torch.add(x, 1.0) on the same {tuple(x.shape)}")
    del x
    return out


def r1b_paths(torch, tv, tid, gphi, origin, dx, chunk=1 << 22):
    """This run's cells on each path of R1b's cell_vjp: (cells with a
    gradient (tid >= 0, grad_phi != 0), of them in the plane case, seg_vjp
    calls: one per outside cell, two at a tie of its two edges). Weights
    and segment distances in the kernel's float32 order (geometry.cuh).
    With gphi None, R1's: every cell with tid >= 0 counts."""
    from sdfgenfast_tpu_torch.ops import recompute as rc
    from sdfgenfast_tpu_torch.ops.geometry import gather_tri9

    def d3(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    def seg(p, x1, x2):
        dv = [x2[i] - x1[i] for i in range(3)]
        t = d3([x2[i] - p[i] for i in range(3)], dv) / torch.clamp(
            d3(dv, dv), min=1e-30)
        t = torch.clamp(t, 0.0, 1.0)
        dd = [p[i] - (t * x1[i] + (1.0 - t) * x2[i]) for i in range(3)]
        return d3(dd, dd)

    tri9 = tv.reshape(-1, 9).T
    ft = tid.reshape(-1)
    fg = None if gphi is None else gphi.reshape(-1)
    cells = inside = segs = 0
    for s in range(0, ft.numel(), chunk):
        n = min(chunk, ft.numel() - s)
        t = ft[s:s + n]
        live = t >= 0 if gphi is None else (t >= 0) & (fg[s:s + n] != 0)
        p = rc._cell_positions(s, n, tid.shape, origin, dx, tid.device)
        a, b, c = gather_tri9(tri9, t)
        x13 = [a[i] - c[i] for i in range(3)]
        x23 = [b[i] - c[i] for i in range(3)]
        x03 = [p[i] - c[i] for i in range(3)]
        m13, m23, d = d3(x13, x13), d3(x23, x23), d3(x13, x23)
        inv = 1.0 / torch.clamp(m13 * m23 - d * d, min=1e-30)
        pa, pb = d3(x13, x03), d3(x23, x03)
        w23 = inv * (m23 * pa - d * pb)
        w31 = inv * (m13 * pb - d * pa)
        ins = (w23 >= 0) & (w31 >= 0) & (1.0 - w23 - w31 >= 0)
        d12, d13, d23 = seg(p, a, b), seg(p, a, c), seg(p, b, c)
        dp = torch.where(w23 > 0, d12, torch.where(w31 > 0, d12, d13))
        dq = torch.where(w23 > 0, d13, d23)
        out = live & ~ins
        cells += int(live.sum())
        inside += int((live & ins).sum())
        segs += int(out.sum()) + int((out & (dp == dq)).sum())
    return cells, inside, segs


def r1_bound(paths, m, n):
    """R1's bound at this run's paths (r1b_paths without a gradient): the
    triangles read once, 9 B per cell (tid, parity, phi)."""
    cells, inside, _ = paths
    ops = (cells * OPS_R1_CELL + inside * OPS_R1_PLANE
           + (cells - inside) * OPS_R1_EDGES)
    return bound_ms(ops, 36 * m + 9 * n)


def r1b_bound(paths, m, n):
    """R1b's bound at this run's paths: the triangles read and the (M, 9)
    float32 gradient written, 9 B per cell (tid, parity, grad_phi)."""
    cells, inside, segs = paths
    ops = (cells * OPS_R1B_CELL + inside * OPS_R1B_PLANE
           + (cells - inside) * OPS_R1B_EDGES + segs * OPS_R1B_SEG)
    return bound_ms(ops, 72 * m + 9 * n)


def r1b_inputs(torch, device, mesh, origin, dx, shape, rng, holes=False):
    """recompute_backward's arguments on `mesh` over the grid (origin, dx,
    shape): ids from the dense twin (dense_sep_reference), grad_phi and
    parity from `rng`; with `holes`, tid = -1 and grad_phi = 0 cells
    scattered and in stretches. Uses only entry points that older versions
    of the package have too."""
    from sdfgenfast_tpu_torch.ops import dense

    origin = tuple(float(o) for o in np.asarray(origin, np.float32))
    dx = float(np.float32(dx))
    tv = tri_local(torch, device, mesh, (0, 0, 0))
    local = tv - torch.tensor(origin, device=device)
    _, tid = dense.dense_sep_reference(dense._sep_coefs(local), dx,
                                       grid_shape=tuple(shape))
    n = tid.numel()
    gphi = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device)
    parity = torch.from_numpy(rng.random(shape) < 0.5).to(device)
    if holes:
        ft, fg = tid.view(-1), gphi.view(-1)
        ft[torch.from_numpy(rng.random(n) < 0.02).to(device)] = -1
        ft[1000:1100] = -1
        fg[torch.from_numpy(rng.random(n) < 0.05).to(device)] = 0.0
        fg[5000:5200] = 0.0
    upper = float(np.float32(sum(shape)) * np.float32(dx))
    return tv, tid, parity, gphi, origin, dx, upper


def r1b_tori():
    """(label, mesh, grid) of the dense meshes of 512 and 1024 triangles,
    torus_mesh(16, 16) and torus_mesh(32, 16), at their 256-class grid
    (sizing_python_api, nx = 254)."""
    from sdfgenfast_tpu_torch.grid import sizing_python_api
    from sdfgenfast_tpu_torch.mesh import torus_mesh

    return [(label, m, sizing_python_api(*m.bounds(), nx=254))
            for label, m in (("torus512", torus_mesh(16, 16)),
                             ("torus1024", torus_mesh(32, 16)))]


def launch_device_ms(torch, fn, reps, pattern):
    """{kernel: (mean device ms over its traced launches, count traced)} of
    the kernels whose demangled name matches `pattern`, over `reps` calls
    of fn under torch.profiler (the tracer may drop some launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t and re.search(pattern, e.key):  # a demangled signature
            name = re.sub(r"\(.*", "", e.key.split("::")[-1])
            out[name] = (t / e.count / 1e3, e.count)
    return out


def split_text(split):
    return ", ".join(f"{name} {ms:.4f} ms ({count} traced)"
                     for name, (ms, count) in split.items()) or "not traced"


def r1b_dense_times(meshes=None, reps=10):
    """R1b alone (``recompute_backward``, CUDA events, the mean of `reps`
    calls) on r1b_inputs with seed 0 for each (label, mesh, grid) of
    `meshes`, by default r1b_tori(). Beside it, each kernel's mean device
    time over its launches in `reps` more calls under torch.profiler (the
    count traced is printed: the tracer may drop some). Uses only
    entry points that older versions of the package have too, so it times
    whichever package is first on the path; from another checkout's root:
    ``python3 -c "import runpy; runpy.run_path('<this file>')
    ['r1b_dense_times']()"``. Prints one line per mesh."""
    import torch

    from sdfgenfast_tpu_torch.ops import recompute as rc

    device = torch.device("cuda", 0)
    if meshes is None:
        meshes = r1b_tori()
    for label, mesh, grid in meshes:
        args = r1b_inputs(torch, device, mesh, grid.origin, grid.dx,
                          grid.shape, np.random.default_rng(0))
        ms = cuda_ms(torch, lambda: rc.recompute_backward(*args), reps)
        split = launch_device_ms(torch, lambda: rc.recompute_backward(*args),
                                 reps, "vjp")
        print(f"R1b {label} ({len(mesh.tris)} triangles, {grid.shape}): "
              f"{ms:.4f} ms; per launch: {split_text(split)}", flush=True)


def check_r1b_cases(torch, device, box, torus, torus_grid):
    """R1b on both sides of its dispatch, against its twin (1e-4 of the
    largest vertex gradient) and run twice bit for bit: torus1024 on its
    256-class grid (M = 1024, the fixed-order sum at the cap), 1025
    triangles of icosphere(3) on a ragged grid (the atomic side), and box36
    on a ragged grid with tid = -1 and grad_phi = 0 cells (r1b_inputs);
    every grid's n is not a multiple of its span. Returns the largest error
    relative to the scale."""
    from sdfgenfast_tpu_torch.mesh import Mesh, icosphere
    from sdfgenfast_tpu_torch.ops import recompute as rc

    rng = np.random.default_rng(7)
    ico = icosphere(3, radius=1.0, center=(0.02, -0.01, 0.03))
    cases = (("torus1024", torus, torus_grid.origin, torus_grid.dx,
              torus_grid.shape, False),
             ("icosphere(3)[:1025]", Mesh(ico.verts, ico.tris[:1025]),
              (-1.2, -1.15, -1.1), 0.04, (61, 67, 53), False),
             ("box36 ragged, holes", box, (-2.6, -3.1, -3.55), 0.09,
              (61, 73, 91), True))
    worst = 0.0
    for label, mesh, origin, dx, shape, holes in cases:
        args = r1b_inputs(torch, device, mesh, origin, dx, shape, rng, holes)
        tv, tid = args[:2]
        n = tid.numel()
        ranges, span = rc.vjp_ranges(n, len(mesh.tris))
        if n % span == 0:
            raise AssertionError(f"R1b {label}: n is a multiple of the span")
        g1 = rc.recompute_backward(*args)
        g2 = rc.recompute_backward(*args)
        gt = rc.recompute_backward_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, g1), bits(torch, g2)):
            raise AssertionError(f"R1b {label}: two runs differ")
        tris = torch.from_numpy(mesh.tris.astype(np.int64)).to(device)
        gv, gvt = (vertex_grad(torch, tris, g, len(mesh.verts))
                   for g in (g1, gt))
        scale = float(gvt.abs().max())
        err = float((gv - gvt).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            raise AssertionError(f"R1b {label}: max err {err:.3e} vs 1e-4 * "
                                 f"{scale:.3e}")
        worst = max(worst, err / scale)
        side = ("fixed order" if len(mesh.tris) <= rc.VJP_ROWS_MAX_TRIS
                else "atomic")
        print(f"R1b {label} ({side}, M={len(mesh.tris)}, {shape}, {ranges} "
              f"ranges of {span} cells): vertex gradient max|err| "
              f"{err / scale:.2e} of max|g|, two runs bit-equal", flush=True)
    return worst


def vertex_grad(torch, tris, g_tri, n_verts):
    """(M, 3, 3) triangle-vertex gradient -> (N, 3) vertex gradient."""
    g = torch.zeros((n_verts, 3), dtype=torch.float64, device=g_tri.device)
    g.index_add_(0, tris.reshape(-1), g_tri.reshape(-1, 3).double())
    return g


def differentiable_half(torch, device, label, mesh, grid, counters):
    """The differentiable path through ``models.SDFGenerator`` on one mesh:
    target = forward of the 0.95-scaled vertices; counters set to 0, one
    ``train_step``, counters read. Then, on that step's ids and parity: R1
    against its twin (bit for bit), R1b against its twin's autograd
    gradient (1e-4 of the largest vertex gradient), R1b run twice bit for
    bit, and a central finite difference of the float64-summed loss along
    u = g/|g| against <g, u> = |g|, ids frozen, away from the surface: rtol
    1e-3 through R1, 1e-4 in float64 through the twin (the full forward's
    is printed). Returns a dict of results and
    the step's tensors for the timings."""
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.ops import recompute as rc
    from sdfgenfast_tpu_torch.ops.sign_kernel import parity_sign
    from sdfgenfast_tpu_torch.pipeline import make_level_set3

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
    parity = parity_sign(torch.from_numpy(
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
    r1_err = abs_err(phi, twin)
    r1_bits = int((bits(torch, phi) != bits(torch, twin)).sum())
    if r1_bits:
        raise AssertionError(f"{label} R1: {r1_bits} cells differ from the "
                             f"twin (max|err| {r1_err:.3e})")
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
    with R1 / R1b swapped for their twins; R1's twin and R1b and its twin
    alone (R1 itself: k4_r1_times)."""
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
    times["r1_twin"] = cuda_ms(torch, lambda: rc.recompute_forward_reference(
        tv, tid, parity, origin, dx, upper), 2)
    times["r1b"] = cuda_ms(torch, lambda: rc.recompute_backward(
        tv, tid, parity, gphi, origin, dx, upper), 10)
    times["r1b_twin"] = cuda_ms(torch, lambda: rc.recompute_backward_reference(
        tv, tid, parity, gphi, origin, dx, upper), 2)
    print(f"[{card}] {label} differentiable step: forward {times['forward']:.3f}"
          f" ms (twin R1 {times['forward_twin']:.3f} ms), forward+backward "
          f"{times['step']:.3f} ms (twin R1/R1b {times['step_twin']:.3f} ms); "
          f"R1 twin {times['r1_twin']:.3f} ms, R1b "
          f"{times['r1b']:.3f} ms (twin {times['r1b_twin']:.3f})", flush=True)
    return times


# The non-default far fields and schedules: each route's SDFConfig knobs
# and its far-field bar against the golden, in dx. Eikonal's is the
# reference's own bar for its CUDA backend (tests/test_pipeline.py:95-97).
# The golden bar is 0.2 dx; where the JAX package itself misses it on a
# route, the bar is the JAX package's gap + 0.05 dx at the 256^3 golden
# that this smoke holds the route to (tools/jax_far_field_gaps.py, on the
# CPU): the capped ladder (hop 8) reads 0.2474 dx there, the flat ladder
# with 2 polish rounds 0.2004 dx (PERF.md section 6).
ROUTES = (
    ("propagate", dict(far_field="propagate"), 0.2),
    ("eikonal", dict(far_field="eikonal"), 25.0),
    ("capped", dict(vdt_max_hop=8), 0.2474 + 0.05),
    ("flat", dict(vdt_extra_rounds=2), 0.2004 + 0.05),
    ("tiles4x4x16", dict(tile_shape=(4, 4, 16)), 0.2),
)
# the flat ladder at 512^3 (the Gauss-Seidel axis rounds' memory case)
ROUTE_512 = ("flat512", dict(vdt_extra_rounds=4), 0.2)


def route_counters():
    """The launch counters a route can move: K2 (two launches), K3, K4,
    R1's table and cells, R1b."""
    from sdfgenfast_tpu_torch.ops import band_kernel, recompute, vdt_kernel

    return (band_kernel.band_coefs, band_kernel.band_rows,
            vdt_kernel.round_phase, vdt_kernel.chamfer,
            recompute.recompute_terms, recompute.recompute_forward,
            recompute.recompute_backward)


def route_launches(config, grid_shape, num_tris):
    """The launches one call of a route must make: K2 at 8^3 tiles in exact
    mode, K3 once per Jacobi round of the schedule (the pyramid: 19 at
    256^3), K4 in exact mode, R1 in propagate and eikonal mode."""
    from sdfgenfast_tpu_torch.ops import recompute, vdt
    from sdfgenfast_tpu_torch.pipeline import ladder_schedule, reads_csr

    exact = config.far_field == "exact"
    sched = ladder_schedule(config, grid_shape) if exact else None
    if not exact:
        k3 = 0
    elif sched is None:
        # the pyramid: the coarsest level's ladder, the middle levels'
        # repair rounds, the finest level's and its 2 polish rounds
        shapes = vdt.pyramid_level_shapes(grid_shape)
        k3 = len(vdt.stride_ladder(max(shapes[-1]), extra_rounds=1))
        if len(shapes) > 1:
            k3 += ((len(shapes) - 2) * len(vdt.PYRAMID_COARSE_ROUNDS)
                   + len(vdt.PYRAMID_LEVEL_ROUNDS) + 2)
    else:
        strides, jacobi = sched
        k3 = sum(1 for st in strides if jacobi or st in (2, 4))
    k2 = int(reads_csr(config))
    r1 = int(not exact)
    return {"band_coefs": k2, "band_rows": k2, "round_phase": k3,
            "chamfer": int(exact),
            "recompute_terms": r1 * int(
                recompute.r1_config(num_tris)[0] == "shared"),
            "recompute_forward": r1, "recompute_backward": 0}


def far_field_routes(torch, device, card, path, mesh, grid, golden, far_key,
                     stride, routes=ROUTES, sample_n=512):
    """Each route through ``generate_from_file`` (``far_field`` and
    ``config``) on the card: counters set to 0 just before the call and
    checked just after (:func:`route_launches`), the golden's bars (signs,
    band, far field below the route's bar), and the exact sample never
    undercut (every route but eikonal, whose far field is an estimate from
    below). Returns {route: results}."""
    from sdfgenfast_tpu_torch import generate_from_file
    from sdfgenfast_tpu_torch.pipeline import SDFConfig

    counters = route_counters()
    sample = exact_sample(mesh, grid, sample_n)
    out = {}
    for name, knobs, bar in routes:
        config = SDFConfig(**knobs)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        sdf, _ = generate_from_file(path, nx=grid.shape[0] - 2, device=device,
                                    far_field=config.far_field, config=config)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counters}
        want = route_launches(config, grid.shape, len(mesh.tris))
        if got != want:
            raise AssertionError(f"route {name} {grid.shape}: launches {got}, "
                                 f"want {want}")
        far = check_golden(sdf, os.path.join(GOLDENS, golden), far_key,
                           stride, grid, far_bar=bar)
        above = (None if config.far_field == "eikonal" else
                 check_never_below(f"route {name}", sdf, sample, grid.dx))
        out[name] = {"far_err_dx": far, "sample_above_dx": above,
                     "launches": got, "cold_s": cold, "config": config}
        print(f"route {name} {grid.shape} on the card: golden bars met (0 sign"
              f" mismatches, band rtol 5e-5, far field {far:.4f} dx < {bar} "
              f"dx)" + ("" if above is None else
                        f", the exact sample never undercut (at most "
                        f"{above:.4f} dx above)")
              + f", cold call {cold:.3f} s, launches {got}", flush=True)
    return out


def routes_card_vs_cpu(torch, device):
    """Every route, the default (pyramid) route included, on icosphere(4)
    (5120 triangles) at 64^3 on the card and on the CPU twins, from one
    binning: the CPU tests' bars (0 sign mismatches off the surface, the
    band at rtol 5e-5, every cell within 0.05 dx; eikonal rtol 1e-5), then
    every cell bit-equal (each operation is correctly rounded on both
    sides: no FMA contraction, correctly rounded roots and divisions).
    Returns {route: cells not bit-equal}."""
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.mesh import icosphere
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, bin_mesh, make_level_set3

    mesh = icosphere(4, radius=1.0, center=(0.03, -0.02, 0.01))
    grid = sizing_mode2a_proportional(*mesh.bounds(), 64, 1)
    if grid.shape != (64, 64, 64):
        raise AssertionError(f"card vs CPU grid {grid.shape}")
    counters = route_counters()
    out = {}
    for name, knobs, _ in (("default", {}, 0.2),) + ROUTES:
        config = SDFConfig(**knobs)
        binned = bin_mesh(mesh, grid, config)
        for fn in counters:
            fn.launches = 0
        card_phi = make_level_set3(mesh, grid, config, binned,
                                   device=device).cpu().numpy()
        got = {fn.__name__: fn.launches for fn in counters}
        want = route_launches(config, grid.shape, len(mesh.tris))
        if got != want:
            raise AssertionError(f"route {name} 64^3: launches {got}, want "
                                 f"{want}")
        t0 = time.perf_counter()
        cpu_phi = make_level_set3(mesh, grid, config, binned,
                                  device="cpu").numpy()
        cpu_s = time.perf_counter() - t0
        a, b = np.abs(card_phi), np.abs(cpu_phi)
        mism = int((((card_phi < 0) != (cpu_phi < 0))
                    & (np.minimum(a, b) > 1e-5)).sum())
        if mism:
            raise AssertionError(f"route {name} 64^3: {mism} sign mismatches "
                                 f"card vs CPU")
        near = b < 2 * grid.dx
        np.testing.assert_allclose(a[near], b[near], rtol=5e-5, atol=2e-6,
                                   err_msg=f"route {name} band card vs CPU")
        err = float(np.abs(card_phi - cpu_phi).max())
        if config.far_field == "eikonal":
            np.testing.assert_allclose(card_phi, cpu_phi, rtol=1e-5,
                                       atol=1e-6,
                                       err_msg="eikonal card vs CPU")
        elif not err <= 0.05 * grid.dx:
            raise AssertionError(f"route {name} 64^3: card vs CPU "
                                 f"{err / grid.dx:.4f} dx")
        bit = int((card_phi.view(np.int32) != cpu_phi.view(np.int32)).sum())
        out[name] = bit
        print(f"route {name} icosphere(4) 64^3, card vs CPU twins: 0 sign "
              f"mismatches, band equal, max |diff| {err / grid.dx:.2e} dx, "
              f"{bit} of {card_phi.size} cells not bit-equal; launches "
              f"{got}; the CPU run {cpu_s:.1f} s", flush=True)
    if any(out.values()):
        raise AssertionError(f"card vs CPU twins at 64^3: cells not "
                             f"bit-equal by route {out}")
    return out


def mode_train_steps(torch, device, mesh, grid):
    """One ``SDFGenerator.train_step`` in propagate and in eikonal mode
    (counters set to 0 just before the step): R1 and R1b launch, the loss
    is finite, and the step's vertex gradient (R1b) agrees with its
    autograd twin's within 1e-4 of the largest. Returns {mode: launches}."""
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.ops import recompute as rc
    from sdfgenfast_tpu_torch.pipeline import SDFConfig

    out = {}
    for mode in ("propagate", "eikonal"):
        model = SDFGenerator(mesh, grid, SDFConfig(far_field=mode),
                             device=device)
        v0 = model.params
        with torch.no_grad():
            target = model.forward(v0 * 0.95)
        counters = route_counters()
        for fn in counters:
            fn.launches = 0
        new, loss = model.train_step(v0, target, lr=1e-2)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        if not (np.isfinite(float(loss)) and float(loss) > 0):
            raise AssertionError(f"{mode} step: loss {float(loss)}")
        if not bool(torch.isfinite(new).all()) or torch.equal(new, v0):
            raise AssertionError(f"{mode} step: the vertices did not move")
        if launches["recompute_forward"] < 1 or launches[
                "recompute_backward"] < 1:
            raise AssertionError(f"{mode} step: R1/R1b launches {launches}")
        # the same gradient with R1/R1b swapped for their twins
        grads = []
        kernels = (rc.recompute_forward, rc.recompute_backward)
        for twins in (False, True):
            if twins:
                rc.recompute_forward = rc.recompute_forward_reference
                rc.recompute_backward = rc.recompute_backward_reference
            try:
                v = v0.clone().requires_grad_()
                (g,) = torch.autograd.grad(model.loss(v, target), v)
            finally:
                rc.recompute_forward, rc.recompute_backward = kernels
            grads.append(g.double())
        scale = float(grads[1].abs().max())
        err = float((grads[0] - grads[1]).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            raise AssertionError(f"{mode} step: R1b vs twin {err:.3e} of "
                                 f"{scale:.3e}")
        out[mode] = launches
        print(f"SDFGenerator.train_step far_field={mode!r} {grid.shape}: loss "
              f"{float(loss):.6e}, launches {launches}; vertex gradient vs "
              f"the twins' {err / scale:.2e} of max|g| {scale:.3e}",
              flush=True)
    return out


def stream_ms(torch, targets, fn):
    """Run fn() with each (module, attribute, label) of `targets` wrapped in
    a pair of CUDA events; returns ({label: summed elapsed ms on the
    stream}, {label: the last call's result}). The elapsed time is device
    time plus the gaps the host leaves inside a host-bound torch module."""
    real, events, results = [], {}, {}

    def wrap(f, label):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = f(*args, **kwargs)
            end.record()
            events.setdefault(label, []).append((start, end))
            results[label] = result
            return result
        return timed

    for mod, attr, label in targets:
        real.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr), label))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for mod, attr, f in real:
            setattr(mod, attr, f)
    return ({label: sum(a.elapsed_time(b) for a, b in ev)
             for label, ev in events.items()}, results)


def route_times(torch, device, card, mesh, grid, routes, calls=3):
    """For each route: the wall per call (median of `calls` warm calls),
    split into host (``bin_mesh``), device (``make_level_set3``,
    synchronised) and copy back (``upload.to_host``; the old
    ``.cpu().numpy()`` beside it, outside the wall); the stream time of
    the torch modules (tile evaluator, band_distance_field, Gauss-Seidel
    rounds, plane scans, eikonal, the device parity) in one more call; and
    peak device memory."""
    from sdfgenfast_tpu_torch.ops import band as band_ops
    from sdfgenfast_tpu_torch.ops import sign as sign_ops
    from sdfgenfast_tpu_torch.ops import sweep as sweep_ops
    from sdfgenfast_tpu_torch.ops import tiled as tiled_ops
    from sdfgenfast_tpu_torch.ops import vdt as vdt_ops
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, bin_mesh, make_level_set3
    from sdfgenfast_tpu_torch.upload import to_host

    modules = ((tiled_ops, "tile_candidate_rows", "tile evaluator"),
               (tiled_ops, "closest_point_rows", "tile evaluator"),
               (band_ops, "band_distance_field", "band_distance_field"),
               (vdt_ops, "_gs_round", "Gauss-Seidel rounds"),
               (vdt_ops, "_gs_axes_round", "Gauss-Seidel rounds"),
               (sweep_ops, "propagate_closest_triangles", "plane scans"),
               (sweep_ops, "eikonal_far_field", "eikonal"),
               (sign_ops, "parity_field", "device parity"))
    out = {}
    for name, knobs, _ in routes:
        config = SDFConfig(**knobs)
        stages = {"host": [], "device": [], "copy back": [], "wall": [],
                  "old copy back": []}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(calls):
            t0 = time.perf_counter()
            binned = bin_mesh(mesh, grid, config)
            t1 = time.perf_counter()
            phi = make_level_set3(mesh, grid, config, binned, device=device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            to_host(phi)
            t3 = time.perf_counter()
            phi.cpu().numpy()
            t4 = time.perf_counter()
            for key, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t3 - t0,
                                       t4 - t3)):
                stages[key].append(v * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del phi
        mods, res = stream_ms(torch, modules, lambda: make_level_set3(
            mesh, grid, config, binned, device=device))
        med = {k: statistics.median(v) for k, v in stages.items()}
        out[name] = dict(med, modules=mods, peak_gib=peak)
        if "plane scans" in res:
            out[name]["passes"] = res["plane scans"][2]
        print(f"[{card}] route {name} {grid.shape}: wall {med['wall']:.1f} ms "
              f"(median of {calls} warm calls; min {min(stages['wall']):.1f})"
              f" = host bin_mesh {med['host']:.1f} + device make_level_set3 "
              f"{med['device']:.1f} + copy back {med['copy back']:.1f} ms "
              f"(.cpu().numpy() {med['old copy back']:.1f} ms); "
              f"peak device memory {peak:.2f} GiB; stream time of the torch "
              f"modules: " + (", ".join(f"{k} {v:.2f} ms" for k, v in
                                        mods.items()) or "none")
              + (f" ({out[name]['passes']} passes)" if "passes" in out[name]
                 else ""), flush=True)
    return out


# The device sign (sign_mode="device", ops/sign.py): every launch counter a
# path of this phase can move
def sign_counters():
    from sdfgenfast_tpu_torch.ops import dense

    return route_counters() + (dense.dense_stream,)


def host_parity_on_card(torch, device, binned, ni):
    """The host sign's parity as the port's host path builds it on the card:
    the host transport uploaded and decoded by the sign kernel's decode
    (``ops/sign_kernel.parity_sign``)."""
    from sdfgenfast_tpu_torch.ops.sign_kernel import parity_sign

    data = (binned.parity_packed if binned.parity_packed is not None
            else binned.parity_crossings)
    return parity_sign(torch.from_numpy(data).to(device), ni)


def device_parity(torch, device, sign, grid, chunk, arrays=None):
    """``ops/sign.parity_field`` on the card from a device-mode binning's
    SignBinning (`arrays`: its tensors, uploaded once by the caller)."""
    from sdfgenfast_tpu_torch.ops import sign as sign_ops

    if arrays is None:
        arrays = sign_arrays(torch, device, sign)
    return sign_ops.parity_field(*arrays, sign.tile_shape, sign.tiles_dim,
                                 grid.shape, chunk=chunk)


def sign_arrays(torch, device, sign):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (sign.f, sign.window, sign.active_ids, sign.cand,
                      sign.cand_valid)]


def median_event_ms(torch, fn, calls=WARM_CALLS):
    """Median device time of fn() over `calls` warm calls, one pair of CUDA
    events around each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sign_cases(grids, cases, box, box_grid):
    """(label, mesh, grid, knobs, run, golden check) of each device-sign
    case at bench.py's sizes: box36 at its main-path grid (dense, K1),
    sphere82k at 256^3 and 512^3 (binned: K2, K3, K4), eikonal at 256^3
    (R1). `run(config)` calls the entry point a user would call; the
    golden check returns the far-field gap in dx (None: no golden)."""
    from sdfgenfast_tpu_torch import generate_from_file, generate_sdf

    out = [("box36", box, box_grid, {},
            lambda device, cfg: generate_sdf(
                box.verts, box.tris, box_grid.origin, box_grid.dx,
                *box_grid.shape, device=device, config=cfg), None)]
    for n, label, knobs, bar in ((256, "sphere82k 256^3", {}, 0.2),
                                 (512, "sphere82k 512^3", {}, 0.2),
                                 (256, "eikonal sphere82k 256^3",
                                  dict(far_field="eikonal"), 25.0)):
        mesh, grid = grids[n]
        path = os.path.join(RESOURCES, cases[n][0])
        golden, far_key, stride = cases[n][1:]

        def run(device, cfg, path=path, n=n):
            sdf, _ = generate_from_file(path, nx=n - 2, device=device,
                                        far_field=cfg.far_field, config=cfg)
            return sdf

        def check(sdf, grid=grid, golden=golden, far_key=far_key,
                  stride=stride, bar=bar):
            return check_golden(sdf, os.path.join(GOLDENS, golden), far_key,
                                stride, grid, far_bar=bar)

        out.append((label, mesh, grid, knobs, run, check))
    return out


def device_sign_phase(torch, device, card, grids, cases, box, box_grid):
    """The device sign on the card, each case at bench.py's sizes
    (:func:`sign_cases`): the device parity bit-equal on every cell to the
    host parity as the host path builds it on the card; the entry point's
    SDF in device mode bit-equal to host mode's, with the same launches
    of every kernel (counters set to 0 just before each call); the golden
    bars where the case has a golden, and the box CLI golden in device
    mode; the device parity makes no host sync. Returns {label:
    results}."""
    from sdfgenfast_tpu_torch import generate_sdf
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.io import mesh_io
    from sdfgenfast_tpu_torch.ops import dense
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, bin_mesh

    counters = sign_counters()
    out = {}
    for label, mesh, grid, knobs, run, check in sign_cases(grids, cases, box,
                                                           box_grid):
        host_cfg = SDFConfig(**knobs)
        dev_cfg = SDFConfig(sign_mode="device", **knobs)
        bh = bin_mesh(mesh, grid, host_cfg)
        bd = bin_mesh(mesh, grid, dev_cfg)
        ph = host_parity_on_card(torch, device, bh, grid.shape[0])
        # no host sync inside the field (its inputs uploaded first), so
        # generate_sdf_batch's host binning of the next mesh overlaps it
        arrays = sign_arrays(torch, device, bd.sign)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pd = device_parity(torch, device, bd.sign, grid,
                               dev_cfg.sign_chunk, arrays)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        del arrays
        differ = int((ph != pd).sum())
        if differ or pd.dtype != torch.bool or pd.shape != ph.shape:
            raise AssertionError(f"device sign {label}: the device parity "
                                 f"differs from the host parity on {differ} "
                                 f"cells")
        inside = int(pd.sum())
        del ph, pd
        sdfs, launches = {}, {}
        for mode, cfg in (("host", host_cfg), ("device", dev_cfg)):
            for fn in counters:
                fn.launches = 0
            sdfs[mode] = run(device, cfg)
            torch.cuda.synchronize()
            launches[mode] = {fn.__name__: fn.launches for fn in counters}
        if launches["device"] != launches["host"]:
            raise AssertionError(f"device sign {label}: launches "
                                 f"{launches['device']}, host mode "
                                 f"{launches['host']}")
        need = (("recompute_forward",) if knobs.get("far_field") == "eikonal"
                else ("dense_stream",) if label == "box36" else
                ("band_coefs", "band_rows", "round_phase", "chamfer"))
        if any(launches["device"][k] < 1 for k in need):
            raise AssertionError(f"device sign {label}: launches "
                                 f"{launches['device']}, need {need}")
        a, b = sdfs["device"], sdfs["host"]
        if a.shape != grid.shape or not np.isfinite(a).all():
            raise AssertionError(f"device sign {label}: bad output")
        differ = int((a.view(np.int32) != b.view(np.int32)).sum())
        if differ:
            raise AssertionError(f"device sign {label}: the SDF differs from "
                                 f"host mode's on {differ} cells")
        far = None if check is None else check(a)
        out[label] = {"launches": launches["device"], "far_err_dx": far,
                      "K": int(bd.sign.cand.shape[1]),
                      "A": int((bd.sign.active_ids
                                < np.prod(bd.sign.tiles_dim)).sum()),
                      "A_pad": int(len(bd.sign.active_ids)),
                      "mesh": mesh, "grid": grid, "knobs": knobs}
        print(f"device sign {label} {grid.shape}: parity bit-equal to the "
              f"host parity on all {a.size} cells ({inside} inside); SDF "
              f"bit-equal to host mode's; launches as host mode's "
              f"{launches['device']}"
              + ("" if far is None else
                 f"; golden bars met (0 sign mismatches, band rtol 5e-5, "
                 f"far field {far:.4f} dx)")
              + f"; 2D sign tiles {bd.sign.tile_shape}: "
              f"{out[label]['A']} active of {int(np.prod(bd.sign.tiles_dim))}"
              f" (padded to {out[label]['A_pad']}), K = {out[label]['K']}",
              flush=True)
    # the box CLI golden (box345.stl, mode 2a at 64) in device mode
    with open(os.path.join(GOLDENS, "manifest.json")) as fh:
        entry = json.load(fh)["box_stl_64_mode2a"]
    m, mn, mx = mesh_io.load_mesh(os.path.join(RESOURCES, entry["mesh"]))
    grid = sizing_mode2a_proportional(mn, mx, int(entry["cli_args"][0]),
                                      int(entry["cli_args"][1]))
    dense.dense_stream.launches = 0
    phi = generate_sdf(m.verts, m.tris, grid.origin, grid.dx, *grid.shape,
                       device=device, config=SDFConfig(sign_mode="device"))
    if dense.dense_stream.launches != 1:
        raise AssertionError("device sign box golden: K1 did not launch once")
    far = golden_bars(phi, grid, os.path.join(GOLDENS, entry["golden"]))
    out["box_stl_64"] = {"far_err_dx": far}
    print(f"device sign box_stl_64_mode2a {phi.shape}: golden bars met (0 "
          f"sign mismatches, band rtol 5e-5, far field {far:.4f} dx)",
          flush=True)
    return out


def device_sign_steps(torch, device, grids, box, box_grid):
    """One ``SDFGenerator.train_step`` in device sign mode on box36 and on
    sphere82k at 256^3 beside the host mode's, from one target (the
    host-mode forward of the 0.95-scaled vertices): R1 and R1b launch,
    and the loss and the vertex gradient agree within R1b's bar (1e-4 of
    the largest vertex gradient). Returns {label: results}."""
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.pipeline import SDFConfig

    counters = sign_counters()
    out = {}
    for label, mesh, grid in (("box36", box, box_grid),
                              ("sphere82k 256^3", *grids[256])):
        target = None
        res = {}
        for mode in ("host", "device"):
            model = SDFGenerator(mesh, grid, SDFConfig(sign_mode=mode),
                                 device=device)
            v0 = model.params
            if target is None:
                with torch.no_grad():
                    target = model.forward(v0 * 0.95)
            for fn in counters:
                fn.launches = 0
            new, loss = model.train_step(v0, target, lr=1e-2)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            v = v0.clone().requires_grad_()
            (g,) = torch.autograd.grad(model.loss(v, target), v)
            res[mode] = (float(loss), g.double(), launches, new)
        (lh, gh, nh, _), (ld, gd, nd, new) = res["host"], res["device"]
        scale = float(gh.abs().max())
        err = float((gd - gh).abs().max())
        if nd != nh or nd["recompute_forward"] < 1 or nd[
                "recompute_backward"] < 1:
            raise AssertionError(f"device sign step {label}: launches {nd}, "
                                 f"host mode {nh}")
        if not (scale > 0 and err <= 1e-4 * scale and abs(ld - lh)
                <= 1e-4 * abs(lh) and bool(torch.isfinite(new).all())):
            raise AssertionError(f"device sign step {label}: loss {ld} vs "
                                 f"{lh}, gradient {err:.3e} of {scale:.3e}")
        out[label] = {"loss": ld, "grad_err": err / scale, "launches": nd,
                      "bit_equal": err == 0.0 and ld == lh}
        print(f"device sign SDFGenerator.train_step {label}: loss {ld:.6e} "
              f"(host mode {lh:.6e}), vertex gradient within {err / scale:.2e}"
              f" of max|g| {scale:.3e} of the host mode's"
              f"{' (bit-equal)' if out[label]['bit_equal'] else ''}; "
              f"launches {nd}", flush=True)
    return out


def device_sign_times(torch, device, card, phase):
    """For each case of :func:`device_sign_phase`: the device parity
    (``parity_field`` on arrays already on the card, CUDA events, median
    of 5 warm calls) and its peak memory beside the host parity it
    replaces (its transport computed on the host, then uploaded and
    expanded on the card; each part timed alike), and each sign mode's
    wall split into host, device and copy back (:func:`route_times`, the
    parity's stream time within the call among its modules)."""
    from sdfgenfast_tpu_torch.ops import sign as sign_ops
    from sdfgenfast_tpu_torch.ops.sign_kernel import parity_sign
    from sdfgenfast_tpu_torch.pipeline import (SDFConfig, _host_parity_choose,
                                               _sign_binning)

    out = {}
    for label, r in phase.items():
        if "mesh" not in r:
            continue
        mesh, grid, knobs = r["mesh"], r["grid"], r["knobs"]
        host_cfg = SDFConfig(**knobs)
        dev_cfg = SDFConfig(sign_mode="device", **knobs)
        ni = grid.shape[0]
        t = {"host_parity_host": [], "sign_binning_host": []}
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            packed, cross = _host_parity_choose(mesh, grid,
                                                host_cfg.parity_transport)
            t1 = time.perf_counter()
            sb = sign_ops.bin_triangles_2d(mesh.verts, mesh.tris, grid,
                                           dev_cfg.tile2d_shape)
            t2 = time.perf_counter()
            t["host_parity_host"].append((t1 - t0) * 1e3)
            t["sign_binning_host"].append((t2 - t1) * 1e3)
        data = packed if packed is not None else cross
        host_dev_ms = median_event_ms(torch, lambda: parity_sign(
            torch.from_numpy(data).to(device), ni))
        sb_pad = _sign_binning(mesh, grid, dev_cfg)
        upload_ms = median_event_ms(torch, lambda: sign_arrays(
            torch, device, sb_pad))
        arrays = sign_arrays(torch, device, sb_pad)
        dev_ms = median_event_ms(torch, lambda: device_parity(
            torch, device, sb_pad, grid, dev_cfg.sign_chunk, arrays))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        field = device_parity(torch, device, sb_pad, grid, dev_cfg.sign_chunk,
                              arrays)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        del field, arrays
        torch.cuda.empty_cache()
        walls = route_times(torch, device, card, mesh, grid, (
            (f"{label}, host sign", knobs, None),
            (f"{label}, device sign", dict(knobs, sign_mode="device"), None)),
            calls=WARM_CALLS)
        hp = statistics.median(t["host_parity_host"])
        sbm = statistics.median(t["sign_binning_host"])
        out[label] = {"host_parity_host_ms": hp, "host_parity_device_ms":
                      host_dev_ms, "sign_binning_host_ms": sbm,
                      "sign_upload_ms": upload_ms, "device_parity_ms": dev_ms,
                      "parity_peak_mib": peak, "walls": walls,
                      "transport": "packed" if packed is not None
                      else f"crossings ({cross.shape[0]} rows)"}
        print(f"[{card}] device sign {label} {grid.shape} (median of "
              f"{WARM_CALLS}): device parity {dev_ms:.3f} ms on the card "
              f"(2D binning {sbm:.1f} ms on the host, upload {upload_ms:.3f}"
              f" ms; K = {r['K']}, {r['A_pad']} tile rows; peak memory "
              f"{peak:.1f} MiB above the inputs) beside the host parity "
              f"{hp:.1f} ms on the host + {host_dev_ms:.3f} ms upload and "
              f"expansion on the card ({out[label]['transport']})",
              flush=True)
    return out


# -- 8. the sharded path (parallel/sharded.py) -------------------------------

SHARD_SHAPES = ((2, 2), (1, 4))


def zero_offset_times(reps=20, repeats=3):
    """The kernels that gained an offset argument, at zero offset on the
    main path's inputs (sphere82k 256^3), through entry points that older
    versions of the package have too: the whole K2 call (``band_rows``:
    fills, coefficient pass, walk), one K3 stride-1 round, R1 and R1b on
    the step's ids, parity and d loss / d phi; queued behind a spin, (min,
    median) of `repeats`. Prints the card and one JSON line; returns the
    dict. To time another checkout's package (the parent), run from that
    checkout's root: ``python3 -c "import runpy;
    runpy.run_path('<this repo>/chip_smoke.py')['zero_offset_times']()"``."""
    import torch

    from sdfgenfast_tpu_torch import load_mesh
    from sdfgenfast_tpu_torch.grid import sizing_python_api
    from sdfgenfast_tpu_torch.mesh import Mesh
    from sdfgenfast_tpu_torch.ops import band_kernel, recompute, vdt_kernel
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, make_level_set3

    device = torch.device("cuda", 0)
    v, t, bounds = load_mesh(os.path.join(RESOURCES, "icosphere6.stl"))
    mesh = Mesh(v, t)
    grid = sizing_python_api(np.asarray(bounds[0], np.float32),
                             np.asarray(bounds[1], np.float32), nx=254)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    binned = bin_mesh(mesh, grid)
    csr = binned.band_csr
    tv, tid, parity, origin, dx, upper = r1_step_inputs(torch, device, mesh,
                                                        grid)
    tri9 = (tv - dev(np.asarray(origin, np.float32))).reshape(-1, 9)
    tri9 = tri9.contiguous()
    args = (tri9, *(dev(csr[k]) for k in ("pair", "ids", "off", "cnt")), dx)
    kw = dict(tiles_dim=binned.tiles_dim, grid_shape=grid.shape)
    st = seeded_state(torch, grid.shape, dx, 3, device)
    phi = recompute.recompute_forward(tv, tid, parity, origin, dx, upper)
    target = make_level_set3(mesh, grid, binned=binned, device=device,
                             verts=dev(mesh.verts) * 0.95)
    gphi = (2 * (phi - target) / phi.numel()).contiguous()
    out = {
        "band_rows call": repeats_ms(torch, lambda: band_kernel.band_rows(
            *args, **kw), reps, repeats),
        "vdt_round stride 1": repeats_ms(torch, lambda: vdt_kernel.round_phase(
            st, dx, (1,), 1), reps, repeats),
        "recompute_phi": repeats_ms(torch, lambda: recompute.recompute_forward(
            tv, tid, parity, origin, dx, upper), reps, repeats),
        "recompute_vjp": repeats_ms(
            torch, lambda: recompute.recompute_backward(
                tv, tid, parity, gphi, origin, dx, upper), reps, repeats),
    }
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"zero_offset_ms": out, "package": os.path.dirname(
        band_kernel.__file__)}), flush=True)
    return out


def shard_counters():
    from sdfgenfast_tpu_torch.ops import band_kernel, dense, recompute, vdt_kernel

    return (band_kernel.band_coefs, band_kernel.band_rows,
            vdt_kernel.round_phase, vdt_kernel.chamfer, dense.dense_stream,
            recompute.recompute_forward, recompute.recompute_backward)


def counted(fn):
    """(fn(), {counter: launches}), every shard counter set to 0 just
    before fn and read just after."""
    counters = shard_counters()
    for c in counters:
        c.launches = 0
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def shard_schedule(config, grid_shape, dense, grad=False):
    """The launches of ONE shard in a sharded call, derived from the
    schedule: K1 1 (dense), or K2 1 + 1, K3 the coarsest ladder's strides
    <= 8 (the others run in torch) plus every repair round of the descent
    (pyramid) or one a rung (capped ladder), K4 one a chunk of passes; R1
    and R1b 1 each with a vertex gradient."""
    from sdfgenfast_tpu_torch.ops import vdt, vdt_kernel
    from sdfgenfast_tpu_torch.pipeline import ladder_schedule

    want = dict.fromkeys((c.__name__ for c in shard_counters()), 0)
    if dense:
        want["dense_stream"] = 1
    else:
        want["band_coefs"] = want["band_rows"] = 1
        ladder = ladder_schedule(config, grid_shape)
        if ladder is None:
            lshapes = vdt.pyramid_level_shapes(grid_shape)
            coarse = sum(1 for s in vdt.stride_ladder(max(lshapes[-1]),
                                                      extra_rounds=1)
                         if s <= 8)
            repair = sum(len(vdt.PYRAMID_COARSE_ROUNDS) if lvl > 0
                         else len(vdt.PYRAMID_LEVEL_ROUNDS) + 2
                         for lvl in range(len(lshapes) - 1))
            want["round_phase"] = coarse + repair
        else:
            want["round_phase"] = len(ladder[0])
        want["chamfer"] = len(vdt_kernel.chamfer_chunks(config.chamfer_passes))
    if grad:
        want["recompute_forward"] = want["recompute_backward"] = 1
    return want


def split_blocks(x, dims, lead):
    """The (Dj, Dk) grid of contiguous blocks of `x` cut along its axes
    lead and lead + 1."""
    Dj, Dk = dims
    bj, bk = x.shape[lead] // Dj, x.shape[lead + 1] // Dk
    return [[x.narrow(lead, a * bj, bj).narrow(lead + 1, b * bk, bk)
             .contiguous() for b in range(Dk)] for a in range(Dj)]


def box36_cube(n=256):
    """box36 on an n^3 grid (blocks divide over both shard meshes): the box
    centred, its longest side across n - 2 cells."""
    from sdfgenfast_tpu_torch.grid import GridSpec
    from sdfgenfast_tpu_torch.testing import box36

    box = box36()
    mn, mx = (np.asarray(b, np.float64) for b in box.bounds())
    dx = float(np.float32((mx - mn).max() / (n - 2)))
    origin = tuple(float(v) for v in (mn + mx) / 2 - dx * n / 2)
    return box, GridSpec(origin, dx, (n, n, n))


def check_offset_kernels(torch, device, mesh, grid):
    """K2, K3, R1 and R1b at the offsets the shards give them, on the card.
    K2: every shard of a (2, 2) binning of `mesh` (coordinate ids, global
    upper) bit-equal to its twin with the same ids and to the global grid's
    rows at those tiles. K3: every block of a seeded 64 x 128 x 128 state on
    (2, 2) and (1, 4) meshes, halo-extended (offsets j0 - s and k0 - s,
    negative on the first row and column), scales 1 and 2, strides 1-8:
    bit-equal to its twin on the extended block and, inside, to the round
    over the whole state. R1 at each (2, 2) block's offset: bit-equal to
    its twin and to the global R1's block. R1b at each offset, on the train
    step's d loss / d phi: within 1e-4 of its twin's largest vertex
    gradient, two runs bit-equal. Returns the
    largest error of each."""
    from sdfgenfast_tpu_torch.ops import band_kernel, recompute as rc, vdt_kernel
    from sdfgenfast_tpu_torch.parallel import sharded as sh
    from sdfgenfast_tpu_torch.ops.sign_kernel import parity_sign
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, make_level_set3

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dx = float(np.float32(grid.dx))
    origin = tuple(float(v) for v in np.asarray(grid.origin, np.float32))
    binned = bin_mesh(mesh, grid)
    tv = dev(mesh.verts)[dev(binned.tris).long()]
    tri9 = (tv - dev(np.asarray(origin, np.float32))).reshape(-1, 9).contiguous()
    g = binned.band_csr
    glob = band_kernel.band_rows(
        tri9, *(dev(g[k]) for k in ("pair", "ids", "off", "cnt")), dx,
        tiles_dim=binned.tiles_dim, grid_shape=grid.shape)
    sb = sh.bin_mesh_sharded(mesh, grid, (2, 2))
    T = int(np.prod(sb.band_tiles_local))
    k2_words = k2_tiles = 0
    for dj, dk in np.ndindex(2, 2):
        args = (tri9, dev(sb.csr_pair[dj, dk]), dev(sb.band_ids[dj, dk]),
                dev(sb.csr_off[dj, dk]), dev(sb.csr_cnt[dj, dk]), dx)
        kw = dict(tiles_dim=sb.band_tiles_local, grid_shape=sb.block,
                  coord_ids=dev(sb.band_gids[dj, dk]),
                  coord_tiles_dim=sb.band_tiles_global,
                  coord_grid_shape=grid.shape)
        got = band_kernel.band_rows(*args, **kw)
        want = band_kernel.band_rows_reference(*args, **kw)
        keep = sb.band_ids[dj, dk] < T
        live = dev(sb.band_ids[dj, dk][keep]).long()
        gl = dev(sb.band_gids[dj, dk][keep]).long()
        for x, y, z in zip(got, want, glob):
            k2_words += int((bits(torch, x[:T]) != bits(torch, y[:T])).sum())
            k2_words += int((bits(torch, x[live]) != bits(torch, z[gl])).sum())
        k2_tiles += len(live)
    torch.cuda.synchronize()
    if k2_words:
        raise AssertionError(f"K2 with coordinate ids: {k2_words} words "
                             "differ from its twin or the global rows")
    print(f"K2 with coordinate ids on the (2, 2) shards of {grid.shape}: "
          f"{k2_tiles} active tiles, every row word bit-equal to the twin's "
          f"and to the global rows", flush=True)

    st = seeded_state(torch, (64, 128, 128), dx, 12, device)
    k3_rounds = negative = 0
    for dims in ((2, 2), (1, 4)):
        blocks = split_blocks(st, dims, 2)
        bj, bk = 128 // dims[0], 128 // dims[1]
        for scale in (1, 2):
            for s in (1, 2, 3, 4, 8):
                full = vdt_kernel.round_phase(st, dx, (s,), scale)
                ext = sh._state_halo_extend(
                    sh.LocalTransport(np.full(dims, device)), blocks, s)
                for a, b in np.ndindex(*dims):
                    off = (0, a * bj - s, b * bk - s)
                    got = vdt_kernel.round_phase(ext[a][b], dx, (s,), scale,
                                                 pos_offset=off)
                    want = vdt_kernel.round_phase_reference(
                        ext[a][b], dx, (s,), scale, pos_offset=off)
                    inner = full[:, :, a * bj:(a + 1) * bj,
                                 b * bk:(b + 1) * bk]
                    if not (torch.equal(bits(torch, got), bits(torch, want))
                            and torch.equal(bits(torch, got[:, :, s:-s, s:-s]),
                                            bits(torch, inner))):
                        raise AssertionError(
                            f"K3 at offset {off} (mesh {dims}, scale "
                            f"{scale}, stride {s}) differs")
                    k3_rounds += 1
                    negative += min(off) < 0
    print(f"K3 at shard offsets: {k3_rounds} rounds ({negative} with a "
          f"negative offset) bit-equal to the twin on the extended block "
          f"and, inside, to the round over the whole state", flush=True)

    phi1, tid1 = make_level_set3(mesh, grid, binned=binned, device=device,
                                 return_tid=True)
    parity = parity_sign(dev(binned.parity_packed
                             if binned.parity_packed is not None
                             else binned.parity_crossings), grid.shape[0])
    upper = float(np.float32(sum(grid.shape)) * np.float32(dx))
    full = rc.recompute_forward(tv, tid1, parity, origin, dx, upper)
    # R1b's input on the main path: the train step's d loss / d phi, its
    # target the field of the 0.95-scaled vertices
    target = make_level_set3(mesh, grid, binned=binned, device=device,
                             verts=dev(mesh.verts) * 0.95)
    gphi_b = split_blocks(2 * (full - target) / full.numel(), (2, 2), 1)
    r1b_err = 0.0
    tris = dev(mesh.tris.astype(np.int64))
    tid_b, par_b = split_blocks(tid1, (2, 2), 1), split_blocks(parity, (2, 2), 1)
    full_b = split_blocks(full, (2, 2), 1)
    bj, bk = grid.shape[1] // 2, grid.shape[2] // 2
    for a, b in np.ndindex(2, 2):
        off = (0, a * bj, b * bk)
        args = (tv, tid_b[a][b], par_b[a][b])
        got = rc.recompute_forward(*args, origin, dx, upper, ijk_offset=off)
        want = rc.recompute_forward_reference(*args, origin, dx, upper,
                                              ijk_offset=off)
        if not (torch.equal(bits(torch, got), bits(torch, want))
                and torch.equal(bits(torch, got), bits(torch, full_b[a][b]))):
            raise AssertionError(f"R1 at offset {off} differs")
        bargs = (*args, gphi_b[a][b], origin, dx, upper)
        g1 = rc.recompute_backward(*bargs, ijk_offset=off)
        g2 = rc.recompute_backward(*bargs, ijk_offset=off)
        gt = rc.recompute_backward_reference(*bargs, ijk_offset=off)
        if not torch.equal(bits(torch, g1), bits(torch, g2)):
            raise AssertionError(f"R1b at offset {off}: two runs differ")
        gv, gvt = (vertex_grad(torch, tris, x, len(mesh.verts))
                   for x in (g1, gt))
        scale = float(gvt.abs().max())
        err = float((gv - gvt).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            raise AssertionError(f"R1b at offset {off}: max err {err:.3e} "
                                 f"vs 1e-4 * {scale:.3e}")
        r1b_err = max(r1b_err, err / scale)
    torch.cuda.synchronize()
    print(f"R1 at the (2, 2) shard offsets of {grid.shape}: bit-equal to its "
          f"twin and to the global R1's blocks; R1b there within "
          f"{r1b_err:.2e} of its twin's largest vertex gradient, two runs "
          f"bit-equal", flush=True)
    return {"band_rows": 0.0, "vdt_round": 0.0, "recompute_phi": 0.0,
            "recompute_vjp": r1b_err}


def sharded_cases(grids, cases, box, box_grid):
    """(label, mesh, grid, knobs, mesh shapes, golden) of each sharded case:
    sphere82k at 256^3 (both meshes) and 512^3 (the full-width run, against
    its golden), the capped ladder and the device sign at 256^3, box36 on a
    256^3 grid (dense shards, K1 at offsets)."""
    return (
        ("sphere82k 256^3", *grids[256], {}, SHARD_SHAPES, cases[256]),
        ("sphere82k 512^3", *grids[512], {}, ((2, 2),), cases[512]),
        ("capped hop 8, sphere82k 256^3", *grids[256], {"vdt_max_hop": 8},
         ((2, 2),), None),
        ("device sign, sphere82k 256^3", *grids[256],
         {"sign_mode": "device"}, ((2, 2),), None),
        ("box36 256^3", box, box_grid, {}, SHARD_SHAPES, None),
    )


def sharded_phase(torch, device, grids, cases, box, box_grid):
    """Every sharded case through ``parallel.sharded_sdf`` on
    ``["cuda:0"] * 4``: phi and ids bit-equal to the single-device card run
    (``make_level_set3``), each counter at 4 x the schedule's count for a
    shard (``shard_schedule``), the 512^3 run within its golden's bars.
    Returns ({label: {mesh shape: launches}}, {label: the (2, 2) run's
    :func:`digest`})."""
    from sdfgenfast_tpu_torch.parallel import (bin_mesh_sharded,
                                               make_device_mesh, sharded_sdf)
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, make_level_set3, use_dense

    meshes = {s: make_device_mesh([device] * 4, s) for s in SHARD_SHAPES}
    out, digests = {}, {}
    for label, mesh, grid, knobs, shapes, golden in sharded_cases(
            grids, cases, box, box_grid):
        cfg = SDFConfig(**knobs)
        want_phi, want_tid = make_level_set3(mesh, grid, cfg, device=device,
                                             return_tid=True)
        per_shard = shard_schedule(cfg, grid.shape,
                                   use_dense(cfg, len(mesh.tris)))
        for shape in shapes:
            sb = bin_mesh_sharded(mesh, grid, shape, cfg)
            (phi, tid), launches = counted(lambda: sharded_sdf(
                sb, meshes[shape], verts=mesh.verts, return_tid=True))
            torch.cuda.synchronize()
            bad = (int((bits(torch, phi) != bits(torch, want_phi)).sum()),
                   int((tid != want_tid).sum()))
            if bad != (0, 0):
                raise AssertionError(f"sharded {label} on {shape}: {bad[0]} "
                                     f"phi and {bad[1]} id cells differ from "
                                     "the single-device run")
            want = {k: 4 * v for k, v in per_shard.items()}
            if launches != want:
                raise AssertionError(f"sharded {label} on {shape}: launches "
                                     f"{launches}, the schedule gives {want}")
            far = ""
            if golden is not None:
                mesh_name, gold, far_key, stride = golden
                far = check_golden(phi.cpu().numpy(),
                                   os.path.join(GOLDENS, gold), far_key,
                                   stride, grid)
                far = f"; golden bars met, far field {far:.4f} dx"
            out.setdefault(label, {})[f"{shape[0]}x{shape[1]}"] = launches
            if shape == (2, 2):
                digests[label] = digest(phi)
            print(f"sharded {label} on {shape} x cuda:0: phi and ids "
                  f"bit-equal to the single-device run; launches a shard "
                  f"{per_shard} (x 4 = counted){far}", flush=True)
    return out, digests


def sharded_steps(torch, device, grids, box, box_grid):
    """``SDFGenerator(device_mesh=...)`` against ``SDFGenerator(device=...)``
    on sphere82k 256^3 and box36 256^3 ((2, 2) mesh): the loss bit-equal,
    the vertex gradient within 1e-4 of its largest component, two sharded
    gradients bit-equal, the launches 4 x the schedule's for a shard, and
    one ``train_step`` through the entry point equal to verts - lr * g."""
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.parallel import make_device_mesh
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, use_dense

    dm = make_device_mesh([device] * 4, (2, 2))
    out = {}
    for label, mesh, grid in (("sphere82k 256^3", *grids[256]),
                              ("box36 256^3", box, box_grid)):
        single = SDFGenerator(mesh, grid, device=device)
        shard = SDFGenerator(mesh, grid, device_mesh=dm)
        target = single.forward(single.params * 0.95).detach()

        def grad(model):
            v = model.params.requires_grad_(True)
            loss = model.loss(v, target)
            return loss.detach(), torch.autograd.grad(loss, v)[0]

        l1, g1 = grad(single)
        (ls, gs), launches = counted(lambda: grad(shard))
        _, gs2 = grad(shard)
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, gs), bits(torch, gs2)):
            raise AssertionError(f"sharded step {label}: two gradients differ")
        if not torch.equal(bits(torch, ls), bits(torch, l1)):
            raise AssertionError(f"sharded step {label}: loss {float(ls)} != "
                                 f"{float(l1)}")
        scale = float(g1.abs().max())
        err = float((gs - g1).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            raise AssertionError(f"sharded step {label}: gradient max err "
                                 f"{err:.3e} vs 1e-4 * {scale:.3e}")
        want = {k: 4 * v for k, v in shard_schedule(
            SDFConfig(), grid.shape, use_dense(SDFConfig(), len(mesh.tris)),
            grad=True).items()}
        if launches != want:
            raise AssertionError(f"sharded step {label}: launches {launches},"
                                 f" the schedule gives {want}")
        lr = 1e-2
        new, _ = shard.train_step(shard.params, target, lr=lr)
        if not torch.equal(bits(torch, new),
                           bits(torch, shard.params - np.float32(lr) * gs)):
            raise AssertionError(f"sharded train_step {label}: verts - lr * g "
                                 "differs")
        out[label] = {"launches": launches, "grad_err": err / scale}
        print(f"sharded SDFGenerator {label} on (2, 2) x cuda:0: loss "
              f"{float(ls):.6e} bit-equal to the single device's, gradient "
              f"within {err / scale:.2e} of max|g| = {scale:.3e}, two runs "
              f"bit-equal, launches {launches}; train_step = verts - lr g",
              flush=True)
    return out


def sharded_times(torch, device, card, grids, box, box_grid):
    """Wall per call of ``generate_sdf_batch`` (one mesh: host binning,
    device, copy back) with ``device_mesh`` ((2, 2) x cuda:0) against the
    single device, median of 3 warm calls; the halo exchange's device time
    in one sharded call (CUDA events around every
    ``sharded.LocalTransport.extend``);
    peak device memory of one call each. One card runs the four shards one
    after another: no speed-up is possible or claimed."""
    from sdfgenfast_tpu_torch import generate_sdf_batch
    from sdfgenfast_tpu_torch.parallel import (bin_mesh_sharded,
                                               make_device_mesh, sharded_sdf)
    from sdfgenfast_tpu_torch.parallel import sharded as sh
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, make_level_set3

    dm = make_device_mesh([device] * 4, (2, 2))
    out = {}
    for label, mesh, grid in (("sphere82k 256^3", *grids[256]),
                              ("sphere82k 512^3", *grids[512]),
                              ("box36 256^3", box, box_grid)):
        args = ([(mesh.verts, mesh.tris)], grid.origin, grid.dx, *grid.shape)
        walls = {}
        for name, kw in (("single", {"device": device}),
                         ("sharded", {"device_mesh": dm})):
            generate_sdf_batch(*args, **kw)
            t = []
            for _ in range(3):
                t0 = time.perf_counter()
                generate_sdf_batch(*args, **kw)
                t.append(time.perf_counter() - t0)
            walls[name] = statistics.median(t) * 1e3
        sb = bin_mesh_sharded(mesh, grid, (2, 2))
        binned = bin_mesh(mesh, grid)
        events = []
        extend = sh.LocalTransport.extend

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = extend(*a, **k)
            end.record()
            events.append((start, end))
            return r

        sh.LocalTransport.extend = timed
        try:
            sharded_sdf(sb, dm, verts=mesh.verts)
            torch.cuda.synchronize()
        finally:
            sh.LocalTransport.extend = extend
        halo_ms = sum(s.elapsed_time(e) for s, e in events)
        peaks = {}
        for name, fn in (("single", lambda: make_level_set3(
                mesh, grid, binned=binned, device=device)),
                         ("sharded", lambda: sharded_sdf(sb, dm,
                                                         verts=mesh.verts))):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        out[label] = dict(walls_ms=walls, halo_ms=halo_ms,
                          halo_calls=len(events), peak_gib=peaks)
        print(f"[{card}] sharded {label}, (2, 2) x cuda:0: generate_sdf_batch "
              f"wall {walls['sharded']:.1f} ms against {walls['single']:.1f} "
              f"ms on one device (median of 3; the shards run one after "
              f"another); halo exchange {halo_ms:.3f} ms over {len(events)} "
              f"extends in one call; peak memory {peaks['sharded']:.2f} GiB "
              f"against {peaks['single']:.2f} GiB", flush=True)
    return out


SWEEP_MODES = ("eikonal", "propagate")


@contextlib.contextmanager
def pass_counts():
    """{"single": passes, "sharded": passes} of the plane scans run inside
    the block (single-device and sharded)."""
    from sdfgenfast_tpu_torch.ops import sweep
    from sdfgenfast_tpu_torch.parallel import sharded as sh

    seen = {}
    real = (sweep.propagate_closest_triangles, sh._sharded_propagate)

    def spy(key, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            seen[key] = out[2]
            return out
        return run

    sweep.propagate_closest_triangles = spy("single", real[0])
    sh._sharded_propagate = spy("sharded", real[1])
    try:
        yield seen
    finally:
        sweep.propagate_closest_triangles, sh._sharded_propagate = real


def sweep_launches():
    """The launches of a sharded sweep-mode call over four shards: R1 once
    a shard, no other kernel."""
    want = dict.fromkeys((c.__name__ for c in shard_counters()), 0)
    want["recompute_forward"] = 4
    return want


def sharded_sweep_phase(torch, device, grids):
    """``far_field="eikonal"`` and ``"propagate"`` through
    ``parallel.sharded_sdf`` on ``["cuda:0"] * 4``: sphere82k at 256^3 on
    (2, 2), phi and ids bit-equal to the single-device card run, the same
    propagate pass count, R1 launched once a shard and K1-K4 never; then
    icosphere(4) at 64^3 on (1, 4), the card bit-equal to the CPU twins'
    sharded run. Returns {mode: {launches, passes, walls, digest}}."""
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.mesh import icosphere
    from sdfgenfast_tpu_torch.parallel import (bin_mesh_sharded,
                                               make_device_mesh, sharded_sdf)
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, make_level_set3

    mesh, grid = grids[256]
    dm = make_device_mesh([device] * 4, (2, 2))
    out = {}
    for mode in SWEEP_MODES:
        cfg = SDFConfig(far_field=mode)
        with pass_counts() as seen:
            t0 = time.perf_counter()
            want_phi, want_tid = make_level_set3(mesh, grid, cfg,
                                                 device=device,
                                                 return_tid=True)
            torch.cuda.synchronize()
            single_s = time.perf_counter() - t0
            sb = bin_mesh_sharded(mesh, grid, (2, 2), cfg)
            t0 = time.perf_counter()
            (phi, tid), launches = counted(lambda: sharded_sdf(
                sb, dm, verts=mesh.verts, return_tid=True))
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t0
        bad = (int((bits(torch, phi) != bits(torch, want_phi)).sum()),
               int((tid != want_tid).sum()))
        if bad != (0, 0):
            raise AssertionError(f"sharded {mode} sphere82k 256^3: {bad[0]} "
                                 f"phi and {bad[1]} id cells differ from the "
                                 "single-device run")
        if launches != sweep_launches():
            raise AssertionError(f"sharded {mode}: launches {launches}, "
                                 f"want {sweep_launches()}")
        if seen.get("sharded") != seen.get("single"):
            raise AssertionError(f"sharded {mode}: {seen.get('sharded')} "
                                 f"passes, the single device "
                                 f"{seen.get('single')}")
        out[mode] = dict(launches=launches, passes=seen.get("single"),
                         single_s=single_s, sharded_s=sharded_s,
                         digest=digest(phi))
        passes = (f", {seen['single']} passes on both"
                  if mode == "propagate" else "")
        print(f"sharded {mode} sphere82k 256^3 on (2, 2) x cuda:0: phi and "
              f"ids bit-equal to the single-device run{passes}; launches "
              f"{launches}; {sharded_s:.1f} s against {single_s:.1f} s on "
              "one device (first call)", flush=True)

    ico = icosphere(4, radius=1.0, center=(0.03, -0.02, 0.01))
    g64 = sizing_mode2a_proportional(*ico.bounds(), 64, 1)
    for mode in SWEEP_MODES:
        sb = bin_mesh_sharded(ico, g64, (1, 4), SDFConfig(far_field=mode))
        with pass_counts() as seen:
            card = sharded_sdf(sb, make_device_mesh([device] * 4, (1, 4)),
                               verts=ico.verts, return_tid=True)
            card_passes = seen.get("sharded")
            cpu = sharded_sdf(sb, make_device_mesh(["cpu"] * 4, (1, 4)),
                              verts=ico.verts, return_tid=True)
        bad = (int((bits(torch, card[0].cpu()) != bits(torch, cpu[0])).sum()),
               int((card[1].cpu() != cpu[1]).sum()))
        if bad != (0, 0) or card_passes != seen.get("sharded"):
            raise AssertionError(f"sharded {mode} icosphere(4) 64^3 (1, 4): "
                                 f"card vs CPU twins {bad} cells differ, "
                                 f"passes {card_passes} vs "
                                 f"{seen.get('sharded')}")
        print(f"sharded {mode} icosphere(4) 64^3 on (1, 4): card bit-equal "
              "to the CPU twins (phi and ids)", flush=True)
    return out


def sharded_sweep_steps(torch, device):
    """``SDFGenerator(device_mesh=...)`` in eikonal and propagate mode on
    icosphere(4) at 64^3 ((2, 2) x cuda:0) against the single device: the
    loss bit-equal, the vertex gradient within 1e-4 of its largest
    component, R1 and R1b once a shard."""
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.mesh import icosphere
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.parallel import make_device_mesh
    from sdfgenfast_tpu_torch.pipeline import SDFConfig

    mesh = icosphere(4, radius=1.0, center=(0.03, -0.02, 0.01))
    grid = sizing_mode2a_proportional(*mesh.bounds(), 64, 1)
    dm = make_device_mesh([device] * 4, (2, 2))
    out = {}
    for mode in SWEEP_MODES:
        cfg = SDFConfig(far_field=mode)
        single = SDFGenerator(mesh, grid, cfg, device=device)
        shard = SDFGenerator(mesh, grid, cfg, device_mesh=dm)
        target = single.forward(single.params * 0.95).detach()

        def grad(model):
            v = model.params.requires_grad_(True)
            loss = model.loss(v, target)
            return loss.detach(), torch.autograd.grad(loss, v)[0]

        l1, g1 = grad(single)
        (ls, gs), launches = counted(lambda: grad(shard))
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, ls), bits(torch, l1)):
            raise AssertionError(f"sharded {mode} step: loss {float(ls)} != "
                                 f"{float(l1)}")
        scale = float(g1.abs().max())
        err = float((gs - g1).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            raise AssertionError(f"sharded {mode} step: gradient max err "
                                 f"{err:.3e} vs 1e-4 * {scale:.3e}")
        want = dict(sweep_launches(), recompute_backward=4)
        if launches != want:
            raise AssertionError(f"sharded {mode} step: launches {launches}, "
                                 f"want {want}")
        out[mode] = {"launches": launches, "grad_err": err / scale}
        print(f"sharded SDFGenerator {mode} icosphere(4) 64^3 on (2, 2) x "
              f"cuda:0: loss bit-equal, gradient within {err / scale:.2e} of "
              f"max|g| = {scale:.3e}, launches {launches}", flush=True)
    return out


def multihost_cases(grids):
    """(label, mesh, grid, knobs, timed) of the multi-process cases; the
    labels of phase 8's and 9a's single-process (2, 2) runs."""
    box, cube = box36_cube()
    return (
        ("sphere82k 256^3", *grids[256], {}, True),
        ("capped hop 8, sphere82k 256^3", *grids[256], {"vdt_max_hop": 8},
         False),
        ("device sign, sphere82k 256^3", *grids[256],
         {"sign_mode": "device"}, False),
        ("eikonal", *grids[256], {"far_field": "eikonal"}, False),
        ("sphere82k 512^3", *grids[512], {}, True),
        ("box36 256^3", box, cube, {}, True),
    )


def batch_meshes(grids):
    """The two meshes of the multi-process batch on sphere82k's 256^3
    grid: the sphere and the sphere scaled by 0.8 about its centre."""
    from sdfgenfast_tpu_torch.mesh import Mesh

    mesh, grid = grids[256]
    c = mesh.verts.mean(axis=0)
    small = Mesh((c + 0.8 * (mesh.verts - c)).astype(np.float32), mesh.tris)
    return [(m.verts, m.tris) for m in (mesh, small)], grid


def multihost_worker(rank, world, backend, port, out_path):
    """One process of the multi-process phase: joins the group, builds the
    global (2, 2) mesh (gloo: two processes with two shards each on
    cuda:0; nccl: one shard a process on cuda:{rank}), runs every
    :func:`multihost_cases` case through ``sharded_sdf_multihost`` and
    ``fetch_global`` and a ``generate_sdf_batch`` of two meshes, and writes
    each grid's digest, this process's launches, the call's wall, the
    exchange's wall (host clock
    around every halo exchange and all-gather, synchronised before and
    after) and this process's peak memory to `out_path` (JSON)."""
    import torch

    from sdfgenfast_tpu_torch import generate_sdf_batch
    from sdfgenfast_tpu_torch.parallel import bin_mesh_sharded
    from sdfgenfast_tpu_torch.parallel import multihost as mh
    from sdfgenfast_tpu_torch.pipeline import SDFConfig

    rank, world = int(rank), int(world)
    local = (["cuda:0"] * (4 // world) if backend == "gloo"
             else [f"cuda:{rank}"])
    torch.cuda.set_device(torch.device(local[0]))
    mh.initialize(f"tcp://localhost:{port}", world, rank, backend)
    dm = mh.global_device_mesh(local, (2, 2))
    exchange = []
    for name in ("_remote_halos", "all_blocks"):
        real = getattr(mh.DistributedTransport, name)

        def timed(*a, _real=real, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = _real(*a, **k)
            torch.cuda.synchronize()
            exchange.append(time.perf_counter() - t0)
            return r

        setattr(mh.DistributedTransport, name, timed)
    grids = sphere_grids()
    out = {}
    for label, mesh, grid, knobs, timed_case in multihost_cases(grids):
        cfg = SDFConfig(**knobs)
        sb = bin_mesh_sharded(mesh, grid, (2, 2), cfg)
        exchange.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        blocks, launches = counted(lambda: mh.sharded_sdf_multihost(
            sb, dm, mesh.verts))
        phi = mh.assemble_blocks(mh.fetch_global(blocks, dm))
        call_ms = (time.perf_counter() - t0) * 1e3
        del blocks
        r = dict(digest=digest(phi), call_ms=call_ms, launches=launches,
                 exchange_ms=sum(exchange) * 1e3, exchanges=len(exchange),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if label == "sphere82k 512^3" and rank == 0:
            _, gold, far_key, stride = GOLDEN_CASES[512]
            r["far_dx"] = check_golden(phi, os.path.join(GOLDENS, gold),
                                       far_key, stride, grid)
        del phi
        if timed_case:
            args = ([(mesh.verts, mesh.tris)], grid.origin, grid.dx,
                    *grid.shape)
            generate_sdf_batch(*args, device_mesh=dm)
            t = []
            for _ in range(3):
                t0 = time.perf_counter()
                generate_sdf_batch(*args, device_mesh=dm)
                t.append(time.perf_counter() - t0)
            r["wall_ms"] = statistics.median(t) * 1e3
        out[label] = r
    meshes, grid = batch_meshes(grids)
    out["batch"] = [digest(p) for p in generate_sdf_batch(
        meshes, grid.origin, grid.dx, *grid.shape, device_mesh=dm)]
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(world, backend, timeout_s=900):
    """Start `world` :func:`multihost_worker` processes of this script,
    wait for all under one deadline (killing every one left when it
    passes), raise if any failed; returns their results, rank order."""
    out_dir = os.path.join(ROOT, "build", "multihost")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    paths = [os.path.join(out_dir, f"{backend}{world}_rank{r}.json")
             for r in range(world)]
    logs = [open(p[:-5] + ".log", "w") for p in paths]
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(r), str(world), backend, str(port), paths[r]],
        stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0
              or not os.path.exists(paths[r])]
    if failed:
        tails = []
        for r in failed:
            with open(paths[r][:-5] + ".log") as fh:
                tails.append(f"rank {r} (rc {procs[r].returncode}):\n"
                             + fh.read()[-3000:])
        raise RuntimeError(f"{backend} workers failed:\n" + "\n".join(tails))
    results = []
    for p in paths:
        with open(p) as fh:
            results.append(json.load(fh))
    return results


def check_workers(results, refs, label):
    """Every process's digest of every case equal to the others' and to
    the single-process run's (`refs`: {case: digest}, "batch": list)."""
    for case, want in refs.items():
        got = [r[case] if case == "batch" else r[case]["digest"]
               for r in results]
        if any(g != want for g in got):
            raise AssertionError(f"{label}: {case} differs from the "
                                 "single-process run (or between processes)")


def multihost_phase(torch, device, card, grids, refs, single_walls):
    """Two processes on the card (gloo, two shards each of a (2, 2) mesh
    on cuda:0, the CUDA blocks staged through host memory): every
    :func:`multihost_cases` case and the batch bit-equal to the
    single-process run on ``["cuda:0"] * 4`` on every process; the
    multi-process walls beside the single-process sharded ones, the
    exchange's wall and each process's peak memory."""
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, use_dense

    torch.cuda.empty_cache()
    results = run_workers(2, "gloo", timeout_s=420)
    check_workers(results, refs, "two processes")
    for label, mesh, grid, knobs, _ in multihost_cases(grids):
        rs = [r[label] for r in results]
        cfg = SDFConfig(**knobs)
        if cfg.far_field == "exact":
            want = {k: 2 * v for k, v in shard_schedule(
                cfg, grid.shape, use_dense(cfg, len(mesh.tris))).items()}
        else:
            want = {k: v // 2 for k, v in sweep_launches().items()}
        if any(r["launches"] != want for r in rs):
            raise AssertionError(f"two processes {label}: launches "
                                 f"{[r['launches'] for r in rs]}, the "
                                 f"schedule gives {want} a process")
        wall = [r.get("wall_ms") for r in rs]
        single = single_walls.get(label)
        line = (f"[{card}] 2 processes x 2 shards (gloo) {label}: bit-equal "
                f"to the single-process run on both, launches a process "
                f"{want}; call "
                f"{max(r['call_ms'] for r in rs):.1f} ms, exchange "
                + " / ".join(f"{r['exchange_ms']:.1f}" for r in rs)
                + f" ms over {rs[0]['exchanges']} exchanges, peak "
                + " / ".join(f"{r['peak_gib']:.2f}" for r in rs) + " GiB")
        if wall[0] is not None:
            line += (f"; generate_sdf_batch wall {max(wall):.1f} ms against "
                     f"{single['sharded']:.1f} ms in one process "
                     f"({single['single']:.1f} on one device)")
        if "far_dx" in rs[0]:
            line += f"; golden bars met, far field {rs[0]['far_dx']:.4f} dx"
        print(line, flush=True)
    print("2 processes: the batch of two meshes bit-equal to the "
          "single-process batch on both", flush=True)
    return results


def multihost_refs(torch, device, grids, phase8, phase9):
    """{case: digest} of the single-process (2, 2) runs the two processes
    are held to (phase 8's and 9a's), and the batch's."""
    from sdfgenfast_tpu_torch import generate_sdf_batch
    from sdfgenfast_tpu_torch.parallel import make_device_mesh

    refs = dict(phase8, eikonal=phase9["eikonal"]["digest"])
    meshes, grid = batch_meshes(grids)
    refs["batch"] = [digest(p) for p in generate_sdf_batch(
        meshes, grid.origin, grid.dx, *grid.shape,
        device_mesh=make_device_mesh([device] * 4, (2, 2)))]
    torch.cuda.synchronize()
    return refs


def four_cards():
    """``--four-cards``: four visible GPUs, one shard each. The
    single-process path on ``["cuda:0", ..., "cuda:3"]`` and four NCCL
    processes (one card each), every :func:`multihost_cases` case and the
    batch bit-equal to the one-card single-process run on
    ``["cuda:0"] * 4``; the single-device batch on each card equal to
    cuda:0's."""
    import torch

    from sdfgenfast_tpu_torch import generate_sdf_batch, require_cuda
    from sdfgenfast_tpu_torch.kernels import build
    from sdfgenfast_tpu_torch.parallel import (bin_mesh_sharded,
                                               make_device_mesh, sharded_sdf)
    from sdfgenfast_tpu_torch.pipeline import (SDFConfig, bin_mesh,
                                               make_level_set3)

    require_cuda()
    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"--four-cards needs four GPUs, "
                           f"{torch.cuda.device_count()} visible")
    card = card_line()
    print(f"card: {card} (x {torch.cuda.device_count()})", flush=True)
    build.build()
    build.library()
    grids = sphere_grids()
    one = make_device_mesh(["cuda:0"] * 4, (2, 2))
    four = make_device_mesh([f"cuda:{r}" for r in range(4)], (2, 2))
    refs = {}
    for label, mesh, grid, knobs, _ in multihost_cases(grids):
        sb = bin_mesh_sharded(mesh, grid, (2, 2), SDFConfig(**knobs))
        refs[label] = digest(sharded_sdf(sb, one, verts=mesh.verts))
        t0 = time.perf_counter()
        got = digest(sharded_sdf(sb, four, verts=mesh.verts))
        ms = (time.perf_counter() - t0) * 1e3
        if got != refs[label]:
            raise AssertionError(f"four cards, one process: {label} differs "
                                 "from the one-card run")
        print(f"[{card}] one process on cuda:0-3 {label}: bit-equal to the "
              f"one-card run; {ms:.1f} ms (first call)", flush=True)
    meshes, grid = batch_meshes(grids)
    args = (grid.origin, grid.dx, *grid.shape)
    refs["batch"] = [digest(p) for p in generate_sdf_batch(
        meshes, *args, device_mesh=one)]
    # the copy back from distinct cards: the one-process sharded batch
    # (each block to the host on its own card's side stream) and the
    # single-device batch on every card, each against cuda:0
    if [digest(p) for p in generate_sdf_batch(
            meshes, *args, device_mesh=four)] != refs["batch"]:
        raise AssertionError("four cards, one process: the sharded batch "
                             "differs from the one-card run")
    alone = [digest(p) for p in generate_sdf_batch(meshes, *args,
                                                   device="cuda:0")]
    for r in range(1, 4):
        if [digest(p) for p in generate_sdf_batch(
                meshes, *args, device=f"cuda:{r}")] != alone:
            raise AssertionError(f"generate_sdf_batch on cuda:{r} differs "
                                 "from cuda:0")
    print(f"[{card}] one process: the sharded batch on cuda:0-3 bit-equal "
          "to the one-card run; the single-device batch on cuda:1-3 "
          "bit-equal to cuda:0's", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results = run_workers(4, "nccl", timeout_s=420)
    check_workers(results, refs, "four NCCL processes")
    for label, *_rest in multihost_cases(grids):
        rs = [r[label] for r in results]
        print(f"[{card}] 4 processes x 1 card (nccl) {label}: bit-equal to "
              f"the one-card run on every process; call "
              f"{max(r['call_ms'] for r in rs):.1f} ms, exchange "
              f"{max(r['exchange_ms'] for r in rs):.1f} ms"
              + (f", generate_sdf_batch wall "
                 f"{max(r['wall_ms'] for r in rs):.1f} ms"
                 if "wall_ms" in rs[0] else ""), flush=True)
    # tools.scaling_bench on 1, 2 and 4 distinct cards beside 1, 2 and 4
    # shards of cuda:0, each bit-equal to one card; then where the host
    # waits in one sharded call at 512^3 on four cards and on one
    from sdfgenfast_tpu_torch.tools import scaling_bench

    torch.cuda.empty_cache()
    cards = [torch.device("cuda", r) for r in range(4)]
    scaling_phase(torch, {
        "one_card": [[cards[0]] * d for d in (1, 2, 4)],
        "cards": [cards[:d] for d in (1, 2, 4)]}, (128, 512))
    mesh, grid, cfg = scaling_bench.case(512)
    binned = bin_mesh(mesh, grid, cfg, device=cards[0])
    runs = {"one device (make_level_set3)": lambda: make_level_set3(
        mesh, grid, cfg, binned, device=cards[0])}
    for label, devs in (("cuda:0 x 1", cards[:1]),
                        ("cuda:0 x 4", [cards[0]] * 4),
                        ("cuda:0-3", cards)):
        dm = make_device_mesh(devs)
        sb = bin_mesh_sharded(mesh, grid, dm.devices.shape, cfg)
        runs[label] = (lambda sb, dm: lambda: sharded_sdf(
            sb, dm, verts=mesh.verts))(sb, dm)
    for label, fn in runs.items():
        torch.cuda.empty_cache()
        print(f"[{card}] profile of one call at 512^3, {label}: "
              + json.dumps(host_waits(torch, fn, cards)), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# -- 10. transfers (upload.py) ------------------------------------------------


def same_bytes(torch, a, b):
    """Equal dtype, shape and bytes (two tensors on one device)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def per_array_upload(torch, arrays, device):
    """The upload as the port made it before upload.py: one pageable
    ``.to(device)`` an array."""
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in arrays.items()}


def transfer_cases(grids, box, box_grid):
    """(label, mesh, grid, SDFConfig knobs) of the upload's checks."""
    return (("box36", box, box_grid, {}),
            ("box36 device sign", box, box_grid, {"sign_mode": "device"}),
            ("sphere82k 256^3", *grids[256], {}),
            ("sphere82k 256^3 device sign", *grids[256],
             {"sign_mode": "device"}))


def check_uploads(torch, device, grids, box, box_grid):
    """The blob upload against the per-array ``.to`` upload on each case:
    every view bit-equal, every view inside the one allocation, the
    staging pinned and byte-equal to ``pack_blob_host``, the blob that
    ``bin_mesh(device=...)`` keeps equal to it, one upload each."""
    from sdfgenfast_tpu_torch import pipeline, upload

    for label, mesh, grid, knobs in transfer_cases(grids, box, box_grid):
        config = pipeline.SDFConfig(**knobs)
        binned = pipeline.bin_mesh(mesh, grid, config)
        arrays = pipeline._blob_arrays(binned, mesh.verts)
        staging, metas = upload._pinned_blob(arrays)
        host, host_metas = upload.pack_blob_host(arrays)
        if not (staging.is_pinned() and metas == host_metas
                and np.array_equal(staging.numpy(), host)):
            raise AssertionError(f"{label}: the staging is not the pinned "
                                 "host blob")
        n0 = upload.pack_device_blob.uploads
        blob = upload.pack_device_blob(arrays, device)
        kept = pipeline.bin_mesh(mesh, grid, config, device=device).device
        if upload.pack_device_blob.uploads != n0 + 2:
            raise AssertionError(f"{label}: uploads counted "
                                 f"{upload.pack_device_blob.uploads - n0}")
        old = per_array_upload(torch, arrays, device)
        base = blob.blob.data_ptr()
        for k, v in blob.arrays.items():
            if not same_bytes(torch, v, old[k]):
                raise AssertionError(f"{label} {k}: the blob's view differs "
                                     "from the per-array upload")
            if (v.untyped_storage().data_ptr() != base
                    or not base <= v.data_ptr() <= base + blob.blob.numel()):
                raise AssertionError(f"{label} {k}: not a view of the blob")
        if not (kept.device == blob.device and torch.equal(kept.blob,
                                                           blob.blob)):
            raise AssertionError(f"{label}: bin_mesh(device=) kept another "
                                 "blob")
        torch.cuda.synchronize()
        print(f"upload {label}: {len(arrays)} arrays, {blob.blob.numel()} "
              f"bytes in one pinned blob, every view bit-equal to the "
              f"per-array upload and inside the blob", flush=True)


def check_downloads(torch, device, phi):
    """to_host and to_host_async against ``.cpu().numpy()`` on the card:
    `phi` (a main-path field), empty tensors, one piece, ragged last pieces,
    non-contiguous, bool, int32, float64 and 0-d tensors, a block written
    into its slice of a larger array; the ring's slots pinned; then the
    race check:
    ``to_host_async(phi)``, phi overwritten on its stream, released, and
    its memory allocated again and filled, the result still phi's bytes."""
    from sdfgenfast_tpu_torch import upload

    g = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((64, 100, 130), generator=g, device=device)
    # sizes that are no multiple of CHUNK_BYTES (16 MiB): whole planes a
    # piece, more pieces than ring slots, and the last piece short; planes
    # above one slot, cut into rows; a 1-d tensor cut into elements
    y = torch.randn((150, 300, 430), generator=g, device=device)
    rows = torch.randn((3, 2050, 2050), generator=g, device=device)
    flat = torch.randn(21_000_001, generator=g, device=device)
    cases = {"phi": phi, "n0": x[:0], "scalar": x[3, 4, 5], "one piece": x,
             "ragged planes": y, "ragged rows": rows, "ragged 1-d": flat,
             "non-contiguous": y[:, ::3, 1:].transpose(0, 2),
             "bool": y > 0, "int32": (y * 100).to(torch.int32),
             "float64": y[:40].double()}
    for label, t in cases.items():
        want = t.cpu().numpy()
        for name, got in (("to_host", upload.to_host(t)),
                          ("to_host_async",
                           upload.to_host_async(t).result())):
            if (got.dtype != want.dtype or got.shape != want.shape
                    or digest(got) != digest(want)):
                raise AssertionError(f"{name} {label}: differs from "
                                     ".cpu().numpy()")
    big = np.full((64, 210, 270), -1, np.float32)
    copies = [upload.to_host_async(x + a + 2 * c, out=big[
        :, a * 105:a * 105 + 100, c * 135:c * 135 + 130]) for a in range(2)
        for c in range(2)]
    for copy in copies:
        copy.result()
    for a in range(2):
        for c in range(2):
            if digest(big[:, a * 105:a * 105 + 100, c * 135:c * 135 + 130]) \
                    != digest(x + a + 2 * c):
                raise AssertionError("to_host_async(out=) block differs")
    slots = upload._STAGER.slots
    if not (slots and all(s.is_pinned() for s in slots)
            and upload.pinned_bytes() == upload.RING_SLOTS
            * upload.CHUNK_BYTES):
        raise AssertionError("the staging ring is not pinned")
    print(f"to_host / to_host_async: {len(cases)} cases and four blocks "
          f"into one array bit-equal to .cpu().numpy(); ring "
          f"{upload.RING_SLOTS} x {upload.CHUNK_BYTES >> 20} MiB pinned",
          flush=True)

    # the race check: a spin keeps the card busy, so the side stream's
    # copies are still waiting when phi is overwritten and its memory
    # handed out again
    want = digest(phi)
    n = phi.numel()
    torch.cuda._sleep(50_000_000)
    copy = upload.to_host_async(phi)
    phi.fill_(float("nan"))
    del phi
    other = torch.empty(n, dtype=torch.float32, device=device)
    other.fill_(7.0)
    got = copy.result()
    if digest(got) != want:
        raise AssertionError("to_host_async: the result changed when its "
                             "source was overwritten and its memory reused")
    del other
    print("race check: to_host_async's result kept its source's bytes "
          "after the source was overwritten, released and its memory "
          "reused", flush=True)


def check_entry_points(torch, device, grids, box, box_grid):
    """Every entry point bit-equal to ``make_level_set3(...).cpu().numpy()``:
    generate_sdf (box36), generate_from_file (sphere82k 256^3), the CLI on
    box36 at 256 x 341 x 425 (a fresh process: its wall and the package's
    import time in another fresh process), generate_sdf_batch of four
    meshes at 256^3 and the one-process sharded batch of two. Returns the
    fresh-process times."""
    import shutil

    from sdfgenfast_tpu_torch import (generate_from_file, generate_sdf,
                                      generate_sdf_batch)
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.io import mesh_io, sdf_io
    from sdfgenfast_tpu_torch.mesh import Mesh
    from sdfgenfast_tpu_torch.parallel import (bin_mesh_sharded,
                                               make_device_mesh, sharded_sdf)
    from sdfgenfast_tpu_torch.pipeline import make_level_set3

    def want(mesh, grid):
        return make_level_set3(mesh, grid, device=device).cpu().numpy()

    def check(label, got, ref):
        if got.shape != ref.shape or digest(got) != digest(ref):
            raise AssertionError(f"{label}: differs from .cpu().numpy()")

    check("generate_sdf box36", generate_sdf(
        box.verts, box.tris, box_grid.origin, box_grid.dx, *box_grid.shape,
        device=device), want(box, box_grid))
    check("generate_from_file sphere82k 256^3", generate_from_file(
        os.path.join(RESOURCES, GOLDEN_CASES[256][0]), nx=254,
        device=device)[0], want(*grids[256]))

    work = os.path.join(ROOT, "build", "chip_smoke_transfers")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mesh_io.save_stl(os.path.join(work, "box36.stl"), box)
    env = {k: v for k, v in os.environ.items() if k != "SDFGEN_TORCH_BACKEND"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    fresh = {}
    for label, cmd in (
            ("python alone", ["-c", "pass"]),
            ("import torch", ["-c", "import torch"]),
            ("import sdfgenfast_tpu_torch", ["-c", "import time; t = "
             "time.perf_counter(); import sdfgenfast_tpu_torch; "
             "print('import_s', time.perf_counter() - t)"]),
            ("CLI box36 256 1", ["-m", "sdfgenfast_tpu_torch.cli",
                                 "box36.stl", "256", "1"])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *cmd], cwd=work, env=env,
                           capture_output=True, text=True, timeout=300)
        fresh[label] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{label} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        if "import_s" in r.stdout:
            fresh["import inside the process"] = float(
                r.stdout.split("import_s")[1])
    loaded, mn, mx = mesh_io.load_mesh(os.path.join(work, "box36.stl"))
    cli_grid = sizing_mode2a_proportional(mn, mx, 256, 1)
    phi, _, _ = sdf_io.read_sdf(os.path.join(
        work, f"box36_sdf_{cli_grid.ni}x{cli_grid.nj}x{cli_grid.nk}.sdf"))
    check("CLI box36", phi, want(loaded, cli_grid))
    shutil.rmtree(work, ignore_errors=True)

    meshes, grid = batch_four(grids)
    got = generate_sdf_batch(meshes, grid.origin, grid.dx, *grid.shape,
                             device=device)
    for k, (v, t) in enumerate(meshes):
        check(f"generate_sdf_batch mesh {k}", got[k], want(Mesh(v, t), grid))
    dm = make_device_mesh([device] * 4, (2, 2))
    got = generate_sdf_batch(meshes[:2], grid.origin, grid.dx, *grid.shape,
                             device_mesh=dm)
    for k, (v, t) in enumerate(meshes[:2]):
        check(f"sharded batch mesh {k}", got[k], sharded_sdf(
            bin_mesh_sharded(Mesh(v, t), grid, (2, 2)), dm,
            verts=v).cpu().numpy())
    print("entry points: generate_sdf, generate_from_file, the CLI, "
          "generate_sdf_batch of four meshes at 256^3 and the one-process "
          "sharded batch bit-equal to .cpu().numpy()", flush=True)
    return fresh


def batch_four(grids):
    """Four meshes on sphere82k's 256^3 grid: the sphere and the sphere
    scaled by 0.95, 0.9 and 0.85 about its centre."""
    meshes, grid = [], grids[256][1]
    mesh = grids[256][0]
    c = mesh.verts.mean(axis=0)
    for s in (1.0, 0.95, 0.9, 0.85):
        meshes.append(((c + np.float32(s) * (mesh.verts - c)).astype(
            np.float32), mesh.tris))
    return meshes, grid


def transfer_walls(reps=WARM_CALLS):
    """The walls of the entry points with entry points an older package
    has (run from another checkout's root to time its package with this
    smoke's inputs): generate_sdf box36, generate_from_file sphere82k 256^3
    and 512^3, one SDFGenerator.train_step on sphere82k 256^3 and box36
    (host clock, synchronised), generate_sdf_batch of four meshes at 256^3
    beside four single calls; median and min of `reps`."""
    import torch

    from sdfgenfast_tpu_torch import (generate_from_file, generate_sdf,
                                      generate_sdf_batch)
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.kernels import build
    from sdfgenfast_tpu_torch.models import SDFGenerator
    from sdfgenfast_tpu_torch.testing import box36

    build.build()
    build.library()
    device = torch.device("cuda", 0)
    card = card_line()
    grids = sphere_grids()
    box = box36()
    box_grid = sizing_mode2a_proportional(*box.bounds(), 256, 1)
    meshes, grid = batch_four(grids)
    args = (grid.origin, grid.dx, *grid.shape)
    calls = {
        "box36": lambda: generate_sdf(box.verts, box.tris, box_grid.origin,
                                      box_grid.dx, *box_grid.shape,
                                      device=device),
        "sphere82k 256^3": lambda: generate_from_file(os.path.join(
            RESOURCES, GOLDEN_CASES[256][0]), nx=254, device=device),
        "sphere82k 512^3": lambda: generate_from_file(os.path.join(
            RESOURCES, GOLDEN_CASES[512][0]), nx=510, device=device),
        "batch of four 256^3": lambda: generate_sdf_batch(meshes, *args,
                                                          device=device),
        "four single calls 256^3": lambda: [generate_sdf(
            v, t, *args, device=device) for v, t in meshes]}
    for label, mesh, g in (("train_step sphere82k 256^3", *grids[256]),
                           ("train_step box36", box, box_grid)):
        model = SDFGenerator(mesh, g, device=device)
        v0 = model.params
        with torch.no_grad():
            target = model.forward(v0 * 0.95)

        def step(model=model, v0=v0, target=target):
            model.train_step(v0, target, lr=1e-2)
            torch.cuda.synchronize()
        calls[label] = step
    out = {}
    for label, fn in calls.items():
        fn()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        out[label] = median_min(walls)
        print(f"[{card}] {os.getcwd()}: {label} {out[label][0]:.2f} / "
              f"{out[label][1]:.2f} ms (median / min of {reps})", flush=True)
    print("transfer_walls " + json.dumps(out), flush=True)
    return out


def median_min(xs):
    return statistics.median(xs) * 1e3, min(xs) * 1e3


def transfer_times(torch, device, card, grids, box, box_grid):
    """New route beside old, each median and min of WARM_CALLS:

    - the copy to the host of each main-path field: ``.cpu().numpy()``
      (old), ``to_host`` (the ring), the link alone (one device -> pinned
      copy of the whole field: the design where results are pinned
      tensors, when torch's host cache holds a free block of that size),
      the same with a fresh pinned allocation (the host cache emptied
      first), and the host write alone (pinned -> a fresh NumPy array,
      first touch included, and -> an array already written);
    - the upload: per-array ``.to`` (old) against ``pack_device_blob``,
      host wall (synchronised) and device time (CUDA events);
    - walls of ``generate_sdf`` (new) against the same call made the old
      way (binning on the host, the inputs uploaded for the call, the copy
      back by ``.cpu().numpy()``);
    - ``train_step`` with the cached blob against re-uploading every step;
    - ``generate_sdf_batch`` of four meshes against four single calls;
    - the pinned memory held."""
    from sdfgenfast_tpu_torch import (generate_sdf, generate_sdf_batch,
                                      pipeline, upload)
    from sdfgenfast_tpu_torch.models import SDFGenerator

    out = {}
    cells = (("box36", box, box_grid), ("sphere82k 256^3", *grids[256]),
             ("sphere82k 512^3", *grids[512]))
    for label, mesh, grid in cells:
        phi = pipeline.make_level_set3(mesh, grid, device=device)
        torch.cuda.synchronize()
        nbytes = phi.numel() * 4
        pinned = torch.empty(phi.numel(), dtype=torch.float32,
                             pin_memory=True)
        touched = np.empty(phi.shape, np.float32)
        touched.fill(0)
        t = {k: [] for k in ("old", "ring", "link", "link_events",
                             "pinned_fresh", "write_fresh", "write_touched")}
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            phi.cpu().numpy()
            t["old"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            upload.to_host(phi)
            t["ring"].append(time.perf_counter() - t0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            pinned.copy_(phi.reshape(-1), non_blocking=True)
            end.record()
            end.synchronize()
            t["link"].append(time.perf_counter() - t0)
            t["link_events"].append(start.elapsed_time(end) / 1e3)
            torch._C._host_emptyCache()
            t0 = time.perf_counter()
            fresh = torch.empty(phi.numel(), dtype=torch.float32,
                                pin_memory=True)
            fresh.copy_(phi.reshape(-1), non_blocking=True)
            torch.cuda.synchronize()
            t["pinned_fresh"].append(time.perf_counter() - t0)
            del fresh
            for key, dst in (("write_fresh", None), ("write_touched",
                                                     touched)):
                t0 = time.perf_counter()
                if dst is None:
                    dst = np.empty(phi.shape, np.float32)
                torch.from_numpy(dst).copy_(pinned.view(phi.shape))
                t[key].append(time.perf_counter() - t0)
        r = {k: median_min(v) for k, v in t.items()}
        r["bytes"] = nbytes
        out[f"copy {label}"] = r
        print(f"[{card}] copy to host {label} ({nbytes / 1e6:.1f} MB, median"
              f" / min of {WARM_CALLS}): .cpu().numpy() {r['old'][0]:.2f} / "
              f"{r['old'][1]:.2f} ms ({nbytes / r['old'][0] / 1e6:.2f} GB/s);"
              f" to_host (pinned ring) {r['ring'][0]:.2f} / {r['ring'][1]:.2f}"
              f" ms ({nbytes / r['ring'][0] / 1e6:.2f} GB/s); the link alone "
              f"(device -> one pinned tensor) {r['link'][0]:.2f} / "
              f"{r['link'][1]:.2f} ms, events {r['link_events'][0]:.2f} ms "
              f"({nbytes / r['link_events'][0] / 1e6:.2f} GB/s), into a "
              f"fresh pinned tensor {r['pinned_fresh'][0]:.2f} ms; the host "
              f"write alone (pinned -> NumPy) {r['write_fresh'][0]:.2f} ms "
              f"into a fresh array (first touch), {r['write_touched'][0]:.2f}"
              f" ms into one already written", flush=True)
        del phi, pinned, touched

        config = pipeline.SDFConfig()
        binned = pipeline.bin_mesh(mesh, grid, config)
        arrays = pipeline._blob_arrays(binned, mesh.verts)
        t = {k: [] for k in ("old", "old_events", "new", "new_events")}
        for _ in range(WARM_CALLS):
            for key, fn in (("old", lambda: per_array_upload(
                    torch, arrays, device)), ("new", lambda: upload.
                                              pack_device_blob(arrays,
                                                               device))):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                fn()
                end.record()
                end.synchronize()
                t[key].append(time.perf_counter() - t0)
                t[key + "_events"].append(start.elapsed_time(end) / 1e3)
        r = {k: median_min(v) for k, v in t.items()}
        r["bytes"] = int(sum(np.asarray(a).nbytes for a in arrays.values()))
        r["arrays"] = len(arrays)
        out[f"upload {label}"] = r
        print(f"[{card}] upload {label} ({r['bytes'] / 1e6:.2f} MB in "
              f"{len(arrays)} arrays, median / min of {WARM_CALLS}): per-array"
              f" .to {r['old'][0]:.3f} / {r['old'][1]:.3f} ms (events "
              f"{r['old_events'][0]:.3f}); one pinned blob "
              f"{r['new'][0]:.3f} / {r['new'][1]:.3f} ms (events "
              f"{r['new_events'][0]:.3f})", flush=True)

        def new_call():
            generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                         *grid.shape, device=device)

        def old_call():
            b = pipeline.bin_mesh(mesh, grid, config)
            pipeline.make_level_set3(mesh, grid, config, b,
                                     device=device).cpu().numpy()

        walls = {"new": [], "old": []}
        for _ in range(WARM_CALLS):
            for key, fn in (("new", new_call), ("old", old_call)):
                t0 = time.perf_counter()
                fn()
                walls[key].append(time.perf_counter() - t0)
        r = {k: median_min(v) for k, v in walls.items()}
        out[f"wall {label}"] = r
        print(f"[{card}] wall {label} (median / min of {WARM_CALLS}): "
              f"generate_sdf {r['new'][0]:.1f} / {r['new'][1]:.1f} ms; the "
              f"old way "
              f"(host binning, one upload for the call, .cpu().numpy()) "
              f"{r['old'][0]:.1f} / {r['old'][1]:.1f} ms", flush=True)
        torch.cuda.empty_cache()

    for label, mesh, grid in cells[:2]:
        model = SDFGenerator(mesh, grid, device=device)
        again = SDFGenerator(mesh, grid, device=device,
                             binned=dataclasses.replace(model.binned,
                                                        device=None))
        v0 = model.params
        with torch.no_grad():
            target = model.forward(v0 * 0.95)
        steps = {}
        for key, m in (("cached", model), ("re-upload", again)):
            n0 = upload.pack_device_blob.uploads
            m.train_step(v0, target, lr=1e-2)
            torch.cuda.synchronize()
            ups = upload.pack_device_blob.uploads - n0
            if ups != (0 if key == "cached" else 1):
                raise AssertionError(f"train_step {label} {key}: {ups} "
                                     "uploads")
            steps[key] = cuda_ms(torch, lambda: m.train_step(
                v0, target, lr=1e-2), WARM_CALLS)
        out[f"train_step {label}"] = steps
        print(f"[{card}] train_step {label}: cached blob {steps['cached']:.3f}"
              f" ms (0 uploads a step), re-uploading every step "
              f"{steps['re-upload']:.3f} ms (1 upload; CUDA events, mean of "
              f"{WARM_CALLS})", flush=True)
        del model, again, v0, target
        torch.cuda.empty_cache()

    meshes, grid = batch_four(grids)
    args = (grid.origin, grid.dx, *grid.shape)
    walls = {"batch": [], "singles": []}
    generate_sdf_batch(meshes, *args, device=device)
    for _ in range(3):
        t0 = time.perf_counter()
        generate_sdf_batch(meshes, *args, device=device)
        walls["batch"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for v, tr in meshes:
            generate_sdf(v, tr, *args, device=device)
        walls["singles"].append(time.perf_counter() - t0)
    r = {k: median_min(v) for k, v in walls.items()}
    out["batch of four 256^3"] = r
    held = upload.pinned_bytes()
    # what stays pinned once torch's host cache lets its free blocks go
    torch._C._host_emptyCache()
    stats = getattr(torch.cuda, "host_memory_stats", None)
    cache = None if stats is None else {
        k: v for k, v in stats().items() if "bytes" in k and "current" in k}
    out["pinned_bytes"] = held
    out["torch_host_cache"] = cache
    print(f"[{card}] generate_sdf_batch of four meshes at {grid.shape}: "
          f"{r['batch'][0]:.1f} / {r['batch'][1]:.1f} ms (median / min of "
          f"3) against four single generate_sdf calls {r['singles'][0]:.1f} "
          f"/ {r['singles'][1]:.1f} ms; pinned memory held by upload.py "
          f"{held >> 20} MiB (the ring), torch's host allocator after "
          f"emptying its cache "
          + ("not reported" if cache is None else str(cache)), flush=True)
    return out


# -- 11. the flagship torus, box64/128 and the port's tools ------------------


def flagship_counters():
    from sdfgenfast_tpu_torch.ops import band_kernel, dense, vdt_kernel

    return (dense.dense_stream, band_kernel.band_coefs, band_kernel.band_rows,
            vdt_kernel.round_phase, vdt_kernel.chamfer)


def pyramid_rounds(grid_shape):
    """The K3 launches of one default-path call on `grid_shape`: the
    pyramid's schedule (ops/vdt.py) on the pipeline's axis permutation of
    the grid; with one level, the ladder alone."""
    from sdfgenfast_tpu_torch.ops import vdt
    from sdfgenfast_tpu_torch.pipeline import _vdt_axis_perm

    shape = tuple(grid_shape[p] for p in _vdt_axis_perm(grid_shape))
    shapes = vdt.pyramid_level_shapes(shape)
    coarse = len(vdt.stride_ladder(max(shapes[-1]), extra_rounds=1))
    if len(shapes) == 1:
        return coarse
    return (coarse + len(vdt.PYRAMID_COARSE_ROUNDS) * (len(shapes) - 2)
            + len(vdt.PYRAMID_LEVEL_ROUNDS) + 2)


def torus_oracle_phase(torch, device, card):
    """Phase 11a: torus100k (``torus_mesh()``, 100,352 triangles) through
    ``generate_sdf`` on bench.py's grids at 256 and 512, its launches
    checked exactly (K1 0, K2 1 + 1, K3 the pyramid's schedule, K4 1), held
    to the analytic torus (``testing.torus_bars``): 0 sign mismatches off
    the tessellation's gap g, the band cells the binning evaluates exactly
    (|phi| <= 3 dx, the seed band) within g + 1e-5 of |s|, no cell below
    |s| - g - 1e-5, none above |s| + g + 0.2 dx. Returns (mesh, {nx: (grid,
    launches, bars)})."""
    from sdfgenfast_tpu_torch import generate_sdf, testing
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.mesh import torus_mesh

    mesh = torus_mesh()
    gap = testing.tessellation_gap(mesh, device=device)
    sagitta = 1.8 * (1 - np.cos(np.pi / 224))
    print(f"torus100k: {mesh.num_tris} triangles, tessellation gap "
          f"{gap:.4e} (sagitta {sagitta:.4e})", flush=True)
    if not gap <= sagitta + 1e-7:
        raise AssertionError(f"torus100k gap {gap} above the sagitta")
    out = {}
    for nx in (256, 512):
        grid = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
        for fn in flagship_counters():
            fn.launches = 0
        t0 = time.perf_counter()
        phi = generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                           *grid.shape, device=device)
        cold = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in flagship_counters()}
        want = {"dense_stream": 0, "band_coefs": 1, "band_rows": 1,
                "round_phase": pyramid_rounds(grid.shape), "chamfer": 1}
        if launches != want:
            raise AssertionError(f"torus100k {grid.shape}: launches "
                                 f"{launches}, the schedule gives {want}")
        if phi.shape != grid.shape or not np.isfinite(phi).all():
            raise AssertionError(f"torus100k {grid.shape}: bad output")
        # the band cells: the binning evaluates every cell within the seed
        # band (3 dx) exactly, and the far field never lowers a cell below
        # exact
        phi_d = torch.from_numpy(phi).to(device)
        bars = testing.torus_bars(phi_d, grid, gap,
                                  phi_d.abs() <= 3 * grid.dx)
        testing.check_torus_bars(f"torus100k {grid.shape}", bars, gap,
                                 grid.dx)
        del phi_d
        torch.cuda.empty_cache()
        print(f"torus100k {grid.shape} through generate_sdf: launches "
              f"{launches}; against the analytic torus 0 sign mismatches "
              f"off the gap, exact band within {bars['band_dev']:.3e} "
              f"(gap {gap:.3e}), never below |s| - gap (by "
              f"{-bars['below']:.3e}), far field above |s| + gap by at most "
              f"{bars['excess_dx']['hole']:.4f} dx in the hole and "
              f"{bars['excess_dx']['outside']:.4f} dx outside it; cold call "
              f"{cold:.3f} s", flush=True)
        out[nx] = (grid, launches, bars)
    return mesh, out


def box_classes_phase(torch, device):
    """Phase 11b: box36 at bench.py's box64 and box128 grids through
    ``generate_sdf`` (one K1 launch each), held as box36 at 256 is in
    phase 4b: exact on a sample, and the binned path on the same grid never
    below it and within 0.2 dx."""
    from sdfgenfast_tpu_torch import generate_sdf
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.testing import box36

    box = box36()
    out = {}
    for nx in (64, 128):
        grid = sizing_mode2a_proportional(*box.bounds(), nx, 1)
        for fn in flagship_counters():
            fn.launches = 0
        phi = generate_sdf(box.verts, box.tris, grid.origin, grid.dx,
                           *grid.shape, device=device)
        launches = {fn.__name__: fn.launches for fn in flagship_counters()}
        if launches != {"dense_stream": 1, "band_coefs": 0, "band_rows": 0,
                        "round_phase": 0, "chamfer": 0}:
            raise AssertionError(f"box{nx}: launches {launches}")
        out[nx] = check_dense_vs_binned(torch, device, f"box{nx}", box, grid,
                                        phi)
    return out


def tools_phase(torch, device, card):
    """Phase 11c-d: the port's tools on the card. ``tools.bench`` through
    its command line (a fresh process) on all seven configurations, at
    least 10 samples each; ``tools.profile_stages`` on box36 at 256,
    sphere82k at 256 and torus100k at 256 and 512, in each run the launches
    of the stages that split a call summing to its ``sdf.make_level_set3``
    span's, and on the sphere and the torus ``sdf.k3``'s the pyramid's
    schedule (``pyramid_rounds``); ``tools.batch_bench`` with 4 meshes,
    the batch bit-equal to the meshes one at a time. Each prints its JSON
    line. Returns (bench line, profile runs, batch row)."""
    from sdfgenfast_tpu_torch.tools import batch_bench, bench, profile_stages

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "sdfgenfast_tpu_torch.tools.bench"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    sys.stdout.write(r.stderr)
    if r.returncode != 0:
        raise AssertionError(f"tools.bench exited {r.returncode}")
    lines = r.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"tools.bench printed {len(lines)} lines")
    line = json.loads(lines[0])
    names = [c[0] for c in bench.CONFIGS]
    if sorted(line["detail"]) != sorted(names):
        raise AssertionError(f"tools.bench rows {sorted(line['detail'])}")
    for name, row in line["detail"].items():
        if row["n"] < bench.MIN_SAMPLES or row["card"] != card:
            raise AssertionError(f"tools.bench {name}: {row['n']} samples "
                                 f"on {row['card']}")
    print(f"tools.bench in {time.perf_counter() - t0:.1f} s:", flush=True)
    print("bench " + json.dumps(line), flush=True)
    runs = []
    for args in (["256", "box"], ["256", "sphere"], ["256", "512", "torus"]):
        runs += profile_stages.main(args)["runs"]
    for run in runs:
        launches = run["launches"]
        split = sum(launches.get(k, 0) for k in profile_stages.SPLIT)
        want = launches["sdf.make_level_set3"]
        if run["mesh"] != "box":
            want_k3 = pyramid_rounds(tuple(run["grid"]))
            if launches["sdf.k3"] != want_k3:
                raise AssertionError(f"profile_stages {run['mesh']} "
                                     f"{run['grid']}: sdf.k3 launches "
                                     f"{launches['sdf.k3']}, the schedule "
                                     f"gives {want_k3}")
        if split != want or launches["sdf.generate_sdf"] != want:
            raise AssertionError(f"profile_stages {run['mesh']} "
                                 f"{run['grid']}: stage launches {launches}"
                                 f" sum to {split}, the call's {want}")
    batch = batch_bench.main(["4"])
    return line, runs, batch


def torus_kernel_rows(torch, device, card, mesh, grid, launches):
    """Phase 11e: K2, K3 and K4 on the torus's main-path inputs at `grid`:
    K2's coefficient pass and walk on its CSR bit-equal to their twins
    (check_k2, its bound from this CSR), K3 summed over one call (each round
    replayed on its own input) and one stride-1 round at the finest level's
    shape bit-equal to its twin, K4 (2 passes) on the call's own
    pre-chamfer field bit-equal to its twin. Returns the kernel-table rows
    (`launches`: phase 11a's counts of the call) and their bounds."""
    from sdfgenfast_tpu_torch import generate_sdf
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    def run():
        generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                     *grid.shape, device=device)

    tag = f"torus100k_{grid.shape[0]}"
    k2 = check_k2(torch, device, mesh, grid)
    torch.cuda.empty_cache()
    k3_ms, k3_n, levels = k3_replay_time(torch, card, run,
                                         f"torus100k {grid.shape}")
    if k3_n != launches["round_phase"]:
        raise AssertionError(f"{tag}: {k3_n} K3 rounds replayed")
    fine = levels[-1][0]
    k3 = time_k3(torch, device, card, fine, plain=True, strides=(1,))
    call_bound = sum(k3_bound(shape)[0] * len(strides)
                     for shape, strides, _ in levels)
    torch.cuda.empty_cache()
    field, dx = chamfer_input(run)
    got = vdt_kernel.chamfer(field, dx, 2)
    want = vdt_kernel.chamfer_reference(field, dx, 2)
    if not torch.equal(bits(torch, got), bits(torch, want)):
        raise AssertionError(f"{tag}: K4 differs from its twin")
    k4_err = abs_err(got, want)
    del got, want
    k4_ms = queued_ms(torch, lambda: vdt_kernel.chamfer(field, dx, 2), 10)
    k4_plain = cuda_ms(torch, lambda: vdt_kernel.chamfer_reference(
        field, dx, 2), 2)
    n = field.numel()
    bounds = {f"band_coefs_{tag}": k2["bounds"]["coefs"],
              f"band_rows_{tag}": k2["bounds"]["walk"],
              f"vdt_round_{tag}": k3_bound(fine),
              f"chamfer_{tag}": bound_ms(2 * n * 26 * OPS_CHAMFER_OFFSET,
                                         8 * n)}
    del field
    torch.cuda.empty_cache()
    k2t = k2["times"]
    print(f"[{card}] {tag} {grid.shape}: K2 coefficient pass "
          f"{k2t['coefs']:.4f} ms + walk {k2t['walk']:.4f} ms (bound "
          f"{bounds[f'band_rows_{tag}'][0]:.4f} ms, {k2['pairs']} (tile, "
          f"candidate) pairs), row fills {k2t['fills']:.4f} ms; K3 "
          f"{k3_ms:.4f} ms over one call's {k3_n} rounds (bound "
          f"{call_bound:.4f} ms), {k3[1]:.4f} ms a stride-1 round at "
          f"{fine} (bound {bounds[f'vdt_round_{tag}'][0]:.4f} ms); K4 "
          f"{k4_ms:.4f} ms (bound {bounds[f'chamfer_{tag}'][0]:.4f} ms), "
          f"plain {k4_plain:.3f} ms", flush=True)
    src = "sdfgenfast_tpu_torch/csrc/"
    rows = [
        {"name": f"band_coefs_{tag}", "route": "cuda",
         "source": src + "band_rows.cu",
         "replaces": "sdfgenfast_tpu/ops/band_pallas.py:76",
         "launches": launches["band_coefs"], "max_abs_err": k2["err"],
         "ms": k2t["coefs"], "plain_ms": k2t["coefs_plain"]},
        {"name": f"band_rows_{tag}", "route": "cuda",
         "source": src + "band_rows.cu",
         "replaces": "sdfgenfast_tpu/ops/band_pallas.py:76",
         "launches": launches["band_rows"], "max_abs_err": k2["err"],
         "ms": k2t["walk"], "plain_ms": k2t["plain"]},
        {"name": f"vdt_round_{tag}", "route": "cuda",
         "source": src + "vdt_round.cu",
         "replaces": "sdfgenfast_tpu/ops/vdt_pallas.py:75",
         "launches": launches["round_phase"], "max_abs_err": k3["err"],
         "ms": k3[1], "plain_ms": k3["plain"], "call_ms": k3_ms,
         "call_bound_ms": call_bound},
        {"name": f"chamfer_{tag}", "route": "cuda",
         "source": src + "chamfer.cu",
         "replaces": "sdfgenfast_tpu/ops/vdt_pallas.py:272",
         "launches": launches["chamfer"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain},
    ]
    return rows, bounds


# -- 12. the last JAX tools: stress_256, kernel_bench, scaling_bench ----------


def stress_phase(card):
    """Phase 12a: ``tools.stress_256`` through its command line in a fresh
    process (its memory readings start from nothing): 10 iterations of
    sphere82k at 256^3, bit-identical, every memory reading flat from the
    second iteration (the tool raises on growth)."""
    from sdfgenfast_tpu_torch.tools.stress_256 import MEMORY

    r = subprocess.run([sys.executable, "-m",
                        "sdfgenfast_tpu_torch.tools.stress_256", "10"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    sys.stdout.write(r.stderr)
    lines = r.stdout.strip().splitlines()
    sys.stdout.write("".join(s + "\n" for s in lines[:-1]))
    if r.returncode != 0 or not lines:
        raise AssertionError(f"tools.stress_256 exited {r.returncode}")
    line = json.loads(lines[-1])
    mem = line["memory"]
    if (line["iterations"] != 10 or not line["bit_identical"]
            or line["card"] != card
            or any(len(mem[k]) != 10 for k in MEMORY)
            or False in line["memory_flat_from_second"].values()):
        raise AssertionError(f"tools.stress_256: {line}")
    print("stress " + json.dumps(line), flush=True)
    return line


def kernel_bench_phase(torch, device):
    """Phase 12b: ``tools.kernel_bench`` at 64, 128 and 256 on the
    12-triangle box; at each size the last queued outputs (phi, ids and
    the signed field) bit-equal to ``pipeline.dense_sign_core`` on the
    same blob, and every stage timed on three clocks."""
    from sdfgenfast_tpu_torch.grid import sizing_mode2a_proportional
    from sdfgenfast_tpu_torch.mesh import box_mesh
    from sdfgenfast_tpu_torch.ops import dense
    from sdfgenfast_tpu_torch.pipeline import bin_mesh, dense_sign_core
    from sdfgenfast_tpu_torch.tools import kernel_bench

    box = box_mesh((3, 4, 5), (-1, -1, -1))
    dense.dense_stream.launches = 0
    line, outs = kernel_bench.run(box, [64, 128, 256], device)
    if dense.dense_stream.launches < 3 * (2 * kernel_bench.REPS + 1):
        raise AssertionError(f"kernel_bench: {dense.dense_stream.launches} "
                             f"K1 launches")
    for row in line["rows"]:
        nx = row["nx"]
        grid = sizing_mode2a_proportional(*box.bounds(), nx, 1)
        a = bin_mesh(box, grid, device=device).device.arrays
        want, want_tid = dense_sign_core(
            a["verts"], a["tris"], a.get("parity", a.get("crossings")),
            a["origin"], grid.dx, grid_shape=grid.shape)
        phi, tid, signed = outs[nx]
        if not (torch.equal(bits(torch, signed), bits(torch, want))
                and torch.equal(tid, want_tid)
                and torch.equal(bits(torch, phi), bits(torch, want.abs()))):
            raise AssertionError(f"kernel_bench Nx {nx}: differs from "
                                 "dense_sign_core")
        if None in (row["dense_kernel_device_ms"],
                    row["unpack_sign_device_ms"]):
            raise AssertionError(f"kernel_bench Nx {nx}: no device clock")
    print("kernel_bench " + json.dumps(line), flush=True)
    return line


def scaling_phase(torch, lists, sizes):
    """Phase 12c (one card) and the four-card scaling: ``tools.
    scaling_bench`` at each Nx of `sizes` over `lists` ({table: [device
    list of each d]}); the tool raises unless every d is bit-equal to
    d = 1, every table to the first and to the single-device call."""
    from sdfgenfast_tpu_torch.tools import scaling_bench

    lines = {}
    for nx in sizes:
        torch.cuda.empty_cache()
        line, _ = scaling_bench.run(*scaling_bench.case(nx), lists)
        print(f"scaling {nx} " + json.dumps(line), flush=True)
        lines[nx] = line
    return lines


def host_waits(torch, fn, devices):
    """torch.profiler over one call of `fn` (warm, ending in a synchronize
    of every device in `devices`): each device's busy share of the call's
    wall (the union of its kernels' and copies' intervals), the host ops
    with the most self CPU time and the kernels with the most device time
    (summed over the devices)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdfgenfast_tpu_torch.tools.profile_stages import (
        _short as short_kernel, union_us)

    def call():
        fn()
        for d in devices:
            torch.cuda.synchronize(d)

    call()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and e.time_range.end > e.time_range.start):
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    busy = {f"cuda:{index}": round(union_us(s) / wall_us, 4)
            for index, s in sorted(spans.items())}
    averages = prof.key_averages()
    host = sorted((e for e in averages if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    kernels = {}
    for e in averages:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            k = kernels.setdefault(short_kernel(e.key), [0.0, 0])
            k[0] += us / 1e3
            k[1] += e.count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": round(wall_us / 1e3, 3),
            "busy_share": busy or "not measured",
            "host_self_ms": {e.key: [round(e.self_cpu_time_total / 1e3, 3),
                                     e.count] for e in host},
            "device_ms": {name: [round(ms, 3), n] for name, (ms, n) in top}}


GOLDEN_CASES = {
    256: ("icosphere6.stl", "sphere6_stl_256_mode2a.sparse.npz",
          "far_sample_stride4", 4),
    512: ("icosphere6_origin.stl", "sphere6_stl_512_mode2a.sparse.npz",
          "far_sample_stride8", 8),
}


def sphere_grids():
    """{n: (sphere82k mesh, its golden's n^3 grid)}."""
    from sdfgenfast_tpu_torch import load_mesh
    from sdfgenfast_tpu_torch.grid import sizing_python_api
    from sdfgenfast_tpu_torch.mesh import Mesh

    grids = {}
    for n, (mesh_name, *_rest) in GOLDEN_CASES.items():
        v, t, bounds = load_mesh(os.path.join(RESOURCES, mesh_name))
        # nx = n - 2 plus one cell of padding per side: the golden's grid
        grids[n] = (Mesh(v, t), sizing_python_api(
            np.asarray(bounds[0], np.float32),
            np.asarray(bounds[1], np.float32), nx=n - 2))
    return grids


def main():
    import torch

    from sdfgenfast_tpu_torch import (generate_from_file, generate_from_mesh,
                                      generate_sdf, generate_sdf_batch,
                                      require_cuda)
    from sdfgenfast_tpu_torch.grid import (sizing_mode2a_proportional,
                                           sizing_python_api)
    from sdfgenfast_tpu_torch.io import native
    from sdfgenfast_tpu_torch.kernels import build
    from sdfgenfast_tpu_torch.mesh import torus_mesh
    from sdfgenfast_tpu_torch.ops import (band_kernel, dense, recompute,
                                          sign_kernel, vdt_kernel)
    from sdfgenfast_tpu_torch.tools import micro_bench as mb
    from sdfgenfast_tpu_torch.testing import box36
    from sdfgenfast_tpu_torch.pipeline import SDFConfig, bin_mesh, make_level_set3
    from sdfgenfast_tpu_torch.upload import to_host

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
    cases = GOLDEN_CASES
    grids = sphere_grids()
    box = box36()
    box_grid = sizing_mode2a_proportional(*box.bounds(), 256, 1)
    torus = torus_mesh(32, 16)  # 1024 triangles: K1's streamed table
    torus_grid = sizing_python_api(*torus.bounds(), nx=254)
    if box_grid.shape != (256, 341, 425) or torus_grid.shape != (256, 256, 75):
        raise AssertionError(f"dense grids {box_grid.shape} {torus_grid.shape}")
    k1 = check_k1(torch, device, box, box_grid, torus, torus_grid)
    k1_table = check_sep_table(torch, device, card, box, box_grid, torus,
                               torus_grid)
    sep_table_steps(torch, device, card, box, box_grid)
    sign_rows = check_sign_kernel(torch, device, card, box, box_grid, grids)
    sign_kernel_steps(torch, device, card, box, box_grid, grids)
    k2 = check_k2(torch, device, *grids[256])
    k3_err = check_k3(torch, device)
    k4_err, k4_plain = check_k4(torch, device,
                                os.path.join(RESOURCES, cases[256][0]))
    check_r1b_cases(torch, device, box, torus, torus_grid)
    terms_err = check_r1_cases(torch, device, box, torus, torus_grid)
    probe_err = check_probes(torch, device)

    # -- 4a. the binned path against the reference binary's goldens --------
    binned_counters = (band_kernel.band_coefs, band_kernel.band_rows,
                       vdt_kernel.round_phase, vdt_kernel.chamfer,
                       sign_kernel.parity_sign)
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
        # 2 chamfer passes in one K4 launch; the sign in place on its field
        rounds = {256: 19, 512: 20}[n]
        if call != {"band_coefs": 1, "band_rows": 1, "round_phase": rounds,
                    "chamfer": 1, "parity_sign": 1}:
            raise AssertionError(f"sphere82k {n}^3 launches {call}")
        for k, v in call.items():
            launches[k] += v
    print(f"binned-path launches: {launches}", flush=True)

    # -- 4b. the dense path: CLI goldens, box36, torus1024, a batch ----------
    cli_goldens()
    dense_counters = (dense.dense_stream, dense.sep_table,
                      sign_kernel.parity_sign)
    for fn in dense_counters:
        fn.launches = 0
    t0 = time.perf_counter()
    box_phi = generate_sdf(box.verts, box.tris, box_grid.origin, box_grid.dx,
                           *box_grid.shape, device=device)
    box_cold = time.perf_counter() - t0
    dense_calls = {"box36": {fn.__name__: fn.launches
                             for fn in dense_counters}}
    for fn in dense_counters:
        fn.launches = 0
    torus_phi, torus_meta = generate_from_mesh(torus.verts, torus.tris,
                                               nx=254, device=device)
    dense_calls["torus1024"] = {fn.__name__: fn.launches
                                for fn in dense_counters}
    dense_launches = {k: c["dense_stream"] for k, c in dense_calls.items()}
    table_launches = {k: c["sep_table"] for k, c in dense_calls.items()}
    sign_launches = {k: c["parity_sign"] for k, c in dense_calls.items()}
    launches["dense_stream"] = sum(dense_launches.values())
    print(f"dense-path launches: K1 {dense_launches}, its table "
          f"{table_launches}, the sign {sign_launches}; box36 cold call "
          f"{box_cold:.3f} s", flush=True)
    if any(c != {"dense_stream": 1, "sep_table": 1, "parity_sign": 1}
           for c in dense_calls.values()):
        raise AssertionError("box36 and torus1024 take one K1 launch, one "
                             "table launch and one sign launch each")
    if torus_meta["dx"] != torus_grid.dx or torus_phi.shape != torus_grid.shape:
        raise AssertionError("generate_from_mesh sized the torus differently")
    check_dense_vs_binned(torch, device, "box36", box, box_grid, box_phi)
    check_dense_vs_binned(torch, device, "torus1024", torus, torus_grid,
                          torus_phi)

    sphere = grids[256][0]
    m_sphere = len(sphere.tris)
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
    per_case = probe_res["launches_per_case"]
    print(f"probe tool launches: {probe_launches} ({per_case} a case: a "
          f"warm-up and the timed calls)", flush=True)
    # P1 twice (with and without FMA), P3 twice (its two block sizes), P2
    # and P4 once, each case through its kernel
    want = {"vpu_peak": 2 * per_case, "vpu_mixed": per_case,
            "grid_overhead": 2 * per_case, "hbm_stream": per_case}
    if probe_launches != want:
        raise AssertionError(f"probe tool launches {probe_launches}, want "
                             f"{want}")
    for g in probe_res["grid_overhead"]:
        if g["launch"]["grid"] != g["blocks"]:
            raise AssertionError(f"P3 launched {g['launch']} for "
                                 f"{g['blocks']} TPU grid steps")
        print(f"P3 {g['blocks']} x ({g['rows']}, {mb.GRID_COLS}): one CTA "
              f"per TPU grid step, {g['launch']}", flush=True)
    sass = sass_text(lib_path)
    if sass is None:
        print("cuobjdump not found: SASS counts not taken", flush=True)
    else:
        for name, c in sorted(sass_counts(sass).items()):
            print(f"  SASS {name}: FFMA {c['FFMA']}, FMUL {c['FMUL']}, "
                  f"FADD {c['FADD']}", flush=True)
        for name, c in sorted(sass_memory(sass, r"tile_kernel").items()):
            print(f"  SASS {name} copies, barriers and fences: {c}",
                  flush=True)
        for name, c in sorted(sass_inner_loops(
                sass, r"dense_stream|band_rows|chamfer_fused").items()):
            print(f"  SASS {name} inner loop: " + (
                "none found" if c is None else
                f"{c[0]} instructions, {c[1]} FP32, {c[2]} LDS") + (
                f"; the bound counts 8 x {OPS_BAND_PAIR} + {OPS_BAND_ROW} = "
                f"{8 * OPS_BAND_PAIR + OPS_BAND_ROW} FP32 operations per "
                f"candidate and row" if name == "band_rows_kernel" else ""),
                flush=True)
        # R1b's SASS beside the bound's count: the code computes each path
        # in full (recomputations included, divisions and sqrt expanded),
        # the bound only what each path needs
        for name, c in sorted(sass_fp32(sass, r"recompute_vjp").items()):
            print(f"  SASS {name}: {c} FP32 instructions; the bound's "
                  f"operations per cell: {OPS_R1B_CELL} + {OPS_R1B_PLANE} "
                  f"(plane case) or {OPS_R1B_EDGES} + {OPS_R1B_SEG} per "
                  f"segment (outside)", flush=True)
        # the fixed-order side (kRows, the second template argument, true)
        # holds no atomic instruction; the atomic side does
        for name, (ins, _) in sorted(sass_functions(sass).items()):
            rows = re.match(r"recompute_vjp_kernel<[^,]+, (true|false)", name)
            if rows is None:
                continue
            atomics = sum(bool(re.search(r"\b(RED|REDG|ATOM|ATOMG)\.", op))
                          for _, op in ins)
            print(f"  SASS {name}: {atomics} global atomic instructions",
                  flush=True)
            if (atomics > 0) != (rows.group(1) == "false"):
                ops = sorted({op.split()[0] for _, op in ins
                              if not op.startswith("@")})
                raise AssertionError(f"{name}: {atomics} global atomic "
                                     f"instructions; mnemonics {ops}")

    # -- 4d. the differentiable path: SDFGenerator.train_step, both halves --
    diff_counters = (band_kernel.band_coefs, band_kernel.band_rows,
                     vdt_kernel.round_phase, vdt_kernel.chamfer,
                     dense.dense_stream, recompute.recompute_terms,
                     recompute.recompute_forward, recompute.recompute_backward,
                     sign_kernel.parity_sign)
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
        # the step decodes the parity once for R1 and R1b, and signs nothing
        # else
        if r["launches"]["parity_sign"] != 1:
            raise AssertionError(f"differentiable {label}: "
                                 f"{r['launches']['parity_sign']} sign "
                                 f"launches a step, want 1")
    need = {"sphere82k": ("band_coefs", "band_rows", "round_phase",
                          "chamfer", "recompute_forward",
                          "recompute_backward"),
            "box36": ("dense_stream", "recompute_forward",
                      "recompute_backward")}
    # R1's table launch where r1_config takes the shared form
    for label, m in (("sphere82k", m_sphere), ("box36", len(box.tris))):
        if recompute.r1_config(m)[0] == "shared":
            need[label] += ("recompute_terms",)
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
    r1b_dense_times([("box36", box, box_grid)] + r1b_tori())
    r1b_work = {label: r1b_paths(torch, r["tv"], r["tid"], r["gphi"],
                                 *r["args"][:2])
                for label, r in diff.items()}
    r1_work = {label: r1b_paths(torch, r["tv"], r["tid"], None,
                                *r["args"][:2])
               for label, r in diff.items()}
    box_tv = diff["box36"]["tv"]
    terms_plain = cuda_ms(torch, lambda: recompute.recompute_terms_reference(
        box_tv), 10)
    # keep the numbers only: the breakdowns below read peak device memory
    diff = {label: {k: r[k] for k in ("launches", "r1_err", "r1b_err")}
            for label, r in diff.items()}
    torch.cuda.empty_cache()
    # K4 and R1 queued behind the spin, min and median of three repeats
    k4_r1 = k4_r1_times()
    # P3 and P4 beside torch's own calls, queued the same way
    probe_t = probe_times()
    k4_ms = k4_r1["k4"][1]
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
                  "copy to host (to_host)": [],
                  "old copy (.cpu().numpy())": []}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARM_CALLS):
            t0 = time.perf_counter()
            binned = bin_mesh(mesh, grid)
            t1 = time.perf_counter()
            phi = make_level_set3(mesh, grid, binned=binned, device=device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            to_host(phi)
            t3 = time.perf_counter()
            phi.cpu().numpy()
            t4 = time.perf_counter()
            for key, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
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
              "copy to host (to_host)": [], "old copy (.cpu().numpy())": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARM_CALLS):
        t0 = time.perf_counter()
        binned = bin_mesh(box, box_grid)
        t1 = time.perf_counter()
        phi = make_level_set3(box, box_grid, binned=binned, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        to_host(phi)
        t3 = time.perf_counter()
        phi.cpu().numpy()
        t4 = time.perf_counter()
        for key, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
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

    # -- 6. the non-default far fields and schedules ------------------------
    # after the main path's timings, so that their CPU work (the CPU
    # twins, the exact sample) does not touch the main path's host times:
    # each route at 256^3 (the flat ladder also at 512^3) against the
    # goldens, every route at 64^3 on the card and on the CPU, one
    # train_step in propagate and in eikonal mode (each checks its own
    # launches)
    torch.cuda.empty_cache()
    routes = far_field_routes(torch, device, card, results[256]["path"],
                              *grids[256], *cases[256][1:])
    torch.cuda.empty_cache()
    routes.update(far_field_routes(torch, device, card, results[512]["path"],
                                   *grids[512], *cases[512][1:],
                                   routes=(ROUTE_512,)))
    torch.cuda.empty_cache()
    routes_card_vs_cpu(torch, device)
    mode_train_steps(torch, device, *grids[256])
    torch.cuda.empty_cache()

    # the new routes: wall per call and its split, the torch modules'
    # stream times, and K3 summed over one call of each exact route
    route_times(torch, device, card, *grids[256], ROUTES)
    torch.cuda.empty_cache()
    route_times(torch, device, card, *grids[512], (ROUTE_512,))
    for name, knobs, _ in ROUTES + (ROUTE_512,):
        if knobs.get("far_field", "exact") != "exact":
            continue
        torch.cuda.empty_cache()
        n = 512 if name == "flat512" else 256
        _, count, _ = k3_call_time(torch, device, card, results[n]["path"],
                                   n - 2, config=SDFConfig(**knobs),
                                   label=f"route {name}")
        if count != routes[name]["launches"]["round_phase"]:
            raise AssertionError(f"route {name}: {count} K3 rounds timed")

    # -- 7. the device sign ---------------------------------------------------
    # after every timing above, so that its host work does not touch them:
    # box36 (dense), sphere82k at 256^3 and 512^3 (binned) and eikonal at
    # 256^3 in sign_mode="device" against the host sign, a train_step in
    # each mode, then the device parity's times beside the host parity's
    torch.cuda.empty_cache()
    sign_phase = device_sign_phase(torch, device, card, grids, cases, box,
                                   box_grid)
    torch.cuda.empty_cache()
    sign_steps = device_sign_steps(torch, device, grids, box, box_grid)
    torch.cuda.empty_cache()
    device_sign_times(torch, device, card, sign_phase)

    # -- 8. the sharded path ---------------------------------------------------
    # parallel/sharded.py on ["cuda:0"] * 4: the changed kernels at the
    # shards' offsets, every case bit-equal to its single-device run with
    # the launches its schedule gives, the sharded train_step, the walls
    torch.cuda.empty_cache()
    _, cube = box36_cube()
    offset_err = check_offset_kernels(torch, device, *grids[256])
    shard_launches, shard_digests = sharded_phase(torch, device, grids, cases,
                                                  box, cube)
    torch.cuda.empty_cache()
    shard_steps = sharded_steps(torch, device, grids, box, cube)
    torch.cuda.empty_cache()
    shard_times = sharded_times(torch, device, card, grids, box, cube)

    # -- 9. the sharded sweep modes and the multi-process path ---------------
    # eikonal and propagate on ["cuda:0"] * 4 against the single device, a
    # train_step in each; then two processes sharing the card (gloo), every
    # case bit-equal to its single-process run above
    torch.cuda.empty_cache()
    sweep_phase = sharded_sweep_phase(torch, device, grids)
    torch.cuda.empty_cache()
    sweep_steps = sharded_sweep_steps(torch, device)
    refs = multihost_refs(torch, device, grids, shard_digests, sweep_phase)
    mh_results = multihost_phase(
        torch, device, card, grids, refs,
        {label: r["walls_ms"] for label, r in shard_times.items()})

    # -- 10. transfers (upload.py) ------------------------------------------
    # after every earlier phase, so that no earlier number moves: the blob
    # upload against the per-array one, every download and entry point
    # against .cpu().numpy(), the race check, then new route beside old
    torch.cuda.empty_cache()
    check_uploads(torch, device, grids, box, box_grid)
    check_downloads(torch, device, make_level_set3(*grids[256],
                                                   device=device))
    torch.cuda.empty_cache()
    fresh = check_entry_points(torch, device, grids, box, box_grid)
    print(f"[{card}] fresh processes, the kernel library built: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in fresh.items()), flush=True)
    torch.cuda.empty_cache()
    transfers = transfer_times(torch, device, card, grids, box, box_grid)
    transfers["fresh_process_s"] = fresh
    print("transfers " + json.dumps(transfers), flush=True)

    # -- 11. the flagship torus, box64/128 and the port's tools ---------------
    # after every earlier phase, so that no earlier number moves: torus100k
    # at 256 and 512 against the analytic torus with exact launches, box64
    # and box128 against the binned path, tools.bench, profile_stages and
    # batch_bench, then the torus's kernel-table rows
    torch.cuda.empty_cache()
    big_torus, flagship = torus_oracle_phase(torch, device, card)
    torch.cuda.empty_cache()
    box_classes_phase(torch, device)
    torch.cuda.empty_cache()
    tools_phase(torch, device, card)
    torus_rows, torus_bounds = [], {}
    for nx, (tgrid, tlaunches, _) in flagship.items():
        torch.cuda.empty_cache()
        rows, b = torus_kernel_rows(torch, device, card, big_torus, tgrid,
                                    tlaunches)
        torus_rows += rows
        torus_bounds.update(b)

    # -- 12. stress_256, kernel_bench and scaling_bench ----------------------
    # after every earlier phase, so that no earlier number moves: the
    # repeat-stress with its memory readings, the queued dense stages
    # against dense_sign_core, the sharded path on 1, 2 and 4 shards of
    # this card against one
    from sdfgenfast_tpu_torch.tools.scaling_bench import device_lists

    torch.cuda.empty_cache()
    stress_phase(card)
    torch.cuda.empty_cache()
    kernel_bench_phase(torch, device)
    scaling_phase(torch, device_lists(device), (128,))

    # the bounds at the shapes timed (see bound_ms)
    n_box, n_torus = int(np.prod(box_grid.shape)), int(np.prod(torus_grid.shape))
    n_256 = int(np.prod(grids[256][1].shape))
    m_box = len(box.tris)
    bounds = {
        # K1 at the share of pairs its cull evaluated in this run
        "dense_stream": k1_bound(n_box, len(box.tris), k1["evaluated_share"]),
        "dense_stream_torus1024": k1_bound(n_torus, len(torus.tris),
                                           k1["torus_evaluated_share"]),
        "sep_table": (k1_table["box36"]["bound_ms"],
                      k1_table["box36"]["bound_by"]),
        "sep_table_torus1024": (k1_table["torus1024"]["bound_ms"],
                                k1_table["torus1024"]["bound_by"]),
        "parity_sign": (sign_rows[SIGN_ROW]["sign_bound_ms"], "bytes"),
        "parity_sign_decode": (sign_rows[SIGN_ROW]["decode_bound_ms"],
                               "bytes"),
        "band_coefs": k2["bounds"]["coefs"],
        "band_rows": k2["bounds"]["walk"],
        "vdt_round": k3_bound(grids[256][1].shape),
        # all passes of a call: each cell read once and written once
        "chamfer": bound_ms(2 * n_256 * 26 * OPS_CHAMFER_OFFSET, 8 * n_256),
        "recompute_terms": bound_ms(OPS_R1_TERMS * m_box,
                                    (36 + 4 * recompute.R1_TERMS) * m_box),
        "recompute_phi": r1_bound(r1_work["sphere82k"], m_sphere, n_256),
        "recompute_vjp": r1b_bound(r1b_work["sphere82k"], m_sphere, n_256),
        "recompute_phi_box36": r1_bound(r1_work["box36"], m_box, n_box),
        "recompute_vjp_box36": r1b_bound(r1b_work["box36"], len(box.tris),
                                         n_box),
    }
    for label, key in (("sphere82k", ""), ("box36", "_box36")):
        r1_cells, r1_inside, _ = r1_work[label]
        cells, inside, segs = r1b_work[label]
        t = diff_times[label]
        r1_ms = k4_r1[f"r1_{label}"][1]
        print(f"[{card}] R1/R1b {label}: R1 {r1_ms:.4f} ms (median), bound "
              f"{bounds['recompute_phi' + key][0]:.4f} ms "
              f"({bounds['recompute_phi' + key][1]}) at {r1_cells} cells with "
              f"a triangle, {r1_inside} in the plane case; R1b "
              f"{t['r1b']:.4f} ms, "
              f"bound {bounds['recompute_vjp' + key][0]:.4f} ms "
              f"({bounds['recompute_vjp' + key][1]}) at {cells} cells with a "
              f"gradient, {inside} in the plane case, {segs} segment "
              f"backward passes", flush=True)
    # the probes' instructions per step: P1 two multiplies and two adds, or
    # two FMAs; P2 three multiplies (a*b, d*d, b*0.999), two adds, a compare
    # and a select (7)
    n_vpu, n_hbm = int(np.prod(mb.VPU_SHAPE)), int(np.prod(mb.HBM_SHAPE))
    bounds.update(
        vpu_peak=bound_ms(n_vpu * mb.PEAK_CHAIN * 4, 8 * n_vpu),
        vpu_peak_fma=bound_ms(n_vpu * mb.PEAK_CHAIN * 2, 8 * n_vpu),
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
            ("K4 chamfer (2 passes, one launch)", "chamfer", "256^3", k4_ms,
             k4_plain)):
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
    # P1 and P2 as the tool timed them; P3 and P4 (and torch's own x * 2
    # and x + 1) by probe_times, the tool's time beside
    grid_res = {g["rows"]: g for g in probe_res["grid_overhead"]}
    probe_ms = {"vpu_peak": probe_res["vpu_peak"]["ms"],
                "vpu_peak_fma": probe_res["vpu_peak_fma"]["ms"],
                "vpu_mixed": probe_res["vpu_mixed"]["ms"],
                "grid_overhead_b128": probe_t["p3_b128"][1],
                "grid_overhead_b1024": probe_t["p3_b1024"][1],
                "hbm_stream": probe_t["p4"][1]}
    probe_lib = {"grid_overhead_b128": probe_t["mul_b128"][1],
                 "grid_overhead_b1024": probe_t["mul_b1024"][1],
                 "hbm_stream": probe_t["add"][1]}
    tool_ms = {"grid_overhead_b128": grid_res[128]["ms"],
               "grid_overhead_b1024": grid_res[1024]["ms"],
               "hbm_stream": probe_res["hbm_stream"]["ms"]}
    for name, ms in probe_ms.items():
        b, by = bounds[name]
        lib = probe_lib.get(name)
        print(f"[{card}] probe {name}: kernel {ms:.4f} ms"
              + (f" (the tool's run {tool_ms[name]:.4f} ms)"
                 if name in tool_ms else "")
              + f", plain torch {probe_err[name][1]:.3f} ms"
              + (f", torch's own call {lib:.4f} ms" if lib else "")
              + f", bound {b:.4f} ms ({by}), {b / ms:.1%} of the bound",
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
        # K1's table, byte-equal to the torch ops it replaces (jnp in the
        # JAX package, no Pallas kernel); plain: those ops back to back
        {"name": "sep_table", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/dense.cu",
         "replaces": "sdfgenfast_tpu/ops/dense.py:68",
         "launches": table_launches["box36"],
         "max_abs_err": k1_table["box36"]["max_abs_err"],
         "ms": k1_table["box36"]["kernel_ms"],
         "plain_ms": k1_table["box36"]["torch_ops_unqueued_ms"]},
        {"name": "sep_table_torus1024", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/dense.cu",
         "replaces": "sdfgenfast_tpu/ops/dense.py:68",
         "launches": table_launches["torus1024"],
         "max_abs_err": k1_table["torus1024"]["max_abs_err"],
         "ms": k1_table["torus1024"]["kernel_ms"],
         "plain_ms": k1_table["torus1024"]["torch_ops_unqueued_ms"]},
        # the sign stage on box36's crossings (jnp in the JAX package, no
        # Pallas kernel): the sign (launches: box36's generate call), and
        # the decode alone (launches: box36's train step); plain: the torch
        # ops it replaces on the same card
        {"name": "parity_sign", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/sign.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:537",
         "launches": sign_launches["box36"],
         "max_abs_err": sign_rows[SIGN_ROW]["sign_max_abs_err"],
         "ms": sign_rows[SIGN_ROW]["sign_ms"],
         "plain_ms": sign_rows[SIGN_ROW]["twin_sign_ms"]},
        {"name": "parity_sign_decode", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/sign.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:555",
         "launches": diff["box36"]["launches"]["parity_sign"],
         "max_abs_err": sign_rows[SIGN_ROW]["decode_max_abs_err"],
         "ms": sign_rows[SIGN_ROW]["decode_ms"],
         "plain_ms": sign_rows[SIGN_ROW]["twin_decode_ms"]},
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
         "plain_ms": probe_err[name][1], "library_ms": probe_lib.get(name)}
        for name, wrapper, line in probe_rows
    ] + [
        # no Pallas counterpart: the JAX package differentiates jnp code
        {"name": "recompute_phi", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": sphere["launches"]["recompute_forward"],
         "max_abs_err": sphere["r1_err"],
         "ms": k4_r1["r1_sphere82k"][1],
         "plain_ms": diff_times["sphere82k"]["r1_twin"]},
        {"name": "recompute_vjp", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": sphere["launches"]["recompute_backward"],
         "max_abs_err": sphere["r1b_err"],
         "ms": diff_times["sphere82k"]["r1b"],
         "plain_ms": diff_times["sphere82k"]["r1b_twin"]},
        # R1's table launch on box36 (the shared form): its device time
        # in the R1 call
        {"name": "recompute_terms", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": diff["box36"]["launches"]["recompute_terms"],
         "max_abs_err": terms_err,
         "ms": k4_r1["r1_box36_split"]["recompute_terms_kernel"][0],
         "plain_ms": terms_plain},
        {"name": "recompute_phi_box36", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": diff["box36"]["launches"]["recompute_forward"],
         "max_abs_err": diff["box36"]["r1_err"],
         "ms": k4_r1["r1_box36"][1],
         "plain_ms": diff_times["box36"]["r1_twin"]},
        {"name": "recompute_vjp_box36", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/recompute.cu",
         "replaces": "sdfgenfast_tpu/pipeline.py:341",
         "launches": diff["box36"]["launches"]["recompute_backward"],
         "max_abs_err": diff["box36"]["r1b_err"],
         "ms": diff_times["box36"]["r1b"],
         "plain_ms": diff_times["box36"]["r1b_twin"]},
    ]
    # the flagship torus's rows (phase 11e), each with its own call's launches
    kernels += torus_rows
    bounds.update(torus_bounds)
    # the launches each new route made (phase 4e), beside the main path's
    by_route = {"band_coefs": "band_coefs", "band_rows": "band_rows",
                "vdt_round": "round_phase", "chamfer": "chamfer",
                "recompute_phi": "recompute_forward"}
    # and each device-sign case's (phase 7; the steps': R1 and R1b), and
    # each sharded case's, over its four shards (phase 8)
    by_sign = dict(by_route, dense_stream="dense_stream",
                   recompute_vjp="recompute_backward")
    for row in kernels:
        if row["name"] in by_sign:
            key = by_sign[row["name"]]
            row["launches_sharded"] = {
                f"{label} {shape}": n[key]
                for label, d in shard_launches.items()
                for shape, n in d.items()}
            row["launches_sharded"].update({
                f"step {label} 2x2": r["launches"][key]
                for label, r in shard_steps.items()})
            # phase 9: the sweep modes over four shards and their steps,
            # and each of the two processes' launches in each case
            row["launches_sharded_sweep"] = {
                f"{mode} sphere82k 256^3 2x2": r["launches"][key]
                for mode, r in sweep_phase.items()}
            row["launches_sharded_sweep"].update({
                f"step {mode} icosphere(4) 64^3 2x2": r["launches"][key]
                for mode, r in sweep_steps.items()})
            row["launches_multihost"] = {
                label: [r[label]["launches"][key] for r in mh_results]
                for label in mh_results[0] if label != "batch"}
        if row["name"] in offset_err:
            row["max_abs_err_offsets"] = offset_err[row["name"]]
        row["bound_ms"], row["bound_by"] = bounds[row["name"]]
        row.setdefault("library_ms", None)
        if row["name"] in by_route:
            row["launches_by_route"] = {
                name: r["launches"][by_route[row["name"]]]
                for name, r in routes.items()}
        if row["name"] in by_sign:
            key = by_sign[row["name"]]
            row["launches_device_sign"] = {
                label: r["launches"][key] for label, r in list(
                    sign_phase.items()) + [(f"step {k}", v) for k, v in
                                           sign_steps.items()]
                if "launches" in r}
    # a kernel above its bound means a wrong count or a wrong time
    over = [(row["name"], row["bound_ms"] / row["ms"]) for row in kernels
            if row["bound_ms"] > row["ms"]]
    if over:
        raise AssertionError(f"kernels above 100% of their bound: {over}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--multihost-worker"]:
        multihost_worker(*sys.argv[2:7])
    elif sys.argv[1:] == ["--four-cards"]:
        four_cards()
    elif sys.argv[1:]:
        sys.exit(f"unknown arguments {sys.argv[1:]}: none, "
                 "--four-cards or --multihost-worker RANK WORLD BACKEND "
                 "PORT OUT")
    else:
        main()
