#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sdfgenfast_tpu_torch``) on one GPU.

Run from anywhere with ``python3 chip_smoke.py`` on a machine with an NVIDIA
Hopper card, nvcc and a C++ compiler. Phases (each raises on failure):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (nvcc) and the native host library (make);
  3. each kernel against its plain-torch twin on the card, at the shapes the
     main path gives it (K2 band rows, K3 jump-flood round, K4 chamfer);
  4. the main path, ``generate_from_file`` on the 81,920-triangle sphere at
     256^3 and 512^3, held against the reference binary's sparse goldens
     with the bars of tests/test_parity_golden.py; every kernel's launch
     counter must have moved during these calls;
  5. wall time per call (median and min of warm calls, host binning and the
     copy back included) and each kernel's time next to its twin's.

Prints one JSON line of per-kernel results, then the card line, then, as the
last line, ``{"ok": true, "device": {...}}``. Exits non-zero on any failure.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
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


def bits(torch, x):
    return x.contiguous().view(torch.int32)


def abs_err(got, want):
    """Largest |got - want| over float values, taken in float64."""
    return float((got.double() - want.double()).abs().max())


def seeded_state(torch, shape, dx, seed, device, n_seed=20000):
    """A (5, ni, nj, nk) VDT state: FAR everywhere except `n_seed` random
    cells holding a closest point near the cell, a random id and its d2."""
    from sdfgenfast_tpu_torch.ops import vdt

    rng = np.random.default_rng(seed)
    ni, nj, nk = shape
    state = np.full((5, ni, nj, nk), vdt.FAR, np.float32)
    ii, jj, kk = (rng.integers(0, n, n_seed) for n in shape)
    cp = (rng.normal(size=(3, n_seed)).astype(np.float32) * 0.3
          + np.stack([ii, jj, kk]).astype(np.float32) * np.float32(dx))
    state[0, ii, jj, kk], state[1, ii, jj, kk], state[2, ii, jj, kk] = cp
    state[3, ii, jj, kk] = rng.integers(0, 1 << 24, n_seed).astype(
        np.int32).view(np.float32)
    st = torch.from_numpy(state).to(device)
    px, py, pz = vdt._level_pos_axes(shape, dx, 1, device)
    st[4] = vdt._dist2(px, py, pz, st[0], st[1], st[2])
    return st


def check_k2(torch, device, mesh, grid):
    """K2 vs its twin on the main path's CSR: phi and cp within rtol 3e-6
    (atol 1e-6 for cells on the surface), ids equal except at exact d2
    ties. Returns (max_abs_err, kernel ms, twin ms)."""
    from sdfgenfast_tpu_torch.ops import band_kernel
    from sdfgenfast_tpu_torch.pipeline import bin_mesh

    binned = bin_mesh(mesh, grid)
    csr = binned.band_csr
    dx = float(np.float32(grid.dx))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    verts = dev(mesh.verts)
    origin = dev(np.asarray(grid.origin, np.float32))
    tri9 = (verts[dev(binned.tris).long()] - origin).reshape(-1, 9).contiguous()
    args = (tri9, dev(csr["pair"]), dev(csr["ids"]), dev(csr["off"]),
            dev(csr["cnt"]), dx)
    kw = dict(tiles_dim=binned.tiles_dim, grid_shape=grid.shape)
    got = band_kernel.band_rows(*args, **kw)
    want = band_kernel.band_rows_reference(*args, **kw)
    torch.cuda.synchronize()
    T = int(np.prod(binned.tiles_dim))
    rows = dev(csr["ids"][csr["ids"] < T]).long()
    g = [x[rows].cpu().numpy() for x in got]
    w = [x[rows].cpu().numpy() for x in want]
    err = 0.0
    for name, a, b in zip(("phi", "tid", "cpx", "cpy", "cpz"), g, w):
        if name == "tid":
            continue
        np.testing.assert_allclose(a, b, rtol=3e-6, atol=1e-6,
                                   err_msg=f"K2 {name}")
        err = max(err, float(np.abs(a - b).max()))
    mism = g[1] != w[1]
    if mism.any():
        # a different id is only allowed where the two distances tie
        np.testing.assert_allclose(g[0][mism], w[0][mism], rtol=3e-6,
                                   atol=1e-6, err_msg="K2 tid at non-tie")
        if mism.mean() > 1e-4:
            raise AssertionError(f"K2: {int(mism.sum())} tid mismatches")
    print(f"K2 band_rows vs twin: A={len(rows)} active tiles, "
          f"P={len(csr['pair'])}, tid mismatches {int(mism.sum())}, "
          f"max|err| {err:.3e}", flush=True)
    ms = cuda_ms(torch, lambda: band_kernel.band_rows(*args, **kw), 10)
    plain = cuda_ms(torch, lambda: band_kernel.band_rows_reference(*args, **kw), 2)
    return err, ms, plain


def check_k3(torch, device, full_shape,
             shapes=((128, 128, 128), (48, 41, 75))):
    """K3 vs its twin: bit-equal on all five channels for every stride
    and scale, at >= 128^3 and a ragged shape. Returns (max_abs_err, ms,
    plain_ms): the error over the float channels, and the times of one
    stride-1 round at the main path's full level."""
    from sdfgenfast_tpu_torch.ops import vdt_kernel

    dx = float(np.float32(0.02))
    n, err = 0, 0.0
    floats = [0, 1, 2, 4]  # channel 3 holds id bits
    for shape in shapes:
        st = seeded_state(torch, shape, dx, sum(shape), device)
        for scale in (1, 2, 4):
            for stride in (1, 2, 4, 8, 16, 32):
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
    print(f"K3 round_phase vs twin: {n} single rounds + 2 phases bit-equal",
          flush=True)
    st = seeded_state(torch, full_shape, dx, 1, device, n_seed=400000)
    ms = cuda_ms(torch, lambda: vdt_kernel.round_phase(st, dx, (1,), 1), 10)
    plain = cuda_ms(
        torch, lambda: vdt_kernel.round_phase_reference(st, dx, (1,), 1), 3)
    return err, ms, plain


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


def main():
    import torch

    from sdfgenfast_tpu_torch import generate_from_file, load_mesh, require_cuda
    from sdfgenfast_tpu_torch.grid import sizing_python_api
    from sdfgenfast_tpu_torch.io import native
    from sdfgenfast_tpu_torch.kernels import build
    from sdfgenfast_tpu_torch.mesh import Mesh
    from sdfgenfast_tpu_torch.ops import band_kernel, vdt_kernel
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
            if "registers" in line or "spill" in line:
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
    k2_err, k2_ms, k2_plain = check_k2(torch, device, *grids[256])
    k3_err, k3_ms, k3_plain = check_k3(torch, device, grids[256][1].shape)
    k4_err, k4_ms, k4_plain = check_k4(torch, device, grids[256][1].shape)

    # -- 4. the main path against the reference binary's goldens -------------
    band_kernel.band_rows.launches = 0
    vdt_kernel.round_phase.launches = 0
    vdt_kernel.chamfer.launches = 0
    results = {}
    for n, (mesh_name, golden, far_key, stride) in cases.items():
        path = os.path.join(RESOURCES, mesh_name)
        t0 = time.perf_counter()
        sdf, meta = generate_from_file(path, nx=n - 2, device=device)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        far = check_golden(sdf, os.path.join(GOLDENS, golden), far_key,
                           stride, grids[n][1])
        results[n] = {"cold_s": cold, "far_err_dx": far, "path": path}
        print(f"main path {sdf.shape}: golden bars met (0 sign mismatches, "
              f"exact band, far field {far:.4f} dx < 0.2 dx), cold call "
              f"{cold:.3f} s", flush=True)
    launches = {
        "band_rows": band_kernel.band_rows.launches,
        "round_phase": vdt_kernel.round_phase.launches,
        "chamfer": vdt_kernel.chamfer.launches,
    }
    print(f"main-path launches: {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    # -- 5. timings ---------------------------------------------------------
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
    for name, ms, plain in (("K2 band_rows", k2_ms, k2_plain),
                            ("K3 round (stride 1)", k3_ms, k3_plain),
                            ("K4 chamfer (2 passes)", k4_ms, k4_plain)):
        print(f"[{card}] {name} at 256^3: kernel {ms:.3f} ms, "
              f"plain torch {plain:.3f} ms", flush=True)

    kernels = [
        {"name": "band_rows", "route": "cuda",
         "source": "sdfgenfast_tpu_torch/csrc/band_rows.cu",
         "replaces": "sdfgenfast_tpu/ops/band_pallas.py:76",
         "launches": launches["band_rows"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
