"""The JAX package's far-field gap to the reference binary's sphere goldens,
per far-field route, on the CPU.

The PyTorch port's smoke (``chip_smoke.py``) holds each non-default route
to the golden's far-field bar of 0.2 dx, or, where the JAX package itself
misses 0.2 dx on that route, to the JAX package's gap + 0.05 dx. This
script measures those gaps:

    python tools/jax_far_field_gaps.py 128            # the dense 128^3 golden
    python tools/jax_far_field_gaps.py 256 flat capped

Routes: default (the pyramid), capped (``vdt_max_hop=8``), flat
(``vdt_extra_rounds=2``), tiles4x4x16, propagate, eikonal. Each prints the
largest |phi| - |golden| over the golden's far-field cells in dx, the sign
mismatches off the surface and the wall time.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = {
    "default": {},
    "capped": {"vdt_max_hop": 8},
    "flat": {"vdt_extra_rounds": 2},
    "tiles4x4x16": {"tile_shape": (4, 4, 16)},
    "propagate": {"far_field": "propagate"},
    "eikonal": {"far_field": "eikonal"},
}


def main(argv):
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from conftest import ensure_resource  # regenerates icosphere6.stl

    import sdfgenfast_tpu as J
    from sdfgenfast_tpu.grid import (sizing_mode2a_proportional,
                                     sizing_python_api)
    from sdfgenfast_tpu.io import mesh_io

    n = int(argv[0]) if argv else 128
    names = argv[1:] or list(ROUTES)
    mesh, mn, mx = mesh_io.load_mesh(ensure_resource("icosphere6.stl"))
    goldens = os.path.join(ROOT, "tests", "goldens")
    if n == 128:
        grid = sizing_mode2a_proportional(mn, mx, 128, 1)
        golden = J.load_sdf(os.path.join(
            goldens, "sphere6_stl_128_mode2a.sdf"))[0]

        def gap(phi):
            surf = np.minimum(np.abs(phi), np.abs(golden)) < 1e-5
            mism = int((((phi < 0) != (golden < 0)) & ~surf).sum())
            return float(np.abs(np.abs(phi) - np.abs(golden)).max()), mism
    elif n == 256:
        grid = sizing_python_api(mn, mx, nx=254)
        g = np.load(os.path.join(goldens, "sphere6_stl_256_mode2a.sparse.npz"))

        def gap(phi):
            flat = phi.reshape(-1)
            neg = np.unpackbits(g["packed_signs"])[: flat.size].astype(bool)
            mism = int(((neg != (flat < 0)) & ~(np.abs(flat) < 1e-5)).sum())
            far = np.abs(np.abs(phi[::4, ::4, ::4])
                         - np.abs(g["far_sample_stride4"])).max()
            return float(far), mism
    else:
        raise SystemExit("grid: 128 (dense golden) or 256 (sparse golden)")
    print(f"icosphere6.stl on {grid.shape}, dx {grid.dx:.6e}", flush=True)
    out = {}
    for name in names:
        # a small band chunk bounds the tile evaluator's temporaries; the
        # field does not depend on it
        cfg = J.SDFConfig(band_chunk=16, **ROUTES[name])
        t0 = time.perf_counter()
        phi = np.asarray(J.make_level_set3(mesh, grid, cfg))
        far, mism = gap(phi)
        out[name] = far / grid.dx
        print(f"JAX {name} {n}^3: far field {far / grid.dx:.4f} dx, {mism} "
              f"sign mismatches, {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"grid": n, "far_dx": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
