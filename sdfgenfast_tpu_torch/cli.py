"""SDFGen-compatible command-line interface of the PyTorch + CUDA port.

Counterpart of ``sdfgenfast_tpu/cli.py``: the reference CLI's three
positional-argument modes, mode detection, grid sizing, output naming and
console reporting (``app/main.cpp:27-368``):

  Mode 1  : SDFGen <file.obj> <dx> <padding> [threads]
  Mode 2a : SDFGen <file.stl> <Nx> [padding] [threads]
  Mode 2b : SDFGen <file.stl> <Nx> <Ny> <Nz> [padding] [threads]

Including the reference's argc==5 ambiguity heuristic (argv[3] < 20 => mode
2a, app/main.cpp:114) and the ``_sdf_{nx}x{ny}x{nz}.sdf`` output suffix in
mode 2 (app/main.cpp:321-328). `threads` is accepted and ignored.

The device comes from ``SDFGEN_TORCH_BACKEND`` (``auto`` | ``gpu`` |
``cpu``, default ``auto``), resolved exactly as the API's ``backend``:
``auto`` and ``gpu`` need CUDA and exit 255 without it; only ``cpu`` runs
the plain-torch path. ``SDFGEN_TORCH_VTI=1`` writes ``.vti`` instead of
``.sdf`` (the runtime analog of the reference's HAVE_VTK build).

Run as: python -m sdfgenfast_tpu_torch.cli <args>   (or ``sdfgen-torch``).
"""

from __future__ import annotations

import os
import re
import sys

USAGE = """\
SDFGen - A utility for converting closed oriented triangle meshes into grid-based signed distance fields.

=== Mode 1: Legacy OBJ with dx spacing ===
Usage: SDFGen <file.obj> <dx> <padding> [threads]

Where:
  <file.obj>  Wavefront OBJ file (text format, triangles only)
  <dx>        Grid cell size (determines resolution automatically)
  <padding>   Number of padding cells around mesh (minimum 1)
  [threads]   Optional: ignored (GPU parallelism is used)

=== Mode 2a: STL with proportional dimensions (recommended) ===
Usage: SDFGen <file.stl> <Nx> [padding] [threads]

Where:
  <file.stl>  Binary or ASCII STL file
  <Nx>        Grid size in X dimension (Ny, Nz calculated proportionally)
  [padding]   Optional padding cells (default: 1)

=== Mode 2b: STL with manual dimensions ===
Usage: SDFGen <file.stl> <Nx> <Ny> <Nz> [padding] [threads]

Output: Binary SDF file with 36-byte header + float32 grid data
Header: 3 ints (Nx,Ny,Nz) + 6 floats (bounds_min, bounds_max)

=== Hardware Acceleration ===
CUDA (PyTorch + hand-written kernels) is required by default.
SDFGEN_TORCH_BACKEND=cpu runs the plain PyTorch path on the CPU instead.
"""

BACKEND_ENV = "SDFGEN_TORCH_BACKEND"
VTI_ENV = "SDFGEN_TORCH_VTI"


def _atoi(s: str) -> int:
    """C `atoi` semantics: the longest leading integer prefix after optional
    whitespace/sign; 0 if none (app/main.cpp:114-162)."""
    m = re.match(r"[+-]?\d+", s.lstrip())
    return int(m.group(0)) if m else 0


def _atof(s: str) -> float:
    """C `atof` semantics: the longest leading float prefix, 0.0 if none
    (app/main.cpp:204-206)."""
    m = re.match(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?", s.lstrip())
    return float(m.group(0)) if m else 0.0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    argc = len(argv)

    mode_precise = False
    filename = argv[1] if argc >= 2 else ""
    is_stl = filename.lower().endswith(".stl") and len(filename) >= 4
    if is_stl and argc >= 3:
        mode_precise = True

    if (not mode_precise and argc < 4) or (mode_precise and argc < 3):
        print(USAGE)
        return -1 & 0xFF  # the reference exits -1 (app/main.cpp:82)

    import torch

    from .grid import (
        sizing_mode1_legacy,
        sizing_mode2a_proportional,
        sizing_mode2b_manual,
    )
    from .io import mesh_io, sdf_io
    from .pipeline import SDFConfig, make_level_set3
    from .platform import resolve_device

    print("========================================")
    print("SDFGen - SDF Generation Tool (CUDA)")
    print("========================================\n")

    padding = 1

    if mode_precise:
        print("Mode: Precise grid dimensions (STL)")
        print(f"Input: {filename}\n")
        try:
            mesh, min_box, max_box = mesh_io.load_stl(filename)
        except mesh_io.MeshLoadError as e:
            print(f"Failed to load STL file. {e}", file=sys.stderr)
            return 255
        mesh_size = max_box - min_box

        # argc==5 ambiguity heuristic: argv[3] < 20 => mode 2a (app/main.cpp:114)
        is_mode2a = argc == 3 or argc == 4 or (argc == 5 and _atoi(argv[3]) < 20)
        if is_mode2a:
            target_nx = _atoi(argv[2])
            if argc >= 4:
                padding = _atoi(argv[3])
            if target_nx <= 0:
                print("Error: Grid dimension must be a positive integer.",
                      file=sys.stderr)
                return 255
            if padding < 1:
                padding = 1
            grid = sizing_mode2a_proportional(min_box, max_box, target_nx,
                                              padding)
            print("Mode: Proportional dimensions (single parameter)")
            print(f"Input Nx: {target_nx}")
            print(f"Calculated grid: {grid.ni} x {grid.nj} x {grid.nk}")
            print(f"Padding: {padding} cells\n")
            print("Grid spacing calculation:")
            print(f"  Mesh size: {mesh_size[0]} x {mesh_size[1]} x "
                  f"{mesh_size[2]} m")
            print(f"  dx = {grid.dx:g} m (based on X dimension)")
            target = (target_nx, grid.nj, grid.nk)
        else:
            target = (_atoi(argv[2]), _atoi(argv[3]), _atoi(argv[4]))
            if argc >= 6:
                padding = _atoi(argv[5])
            if min(target) <= 0:
                print("Error: Grid dimensions must be positive integers.",
                      file=sys.stderr)
                return 255
            if padding < 1:
                padding = 1
            grid = sizing_mode2b_manual(min_box, max_box, *target, padding)
            print("Mode: Manual dimensions (three parameters)")
            print(f"Target grid: {target[0]} x {target[1]} x {target[2]}")
            print(f"Padding: {padding} cells\n")
            print("Grid spacing calculation:")
            print(f"  Mesh size: {mesh_size[0]} x {mesh_size[1]} x "
                  f"{mesh_size[2]} m")
            print(f"  Using dx = {grid.dx:g} m (maximum to fit all dimensions)")
    else:
        print("Mode: Legacy dx spacing (OBJ)")
        print(f"Input: {filename}\n")
        if len(filename) < 5 or not filename.lower().endswith(".obj"):
            print("Error: Mode 1 requires OBJ file (.obj extension).",
                  file=sys.stderr)
            return 255
        dx_in = _atof(argv[2])
        padding = _atoi(argv[3])
        if dx_in <= 0.0:
            print("Error: Grid spacing dx must be a positive number.",
                  file=sys.stderr)
            return 255
        if padding < 1:
            padding = 1
        print(f"Grid spacing (dx): {dx_in:g}")
        print(f"Padding: {padding} cells\n")
        try:
            mesh, min_box, max_box = mesh_io.load_obj(filename)
        except mesh_io.MeshLoadError as e:
            print(f"Failed to load OBJ file. Terminating. {e}", file=sys.stderr)
            return 255
        grid = sizing_mode1_legacy(min_box, max_box, dx_in, padding)
        target = None

    print("Computing signed distance field...")
    print(f"  Padded bounds: ({tuple(float(v) for v in grid.bounds_min)}) to "
          f"({tuple(float(v) for v in grid.bounds_max)})")
    print(f"  Grid dimensions: {grid.ni} x {grid.nj} x {grid.nk}")
    print(f"  Total cells: {grid.num_cells}")

    backend = os.environ.get(BACKEND_ENV, "auto")
    try:
        device = resolve_device(backend)
    except (ValueError, RuntimeError) as e:
        print(f"Error: no usable device for {BACKEND_ENV}={backend!r}: {e}. "
              f"The default needs CUDA; set {BACKEND_ENV}=cpu to run on the "
              "CPU.", file=sys.stderr)
        return 255
    print("  Hardware: ", end="")
    if device.type == "cuda":
        print(f"CUDA GPU {torch.cuda.get_device_name(device)}")
        print("  Implementation: CUDA (PyTorch + hand-written kernels)\n")
    else:
        print(f"CPU ({BACKEND_ENV}={backend})")
        print("  Implementation: CPU (plain PyTorch)\n")

    try:
        phi = make_level_set3(mesh, grid, SDFConfig(),
                              device=device).cpu().numpy()
    except (ValueError, RuntimeError) as e:
        print(f"Error: SDF computation failed: {e}", file=sys.stderr)
        return 255
    print("SDF computation complete.\n")

    base = filename[: filename.rfind(".")]
    suffix = f"_sdf_{grid.ni}x{grid.nj}x{grid.nk}" if mode_precise else ""
    if os.environ.get(VTI_ENV, "") not in ("", "0"):
        from .io.vti import write_vti

        outname = f"{base}{suffix}.vti"
        print(f"Writing VTK output to: {outname}")
        write_vti(outname, phi, grid.origin, grid.dx)
        inside_count = int((phi < 0.0).sum())
    else:
        outname = f"{base}{suffix}.sdf"
        print(f"Writing binary SDF to: {outname}")
        inside_count = sdf_io.write_sdf(outname, phi, grid.origin, grid.dx)
    total_count = grid.num_cells

    print("\n========================================")
    print("Output Summary")
    print("========================================")
    print(f"File: {outname}")
    print(f"Dimensions: {grid.ni} x {grid.nj} x {grid.nk}")
    if mode_precise and target is not None:
        match = (grid.ni, grid.nj, grid.nk) == target
        print(f"Target dimensions: {target[0]} x {target[1]} x {target[2]}")
        print(f"Match: {'OK' if match else 'FAIL'}")
    print(f"Grid spacing (dx): {grid.dx:g}")
    print(f"Inside cells: {inside_count} / {total_count} "
          f"({100.0 * inside_count / total_count:g}%)")
    size_mb = (36 + 4 * total_count) / (1024.0 * 1024.0)
    print(f"File size: {size_mb:g} MB")
    print("========================================")
    print("Processing complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
