"""Amortized device time of the dense path's two stages: calls queued back
to back, one synchronize at the end.

Counterpart of ``tools/kernel_bench.py``: the 12-triangle box
``box_mesh((3, 4, 5), (-1, -1, -1))`` on ``sizing_mode2a_proportional(mn,
mx, Nx, 1)`` for Nx in 64, 128, 256 (or those given), ``SDFConfig()``,
``bin_mesh(..., device=)``. Two stages, each called once, then ``REPS``
times queued, then one synchronize:

- "dense kernel": ``ops.dense.dense_distance_field`` on the gathered
  triangle vertices (K1 and its table, built by torch, as the main path
  runs them);
- "unpack+sign": ``ops.sign_kernel.parity_sign`` (one kernel on a card:
  the parity decoded and phi signed in one pass), the sign step of
  ``pipeline.dense_sign_core``, into a fresh tensor, fed from the parity
  transport that ``bin_mesh`` chose ("auto": the packed field or the int16
  crossings, whichever is smaller, the JAX package's choice on the same
  case).

The host clock over the queued calls gives ``ms/iter`` and the voxel rate,
as the JAX tool prints them. On the card each stage also has two device
clocks: CUDA events around the same queued calls (``event_ms``), and the
median of REPS more calls, each queued alone behind a spin of the card and
timed by CUDA events around it (``device_ms``), so that the host's
launches run ahead of the device and leave no gaps. ``device_ms`` below
``ms/iter`` means the host sets the pace.
Run on a machine with a card::

    python3 -m sdfgenfast_tpu_torch.tools.kernel_bench [Nx ...]

It prints the JAX tool's lines, the card's name and power limit and, last,
one JSON line; it raises, naming CUDA, when there is no card and no
``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from ..grid import sizing_mode2a_proportional
from ..mesh import box_mesh
from ..ops.dense import dense_distance_field
from ..ops.sign_kernel import parity_sign
from ..pipeline import SDFConfig, bin_mesh
from .timing import card_line, sync, tool_device

__all__ = ["REPS", "SPIN_CYCLES", "amortized", "spin_queued_ms", "inputs",
           "run", "main"]

REPS = 20
# the first spin, in clock cycles (~5 ms at the H100's 1.98 GHz); doubled
# until the host has queued a call before the spin ends
SPIN_CYCLES = 10_000_000


def amortized(name: str, fn, device, reps: int = REPS):
    """fn() once, then `reps` calls queued and one synchronize: (the last
    output, host ms per call, CUDA-event ms per call over the same calls
    or None on the CPU). Prints the JAX tool's line."""
    out = fn()
    sync(device)
    cuda = device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if cuda:
        end.record()
    sync(device)
    ms = (time.perf_counter() - t0) / reps * 1e3
    event_ms = start.elapsed_time(end) / reps if cuda else None
    dev = "" if event_ms is None else f" (events {event_ms:9.3f} ms/iter)"
    print(f"  {name:32s} {ms:9.3f} ms/iter{dev}", flush=True)
    return out, ms, event_ms


def spin_queued_ms(fn, reps: int = REPS, tries: int = 6) -> float:
    """Median device ms of `reps` calls of fn(), each queued alone behind a
    spin of the current CUDA device and timed by CUDA events around it:
    the spin is doubled until the host has queued the call (and its end
    event) before the start event ran. One call at a time: `reps` calls
    of a stage of many launches (K1's table is some 120 torch ops that
    launch) overrun the card's queue of pending launches, which blocks the
    host. Raises RuntimeError if the spin never outlasts the host."""
    cycles, times = SPIN_CYCLES, []
    while len(times) < reps:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            times.append(start.elapsed_time(end))
            continue
        tries -= 1
        if tries == 0:
            raise RuntimeError(f"the host did not queue one call within a "
                               f"spin of {cycles} cycles")
        cycles *= 2
    return statistics.median(times)


def inputs(mesh, grid, config, device):
    """(tri_verts, origin, parity data, transport name) on `device` from
    ``bin_mesh(mesh, grid, config, device=device)``'s blob."""
    binned = bin_mesh(mesh, grid, config, device=device)
    a = binned.device.arrays
    transport = "parity" if "parity" in a else "crossings"
    return a["verts"][a["tris"].long()], a["origin"], a[transport], \
        "packed" if transport == "parity" else "crossings"


def run(mesh, sizes, device, reps: int = REPS):
    """Both stages at each Nx of `sizes`; returns (the JSON line's object,
    {nx: (phi, tid, signed phi)}: the last queued call's outputs)."""
    device = torch.device(device)
    rows, outs = [], {}
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        for nx in sizes:
            row, outs[nx] = _size(mesh, nx, device, reps)
            rows.append(row)
    card = card_line(device)
    print(f"card: {card}", flush=True)
    return {"mesh": f"box_mesh((3, 4, 5), (-1, -1, -1)), "
                    f"{mesh.num_tris} tris",
            "rows": rows, "card": card}, outs


def _size(mesh, nx: int, device, reps: int):
    """One Nx of :func:`run`: (its row, its outputs)."""
    cuda = device.type == "cuda"
    grid = sizing_mode2a_proportional(*mesh.bounds(), nx, 1)
    cfg = SDFConfig()
    tv, origin, pdata, transport = inputs(mesh, grid, cfg, device)
    dx = grid.dx
    ni = grid.shape[0]
    print(f"== Nx={nx}: grid={grid.shape} "
          f"cells={grid.num_cells / 1e6:.2f}M ==", flush=True)

    def kernel():
        return dense_distance_field(tv, origin, dx, grid_shape=grid.shape)

    (phi, tid), t_k, e_k = amortized("dense kernel", kernel, device, reps)

    def sign():
        return parity_sign(pdata, ni, phi)

    signed, t_s, e_s = amortized("unpack+sign", sign, device, reps)
    v = grid.num_cells / ((t_k + t_s) / 1e3)
    print(f"  -> kernel+sign amortized: {v / 1e6:.1f}M voxels/s",
          flush=True)
    row = {"nx": nx, "grid": list(grid.shape), "cells": grid.num_cells,
           "tris": int(mesh.num_tris), "transport": transport,
           "reps": reps, "dense_kernel_ms": round(t_k, 4),
           "unpack_sign_ms": round(t_s, 4),
           "mvoxels_per_sec": round(v / 1e6, 2),
           "dense_kernel_event_ms": None, "unpack_sign_event_ms": None,
           "dense_kernel_device_ms": None, "unpack_sign_device_ms": None}
    if cuda:
        d_k = spin_queued_ms(kernel, reps)
        d_s = spin_queued_ms(sign, reps)
        row.update(dense_kernel_event_ms=round(e_k, 4),
                   unpack_sign_event_ms=round(e_s, 4),
                   dense_kernel_device_ms=round(d_k, 4),
                   unpack_sign_device_ms=round(d_s, 4))
        print(f"  queued behind a spin: dense kernel {d_k:.3f} ms, "
              f"unpack+sign {d_s:.3f} ms (device)", flush=True)
    return row, (phi, tid, signed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="Nx values (default 64 128 256)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain twins (default: the card)")
    a = ap.parse_args(argv)
    device = tool_device(a.device)
    line, _ = run(box_mesh((3, 4, 5), (-1, -1, -1)),
                  a.sizes or [64, 128, 256], device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
