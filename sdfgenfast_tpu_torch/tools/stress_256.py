"""Repeat-stress of the binned 256-class pipeline in one process, with the
memory it holds read after every call.

Counterpart of ``tools/stress_256.py``: icosphere(6) (81,920 triangles) on
``sizing_mode2a_proportional(mn, mx, 256, 1)`` with ``SDFConfig()``, N
iterations (default 10) of ``bin_mesh(..., device=)`` (host binning and the
blob's upload), ``make_level_set3`` on that binning and the copy back
(``upload.to_host``). Every result must be finite and bit-identical to the
first. Each iteration's time is split into the binning, the computation
(``make_level_set3`` and a synchronize) and the copy back, by the host
clock, and on the card the computation's device time (CUDA events around
``make_level_set3``).

On the card each iteration also reads the memory the process holds:
``torch.cuda.memory_reserved`` and ``memory_allocated`` (the caching
allocator), ``upload.pinned_bytes()`` (the copy back's pinned ring) and,
where torch reports it, the pinned bytes of torch's caching host allocator
(the blobs' staging). The first two iterations may grow them: the first
warms the allocators and the ring, and the second still holds the first's
binning and result while it makes its own, as the JAX tool's loop does.
From then on none may grow: a reading above the second iteration's fails
the run. A CPU run reads no memory. Run on a machine with a card::

    python3 -m sdfgenfast_tpu_torch.tools.stress_256 [N]

It prints the JAX tool's lines, the card's name and power limit and, last,
one JSON line; it raises, naming CUDA, when there is no card and no
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import upload
from ..grid import sizing_mode2a_proportional
from ..mesh import icosphere
from ..pipeline import SDFConfig, bin_mesh, make_level_set3
from .timing import card_line, tool_device

__all__ = ["MEMORY", "memory", "plateau", "run", "main"]

# the readings, in the order of the JSON line's "memory" keys
MEMORY = ("reserved", "allocated", "pinned_ring", "pinned_host_cache")


def memory(device: torch.device) -> dict:
    """The bytes the process holds on `device` and pinned on the host
    (None for a reading torch does not give)."""
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    host = stats() if stats is not None else {}
    return {"reserved": torch.cuda.memory_reserved(device),
            "allocated": torch.cuda.memory_allocated(device),
            "pinned_ring": upload.pinned_bytes(),
            "pinned_host_cache": host.get("allocated_bytes.current")}


def plateau(readings) -> dict:
    """{reading: True where it is equal from the second iteration on} for
    a list of :func:`memory` dicts, one an iteration. Raises
    AssertionError if a reading after the second iteration is above the
    second's (None readings are skipped)."""
    flat = {}
    for k in MEMORY:
        series = [r[k] for r in readings]
        if any(v is None for v in series):
            flat[k] = None
            continue
        if any(v > series[1] for v in series[2:]):
            raise AssertionError(
                f"{k} grew after the second iteration: {series}")
        flat[k] = len(set(series[1:])) <= 1
    return flat


def run(mesh, grid, config, device, n: int = 10):
    """N iterations of bin, compute and copy back on `device`; returns
    (the JSON line's object, the first iteration's field). Raises
    AssertionError if a field is not finite, differs from the first, or,
    on a card, if a memory reading grows after the second iteration."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"need at least one iteration, got {n}")
    cuda = device.type == "cuda"
    print(f"stress: {n} iterations of {grid.shape} / {mesh.num_tris} tris",
          flush=True)
    ref, seconds, readings = None, [], []
    split = {"bin_ms": [], "compute_ms": [], "device_ms": [],
             "copy_back_ms": []}
    for i in range(n):
        t0 = time.perf_counter()
        binned = bin_mesh(mesh, grid, config, device=device)
        t1 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        phi = make_level_set3(mesh, grid, config, binned=binned,
                              device=device)
        if cuda:
            end.record()
            end.synchronize()
        t2 = time.perf_counter()
        # full device -> host readback each iteration, as the JAX tool does
        host = upload.to_host(phi)
        t3 = time.perf_counter()
        if not np.isfinite(host).all():
            raise AssertionError(f"iteration {i}: non-finite values")
        inside = float((host < 0).mean())
        if ref is None:
            ref = host
        elif not np.array_equal(host.view(np.int32), ref.view(np.int32)):
            raise AssertionError(f"iteration {i} diverged")
        seconds.append(time.perf_counter() - t0)
        split["bin_ms"].append((t1 - t0) * 1e3)
        split["compute_ms"].append((t2 - t1) * 1e3)
        split["device_ms"].append(start.elapsed_time(end) if cuda else None)
        split["copy_back_ms"].append((t3 - t2) * 1e3)
        mem = ""
        if cuda:
            readings.append(memory(device))
            mem = " " + " ".join(f"{k}={v}" for k, v in readings[-1].items())
        dev = "" if not cuda else f", device {split['device_ms'][-1]:.1f} ms"
        print(f"  iter {i}: {seconds[-1]:.2f}s inside={inside:.4f} (bin "
              f"{split['bin_ms'][-1]:.1f} ms, compute "
              f"{split['compute_ms'][-1]:.1f} ms{dev}, copy back "
              f"{split['copy_back_ms'][-1]:.1f} ms){mem}", flush=True)
    flat = plateau(readings) if cuda else None
    print("STRESS OK: all iterations finite, bit-identical, no device fault",
          flush=True)
    card = card_line(device)
    print(f"card: {card}", flush=True)
    line = {
        "workload": f"icosphere {mesh.num_tris} tris @ "
                    f"{'x'.join(str(s) for s in grid.shape)}",
        "iterations": n, "seconds": [round(s, 4) for s in seconds],
        **{k: [None if v is None else round(v, 3) for v in vs]
           for k, vs in split.items()},
        "inside_frac": float((ref < 0).mean()), "bit_identical": True,
        "memory": ({k: [r[k] for r in readings] for k in MEMORY}
                   if cuda else None),
        "memory_flat_from_second": flat,
        "card": card,
    }
    return line, ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=10,
                    help="iterations (default 10)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain twins (default: the card)")
    a = ap.parse_args(argv)
    device = tool_device(a.device)
    mesh = icosphere(6, radius=1.0)
    grid = sizing_mode2a_proportional(*mesh.bounds(), 256, 1)
    line, _ = run(mesh, grid, SDFConfig(), device, a.n)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
