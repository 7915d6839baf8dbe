"""Device-scaling table of the sharded band + pyramid pipeline: voxels per
second, speed-up and efficiency on 1, 2, 4 (8 on the CPU) shards.

Counterpart of ``tools/scaling_bench.py``: icosphere(4) on the (Nx, Nx, Nx)
grid ``GridSpec((-1.3,) * 3, 2.6 / Nx, ...)`` (Nx default 128) with
``SDFConfig(dense_max_tris=0)`` (``vdt_max_hop=8`` under ``--ladder``). For
each device count d: ``make_device_mesh(devices[:d])``,
``bin_mesh_sharded``, one warm ``sharded_sdf``, then the minimum of 3
timed calls, each ending in a synchronize of every device of the mesh.
Every d must give the d = 1 field bit for bit, and the single-device
``make_level_set3`` on the same case, binned beforehand as the sharded
calls are, is timed beside the table (on a cube grid the sharded field
equals it bit for bit too).

The device lists:

- ``--device cpu``: ``["cpu"] * d`` for d in 1, 2, 4, 8 (as the JAX tool's
  virtual CPU devices, they share the host's cores: a trend only);
- on the card: ``["cuda:0"] * d`` for d in 1, 2, 4, one card running the
  shards one after another, and where several cards are visible also
  ``cuda:0 ... cuda:d-1`` for each d that many cards hold, one shard a
  card.

It prints ``halo_comms_model``'s line for a (2, 4) mesh and the markdown
table as the JAX tool does, the card's name and power limit and, last, one
JSON line holding what the JAX tool writes into ``BASELINE.json``'s
"published" (this tool writes no file). Run on a machine with a card::

    python3 -m sdfgenfast_tpu_torch.tools.scaling_bench [Nx] [--ladder]

It raises, naming CUDA, when there is no card and no ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..grid import GridSpec
from ..mesh import icosphere
from ..parallel import bin_mesh_sharded, make_device_mesh, sharded_sdf
from ..parallel.sharded import halo_comms_model
from ..pipeline import SDFConfig, bin_mesh, make_level_set3
from ..upload import to_host
from .timing import card_line, sync, tool_device

__all__ = ["case", "device_lists", "timed", "bench", "run", "main"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def case(nx: int, ladder: bool = False):
    """(mesh, grid, config) of the JAX tool at `nx`."""
    mesh = icosphere(4, radius=1.0)
    grid = GridSpec((-1.3, -1.3, -1.3), 2.6 / nx, (nx, nx, nx))
    return mesh, grid, SDFConfig(dense_max_tris=0,
                                 vdt_max_hop=8 if ladder else None)


def device_lists(device: torch.device) -> dict:
    """{table name: [device list of each d]}: the CPU's 1, 2, 4, 8 shards;
    on a card 1, 2, 4 shards on it, and 1, 2, 4 distinct cards as far as
    the visible ones go (where more than one is)."""
    if device.type == "cpu":
        return {"cpu": [["cpu"] * d for d in (1, 2, 4, 8)]}
    out = {"one_card": [[device] * d for d in (1, 2, 4)]}
    n = torch.cuda.device_count()
    if n > 1:
        out["cards"] = [[torch.device("cuda", r) for r in range(d)]
                        for d in (1, 2, 4) if d <= n]
    return out


def timed(fn, devices, repeats: int = 3):
    """fn() once to warm, then the least of `repeats` calls, each ending in
    a synchronize of every device in `devices`: (the last output, s)."""
    def sync_all():
        for d in {torch.device(d) for d in devices}:
            sync(d)

    out = fn()
    sync_all()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync_all()
        best = min(best, time.perf_counter() - t0)
    return out, best


def bench(devices, mesh, grid, config, repeats: int = 3):
    """(voxels/s, the field as a NumPy array) of the sharded call on the
    mesh ``make_device_mesh(devices)``."""
    dmesh = make_device_mesh(devices)
    sb = bin_mesh_sharded(mesh, grid, dmesh.devices.shape, config)
    out, s = timed(lambda: sharded_sdf(sb, dmesh, verts=mesh.verts),
                   list(dmesh.devices.flat), repeats)
    return grid.num_cells / s, to_host(out)


NOTES = {
    "cpu": "CPU shards share the host's cores; trend evidence only",
    "one_card": "every shard on one card, run one after another",
    "cards": "one shard a card, the cards driven by one process",
}


def _table(name: str, lists, mesh, grid, config, cm: dict, repeats: int):
    """One table of :func:`run`: (its "published" entry, the d = 1
    field)."""
    rows, ref_v, ref_phi = [], None, None
    for devs in lists:
        d = len(devs)
        v, phi = bench(devs, mesh, grid, config, repeats)
        if ref_v is None:
            ref_v, ref_phi = v, phi
        elif not np.array_equal(phi.view(np.int32), ref_phi.view(np.int32)):
            raise AssertionError(f"{name}: {d} shards differ from 1")
        eff = v / (ref_v * d)
        rows.append((d, v, v / ref_v, eff))
        log(f"devices={d}: {v / 1e6:.2f}M voxels/s  speedup "
            f"{v / ref_v:.2f}x  efficiency {eff * 100:.0f}%")
    print(f"\n[{name}] {NOTES.get(name, '')}")
    print("| devices | Mvoxels/s | speedup | efficiency |")
    print("|---|---|---|---|")
    for d, v, s, e in rows:
        print(f"| {d} | {v / 1e6:.2f} | {s:.2f}x | {e * 100:.0f}% |")
    entry = {
        "workload": f"icosphere {mesh.num_tris} tris, grid "
                    f"{list(grid.shape)}, "
                    + ("band+PYRAMID sharded path (default schedule)"
                       if config.vdt_max_hop is None else
                       f"band+VDT sharded path, vdt_max_hop="
                       f"{config.vdt_max_hop}"),
        "devices": [str(x) for x in lists[-1]],
        "comms_model_2x4": cm,
        "rows": [{"devices": d, "mvoxels_per_sec": round(v / 1e6, 2),
                  "ms": round(grid.num_cells / v * 1e3, 3),
                  "speedup": round(s, 2), "efficiency": round(e, 3)}
                 for d, v, s, e in rows],
        "note": NOTES.get(name, ""),
        "bit_equal": True,
    }
    return entry, ref_phi


def run(mesh, grid, config, lists, repeats: int = 3):
    """The tables of `lists` ({name: [device list of each d]}, as
    :func:`device_lists` gives them) and the single-device call on the
    first device, for `mesh` on the cube `grid`; returns (the JSON line's
    object, the d = 1 field). Raises AssertionError if any d differs from
    d = 1 or from the single-device call (on a cube grid the pyramid's
    axes keep their order)."""
    hop = config.vdt_max_hop
    cm = halo_comms_model(grid.shape, (2, 4), max_hop=hop)
    log(f"comms model [{cm['schedule']}] on (2,4): "
        f"{cm['vdt_rounds']} halo rounds, "
        f"{cm['ppermute_calls']} ppermute calls, "
        f"{cm['vdt_total_bytes_per_device'] / 1e6:.2f} MB/device VDT "
        f"(+{cm['chamfer_bytes_per_device'] / 1e6:.3f} MB chamfer)")
    published, ref = {}, None
    for name, table in lists.items():
        entry, phi = _table(name, table, mesh, grid, config, cm, repeats)
        if ref is None:
            ref = phi
        elif not np.array_equal(phi.view(np.int32), ref.view(np.int32)):
            raise AssertionError(f"{name}: differs from the first table")
        published[f"device_scaling_{name}"] = entry
    first = torch.device(next(iter(lists.values()))[0][0])
    binned = bin_mesh(mesh, grid, config, device=first)
    single, s = timed(lambda: make_level_set3(mesh, grid, config, binned,
                                              device=first),
                      [first], repeats)
    if not np.array_equal(to_host(single).view(np.int32), ref.view(np.int32)):
        raise AssertionError("the sharded field differs from the "
                             "single-device make_level_set3")
    log(f"single device ({first}, make_level_set3): "
        f"{grid.num_cells / s / 1e6:.2f}M voxels/s, {s * 1e3:.3f} ms")
    card = card_line(first)
    print(f"card: {card}", flush=True)
    return {"published": published,
            "single_device": {"device": str(first),
                              "mvoxels_per_sec": round(
                                  grid.num_cells / s / 1e6, 2),
                              "ms": round(s * 1e3, 3),
                              "bit_equal_to_sharded": True},
            "card": card}, ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nx", nargs="?", type=int, default=128,
                    help="grid cells per axis (default 128)")
    ap.add_argument("--ladder", action="store_true",
                    help="the capped ladder (vdt_max_hop=8) instead of the "
                         "pyramid")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain twins (default: the card)")
    a = ap.parse_args(argv)
    device = tool_device(a.device)
    line, _ = run(*case(a.nx, a.ladder), device_lists(device))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
