#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program, ``sdfgenfast_tpu_torch``.
The run loads the cell's files (``lib/cells.py``), sets up and warms up the
cell's entry (``entries/<entry>.py``: its meshes, weights and grids made
from ``--seed``), measures for ``--seconds`` seconds, and then judges what
the window produced against the plain reference (``reference/``), each
number against its limit (``limits/<workload>.json``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, ``setup_parts`` (the seconds of set-up by part),
``readings``, and last ``checks``, each number compared beside its limit
and its verdict; the same numbers close standard error.

It exits with 3 and prints no result without a CUDA device (or with fewer
than the cell asks for), and with 4 if JAX or the JAX package is loaded
once the window has closed. Kernel and compile caches stay inside the
checkout (``build/``).
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdfgenfast_tpu")
# Seconds of set-up before the entry's own, by part (printed beside
# ``setup_s`` in the result line, to show what moves it).
SETUP_PARTS: dict = {}


def _environment(root: str) -> None:
    """Point every compile cache at fixed directories of the checkout."""
    cache = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(cache, sub)


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, root: str = ROOT, here: str = HERE,
             entry_hook=None):
    """One run of `workload` on `device` (a torch.device); returns the
    result line's object (without the import check). The cell's files are
    read under `here` (the benchmark's folder) and its configuration's
    under `root` (the checkout). `entry_hook(entry)` may change the entry
    before set-up."""
    import json

    import torch

    from benchmark.lib import cells, compare, trace

    cell = cells.find(bench, workload, root, here)
    entry = cell.entry().Entry(cell, seed, device)
    if entry_hook is not None:
        entry_hook(entry)
    cuda = device.type == "cuda"
    t_setup = time.time()
    entry.setup()
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - T_START
    setup_parts = dict(SETUP_PARTS, entry_setup_s=time.time() - t_setup)
    entry.window(seconds, traced)
    if cuda:
        torch.cuda.synchronize(device)
        window_peak = torch.cuda.max_memory_allocated(device)
    e2e = dict(entry.end_to_end())
    e2e["setup_s"] = setup_s
    if cuda:
        e2e["peak_mem_mib"] = window_peak / 2**20
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0}
    metrics, breakdown = {}, None
    if traced:
        with open(os.path.join(here, "lib", "peaks.json")) as fh:
            peaks = json.load(fh)["cards"].get(kind)
        record = {"spans": entry.spans, "profile": entry.profile,
                  "platform": dev["platform"],
                  "shape": getattr(entry, "shape", None), "peaks": peaks}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = entry.profile
        if prof is not None:
            dev["busy_s"] = prof["busy_us"] / 1e6
            dev["window_s"] = prof["window_us"] / 1e6
            breakdown = {"device_ops": trace.top(prof["kernels"]),
                         "idle_gaps": trace.top(prof["gaps"])}
    else:
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = entry.check()
    correct, rows = compare.judge(numbers, cell.limits)
    readings = {k: v for k, v in numbers.items() if k not in rows}
    correct = correct and entry.failed == 0 and entry.attempted > 0
    line = {"correct": correct, "attempted": entry.attempted,
            "failed": entry.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if entry.failed:
        line["error"] = getattr(entry, "error", None)
    line["setup_parts"] = setup_parts
    line["readings"] = readings
    line["checks"] = rows
    return line


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}
    if args.workload not in chips:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    _environment(ROOT)
    t0 = time.time()
    SETUP_PARTS["before_main_s"] = t0 - T_START
    import torch

    SETUP_PARTS["import_torch_s"] = time.time() - t0
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        log(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 3
    t0 = time.time()
    import sdfgenfast_tpu_torch  # noqa: F401  (the program must be there)
    from benchmark.lib import compare, program

    SETUP_PARTS["import_program_s"] = time.time() - t0
    t0 = time.time()
    log(f"card: {program.card_line()}")
    SETUP_PARTS["card_query_s"] = time.time() - t0
    device = torch.device("cuda", 0)
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 4
    if line["failed"]:
        log(f"{line['failed']} of {line['attempted']} failed; the last: "
            f"{line.get('error')}")
    for k, v in line["readings"].items():
        log(f"reading {k} = {v!r} (not compared)")
    for text in compare.lines(line["checks"]):
        log(text)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
