#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's numbers on many seeds,
and the control's, in one process.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--fault half_batch] [--seconds 2]

For each seed the cell is set up as a run sets it up, a short window runs
(long enough to finish calls of every mesh of the pool), and the check's
numbers are printed: the program's (``program``) and, for the control
seeds, the control's (``control``: the reference in bfloat16 in the
program's place). ``--fault half_batch`` runs a training cell's first
steps with the loss taken over half of the grid's cells (the fault whose
reading bounds a training cell's numbers from above). One JSON line a
seed on standard output. Needs a CUDA device; the benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def half_batch(entry):
    """Plant the fault: the model's loss over the first half of the grid's
    cells only, its mean over them."""
    setup = entry.setup

    def planted():
        import torch
        from sdfgenfast_tpu_torch.models import SDFGenerator

        def loss(self, verts, target_phi):
            phi = self.forward(verts)
            half = phi.shape[0] // 2
            return torch.mean((phi[:half] - target_phi[:half]) ** 2)

        SDFGenerator.loss = loss
        setup()

    entry.setup = planted


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import run
    from benchmark.lib import cells

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = cells.find(bench, args.workload, ROOT)
    run._environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        entry = cell.entry().Entry(cell, seed, device)
        if args.fault == "half_batch":
            half_batch(entry)
        entry.setup()
        entry.window(args.seconds, False)
        entry.release()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "attempted": entry.attempted, "failed": entry.failed,
               "program": entry.check()}
        out["check_s"] = time.perf_counter() - t0
        if seed in args.control_seeds:
            out["control"] = entry.check(control=True)
        print(json.dumps(out), flush=True)
        del entry
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
