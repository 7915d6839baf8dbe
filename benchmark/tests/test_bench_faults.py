"""The check sees a broken timed path: each fault a cell can have, planted
under a whole run on the CPU at a cut-down size (the program's plain-torch
twins), turns ``correct`` false, and so does the control, the reference in
bfloat16 put in the program's place. The look for a card is skipped."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.lib import cells, compare
from benchmark.tests import tiny

SEED = 2**31 + 101


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("root")
    return tiny.tiny_bench(str(root), deferred=True), str(root)


def _run(bench, workload, hook=None):
    b, root = bench
    return run.run_cell(b, workload, SEED, 0.4, False, torch.device("cpu"),
                        root=root, entry_hook=hook)


def _wrap_call(entry, change):
    """Plant `change(out, state) -> out` on every generate call."""
    call, state = entry._call, {}

    def broken(verts):
        true = call(verts)
        out = change(true, state)
        state["last"] = true
        return out
    entry._call = broken


def stale(out, state):
    """A step that returns its state unchanged: the previous grid."""
    return state.get("last", out)


def half_left_out(out, state):
    """Half of the grid left out (never written)."""
    out = out.copy()
    out[out.shape[0] // 2:] = 0.0
    return out


def altered(out, state):
    """An answer altered where it is produced: the sign of a slab."""
    out = out.copy()
    out[: max(1, out.shape[0] // 8)] *= -1
    return out


@pytest.mark.parametrize("fault", [stale, half_left_out, altered],
                         ids=lambda f: f.__name__)
def test_generate_fault_is_caught(bench, fault):
    line = _run(bench, "sphere82k_256.generate",
                lambda e: _wrap_call(e, fault))
    assert line["attempted"] >= 1
    assert line["correct"] is False, line["checks"]


def test_train_unchanged_state_is_caught(bench, monkeypatch):
    from sdfgenfast_tpu_torch.models import SDFGenerator

    monkeypatch.setattr(SDFGenerator, "train_step",
                        lambda self, v, t, lr=1e-2: (v, self.loss(v, t)))
    line = _run(bench, "box36_256.train")
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["correct"] is False


def test_train_half_batch_is_caught(bench, monkeypatch):
    from sdfgenfast_tpu_torch.models import SDFGenerator

    monkeypatch.setattr(SDFGenerator, "loss", SDFGenerator.loss)
    line = _run(bench, "box36_256.train", control.half_batch)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", ["sphere82k_256.generate",
                                      "box36_256.generate",
                                      "box36_256.train"])
def test_control_is_not_correct(bench, workload):
    b, root = bench
    cell = cells.find(b, workload, root)
    entry = cell.entry().Entry(cell, SEED, torch.device("cpu"))
    entry.setup()
    entry.window(0.3, False)
    entry.release()
    sound, _ = compare.judge(entry.check(), cell.limits)
    low, rows = compare.judge(entry.check(control=True), cell.limits)
    assert low is False, rows
    assert all(np.isfinite(r["value"]) for r in rows.values())
    del sound  # judged at the cell's own size on the card, not here
