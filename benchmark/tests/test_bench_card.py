"""The command as the benchmark's driver runs it. Without a card it exits
with 3 and prints no result; a folder that holds only BENCHMARK.json and
the benchmark's files, without the program, prints none either; on a card
(marked ``card``) a short run prints the contract's last line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import cells
from benchmark.tests import tiny


def _run(cwd, *extra, timeout=600):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sphere82k_256.generate", "--seed", str(2**31 + 5), "--seconds", "2",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(tiny.REPO, "--trace", "0")
    assert out.returncode == 3
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_run_on_a_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run(tiny.REPO, "--trace", trace, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace == "1":
        assert line["device"]["busy_s"] > 0
