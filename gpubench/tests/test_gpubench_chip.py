"""On the H100 (``python -m pytest gpubench/tests -m chip``): each cell's
float8 control, at the cell's own size, fails the limits that its sound
runs pass. The cell runs once, with a short window, and reads its own
numbers and its control's from the same sample."""

import json
import os
import subprocess
import sys

import pytest

from gpubench import check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["mixtral-chat", "mixtral-docs",
                                  "gpt2xl-train"])
def test_control_fails_where_the_program_passes(card, cell):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         "2147483701", "--seconds", "15", "--trace", "0", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    lims = check.limits(cell)
    ok, _ = check.judge(line["control"], lims)
    assert not ok, (line["control"], lims)
