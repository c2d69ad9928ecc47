"""Each cell on the card: a short run of `gpbench/run.py` reads correct,
and its last line has the contract's keys (`-m cuda` on a machine with a
card; skipped elsewhere)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["wf2y_d20r4", "nuts512_c128", "wf3y_d20r4"])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", cell, "--seed",
                          "3000000017", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
