"""On a card: one short run of a cell through the command, as the
benchmark runs it, comes out correct (skips without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ddb3d_1m.rollout_inc"])
def test_short_run_on_the_card(cuda, workload):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 3), "--seconds",
                        "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
