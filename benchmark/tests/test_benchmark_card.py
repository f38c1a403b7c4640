"""A short run of a cell on the card, through the command the driver runs:
`python -m pytest benchmark/tests -m cuda` on a machine with a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_hall_cell_runs_correct_on_the_card(card):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "r34c-hall-gpallas", "--seed", "2147483647", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"voxels_per_s", "batch_latency_p95_ms",
                                   "peak_mem_gib", "setup_s"}
