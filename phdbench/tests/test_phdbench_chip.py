"""One short run of a cell on the card (skips without one)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    p = subprocess.run([sys.executable, "phdbench/run.py", "--workload",
                        "ackerman-phd.replay", "--seed", "5", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
