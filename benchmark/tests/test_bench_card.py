"""On the card only: one short run of a cell through the command, its last
line the contract's object and correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "bm-1080p-d288.rig1", "--seed", "2147483648", "--seconds", "2",
                           "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    if trace:
        assert out["device"]["busy_s"] > 0 and "bm_roofline_pct" in out["metrics"]
