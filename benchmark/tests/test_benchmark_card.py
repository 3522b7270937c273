"""The benchmark's command on the card: each cell's run prints one result
line with the keys the contract names, from the card. Marked
requires_cuda; skips where there is none.

    python -m pytest benchmark/tests/test_benchmark_card.py -q   # on the card
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [c["name"] for c in run.benchmark_spec()["workloads"]])
def test_cell_prints_its_result(card, cell):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                        "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
