"""The benchmark's command on the card (skips without one): one short run
of a cell prints a correct result line."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_serve_cell_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "serve.paper16.greedy-524288", "--seed", "3000000001",
         "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and list(res)[-1] == "checks"
