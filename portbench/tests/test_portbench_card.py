"""On the card only: one short run of the first cell ends correct."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


@pytest.mark.cuda
def test_first_cell_runs_correct_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "crnn_720p",
                        "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
