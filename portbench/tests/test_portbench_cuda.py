"""On the card: one short run of each cell, correct (``-m cuda``)."""

import json
import subprocess
import sys

import pytest
from pb_small import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ref128-deal", "t256-threshold", "t256-deal",
                                      "ref128-threshold"])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", workload,
                          "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "ref128-deal",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
