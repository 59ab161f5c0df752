"""The command itself: no result without a card, a result line whose
checks come last with a card (a short run of the cell)."""

import json
import os
import subprocess
import sys

import pytest

from ghs_bench import harness

ARGS = ["--seed", "2147483661", "--seconds", "3", "--trace", "0"]


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible; this test needs a machine without one")


def test_without_a_card_there_is_no_result(no_card):
    for cmd in ([sys.executable, "ghs_bench/run.py"], [sys.executable, "-m", "ghs_bench.run"]):
        done = subprocess.run(cmd + ["--workload", "rmat24-fresh"] + ARGS, cwd=harness.ROOT,
                              capture_output=True, text=True, timeout=120)
        assert done.returncode != 0 and done.stdout == ""
        assert "CUDA is not available" in done.stderr


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    done = subprocess.run([sys.executable, "ghs_bench/run.py", "--workload",
                           "rmat24-fresh"] + ARGS, cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, BENCH_RUN="test"))
    assert done.returncode == 0, done.stderr[-2000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert done.stderr.strip().splitlines()[-1].startswith("check ")
