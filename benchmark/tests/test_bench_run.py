"""The benchmark's command: without a card it prints no result and
exits with an error naming the card; on a card (``-m cuda``) one short
run of a cell prints the result line last."""

import json
import os
import subprocess
import sys

import pytest

from lbench import spec

CMD = [sys.executable, os.path.join(spec.ROOT, "benchmark", "run.py"),
       "--workload", "s2s-aligned-relocalize", "--seed", "2147483999",
       "--seconds", "2", "--trace", "0"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(CMD, capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "NVIDIA card" in out.stderr


@pytest.mark.cuda
def test_a_run_on_the_card(card):
    out = subprocess.run(CMD, capture_output=True, text=True, timeout=900,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
