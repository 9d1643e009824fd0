"""Card-only tests of the benchmark (marked ``cuda``; they skip without a
card): a short run of the AllConvNet batch cell comes out correct, and the
control (the program under PRECISION='default', TF32 products) does not.

    python -m pytest -m cuda kbench/tests/test_kbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")


def _run(*extra):
    out = subprocess.run([sys.executable, "kbench/run.py", "--workload",
                          "allconv-stoch-32.b1024", "--seed", str(2 ** 31 + 17),
                          "--seconds", "2", *extra], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_batch_cell_is_correct(card):
    r = _run("--trace", "1")
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "slot_walk_roofline.batch" in r["metrics"]


@pytest.mark.cuda
def test_control_is_not_correct(card):
    r = _run("--trace", "0", "--precision", "default")
    assert not r["correct"]
    c = r["compared"]["max_rel_err"]
    assert c["value"] > c["limit"]
