"""Card-only test of the program's spans as the benchmark reads them (marked
``cuda``; it skips without a card): a traced run of the AllConvNet batch
cell reports the six span and load metrics, the reducer charges at least
99% of the window's kernel time to program spans, and every slot-walk
launch (a ctypes launch from a library on the static CUDA runtime) lands
in conv1's Block-ELL link.

    python -m pytest -m cuda kbench/tests/test_kbench_spans_card.py
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from kbench import spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "allconv-stoch-32.b1024"
METRICS = ("blocksparse_ms.batch", "tapsum_ms.batch", "launches_per_req.batch",
           "h2d_ms.batch", "load_read_s", "load_restore_s")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")


@pytest.mark.cuda
def test_traced_run_charges_the_window_to_program_spans(card):
    out = subprocess.run([sys.executable, "kbench/run.py", "--workload", CELL,
                          "--seed", str(2 ** 31 + 29), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    for m in METRICS:
        assert m in r["metrics"] and r["metrics"][m]["value"] > 0, m
    with open(os.path.join(spans.TRACES, CELL + ".json")) as f:
        red = spans.reduce(json.load(f))
    assert red["span_us"] == pytest.approx(r["device"]["window_s"] * 1e6)
    assert red["coverage"] >= spans.MIN_COVERAGE and red["requests"] > 0
    walk = [rows for name, rows in red["kernel_rows"].items()
            if re.search(r"\bslot_walk_(kernel|wgmma)\b", name)]
    assert walk
    for rows in walk:
        for key in rows:
            assert key[0] == "conv1" and red["rows"][key]["kind"] == "blocksparse", key
