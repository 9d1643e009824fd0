"""keynet_tpu_torch.profiling against keynet_tpu.profiling on the CPU: the
per-layer report row for row (format, shape, nnz, device bytes) for the
same seeded small StochasticKeynet nets, and the torch.profiler trace,
span annotation and device share on a CPU run."""

import json
import os

import numpy as np
import pytest
import torch

import keynet_tpu as kj
import keynet_tpu_torch as kt


def _tiny(m):
    return m.Model([m.Conv2d("conv1", 1, 2, 3), m.ReLU("relu1"),
                    m.Linear("fc", 2 * 8 * 8, 4)], inshape=(1, 8, 8), seed=0)


def _narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)


# net, input shape, blocksize, GLOBAL overrides (narrow: Block-ELL and Kronecker routes)
NETS = {"tiny": (_tiny, (1, 8, 8), 4, {}),
        "narrow": (_narrow, (3, 16, 16), 8, {"DENSE_MAX_BYTES": 1 << 20, "ELL_MAX_K": 32})}


@pytest.fixture(scope="module", params=sorted(NETS))
def keyed_pair(request):
    make, inshape, bs, over = NETS[request.param]
    saved = [(G, {k: G.get(k) for k in over}) for G in (kj.globals.GLOBAL, kt.globals.GLOBAL)]
    try:
        for G, _ in saved:
            G.update(over)
        _, knj = kj.StochasticKeynet(inshape, make(kj.models), alpha=2, blocksize=bs, seed=0)
        _, knt = kt.StochasticKeynet(inshape, make(kt.models), alpha=2, blocksize=bs, seed=0,
                                     device="cpu")
    finally:
        for G, old in saved:
            for k, v in old.items():
                if v is None:
                    G.pop(k, None)
                else:
                    G[k] = v
    return knj, knt


def test_layer_report_matches_jax(keyed_pair):
    knj, knt = keyed_pair
    rows_j = kj.profiling.layer_report(knj)
    rows_t = kt.profiling.layer_report(knt)
    assert rows_t == rows_j
    assert any(r["nnz"] > 0 for r in rows_t)


def test_print_layer_report_matches_jax(keyed_pair, capsys):
    knj, knt = keyed_pair
    kj.profiling.print_layer_report(knj)
    out_j = capsys.readouterr().out
    rows = kt.profiling.print_layer_report(knt)
    out_t = capsys.readouterr().out
    assert out_t == out_j
    assert len(out_t.splitlines()) == len(rows) + 1      # one line a layer, then TOTAL


def test_stopwatch_spans():
    sw = kt.profiling.Stopwatch()
    with sw:
        sum(range(1000))
    assert sw.elapsed >= 0.0
    assert sw.lap() >= 0.0 and sw.since(reset=True) >= 0.0


def test_trace_span_and_chrome_trace(tmp_path):
    P = kt.profiling
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    with P.trace("forward", trace_dir=str(tmp_path)) as prof:
        with P.annotate("matmul"):
            (a @ a).sum()
    names = {e.name for e in prof.events()}
    assert {"forward", "matmul"} <= names
    with open(os.path.join(str(tmp_path), "forward.json")) as f:
        assert "traceEvents" in json.load(f)
    share = P.device_busy(prof, "forward")
    assert share["window_ms"] > 0
    if not torch.cuda.is_available():          # no device event on a CPU run
        assert share["device_events"] == 0 and share["busy_share"] is None
    with pytest.raises(ValueError):
        P.device_busy(prof, "no such span")
