"""kbench/spans.py on Chrome traces made by hand: device events charged to
the innermost program span through cuda_runtime and cuda_driver launch events, the
op kinds, launches a request, the H2D reading and the idle gaps' labels
against counts made by hand; the stale-file and coverage gates; the
readers; and the per-link table printed by the script."""

import json
import os
import subprocess
import sys
import types

import pytest

from kbench import harness, spans

ROOT = harness.ROOT
MAIN, OTHER = (1, 1), (1, 2)        # (pid, tid) of the serving thread, another thread


def _x(name, cat, ts, dur, thread=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _request(t, c):
    """One request at time ``t`` (µs), correlation ids from ``c``.

    Host spans:  forward [t, t+400): h2d [t, t+40), run [t+40, t+390):
    layer conv1/ChainedOp [t+50, t+200) with link 0 PermutedBlockSparseOp
    [t+50, t+120) and link 1 KroneckerOp [t+120, t+200), layer relu1/relu
    [t+200, t+220), layer fc/TapSumOp [t+220, t+380); decrypt [t+390, t+400).
    Device: the H2D copy [t+15, t+35) (runtime launch at t+10); the slot
    walk [t+60, t+160), 100 µs (cuLaunchKernel at t+55); a GEMM [t+165, t+245),
    80 µs (runtime at t+130); the ReLU [t+245, t+255), 10 µs (t+205); a GEMM
    [t+255, t+355), 100 µs (t+230)."""
    ev = [_x("keynet.forward", "user_annotation", t, 400),
          _x("keynet.h2d", "user_annotation", t, 40),
          _x("keynet.run", "user_annotation", t + 40, 350),
          _x("keynet.layer/conv1/ChainedOp", "user_annotation", t + 50, 150),
          _x("keynet.link/0/PermutedBlockSparseOp", "user_annotation", t + 50, 70),
          _x("keynet.link/1/KroneckerOp", "user_annotation", t + 120, 80),
          _x("keynet.layer/relu1/relu", "user_annotation", t + 200, 20),
          _x("keynet.layer/fc/TapSumOp", "user_annotation", t + 220, 160),
          _x("keynet.decrypt", "user_annotation", t + 390, 10)]
    launches = [("cudaMemcpyAsync", "cuda_runtime", t + 10, "Memcpy HtoD", "gpu_memcpy", 15, 20),
                ("cuLaunchKernel", "cuda_driver", t + 55, "slot_walk_kernel", "kernel", 60, 100),
                ("cudaLaunchKernel", "cuda_runtime", t + 130, "sgemm_128x64", "kernel", 165, 80),
                ("cudaLaunchKernel", "cuda_runtime", t + 205, "clamp_min", "kernel", 245, 10),
                ("cudaLaunchKernel", "cuda_runtime", t + 230, "sgemm_64x64", "kernel", 255, 100)]
    for k, (api, cat, ts, kname, kcat, start, dur) in enumerate(launches):
        ev.append(_x(api, cat, ts, 3, corr=c + k))
        ev.append(_x(kname, kcat, t + start, dur, thread=(0, 7), corr=c + k))
    return ev


def _trace(extra=()):
    """The window [0, 1000) holding two requests, at 100 and 600 µs."""
    ev = [_x("kbench.window", "user_annotation", 0, 1000)]
    ev += _request(100, 10) + _request(600, 20) + list(extra)
    return {"traceEvents": ev}


def test_charges_through_runtime_and_cu_launches():
    r = spans.reduce(_trace())
    assert r["span_us"] == 1000 and r["requests"] == 2
    assert r["kernel_us"] == r["charged_us"] == 2 * 290 and r["coverage"] == 1.0
    assert r["unattributed_us"] == 0
    # the slot walk (cuLaunchKernel) lands in its link, not in the layer around it
    assert r["kernel_rows"]["slot_walk_kernel"] == {("conv1", "0", "PermutedBlockSparseOp"): 2}
    assert r["kernel_rows"]["sgemm_128x64"] == {("conv1", "1", "KroneckerOp"): 2}
    assert r["kernel_rows"]["clamp_min"] == {("relu1", "-", "relu"): 2}


def test_kinds_launches_and_h2d_by_hand():
    r = spans.reduce(_trace())
    assert r["kind_us"] == {"blocksparse": 200.0, "kronecker": 160.0, "tapsum": 200.0,
                            "other": 20.0}
    assert sum(r["kind_us"].values()) == r["charged_us"]
    assert r["forward_kernels"] == 8                     # four kernels a request
    assert r["h2d_us"] == [40.0, 40.0]                   # keynet.h2d on the host
    row = r["rows"][("keynet.h2d", "-", "")]
    assert row["copies"] == 2 and row["copy_us"] == 40 and row["kernels"] == 0
    assert r["rows"][("conv1", "0", "PermutedBlockSparseOp")]["kind"] == "blocksparse"
    assert r["rows"][("conv1", "-", "ChainedOp")]["kind"] == "other"


def test_idle_gaps_by_hand():
    """Device busy [115, 135), [160, 260), [265, 455) in request one, +500
    in two.  Gaps, each put down to the innermost span open when it began:
    [0, 115) outside the program; [135, 160) keynet.h2d (open to 140);
    [260, 265) the Kronecker link; [455, 615) fc's span (open to 480); then
    h2d 25, Kronecker 5, and [955, 1000) fc's span of request two."""
    r = spans.reduce(_trace())
    fc, kron = "keynet.layer/fc/TapSumOp", "keynet.link/1/KroneckerOp"
    assert sorted(r["gaps"]) == sorted([
        (spans.OUTSIDE, 115.0), ("keynet.h2d", 25.0), (kron, 5.0), (fc, 160.0),
        ("keynet.h2d", 25.0), (kron, 5.0), (fc, 45.0)])
    assert r["gaps"][0] == (fc, 160.0)
    assert r["rows"][(spans.OUTSIDE, "-", "")]["idle_us"] == 115.0
    assert r["rows"][("keynet.h2d", "-", "")]["idle_us"] == 50.0
    assert r["rows"][("fc", "-", "TapSumOp")]["idle_us"] == 205.0


def test_device_clock_drift_moves_nothing():
    """The device's timestamps offset and drifting from the host's (here
    -30 µs and 5%): charging, H2D and the gaps' labels read the same."""
    drifted = _trace()
    for e in drifted["traceEvents"]:
        if e["cat"] in ("kernel", "gpu_memcpy"):
            e["ts"], e["dur"] = e["ts"] * 0.95 - 30, e["dur"] * 0.95
    r, d = spans.reduce(_trace()), spans.reduce(drifted)
    for k in ("requests", "forward_kernels", "h2d_us", "kernel_rows"):
        assert d[k] == r[k], k
    assert d["kind_us"] == pytest.approx({k: 0.95 * v for k, v in r["kind_us"].items()})
    assert sorted(label for label, _ in d["gaps"]) == sorted(label for label, _ in r["gaps"])


def test_no_launch_event_is_unattributed():
    extra = [_x("stray_kernel", "kernel", 500, 50, thread=(0, 7), corr=999),
             # launched on another thread, where no program span is open
             _x("cudaLaunchKernel", "cuda_runtime", 150, 3, thread=OTHER, corr=998),
             _x("other_thread_kernel", "kernel", 460, 20, thread=(0, 7), corr=998)]
    r = spans.reduce(_trace(extra))
    assert r["unattributed_us"] == 50
    assert r["kernel_us"] == 2 * 290 + 70 and r["charged_us"] == 2 * 290
    assert r["kernel_rows"]["other_thread_kernel"] == {(spans.OUTSIDE, "-", ""): 1}
    assert "stray_kernel" not in r["kernel_rows"]


def _write(tmp_path, trace, cell="c.b1"):
    with open(tmp_path / (cell + ".json"), "w") as f:
        json.dump(trace, f)
    return {"cell": cell, "trace": {"span_us": 1000.0}}


def test_for_record_gates(tmp_path):
    rec = _write(tmp_path, _trace())
    r = spans.for_record(rec, traces=str(tmp_path))
    assert r is not None and r["requests"] == 2
    assert spans.for_record(rec, traces=str(tmp_path)) is r            # parsed once
    # a stale file: its window is not the run's
    assert spans.for_record({"cell": "c.b1", "trace": {"span_us": 999.0}},
                            traces=str(tmp_path)) is None
    assert spans.for_record({"cell": "missing", "trace": {"span_us": 1000.0}},
                            traces=str(tmp_path)) is None
    assert spans.for_record({"cell": "c.b1", "trace": None}, traces=str(tmp_path)) is None
    # 98.3% of the kernel time charged: under the 99% gate
    low = _write(tmp_path, _trace([_x("stray", "kernel", 500, 10, thread=(0, 7), corr=9)]),
                 cell="low.b1")
    assert spans.reduce(json.loads((tmp_path / "low.b1.json").read_text()))["coverage"] < 0.99
    assert spans.for_record(low, traces=str(tmp_path)) is None
    # the parent's program: no spans at all
    bare = {"traceEvents": [e for e in _trace()["traceEvents"]
                            if not e["name"].startswith("keynet.")]}
    assert spans.for_record(_write(tmp_path, bare, cell="bare.b1"),
                            traces=str(tmp_path)) is None


def _reader(name):
    return harness.load_module(os.path.join(ROOT, "kbench", "metrics", name + ".py"),
                               "test_reader_" + name.replace(".", "_"))


def test_readers(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "TRACES", str(tmp_path))
    rec = _write(tmp_path, _trace(), cell="r.b1")
    want = {"blocksparse_ms.batch": 0.1, "tapsum_ms.batch": 0.1,
            "launches_per_req.batch": 4.0, "h2d_ms.batch": 0.04}
    for name, v in want.items():
        assert _reader(name).read(rec) == pytest.approx(v, rel=1e-12), name
        assert _reader(name).read({"cell": "none.b1", "trace": {"span_us": 1.0}}) is None
    # the kind that no reader reports since the folded plans keep no Kronecker link
    assert spans.per_request_ms(rec, "kronecker") == pytest.approx(0.08, rel=1e-12)
    prof = types.SimpleNamespace(LOAD_SECONDS={"read": 1.5, "restore": 0.25})
    monkeypatch.setitem(sys.modules, "keynet_tpu_torch.profiling", prof)
    assert _reader("load_read_s").read(rec) == 1.5
    assert _reader("load_restore_s").read(rec) == 0.25
    monkeypatch.setitem(sys.modules, "keynet_tpu_torch.profiling", types.SimpleNamespace())
    assert _reader("load_read_s").read(rec) is None
    assert _reader("load_restore_s").read(rec) is None


def test_trace_without_window_and_the_script(tmp_path):
    """A trace of scripts/serve.py --profile has no kbench.window: the
    window is the whole trace; the script prints the per-link table."""
    ev = [e for e in _trace()["traceEvents"] if e["name"] != "kbench.window"]
    r = spans.reduce({"traceEvents": ev})
    assert r["requests"] == 2 and r["span_us"] == 1000 - 100 and r["coverage"] == 1.0
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "kbench", "spans.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("2 whole requests") and "100.00% charged" in lines[0]
    assert "launches" in lines[1] and "h2d median 0.040 ms" in lines[1]
    row = next(l for l in lines if "PermutedBlockSparseOp" in l).split()
    assert row[:4] == ["conv1", "0", "PermutedBlockSparseOp", "blocksparse"]
    assert float(row[4]) == pytest.approx(0.1) and float(row[5]) == 1.0
