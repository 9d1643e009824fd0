"""The benchmark's frozen arithmetic against the program's as it is today
(``bench_kernels.work``, ``profiling.device_busy``) and against counts made
by hand, and the reduction of a Chrome trace."""

import types

import numpy as np
import pytest
import torch

from keynet_tpu_torch import bench_kernels, profiling
from kbench import yardstick


def _block_ell(rng, n_rb, KB, n_uniq, n_cb):
    ids = rng.integers(0, n_uniq, (n_rb, KB)).astype(np.int32)
    cols = rng.integers(0, n_cb, (n_rb, KB)).astype(np.int32)
    return torch.from_numpy(ids), torch.from_numpy(cols)


def test_peaks_are_the_h100_sxm_rows():
    assert yardstick.PEAKS == bench_kernels.PEAKS["H100 SXM"]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B", [1, 32, 1024])
def test_slot_walk_work_is_bench_kernels_work(itemsize, B):
    ids, cols = _block_ell(np.random.default_rng(B + itemsize), 40, 9, 30, 60)
    TM = TN = 128
    n_out = 40 * TM
    mine = yardstick.slot_walk_work(ids, cols, TM, TN, n_out, B, itemsize)
    theirs = bench_kernels.work(ids, cols, TM, TN, n_out, B, itemsize, yardstick.PEAKS)
    for k in ("flops", "bytes", "unique_tiles", "x_blocks"):
        assert mine[k] == theirs[k], k
    assert mine["slots"] == theirs["nonzero_slots"]
    peak = yardstick.PEAKS["f32" if itemsize == 4 else "bf16"]
    assert yardstick.bound_s(mine["flops"], mine["bytes"], peak) * 1e3 == \
        pytest.approx(theirs["bound_ms"], rel=1e-12)


def test_periodic_work_by_hand():
    """A core of 2 head rows, a period of P=2 rows repeated R=3 times and
    1 tail row, KB=2, 128x128 tiles.  Period rows: (5, 0) and (5, 7): three
    non-zero slots, two distinct tiles.  The mid rows' non-zero slots read
    column blocks 1, 2, 3 (rep 0), 1, 4, 5 (rep 1), 2, 4, 6 (rep 2): six
    distinct x blocks."""
    ids = torch.tensor([[1, 2], [3, 0],
                        [5, 0], [5, 7], [5, 0], [5, 7], [5, 0], [5, 7],
                        [9, 9]], dtype=torch.int32)
    cols = torch.tensor([[0, 0], [0, 0],
                         [1, 9], [2, 3], [1, 8], [4, 5], [2, 7], [4, 6],
                         [0, 0]], dtype=torch.int32)
    s, P, R, B, T = 2, 2, 3, 4, 128
    w = yardstick.periodic_work(ids, cols, T, T, 4, s, P, R, B)
    assert w["slots"] == 9 and w["unique_tiles"] == 2 and w["x_blocks"] == 6
    assert w["flops"] == 2.0 * T * T * B * 9
    assert w["bytes"] == (2 * T * T * 4          # the two distinct tiles
                          + B * 6 * T * 4         # six x blocks a row
                          + B * P * R * T * 4     # the f32 output
                          + P * 2 * 4             # the period's ids
                          + P * R * 2 * 4)        # the mid rows' column blocks


def _ev(name, a, b, device="CUDA"):
    return types.SimpleNamespace(
        name=name, device_type="DeviceType." + device, is_user_annotation=False,
        time_range=types.SimpleNamespace(start=a, end=b, elapsed_us=lambda: b - a))


@pytest.mark.parametrize("seed", range(5))
def test_busy_is_device_busy(seed):
    rng = np.random.default_rng(seed)
    t0, t1 = 1000.0, 5000.0
    iv = sorted((float(a), float(a + d)) for a, d in zip(rng.uniform(0, 6000, 40),
                                                          rng.uniform(1, 300, 40)))
    events = [_ev("span", t0, t1, "CPU")] + [_ev("k%d" % i, a, b) for i, (a, b) in
                                             enumerate(iv)]
    prof = types.SimpleNamespace(events=lambda: events)
    theirs = profiling.device_busy(prof, "span")
    assert yardstick.busy(iv, t0, t1) / 1e3 == pytest.approx(theirs["busy_ms"], rel=1e-12)
    idle = sum(b - a for a, b in yardstick.gaps(iv, t0, t1))
    assert idle + yardstick.busy(iv, t0, t1) == pytest.approx(t1 - t0)


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    return {"traceEvents": [
        X("user_annotation", yardstick.WINDOW_SPAN, 100, 1000),
        X("gpu_user_annotation", yardstick.WINDOW_SPAN, 100, 1000),
        X("cpu_op", "aten::to", 100, 60),
        X("cuda_runtime", "cudaMemcpyAsync", 110, 40),
        X("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 130, 30),
        X("kernel", "void periodic_kernel<Core<float, 32> >(float const*)", 200, 300),
        X("kernel", "void slot_walk_kernel<Core<float, 32> >(float const*)", 450, 100),
        X("cpu_op", "aten::cat", 560, 200),
        X("kernel", "void at::native::cat_kernel()", 800, 50),
        X("cuda_runtime", "cudaStreamSynchronize", 860, 240),
        X("kernel", "void periodic_wgmma<Core<float, 32> >(float const*)", 1000, 50),
        X("kernel", "outside the window", 1200, 10),
        {"ph": "i", "name": "marker", "ts": 300}]}


def test_reduce_trace():
    r = yardstick.reduce_trace(_trace())
    assert r["span_us"] == 1000
    # device: 130-160, 200-550, 800-850, 1000-1050 -> 30 + 350 + 50 + 50
    assert r["busy_us"] == 480
    assert r["n_kernels"] == 4
    assert yardstick.kernel_match(r, r"\bperiodic_(kernel|wgmma)\b") == (350.0, 2)
    assert yardstick.kernel_match(r, r"\bslot_walk_(kernel|wgmma)\b") == (100.0, 1)
    assert r["top_kernels"][0][1] == 300
    # gaps: 100-130 (aten::to: 30 of 30, cudaMemcpyAsync 20), 160-200 (none),
    # 550-800 (aten::cat 200), 850-1000 (cudaStreamSynchronize), 1050-1100
    assert [g for g, _ in r["idle_gaps"]] == ["aten::cat", "cudaStreamSynchronize",
                                               "cudaStreamSynchronize", "host between ops",
                                               "aten::to"]
    assert [d for _, d in r["idle_gaps"]] == [250, 150, 50, 40, 30]


def test_reduce_trace_needs_the_window():
    with pytest.raises(ValueError):
        yardstick.reduce_trace({"traceEvents": []})


def test_roofline_and_idle_from_a_record():
    r = yardstick.reduce_trace(_trace())
    work = {"periodic": {"launches": 1, "counted": 1, "bound_s": 50e-6},
            "slot_walk": {"launches": 1, "counted": 1, "bound_s": 10e-6}}
    rec = {"trace": r, "launch_work": work, "trace_requests": [None, None]}
    assert yardstick.roofline(rec, "periodic", r"\bperiodic_(kernel|wgmma)\b") == \
        pytest.approx(100 * 2 * 50 / 350)
    # two requests need two slot-walk launches; the trace holds one
    assert yardstick.roofline(rec, "slot_walk", r"\bslot_walk_(kernel|wgmma)\b") is None
    assert yardstick.idle_percent(rec) == pytest.approx(52.0)

