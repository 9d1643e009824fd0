"""The grouped-row apply's span and counter (BlockSparseOp.run_step's
grouped step, profiling.GROUPED_ROWS) on the CPU, and the benchmark's reading of them
(kbench/grouped.py, the metrics grouped_ms.batch and
grouped_roofline.batch): the span opens only under a profiler, inside the
link span that holds the core, and changes no output bit; the counter's
shapes give the FLOPs and bytes of a hand count; the readers read a trace
and a counter made by hand, and nothing without them.  Imports no JAX.

The core: 128 row-blocks of 8x8 tiles, KB = 4 slots each, whose tile_ids
rows repeat 8 distinct patterns 4, 4, 8, 8, 16, 16, 32 and 40 times
(buckets m = 4, 8, 16, 32, 40).  In ``core`` every slot holds a tile of its
own; in ``padded_core`` (PADDED) slots hold tile 0, patterns share tiles,
and the zero slots alone read the last column block of x."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import keynet_tpu_torch as kt
from keynet_tpu_torch import profiling
from keynet_tpu_torch.ops.operators import BlockSparseOp, ChainedOp, Step
from kbench import grouped, harness, spans, yardstick

TM = TN = 8
KB, N_RB, N_CB = 4, 128, 16
COUNTS = (4, 4, 8, 8, 16, 16, 32, 40)
B = 4


# non-zero slots 2, 3, 3, 1, 4, 3, 2, 1; tiles 1-7
PADDED = np.array([[1, 2, 0, 0], [1, 3, 4, 0], [2, 3, 0, 5], [6, 0, 0, 0],
                   [1, 2, 3, 4], [5, 6, 7, 0], [7, 0, 1, 0], [0, 0, 0, 2]])


def _core(patterns, pad_col=False):
    rng = np.random.default_rng(0)
    n_tiles = 1 + int(patterns.max())
    tiles = rng.standard_normal((n_tiles, TM, TN)).astype(np.float32)
    tiles[0] = 0.0
    rows = np.repeat(np.arange(8), COUNTS)
    rng.shuffle(rows)
    tile_ids = patterns[rows].astype(np.int32)
    col_blk = rng.integers(0, N_CB, (N_RB, KB)).astype(np.int32)
    if pad_col:
        col_blk = np.where(tile_ids == 0, N_CB - 1, col_blk % (N_CB - 1)).astype(np.int32)
    G = kt.globals.GLOBAL
    old = G.get("ROWGROUP_MIN_SLOT_BYTES")
    G["ROWGROUP_MIN_SLOT_BYTES"] = 1 << 16
    try:
        op = BlockSparseOp(torch.from_numpy(tiles), tile_ids, col_blk, (N_RB * TM, N_CB * TN),
                           (TM, TN), int((tile_ids > 0).sum()) * TM * TN)
    finally:
        if old is None:
            G.pop("ROWGROUP_MIN_SLOT_BYTES")
        else:
            G["ROWGROUP_MIN_SLOT_BYTES"] = old
    assert op._rgroup_meta == ((4, 2), (8, 2), (16, 2), (32, 1), (40, 1))
    assert op.schedule(B, torch.device("cpu")) == (Step("grouped", 0, N_RB, None),)
    return op


def _walk(op, x):
    """The slot walk's plain version over every row-block of ``op``."""
    return op.run_step(Step("rows", 0, N_RB, None), x)


@pytest.fixture(scope="module")
def core():
    return _core(1 + np.arange(8 * KB).reshape(8, KB))


@pytest.fixture(scope="module")
def padded_core():
    return _core(PADDED, pad_col=True)


@pytest.fixture
def x():
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, N_CB * TN)).astype(np.float32))


def _names(prof):
    return [e.name for e in prof.events() if e.name.startswith("keynet.")]


def test_span_opens_only_under_a_profiler(core, x, monkeypatch):
    calls = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __init__(self, *a, **k):
            calls.append(a[0] if a else k.get("name"))
            super().__init__(*a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    plain = core.apply(x)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = core.apply(x)
    assert calls == [grouped.SPAN] and _names(prof) == [grouped.SPAN]
    assert torch.equal(plain, traced)
    # the grouped-row apply is the slot walk's sum, row-blocks in place
    assert torch.allclose(plain, _walk(core, x), rtol=1e-5, atol=1e-5)


def test_span_sits_inside_its_link(core, x):
    """In a chain the span is inside the link's, and the link keeps its op
    kind: kbench/spans.py charges the span's kernels to blocksparse."""
    chain = ChainedOp([core])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chain.apply(x)
    evs = {e.name: e for e in prof.events() if e.name.startswith("keynet.")}
    link, span = evs["keynet.link/0/BlockSparseOp"], evs[grouped.SPAN]
    assert span.cpu_parent is not None and span.cpu_parent.name == link.name
    assert spans.kind_of([link.name, span.name]) == "blocksparse"
    assert spans.op_class(span.name) is None


def _ids_bytes(n_patterns):
    """The plan's ids at 4 bytes: patterns, column blocks, row order."""
    return (n_patterns * KB + N_RB * KB + N_RB) * 4


def test_counter_by_hand(core, x):
    before = {k: profiling.GROUPED_ROWS[k] for k in ("applies", "chunks")}
    core.apply(x)
    c = profiling.GROUPED_ROWS
    assert c["applies"] == before["applies"] + 1
    assert c["chunks"] == before["chunks"] + 5                 # one einsum a bucket
    rec = c["cores"]["%dx%d" % (N_RB * TM, N_CB * TN)]
    assert rec == {"last": c["applies"], "B": B, "x_itemsize": 4, "tiles": 8 * KB,
                   "x_blocks": N_CB,
                   "buckets": [[4, 2, KB, TM, TN, 4, 2 * KB], [8, 2, KB, TM, TN, 4, 2 * KB],
                               [16, 2, KB, TM, TN, 4, 2 * KB], [32, 1, KB, TM, TN, 4, KB],
                               [40, 1, KB, TM, TN, 4, KB]]}
    w = grouped.apply_work(rec)
    # every row-block's KB tiles times x; 8 patterns' tiles, x and the output once
    assert w["flops"] == 2 * B * N_RB * KB * TM * TN
    assert w["bytes"] == 8 * KB * TM * TN * 4 + B * N_CB * TN * 4 + B * N_RB * TM * 4 \
        + _ids_bytes(8)


def test_counter_by_hand_padded(padded_core, x):
    """Padding slots (tile 0) are no work, a tile shared between patterns
    is read once, and x blocks only zero slots name are not read: the count
    of yardstick.slot_walk_work, whose ids are tile_ids and col_blk."""
    want = _walk(padded_core, x)
    y = padded_core.apply(x)
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    c = profiling.GROUPED_ROWS
    rec = c["cores"]["%dx%d" % (N_RB * TM, N_CB * TN)]
    assert rec["last"] == c["applies"]
    assert (rec["tiles"], rec["x_blocks"]) == (7, N_CB - 1)
    # m = 4: patterns 0, 1; m = 8: 2, 3; m = 16: 4, 5; m = 32: 6; m = 40: 7
    assert [b[6] for b in rec["buckets"]] == [5, 4, 7, 2, 1]
    nz = 4 * 5 + 8 * 4 + 16 * 7 + 32 * 2 + 40 * 1
    assert nz == int((padded_core.tile_ids > 0).sum()) == 268
    w = grouped.apply_work(rec)
    assert w["flops"] == 2 * B * nz * TM * TN
    assert w["bytes"] == 7 * TM * TN * 4 + B * (N_CB - 1) * TN * 4 + B * N_RB * TM * 4 \
        + _ids_bytes(8)
    sw = yardstick.slot_walk_work(padded_core.tile_ids, padded_core.col_blk, TM, TN,
                                  N_RB * TM, B, 4)
    assert w["flops"] == sw["flops"]
    assert w["bytes"] - _ids_bytes(8) == sw["bytes"] - 2 * N_RB * KB * 4


def test_counter_counts_chunks(core, x):
    """A budget of one pattern's x gathers a chunk: one einsum a pattern,
    the same output up to the order of the sums."""
    G = kt.globals.GLOBAL
    want = core.apply(x)
    old = G.get("PERIODIC_X_CHUNK_BYTES")
    G["PERIODIC_X_CHUNK_BYTES"] = 1
    try:
        before = profiling.GROUPED_ROWS["chunks"]
        got = core.apply(x)
    finally:
        if old is None:
            G.pop("PERIODIC_X_CHUNK_BYTES")
        else:
            G["PERIODIC_X_CHUNK_BYTES"] = old
    assert profiling.GROUPED_ROWS["chunks"] == before + 8
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------ the readers

MAIN = (1, 1)
CORE = {"last": 7, "B": 2, "x_itemsize": 4, "tiles": 10, "x_blocks": 3,
        "buckets": [[2, 3, 4, 8, 8, 4, 9]]}


def _x(name, cat, ts, dur, thread=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _request(t, c, with_span=True):
    """One request at ``t`` (µs): forward [t, t+400) holding run [t+10,
    t+390) holding layer conv1/ChainedOp [t+20, t+300) with link 0
    PermutedBlockSparseOp [t+20, t+300); with ``with_span`` the link holds
    keynet.grouped [t+40, t+200).  Kernels: a layout copy launched
    in the link before the span (30 µs), a tile gather (20 µs) and an
    einsum (60 µs) launched in the span, a take launched in the link after
    it (10 µs)."""
    ev = [_x("keynet.forward", "user_annotation", t, 400),
          _x("keynet.run", "user_annotation", t + 10, 380),
          _x("keynet.layer/conv1/ChainedOp", "user_annotation", t + 20, 280),
          _x("keynet.link/0/PermutedBlockSparseOp", "user_annotation", t + 20, 280)]
    if with_span:
        ev.append(_x(grouped.SPAN, "user_annotation", t + 40, 160))
    for k, (ts, name, dur) in enumerate([(25, "permute", 30), (50, "index_gather", 20),
                                         (60, "gemm", 60), (250, "take", 10)]):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + ts, 3, corr=c + k))
        ev.append(_x(name, "kernel", t + ts + 5, dur, thread=(0, 7), corr=c + k))
    return ev


def _write(tmp_path, cell, with_span=True):
    ev = [_x("kbench.window", "user_annotation", 0, 1000)]
    ev += _request(100, 10, with_span) + _request(600, 20, with_span)
    with open(tmp_path / (cell + ".json"), "w") as f:
        json.dump({"traceEvents": ev}, f)
    return {"cell": cell, "batch": 2, "step_peak": yardstick.PEAKS["f32"],
            "trace": {"span_us": 1000.0}}


def _reader(name):
    return harness.load_module(os.path.join(harness.ROOT, "kbench", "metrics", name + ".py"),
                               "test_grouped_reader_" + name.replace(".", "_"))


def _counter(monkeypatch, cores, applies=7):
    prof = types.SimpleNamespace(GROUPED_ROWS={"applies": applies, "chunks": 0,
                                               "cores": cores})
    monkeypatch.setitem(sys.modules, "keynet_tpu_torch.profiling", prof)


def test_reduce_by_hand(tmp_path):
    rec = _write(tmp_path, "g.b2")
    with open(tmp_path / "g.b2.json") as f:
        trace = json.load(f)
    r = grouped.reduce(trace)
    assert r == {"requests": 2, "spans": 2, "kernel_us": 2 * 80.0}
    # spans.py charges the same kernels, and the rest of the link, to blocksparse
    s = spans.reduce(trace)
    assert s["kind_us"]["blocksparse"] == 2 * 120.0 and s["coverage"] == 1.0
    assert grouped.for_record(rec, traces=str(tmp_path))["kernel_us"] == 160.0


def test_readers(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "TRACES", str(tmp_path))
    rec = _write(tmp_path, "r.b2")
    ms, roof = _reader("grouped_ms.batch"), _reader("grouped_roofline.batch")
    assert ms.read(rec) == pytest.approx(0.08, rel=1e-12)
    # CORE by hand: 2·B·m·nz·TM·TN FLOPs; 10 tiles, 3 x blocks, the output
    # and the ids (3 patterns of 4, 6 row-blocks' 4 column blocks, 6 rows)
    flops = 2 * 2 * 2 * 9 * 8 * 8
    nbytes = 10 * 8 * 8 * 4 + 2 * 3 * 8 * 4 + 2 * 6 * 8 * 4 + (12 + 24 + 6) * 4
    assert grouped.apply_work(CORE) == {"flops": flops, "bytes": nbytes}
    bound = max(flops / 67e12, nbytes / 3.35e12)
    _counter(monkeypatch, {"48x32": CORE})
    want = 100.0 * bound * 2 / 160e-6
    assert roof.read(rec) == pytest.approx(want, rel=1e-12)
    # the keyed sensor's core, applied before the requests, is left out
    _counter(monkeypatch, {"3x3": dict(CORE, last=3, B=5), "48x32": CORE})
    assert roof.read(rec) == pytest.approx(want, rel=1e-12)
    # the last apply is not the request's: the counter and the trace disagree
    _counter(monkeypatch, {"48x32": dict(CORE, last=6)})
    assert roof.read(rec) is None
    # a core last applied at another batch
    _counter(monkeypatch, {"48x32": dict(CORE, B=4)})
    assert roof.read(rec) is None
    # a program without the counter
    monkeypatch.setitem(sys.modules, "keynet_tpu_torch.profiling", types.SimpleNamespace())
    assert roof.read(rec) is None


def test_readers_read_nothing_without_a_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "TRACES", str(tmp_path))
    _counter(monkeypatch, {"48x32": CORE})
    for rec in ({"cell": "none.b2", "batch": 2, "step_peak": 67e12, "trace": None},
                {"cell": "none.b2", "batch": 2, "step_peak": 67e12,
                 "trace": {"span_us": 1000.0}}):
        assert _reader("grouped_ms.batch").read(rec) is None
        assert _reader("grouped_roofline.batch").read(rec) is None
    # a program without the span: a trace with no keynet.grouped
    rec = _write(tmp_path, "bare.b2", with_span=False)
    assert spans.for_record(rec) is not None
    assert _reader("grouped_ms.batch").read(rec) is None
    assert _reader("grouped_roofline.batch").read(rec) is None


# ------------------------------------------------------------ the grouped kernel

def test_kernel_plan_is_the_plan(core, padded_core):
    """The grouped kernel's int32 arrays hold the plan: the patterns of each
    bucket in turn, and the row-blocks of each group, whose tile_ids rows
    are the group's pattern; every row-block once."""
    for op in (core, padded_core):
        patterns, rows = op._rgroups
        assert patterns.dtype == rows.dtype == torch.int32
        assert sorted(rows.tolist()) == list(range(N_RB))
        g = r = 0
        for m, G in op._rgroup_meta:
            for _ in range(G):
                assert bool((op.tile_ids[rows[r:r + m].long()] == patterns[g]).all())
                g, r = g + 1, r + m
        assert g == patterns.shape[0]


@pytest.mark.parametrize("which", ["core", "padded_core"])
def test_grouped_entry_plain_on_the_cpu(which, x, request):
    """The grouped entry on a CPU tensor computes its plain version, the
    grouped einsum that the CPU route applies, within 1e-5 of the slot
    walk's plain version, and launches nothing; a plan that does not fit
    col_blk is refused."""
    from keynet_tpu_torch.ops import block_ell
    op = request.getfixturevalue(which)
    patterns, rows = op._rgroups
    block_ell.reset_launches()
    y = block_ell.grouped_block_ell_matmul(x, op.tiles, patterns, rows, op.col_blk,
                                           op._rgroup_meta, N_RB * TM)
    assert sum(block_ell.LAUNCHES.values()) == 0
    assert op.schedule(B, x.device)[0].entry is None and torch.equal(op.apply(x), y)
    assert torch.allclose(y, _walk(op, x), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="do not fit"):
        block_ell.grouped_block_ell_matmul(x, op.tiles, patterns, rows[1:], op.col_blk,
                                           op._rgroup_meta, N_RB * TM)


# The grouped-row plans of the stochastic VGG-16's conv1_1 and conv2_1 cores
# at 224 (the cell vgg16-stoch-224.b32): (m, G) a bucket, KB, column blocks
VGG_PLANS = {
    "conv1_1": ([(1, 243), (2, 3), (5, 218), (10, 12), (26, 3), (31, 1), (32, 10),
                 (206, 3), (212, 10), (217, 1), (232, 8), (238, 25), (243, 4), (244, 47)],
                26, 1281),
    "conv2_1": ([(1, 228), (2, 3), (3, 4), (4, 1), (5, 4), (6, 6), (7, 13), (8, 32), (9, 15),
                 (10, 54), (11, 55), (12, 26), (20, 2), (23, 8), (24, 6), (25, 2), (27, 2),
                 (31, 156), (32, 156)], 37, 6273)}


def _vgg_patterns(name, seed=0):
    buckets, KB, _ = VGG_PLANS[name]
    rng = np.random.default_rng(seed)
    patterns = rng.integers(1, 64, (sum(G for _, G in buckets), KB)).astype(np.int32)
    patterns[rng.random(patterns.shape) < 0.3] = 0
    return buckets, patterns


@pytest.mark.parametrize("B", [1, 8, 32, 33, 128])
@pytest.mark.parametrize("name", sorted(VGG_PLANS))
def test_grouped_tables(name, B):
    """grouped_tables at the VGG cores' plans: one launch a row tile (each
    bucket at the least tile that holds its m·B pairs), widest first; every
    pair chunk of every group once, a group's chunks side by side, groups
    by non-zero slots, most first."""
    from keynet_tpu_torch.ops import block_ell
    buckets, patterns = _vgg_patterns(name)
    t = block_ell.grouped_tables(buckets, patterns, B, 128, 128, torch.float32)
    assert t["B"] == B
    bt = {}
    g0 = r0 = 0
    for m, G in buckets:
        plan = block_ell.launch_plan(m * B, 128, 128, 128, torch.float32, "grouped")
        # the slot walk's cp.async ring and two slots of 8-byte row offsets
        assert plan["kind"] == 0 and plan["smem"] == block_ell.launch_plan(
            m * B, 128, 128, 128, torch.float32)["smem"] + 16 * plan["BT"]
        for g in range(G):
            bt[g0 + g] = (plan["BT"], r0 + g * m, m, -(-m * B // plan["BT"]))
        g0, r0 = g0 + G, r0 + G * m
    tiles = [p["BT"] for p, _ in t["launches"]]
    assert tiles == sorted(set(v[0] for v in bt.values()), reverse=True)
    nz = (patterns > 0).sum(1)
    seen = set()
    for plan, table in t["launches"]:
        assert table.dtype == torch.int32 and table.shape[1] == 4
        e = table.numpy()
        groups = [int(g) for i, g in enumerate(e[:, 0]) if i == 0 or e[i - 1, 0] != g]
        assert len(groups) == len(set(groups))                   # chunks side by side
        assert list(nz[groups]) == sorted(nz[groups], reverse=True)
        for g, first, m, q0 in e:
            BT, want_first, want_m, chunks = bt[int(g)]
            assert (plan["BT"], int(first), int(m)) == (BT, want_first, want_m)
            assert q0 % BT == 0 and q0 < m * B
            seen.add((int(g), int(q0)))
    n_blocks = sum(len(tb) for _, tb in t["launches"])
    assert len(seen) == sum(v[3] for v in bt.values()) == n_blocks


@pytest.fixture(scope="module", params=sorted(VGG_PLANS))
def vgg_core(request):
    """A core with the plan of a VGG core (random tiles and column blocks)."""
    buckets, patterns = _vgg_patterns(request.param)
    KB, n_cb = VGG_PLANS[request.param][1:]
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(len(patterns)), np.concatenate([[m] * G for m, G in buckets]))
    rng.shuffle(rows)
    tile_ids = patterns[rows]
    col_blk = rng.integers(0, n_cb, tile_ids.shape).astype(np.int32)
    tiles = torch.zeros((64, 128, 128))
    op = BlockSparseOp(tiles, tile_ids, col_blk, (len(rows) * 128, n_cb * 128), (128, 128),
                       int((tile_ids > 0).sum()) * 128 * 128)
    assert [tuple(b) for b in op._rgroup_meta] == buckets
    return op


@pytest.mark.parametrize("B", [1, 8, 32, 128])
def test_grouped_wins_takes_the_kernel(vgg_core, B, monkeypatch):
    """On the kernel side with f32 tiles in 'highest' and 'high' the
    schedule is the grouped kernel's one step; under 'default' (tf32
    products) and on the CPU the grouped einsum keeps its own model."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    n_rb, KB = vgg_core.tile_ids.shape
    G = kt.globals.GLOBAL
    for mode in ("highest", "high"):
        monkeypatch.setitem(G, "PRECISION", mode)
        assert vgg_core.schedule(B, cuda) == (Step("grouped", 0, n_rb,
                                                   "grouped_block_ell_matmul"),)
    # the einsum's model: the gathers' write and read, the reorder, against
    # the slot walk's tile a slot (its gather's write and read on the CPU)
    TM, TN = vgg_core.tileshape
    tile_b = TM * TN * 4
    x_b = n_rb * KB * B * TN * 4
    einsum = 2 * sum(G * KB for _, G in vgg_core._rgroup_meta) * tile_b + x_b \
        + 2 * B * n_rb * TM * 4
    walk = "block_ell_matmul_xresd" if KB >= 8 else "block_ell_matmul_xres2"
    for device, alt in ((cpu, 2), (cuda, 1)):
        if device is cuda:
            monkeypatch.setitem(G, "PRECISION", "default")
        want = (Step("grouped", 0, n_rb, None),) \
            if einsum < alt * n_rb * KB * tile_b + x_b \
            else (Step("rows", 0, n_rb, walk if device is cuda else None),)
        assert vgg_core.schedule(B, device) == want, device
