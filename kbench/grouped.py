"""The grouped-row apply of keynet_tpu_torch's Block-ELL cores
(``BlockSparseOp._apply_grouped``): its work, computed by the benchmark from
the shapes the program's counter keeps, and its device time, read from the
program's ``keynet.grouped`` spans in a trace.

``profiling.GROUPED_ROWS["cores"]`` keeps, for each core, its last apply:
its place among all applies (``last``), ``B``, ``x_itemsize``, the distinct
non-zero tiles the core holds (``tiles``), the x blocks its non-zero slots
read (``x_blocks``) and one ``[m, G, KB, TM, TN, tile itemsize, nz]`` a
multiplicity bucket (G distinct tile_ids patterns of KB slots, each shared
by m row-blocks, nz of the G·KB slots non-zero).  The cores of a request
are the last applies: a process also holds the keyed sensor's cores, which
the camera's side applies.  An apply's work is counted as
``yardstick.slot_walk_work`` counts a slot-walk launch, so that padding
slots (tile 0) and tiles shared between patterns are no work:

- FLOPs: 2·B·m·nz·TM·TN summed over the buckets;
- least bytes: each distinct non-zero tile read once, each x block a
  non-zero slot reads once, the f32 output (B·n_rb·TM, n_rb = Σ G·m)
  written once, and the plan's ids at 4 bytes (the patterns, Σ G·KB; the
  slots' column blocks, n_rb·KB; the un-permute's order, n_rb).

A ``keynet.grouped`` span sits inside the link span of the core it applies,
so ``kbench/spans.py`` charges its kernels to that link's kind as before;
here each kernel launched inside one (innermost, by ``correlation`` as there)
within a whole request of the window is charged to it.
"""

import json
import os

from kbench import spans, yardstick

SPAN = "keynet.grouped"


def apply_work(core):
    """{"flops", "bytes"} of one grouped-row apply with the counter's record
    ``core``."""
    B, buckets = core["B"], core["buckets"]
    TM, TN, it = buckets[0][3:6]
    n_rb = sum(G * m for m, G, *_ in buckets)
    flops = sum(2 * B * m * nz * TM * TN for m, *_, nz in buckets)
    ids = sum(G * KB * (1 + m) for m, G, KB, *_ in buckets) + n_rb
    nbytes = core["tiles"] * TM * TN * it + B * core["x_blocks"] * TN * core["x_itemsize"] \
        + B * n_rb * TM * 4 + ids * 4
    return {"flops": float(flops), "bytes": nbytes}


def request_work(counter, batch, peak, applies):
    """The last ``applies`` grouped-row applies of the counter, a request of
    ``batch`` images: {"flops", "bytes", "bound_s"} (the bound at ``peak``
    FLOP/s and yardstick.PEAKS["bw"]), or None unless they were the last
    applies of as many distinct cores, each at ``batch``."""
    if not counter or applies < 1:
        return None
    cores = sorted(counter["cores"].values(), key=lambda c: c["last"])[-applies:]
    n = counter["applies"]
    if [c["last"] for c in cores] != list(range(n - applies + 1, n + 1)) \
            or any(c["B"] != batch for c in cores):
        return None
    works = [apply_work(c) for c in cores]
    return {"flops": sum(w["flops"] for w in works),
            "bytes": sum(w["bytes"] for w in works),
            "bound_s": sum(yardstick.bound_s(w["flops"], w["bytes"], peak) for w in works)}


def reduce(trace):
    """The whole requests of the trace's window (``requests``), the
    ``keynet.grouped`` spans inside them (``spans``) and the kernel µs
    launched inside those spans (``kernel_us``)."""
    events = [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"]
    t0, t1, _ = spans._window(events)
    sp = [dict(name=e["name"], ts=float(e["ts"]), dur=float(e["dur"]),
               end=float(e["ts"]) + float(e["dur"]), thread=(e.get("pid"), e.get("tid")),
               parent=None)
          for e in events if e.get("cat") == "user_annotation"
          and str(e.get("name", "")).startswith(spans.PREFIX)]
    timeline = spans._Timeline(sp)
    whole = {i for i, s in enumerate(sp) if s["name"] == spans.FORWARD
             and s["ts"] >= t0 and s["end"] <= t1}
    grouped = {i for i, s in enumerate(sp) if s["name"] == SPAN
               and spans._path(sp, i)[0] in whole}
    launches = {}
    for e in events:
        if e.get("cat") in spans.LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches.setdefault(c, (float(e["ts"]), (e.get("pid"), e.get("tid"))))
    us = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch and t0 <= launch[0] <= t1 and timeline.at(launch[1], launch[0]) in grouped:
            us += float(e["dur"])
    return dict(requests=len(whole), spans=len(grouped), kernel_us=us)


_CACHE = {}


def for_record(record, traces=None):
    """The reduction of the run's trace (``<traces>/<cell>.json``, by default
    spans.TRACES), or None where ``spans.for_record`` finds none (no trace,
    a stale file, under 99% of the kernel time charged to program spans, no
    whole request) or no ``keynet.grouped`` span lies in a whole request.
    Each file is parsed once a process."""
    if spans.for_record(record, traces) is None:
        return None
    path = os.path.join(traces or spans.TRACES, record["cell"] + ".json")
    key = (path, record["trace"]["span_us"])
    if key not in _CACHE:
        with open(path) as f:
            _CACHE[key] = reduce(json.load(f))
    r = _CACHE[key]
    return r if r["spans"] else None


def per_request_ms(record, traces=None):
    """Device ms a whole request charged to keynet.grouped spans, or None."""
    r = for_record(record, traces)
    return None if r is None else r["kernel_us"] / r["requests"] / 1e3


def roofline(record, counter, traces=None):
    """The grouped-row applies' share of their roofline in the traced
    window, in %: a request's bound (request_work at the record's step
    peak, over the applies a whole request of the trace holds) times the
    whole requests, over the kernel time charged to keynet.grouped spans.
    None where either side finds nothing, or where the counter's last
    applies are not that many distinct cores at the record's batch."""
    r = for_record(record, traces)
    if r is None or not r["kernel_us"] or r["spans"] % r["requests"]:
        return None
    w = request_work(counter, record["batch"], record["step_peak"],
                     r["spans"] // r["requests"])
    if w is None:
        return None
    return 100.0 * w["bound_s"] * r["requests"] / (r["kernel_us"] / 1e6)
