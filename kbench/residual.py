"""The residual adds of keynet_tpu_torch's residual nets
(``KeyedModel._add_residual``): the least bytes of a request's shortcut
applies and adds, computed by the benchmark from the shapes the program's
counter keeps, and their device time, read from the program's
``keynet.residual`` spans in a trace.

``profiling.RESIDUAL["shortcuts"]`` keeps, for each residual ReLU, its
shortcut's last apply: its place among all applies (``last``), ``B``,
``x_itemsize``, ``rows_out`` and ``rows_in`` (the keyed shortcut Ŝ's shape),
``nnz``, ``x_cols`` (the distinct input coordinates Ŝ's non-zero entries
read) and ``op_bytes`` (Ŝ's values and indices on the device).  The
shortcuts of a request are the last applies.  An apply's least bytes:

- x̂'s coordinates that Ŝ reads, once: B·x_cols·x_itemsize;
- the branch output read and the sum written, f32: 2·B·rows_out·4;
- Ŝ's values and indices once: op_bytes;

and its FLOPs 2·B·nnz.  A ``keynet.residual`` span sits inside the stage
span ``keynet.layer/<relu>/relu`` of its ReLU; each kernel launched inside
one (innermost, by ``correlation``, as ``kbench/spans.py`` charges) within a
whole request of the window is charged to it.
"""

import json
import os

from kbench import spans, yardstick

SPAN = "keynet.residual"


def apply_work(sc):
    """{"flops", "bytes"} of one shortcut apply and add with the counter's
    record ``sc``."""
    B = sc["B"]
    return {"flops": 2.0 * B * sc["nnz"],
            "bytes": B * sc["x_cols"] * sc["x_itemsize"] + 2 * B * sc["rows_out"] * 4
            + sc["op_bytes"]}


def request_work(counter, batch, peak, applies):
    """The last ``applies`` shortcut applies of the counter, a request of
    ``batch`` images: {"flops", "bytes", "bound_s"} (the bound at ``peak``
    FLOP/s and yardstick.PEAKS["bw"]), or None unless they were the last
    applies of as many distinct shortcuts, each at ``batch``."""
    if not counter or applies < 1:
        return None
    scs = sorted(counter["shortcuts"].values(), key=lambda c: c["last"])[-applies:]
    n = counter["applies"]
    if [c["last"] for c in scs] != list(range(n - applies + 1, n + 1)) \
            or any(c["B"] != batch for c in scs):
        return None
    works = [apply_work(c) for c in scs]
    return {"flops": sum(w["flops"] for w in works),
            "bytes": sum(w["bytes"] for w in works),
            "bound_s": sum(yardstick.bound_s(w["flops"], w["bytes"], peak) for w in works)}


def reduce(trace, span=SPAN):
    """The whole requests of the trace's window (``requests``), the
    ``span`` spans inside them (``spans``) and the kernel µs launched inside
    those spans (``kernel_us``)."""
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
    inside = {i for i, s in enumerate(sp) if s["name"] == span
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
        if launch and t0 <= launch[0] <= t1 and timeline.at(launch[1], launch[0]) in inside:
            us += float(e["dur"])
    return dict(requests=len(whole), spans=len(inside), kernel_us=us)


_CACHE = {}


def for_record(record, traces=None):
    """The reduction of the run's trace (``<traces>/<cell>.json``, by default
    spans.TRACES), or None where ``spans.for_record`` finds none (no trace,
    a stale file, under 99% of the kernel time charged to program spans, no
    whole request) or no ``keynet.residual`` span lies in a whole request.
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
    """Device ms a whole request charged to keynet.residual spans, or None."""
    r = for_record(record, traces)
    return None if r is None else r["kernel_us"] / r["requests"] / 1e3


def roofline(record, counter, traces=None):
    """The residual adds' share of their roofline in the traced window, in
    %: a request's bound (request_work at the record's step peak, over the
    applies a whole request of the trace holds) times the whole requests,
    over the kernel time charged to keynet.residual spans.  None where
    either side finds nothing, or where the counter's last applies are not
    that many distinct shortcuts at the record's batch."""
    r = for_record(record, traces)
    if r is None or not r["kernel_us"] or r["spans"] % r["requests"]:
        return None
    w = request_work(counter, record["batch"], record["step_peak"],
                     r["spans"] // r["requests"])
    if w is None:
        return None
    return 100.0 * w["bound_s"] * r["requests"] / (r["kernel_us"] / 1e6)
