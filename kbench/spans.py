"""Charge the device time of a torch.profiler trace of keynet_tpu_torch to
the program's own spans, and print the per-link table:

    python3 kbench/spans.py <trace.json>

The program opens a span at each layer boundary of a request while a
profiler records (``keynet_tpu_torch/profiling.py`` names them):
``keynet.forward`` holds ``keynet.h2d``, ``keynet.run`` and
``keynet.decrypt``; ``keynet.run`` holds ``keynet.layer/<layer>/<OpClass>``
(or ``.../relu``), and a chained layer ``keynet.link/<j>/<OpClass>``.  Each
device event (kernels, copies, sets) launched in the window is charged to
the innermost ``keynet.`` span open on its launching thread when it was
launched; the launch is the ``cuda_runtime`` or ``cuda_driver`` event with
the same ``correlation`` (the Block-ELL kernels are launched from libraries
linked against the static CUDA runtime, whose launches may show only as
``cuLaunchKernel``).  A device event with no launch event is unattributed (and
in the window if it overlaps it).  The window is the benchmark's
``kbench.window`` span, or the whole trace where it has none
(``scripts/serve.py --profile``).  Charging reads the host clock alone:
the device's clock drifts from it within a trace.

An op kind is read from the innermost span that names an op class:
``blocksparse`` (BlockSparseOp, PermutedBlockSparseOp), ``kronecker``,
``tapsum``, else ``other`` (ReLUs, the copy, decrypt, every other class).
Each idle gap of the window is put down to the innermost program span open
on the host when it began, or to ``outside the program``.

The benchmark's readers call ``for_record``: the reduction of the trace the
harness wrote for the run (``cache/traces/<cell>.json``), parsed once a
process, or None where that file is missing or from another run, where less
than ``MIN_COVERAGE`` of the window's kernel time is charged to the
program's spans, or where the window holds no whole request.
"""

import bisect
import collections
import json
import os
import statistics
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kbench import yardstick  # noqa: E402

PREFIX = "keynet."
FORWARD, H2D = "keynet.forward", "keynet.h2d"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
KINDS = {"BlockSparseOp": "blocksparse", "PermutedBlockSparseOp": "blocksparse",
         "KroneckerOp": "kronecker", "TapSumOp": "tapsum"}
KIND_NAMES = ("blocksparse", "kronecker", "tapsum", "other")
OUTSIDE = "outside the program"
MIN_COVERAGE = 0.99
TRACES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cache", "traces")


def op_class(name):
    """The op class a span names (``keynet.layer/<layer>/<OpClass>``,
    ``keynet.link/<j>/<OpClass>``), else None."""
    parts = name.split("/")
    if len(parts) == 3 and parts[0] in ("keynet.layer", "keynet.link") and parts[2] != "relu":
        return parts[2]
    return None


def _window(events):
    """(t0, t1, thread) of the first kbench.window span; the extent of every
    event and no thread where there is none."""
    for e in events:
        if e.get("name") == yardstick.WINDOW_SPAN and e.get("cat") == "user_annotation":
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])          # as yardstick.reduce_trace takes it
            return t0, t1, (e.get("pid"), e.get("tid"))
    return (min(float(e["ts"]) for e in events),
            max(float(e["ts"]) + float(e["dur"]) for e in events), None)


class _Timeline:
    """The innermost span open at a time on each thread: the spans' starts
    and ends in order, with the span innermost after each."""

    def __init__(self, spans):
        marks = {}
        for i, s in enumerate(spans):
            if s["dur"] <= 0:                           # encloses no launch
                continue
            m = marks.setdefault(s["thread"], [])
            m.append((s["ts"], 1, -s["dur"], i))      # starts: outer first
            m.append((s["end"], 0, s["dur"], i))      # ends before starts, inner first
        self.times, self.inner = {}, {}
        for thread, m in marks.items():
            m.sort()
            stack, times, inner = [], [], []
            for t, start, _, i in m:
                if start:
                    spans[i]["parent"] = stack[-1] if stack else None
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                times.append(t)
                inner.append(stack[-1] if stack else None)
            self.times[thread], self.inner[thread] = times, inner

    def at(self, thread, t):
        times = self.times.get(thread)
        if not times:
            return None
        k = bisect.bisect_right(times, t) - 1
        return self.inner[thread][k] if k >= 0 else None


def _path(spans, i):
    path = []
    while i is not None:
        path.append(i)
        i = spans[i]["parent"]
    return path[::-1]


def row_key(names):
    """A span path's row in the table: (layer, link, class) for the
    program's layer and link spans, (span name, "-", "") for the others."""
    layer = link = None
    for n in names:
        if n.startswith("keynet.layer/"):
            layer = n.split("/")
        elif n.startswith("keynet.link/"):
            link = n.split("/")
    if link:
        return (layer[1] if layer else "?", link[1], link[2])
    if layer:
        return (layer[1], "-", layer[2])
    return (names[-1], "-", "")


def kind_of(names):
    """The op kind of a span path: from the innermost span naming an op class."""
    for n in reversed(names):
        c = op_class(n)
        if c:
            return KINDS.get(c, "other")
    return "other"


def reduce(trace):
    """Reduce a Chrome trace (the dict ``export_chrome_trace`` writes) to the
    window (``span_us``), its kernel time (``kernel_us``) and the part charged
    to program spans (``charged_us``, ``coverage``), the whole requests
    (``requests``: the ``keynet.forward`` spans inside the window), per
    request-summed totals by op kind (``kind_us``) and by table row
    (``rows``: kernel µs, kernels, copy µs, copies, idle µs), the kernels
    charged inside ``keynet.forward`` (``forward_kernels``), the launches of
    each kernel name by row (``kernel_rows``; a launch outside every program
    span under ``outside the program``), each request's
    H2D µs (``h2d_us``: the host duration of ``keynet.h2d``; the copy is
    synchronous, so the span ends once the copy has), the unattributed device
    µs, and the idle gaps ``[(label, µs)]``, longest first."""
    events = [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"]
    if not events:
        raise ValueError("no events in the trace")
    t0, t1, win_thread = _window(events)
    spans = [dict(name=e["name"], ts=float(e["ts"]), dur=float(e["dur"]),
                  end=float(e["ts"]) + float(e["dur"]), thread=(e.get("pid"), e.get("tid")),
                  parent=None, kernel_us=0.0, kernels=0, copy_us=0.0, copies=0,
                  idle_us=0.0)
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    timeline = _Timeline(spans)
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches.setdefault(c, (float(e["ts"]), (e.get("pid"), e.get("tid"))))
    device = []                       # (event, its launch or None)
    for e in events:
        if e.get("cat") in yardstick.DEVICE_CATS:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if (t0 <= launch[0] <= t1) if launch else \
                    (float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0):
                device.append((e, launch))
    kernel_us = charged_us = unattributed_us = 0.0
    charged = []                      # (kernel name, span) of each kernel
    for e, launch in device:
        dur = float(e["dur"])
        is_kernel = e["cat"] == "kernel"
        kernel_us += dur if is_kernel else 0.0
        if launch is None:
            unattributed_us += dur
            continue
        i = timeline.at(launch[1], launch[0])
        if is_kernel:
            charged.append((e["name"], i))
        if i is None:
            continue
        s = spans[i]
        if is_kernel:
            charged_us += dur
            s["kernel_us"] += dur
            s["kernels"] += 1
        else:
            s["copy_us"] += dur
            s["copies"] += 1

    # The device clock drifts from the host's within a trace (by up to ~0.35
    # µs a ms on the H100), so a gap's start is put on the host clock through
    # the launch of the event that ends it: an idle device starts that event
    # as it is launched, so the host was at launch - gap length when the gap
    # began.  Only the window's last gap, which no event ends, is read raw.
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), launch)
                for e, launch in device)
    starts = [v[0] for v in iv]
    thread = win_thread
    if thread is None:
        thread = next((s["thread"] for s in spans if s["name"] == FORWARD), None)
    gaps = []
    for a, b in yardstick.gaps([v[:2] for v in iv], t0, t1):
        k = bisect.bisect_left(starts, b)
        launch = iv[k][2] if k < len(iv) and iv[k][0] == b else None
        i = timeline.at(launch[1], launch[0] - (b - a)) if launch else timeline.at(thread, a)
        if i is None:
            gaps.append((OUTSIDE, b - a))
        else:
            spans[i]["idle_us"] += b - a
            gaps.append((spans[i]["name"], b - a))

    requests = [i for i, s in enumerate(spans) if s["name"] == FORWARD
                and s["ts"] >= t0 and s["end"] <= t1]
    whole = set(requests)
    rows, kind_us, forward_kernels, h2d = {}, dict.fromkeys(KIND_NAMES, 0.0), 0, []
    keys = []
    for i, s in enumerate(spans):
        path = _path(spans, i)
        names = [spans[j]["name"] for j in path]
        keys.append(row_key(names))
        r = rows.setdefault(keys[-1], dict(kind=kind_of(names), kernel_us=0.0,
                                           kernels=0, copy_us=0.0, copies=0, idle_us=0.0))
        for k in ("kernel_us", "kernels", "copy_us", "copies", "idle_us"):
            r[k] += s[k]
        if path[0] in whole:
            kind_us[r["kind"]] += s["kernel_us"]
            forward_kernels += s["kernels"]
            if s["name"] == H2D:
                h2d.append(s["dur"])
    kernel_rows = collections.defaultdict(collections.Counter)
    for name, i in charged:
        kernel_rows[name][keys[i] if i is not None else (OUTSIDE, "-", "")] += 1
    outside = sum(g for label, g in gaps if label == OUTSIDE)
    if outside:
        rows[(OUTSIDE, "-", "")] = dict(kind="", kernel_us=0.0, kernels=0, copy_us=0.0,
                                        copies=0, idle_us=outside)
    return dict(span_us=t1 - t0, kernel_us=kernel_us, charged_us=charged_us,
                coverage=charged_us / kernel_us if kernel_us else 0.0,
                unattributed_us=unattributed_us, requests=len(requests),
                kind_us=kind_us, forward_kernels=forward_kernels, h2d_us=h2d, rows=rows,
                kernel_rows=dict(kernel_rows), gaps=sorted(gaps, key=lambda g: -g[1]))


_CACHE = {}


def for_record(record, traces=None):
    """The reduction of the trace the harness wrote for ``record``'s run
    (``<traces>/<cell>.json``), or None: no traced window in the record, no
    file, a file whose kbench.window span is not the record's
    (``trace.span_us``), less than MIN_COVERAGE of the kernel time charged
    to program spans, or no whole request.  Each file is parsed once a
    process."""
    t = record.get("trace")
    if not t:
        return None
    path = os.path.join(traces or TRACES, record["cell"] + ".json")
    key = (path, t["span_us"])
    if key not in _CACHE:
        _CACHE[key] = _load(path, t["span_us"])
    r = _CACHE[key]
    if r is None or r["coverage"] < MIN_COVERAGE or not r["requests"]:
        return None
    return r


def _load(path, span_us):
    try:
        with open(path) as f:
            trace = json.load(f)
    except (OSError, ValueError):
        return None
    windows = [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"
               and e.get("name") == yardstick.WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    t0, t1, _ = _window(windows)
    return reduce(trace) if t1 - t0 == span_us else None


def per_request_ms(record, kind):
    """Device ms a whole request charged to links of ``kind``, or None."""
    r = for_record(record)
    return None if r is None else r["kind_us"][kind] / r["requests"] / 1e3


def table(r):
    """The per-link table of a reduction, as text lines."""
    n = max(r["requests"], 1)
    out = ["%d whole requests in a %.3f ms window; kernel time %.3f ms, %.2f%% charged to "
           "program spans; %.3f ms of device events with no launch event"
           % (r["requests"], r["span_us"] / 1e3, r["kernel_us"] / 1e3, 100 * r["coverage"],
              r["unattributed_us"] / 1e3),
           "per request: " + ", ".join("%s %.3f ms" % (k, r["kind_us"][k] / n / 1e3)
                                       for k in KIND_NAMES)
           + "; %.1f launches" % (r["forward_kernels"] / n)
           + ("; h2d median %.3f ms" % (statistics.median(r["h2d_us"]) / 1e3)
              if r["h2d_us"] else ""),
           "%-22s %-5s %-24s %-12s %10s %9s %9s %9s" % (
               "layer", "link", "class", "kind", "ms/req", "launches", "copy ms", "idle ms")]
    for (layer, link, cls), v in r["rows"].items():
        out.append("%-22s %-5s %-24s %-12s %10.4f %9.1f %9.4f %9.4f" % (
            layer, link, cls, v["kind"], v["kernel_us"] / n / 1e3, v["kernels"] / n,
            v["copy_us"] / n / 1e3, v["idle_us"] / n / 1e3))
    out.append("longest idle gaps: " + ", ".join("%s %.3f ms" % (label, us / 1e3)
                                                 for label, us in r["gaps"][:10]))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        r = reduce(json.load(f))
    print("\n".join(table(r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
