"""Tracing/profiling utilities: the port of keynet_tpu/profiling.py.

Stopwatch spans and the per-layer accounting report (format, shape, nnz,
device bytes) as in keynet_tpu; ``trace`` and ``annotate`` sit on
torch.profiler where keynet_tpu used jax.profiler.  ``device_busy`` reads a
trace's device share: the part of a traced span during which a kernel or
copy ran on the card."""

import contextlib
import os
import time

import torch


class Stopwatch:
    """Wall-clock span timer with the reference's fluent feel."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = self._last = time.perf_counter()
        return self

    def since(self, reset=False):
        now = time.perf_counter()
        dt = now - self._t0
        if reset:
            self._t0 = now
        return dt

    def lap(self):
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        return dt

    def __enter__(self):
        return self.reset()

    def __exit__(self, *exc):
        self.elapsed = self.since()


@contextlib.contextmanager
def trace(name, trace_dir=None):
    """A torch.profiler trace of the block, annotated as the span ``name``:
    CPU activity, and CUDA activity when a card is present.  Yields the
    profiler (``key_averages()``, ``events()``); with ``trace_dir`` the
    trace is also written there as ``<name>.json`` (Chrome trace format).
    Work queued on the card inside the block is traced only once it has run:
    synchronise before the block ends."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(name):
            yield prof
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, name + ".json"))


def annotate(name):
    """A named span inside a trace."""
    return torch.profiler.record_function(name)


def device_events(prof):
    """The work a finished trace saw on the card: kernels, copies and sets
    (user annotations mirrored onto the device's timeline left out)."""
    return [e for e in prof.events() if not _on_cpu(e)
            and not getattr(e, "is_user_annotation", False)]


def device_busy(prof, name):
    """The device's busy share of the span ``name`` in a finished trace:
    the union of the device events that overlap the span, over the span's
    length.  Returns a dict with ``window_ms``, ``busy_ms``, ``busy_share``,
    ``idle_share`` and ``device_events``; busy and idle are None when the
    trace holds no device event (no card, or the profiler did not reach
    it)."""
    spans = [e for e in prof.events() if e.name == name and _on_cpu(e)]
    if not spans:
        raise ValueError("no span %r in the trace" % name)
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    iv = sorted((max(t0, e.time_range.start), min(t1, e.time_range.end))
                for e in device_events(prof) if e.name != name
                and e.time_range.end > t0 and e.time_range.start < t1)
    busy, end = 0.0, t0
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = t1 - t0
    share = busy / window if iv and window > 0 else None
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3 if iv else None,
            "busy_share": share, "idle_share": None if share is None else 1.0 - share,
            "device_events": len(iv)}


def _on_cpu(event):
    return str(event.device_type).rsplit(".", 1)[-1] == "CPU"


def layer_report(knet):
    """Per-layer accounting table: format, shape, nnz, device bytes
    (reference: per-layer nnz repr, keynet/layer.py:84-86)."""
    rows = []
    for name, l in knet.layers().items():
        if l == "relu":
            rows.append({"layer": name, "format": "elementwise-relu",
                         "shape": None, "nnz": 0, "device_bytes": 0})
        else:
            rows.append({"layer": name, "format": type(l.op()).__name__,
                         "shape": tuple(l.shape), "nnz": l.nnz(),
                         "device_bytes": l.device_bytes()})
    return rows


def print_layer_report(knet):
    rows = layer_report(knet)
    total_nnz = sum(r["nnz"] for r in rows)
    total_b = sum(r["device_bytes"] for r in rows)
    for r in rows:
        print("%-12s %-22s %-22s nnz=%-12d %8.2f MB"
              % (r["layer"], r["format"], r["shape"], r["nnz"],
                 r["device_bytes"] / 1e6))
    print("%-12s %-22s %-22s nnz=%-12d %8.2f MB"
          % ("TOTAL", "", "", total_nnz, total_b / 1e6))
    return rows
