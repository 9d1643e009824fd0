"""Tracing/profiling utilities: the port of keynet_tpu/profiling.py.

Stopwatch spans and the per-layer accounting report (format, shape, nnz,
device bytes) as in keynet_tpu; ``trace`` and ``annotate`` sit on
torch.profiler where keynet_tpu used jax.profiler.  ``device_busy`` reads a
trace's device share: the part of a traced span during which a kernel or
copy ran on the card.

The program's spans.  ``annotate`` is the one span primitive: while a
torch.profiler (or autograd profiler) records, it is ``record_function``,
on the clock of the trace's CUPTI kernel and copy events; otherwise it is a
shared null context that calls nothing in torch.  No span synchronises or
puts work on the device.  The serving path opens, per request:

- ``keynet.forward``: the whole of ``KeyedModel.forward``, holding
  - ``keynet.h2d``: the copy of the cipher batch to the device;
  - ``keynet.run``: ``KeyedModel.run``, holding one span per stage:
    ``keynet.layer/<layer>/<OpClass>`` (the op and its fused ReLU) or
    ``keynet.layer/<layer>/relu``; a ``ChainedOp`` layer holds
    ``keynet.link/<j>/<OpClass>`` for each link j, in order, and a
    ``ChannelBroadcastOp`` layer ``keynet.link/0/<OpClass>`` for its inner op;
  - ``keynet.decrypt``: the output key and the affine reshape.

``load_keynet`` fills ``LOAD_SECONDS`` (host seconds, always on) with its
two phases, each also a span: ``read`` (``keynet.load.read``: the
snapshot's members read and inflated) and ``restore``
(``keynet.load.restore``: the ops, the model and the sensor built from
them).  PERF.md §3 maps each span and the record to the benchmark metric
that reads it (``kbench/spans.py`` charges device time to the spans).

``GROUPED_ROWS`` (always on) counts the grouped steps
``BlockSparseOp.run_step`` runs (``applies``) and their launches of the
grouped kernel or einsums (``chunks``), and keeps in ``cores``, under each
core's logical shape ``"<n_out>x<n_in>"``, its last apply: ``last`` (the value of ``applies`` it
left), ``B``, ``x_itemsize``, ``tiles`` (the distinct non-zero tiles the
core holds), ``x_blocks`` (the x blocks its non-zero slots read) and
``buckets``, one ``[m, G, KB, TM, TN, tile itemsize, nz]`` per multiplicity
bucket: G tile_ids patterns of KB slots, each applied to m row-blocks, nz
of the G·KB slots non-zero.  ``run_step`` opens the span
``keynet.grouped`` around each grouped step, inside the link span that holds
the core: the benchmark reads its device time beside the work it computes
from these shapes.

In a residual net each residual ReLU's stage ``keynet.layer/<relu>/relu``
holds the span ``keynet.residual`` around its shortcut's apply, its add
and the ReLU (``KeyedModel._add_residual``).
``RESIDUAL`` (always on) counts those applies (``applies``) and keeps in
``shortcuts``, under the ReLU's name, its last apply: ``last`` (the value
of ``applies`` it left), ``B``, ``x_itemsize``, ``rows_out`` and
``rows_in`` (the keyed shortcut's shape, homogeneous coordinate included),
``nnz``, ``x_cols`` (the distinct input coordinates its non-zero entries
read) and ``op_bytes`` (its values and indices on the device).  The
benchmark computes the least bytes of a request's shortcuts from these."""

import contextlib
import os
import time

import torch

# host seconds of the last load_keynet's phases: {"read": s, "restore": s}
LOAD_SECONDS = {}
# BlockSparseOp.run_step's grouped steps, their bucket chunks, and each core's
# shapes at its last apply (see above)
GROUPED_ROWS = {"applies": 0, "chunks": 0, "cores": {}}
# the residual adds KeyedModel.run makes and each shortcut's last apply (see above)
RESIDUAL = {"applies": 0, "shortcuts": {}}
_NO_SPAN = contextlib.nullcontext()


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


def timed_ms(device, fn, *args):
    """(fn(*args), its milliseconds): CUDA events on the card, the host
    clock elsewhere."""
    if torch.device(device).type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)
    t = time.perf_counter()
    out = fn(*args)
    return out, 1e3 * (time.perf_counter() - t)


def residual_record(relu, op):
    """The counter's record of the shortcut ``op`` into the residual ReLU
    ``relu``, its shapes read once (KeyedModel._build)."""
    n_out, n_in = op.shape
    x_cols = op.read_cols() if hasattr(op, "read_cols") else n_in
    return {"name": relu, "last": 0, "B": 0, "x_itemsize": 4, "rows_out": int(n_out),
            "rows_in": int(n_in), "nnz": int(op.nnz()), "x_cols": int(x_cols),
            "op_bytes": int(op.device_bytes())}


def count_residual(record, x):
    """Count one residual add of the shortcut ``record`` on the batch ``x``."""
    RESIDUAL["applies"] += 1
    record.update(last=RESIDUAL["applies"], B=int(x.shape[0]),
                  x_itemsize=x.element_size())
    RESIDUAL["shortcuts"][record["name"]] = record


def active():
    """Whether a torch.profiler or autograd profiler is recording."""
    return torch.autograd.profiler._is_profiler_enabled


def annotate(name, on=None):
    """A named span inside a trace: ``record_function(name)`` while a
    profiler records, else a shared null context.  ``on`` is the caller's
    own reading of ``active()``, taken once for many spans."""
    if on is None:
        on = active()
    return torch.autograd.profiler.record_function(name) if on else _NO_SPAN


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
    (reference: per-layer nnz repr, keynet/layer.py:84-86); a residual
    ReLU's shortcut follows it as the row ``<relu>+<source>``."""
    rows = []
    for name, l in knet.layers().items():
        if l == "relu":
            rows.append({"layer": name, "format": "elementwise-relu",
                         "shape": None, "nnz": 0, "device_bytes": 0})
        else:
            rows.append({"layer": name, "format": type(l.op()).__name__,
                         "shape": tuple(l.shape), "nnz": l.nnz(),
                         "device_bytes": l.device_bytes()})
        if name in knet.residuals():
            src, sc = knet.residuals()[name]
            rows.append({"layer": "%s+%s" % (name, src), "format": type(sc.op()).__name__,
                         "shape": tuple(sc.shape), "nnz": sc.nnz(),
                         "device_bytes": sc.device_bytes()})
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
