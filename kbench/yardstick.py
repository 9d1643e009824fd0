"""The benchmark's own arithmetic, frozen here so that a change to the program
cannot change the yardstick it is measured by.

- ``PEAKS``: the H100 SXM data-sheet rates (dense, no sparsity, 700 W), as
  ``keynet_tpu_torch.bench_kernels.PEAKS`` gives them.
- ``source_flops``: the FLOPs of one image through the source network of a
  configuration's layer list (2 per multiply-add of every conv and linear
  layer, side-branch convs included; pools, ReLUs, residual adds and biases
  left out).  They do not depend on what implements the forward.
- ``slot_walk_work`` and ``periodic_work``: the FLOPs and least bytes of one
  launch of the Block-ELL slot walk and of the periodic kernel, copied from
  ``bench_kernels.work`` and chip_smoke's ``periodic_work``: each distinct
  non-zero tile and each x block a non-zero slot reads counted once, the
  f32 output written once, the index arrays read.
- ``busy``: the union of device intervals over a span, as
  ``profiling.device_busy`` takes it.
- ``reduce_trace``: a Chrome trace of ``torch.profiler`` reduced to what the
  per-layer readers need.
"""

import bisect
import re

import torch

PEAKS = dict(f32=67e12, bf16=989e12, tf32=494.7e12, bw=3.35e12)
WINDOW_SPAN = "kbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def product_peak(tile_dtype, precision):
    """The FLOP/s peak of the product the Block-ELL kernels run for a
    configuration's f32 tiles in its PRECISION mode: TF32 under 'default',
    else IEEE f32 FMAs."""
    if tile_dtype != "float32":
        raise ValueError("no peak for %r tiles" % tile_dtype)
    return PEAKS["tf32"] if precision == "default" else PEAKS["f32"]


def step_peak(precision):
    """The FLOP/s peak of the configuration's arithmetic for the whole step:
    f32 outside the tensor cores unless the mode lets TF32 in."""
    return PEAKS["tf32"] if precision == "default" else PEAKS["f32"]


def _conv(l, shape):
    """The (C, H, W) a conv entry gives from SHAPE, and its FLOPs."""
    C, H, W = shape
    if l["in"] != C:
        raise ValueError("%s takes %d channels, gets %d" % (l["name"], l["in"], C))
    out = (l["out"], H // l["stride"], W // l["stride"])
    return out, 2 * l["in"] * l["k"] * l["k"] * out[0] * out[1] * out[2]


def source_flops(layers, inshape):
    """FLOPs of one image through the layer list (2 per multiply-add).

    The list is a chain: each entry reads the output of the one before.  A
    ``conv`` entry with ``"input": "<earlier layer>"`` is a side branch (a
    projection shortcut): it reads that layer's output, does not move the
    chain, and keeps its own output under its name, which a ``relu``
    entry's ``"residual"`` then adds as it is, shape for shape.  ValueError
    for a layer that takes another width than it gets, an ``input`` that
    names no earlier layer or is set on another kind than ``conv``, and a
    side conv added before it is computed or at another shape."""
    shape = tuple(inshape)
    named = {l["input"] for l in layers if l.get("input")}
    sides = {l["name"] for l in layers if l.get("input")}
    kept, flops = {}, 0
    for l in layers:
        kind = l["kind"]
        if l.get("input"):
            if kind != "conv":
                raise ValueError("%s: only a conv may read another layer's output"
                                 % l["name"])
            if l["input"] not in kept:
                raise ValueError("%s reads %r, no earlier layer" % (l["name"], l["input"]))
            kept[l["name"]], f = _conv(l, kept[l["input"]])
            flops += f
            continue
        if kind == "conv":
            shape, f = _conv(l, shape)
            flops += f
        elif kind == "avgpool":
            shape = (shape[0], shape[1] // l["stride"], shape[2] // l["stride"])
        elif kind == "linear":
            C, H, W = shape
            if l["in"] != C * H * W:
                raise ValueError("%s takes %d features, gets %d"
                                 % (l["name"], l["in"], C * H * W))
            flops += 2 * l["in"] * l["out"]
            shape = (l["out"], 1, 1)
        elif kind == "relu":
            side = l.get("residual")
            if side in sides and kept.get(side) != shape:
                raise ValueError("%s adds %s of shape %s to %s" % (
                    l["name"], side, kept.get(side, "not yet computed"), shape))
        elif kind != "dropout":
            raise ValueError("unknown layer kind %r" % kind)
        if l["name"] in named:
            kept[l["name"]] = shape
    return flops


def source_macs(layers, inshape):
    return source_flops(layers, inshape) // 2


def slot_walk_work(tile_ids, col_blk, TM, TN, n_out, B, itemsize):
    """FLOPs and least bytes of one slot-walk launch over B rows: 2·TM·TN
    per non-zero slot and row; each distinct non-zero tile and each x block
    a non-zero slot reads once (x in the tile dtype), the f32 output once,
    tile_ids and col_blk read."""
    nz = tile_ids > 0
    slots = int(nz.sum())
    uniq = int(torch.unique(tile_ids[nz]).numel())
    x_blocks = int(torch.unique(col_blk[nz]).numel())
    flops = 2.0 * TM * TN * B * slots
    nbytes = (uniq * TM * TN * itemsize + B * x_blocks * TN * itemsize + B * n_out * 4
              + 2 * tile_ids.numel() * 4)
    return dict(slots=slots, unique_tiles=uniq, x_blocks=x_blocks, flops=flops,
                bytes=nbytes)


def periodic_work(tile_ids, col_blk, TM, TN, itemsize, s, P, R, B):
    """FLOPs and least bytes of one periodic launch over rows [s, s+P·R) at
    B rows: each referenced tile of the period read once, each x block a
    non-zero slot of the mid rows reads once, the f32 output written once,
    the period's ids and the mid rows' column blocks read."""
    ids = tile_ids[s:s + P]
    nz = ids > 0
    n_nz = int(nz.sum())
    uniq = int(torch.unique(ids[nz]).numel())
    cols = col_blk[s:s + P * R].reshape(R, P, -1)
    x_blocks = int(torch.unique(cols[nz.expand(R, -1, -1)]).numel())
    flops = 2.0 * TM * TN * B * R * n_nz
    nbytes = (uniq * TM * TN * itemsize + B * x_blocks * TN * itemsize
              + B * P * R * TM * 4 + ids.numel() * 4 + P * R * ids.shape[1] * 4)
    return dict(slots=n_nz * R, unique_tiles=uniq, x_blocks=x_blocks, flops=flops,
                bytes=nbytes)


def bound_s(flops, nbytes, peak, bw=PEAKS["bw"]):
    """The least time the card could take: the larger of operations over
    the peak and bytes over the memory rate."""
    return max(flops / peak, nbytes / bw)


def busy(intervals, t0, t1):
    """The length of the union of ``intervals`` (start, end) clipped to
    [t0, t1]."""
    iv = sorted((max(t0, a), min(t1, b)) for a, b in intervals if b > t0 and a < t1)
    total, end = 0.0, t0
    for a, b in iv:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals, t0, t1):
    """The idle stretches of [t0, t1] between the union of ``intervals``:
    [(start, end)]."""
    iv = sorted((max(t0, a), min(t1, b)) for a, b in intervals if b > t0 and a < t1)
    out, end = [], t0
    for a, b in iv:
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if t1 > end:
        out.append((end, t1))
    return out


def _label(gap, host):
    """What the host was doing in an idle gap: of the host events that
    overlap it, the one that covers most of it, the shortest on a tie
    (the innermost); host events are (start, end, name) sorted by start."""
    a, b = gap
    best = None
    for s, e, name in host[:bisect.bisect_left(host, (b,))]:
        ov = min(b, e) - max(a, s)
        if ov > 0:
            key = (ov, -(e - s))
            if best is None or key > best[0]:
                best = (key, name)
    return best[1] if best else "host between ops"


def reduce_trace(trace, n_top=10):
    """Reduce a Chrome trace (the dict ``export_chrome_trace`` writes) to the
    traced window's span (µs), the device's busy µs in it, the device time
    of each kernel name, the number of kernel launches, the ``n_top``
    kernels that took most device time and the ``n_top`` longest idle gaps,
    each labelled with what the host was doing."""
    events = [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError("no %r span in the trace" % WINDOW_SPAN)
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    kernels, launches = {}, {}
    for e in device:
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + float(e["dur"])
            launches[e["name"]] = launches.get(e["name"], 0) + 1
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW_SPAN)
    idle = sorted(gaps(iv, t0, t1), key=lambda g: g[0] - g[1])[:n_top]
    return dict(span_us=t1 - t0, busy_us=busy(iv, t0, t1), kernel_us=kernels,
                kernel_launches=launches, n_kernels=sum(launches.values()),
                top_kernels=sorted(kernels.items(), key=lambda kv: -kv[1])[:n_top],
                idle_gaps=[(_label(g, host), g[1] - g[0]) for g in idle])


def kernel_match(reduced, pattern):
    """(device µs, launches) of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    names = [k for k in reduced["kernel_us"] if rx.search(k)]
    return (sum(reduced["kernel_us"][k] for k in names),
            sum(reduced["kernel_launches"][k] for k in names))


def roofline(record, kernel, pattern):
    """A kernel's share of its roofline in the traced window, in %: the
    yardstick's bound of the launches of one request (``launch_work``,
    recorded in warm-up) times the traced requests, over the device time of
    the kernels whose name matches ``pattern``.  None where nothing ran, or
    where the launches the trace holds are not those the bound counts."""
    t, w = record["trace"], record["launch_work"].get(kernel)
    if not t or not w or not w["launches"] or w["launches"] != w["counted"]:
        return None
    us, n = kernel_match(t, pattern)
    n_req = len(record["trace_requests"])
    if not us or n != w["launches"] * n_req:
        return None
    return 100.0 * w["bound_s"] * n_req / (us / 1e6)


def idle_percent(record):
    """The share of the traced window with no kernel, copy or set on the
    card, in %; None where the trace holds no device event."""
    t = record["trace"]
    if not t or not t["span_us"] or not t["busy_us"]:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["span_us"])
