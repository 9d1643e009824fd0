"""One run of one benchmark cell: set-up, the measured window (or, with
``--trace 1``, the traced one in its place), the comparison with the plain
reference, and the metrics.

Everything particular to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration and its traffic mix; the
configuration is ``<file>`` (its sizes, keys and weights) with its recipe
``<file minus .json>.py`` beside it; the traffic mix is
``kbench/traffic/<traffic>.json``; the cell's limits on the comparison with
the plain reference are ``kbench/workloads/<cell>.json``; each metric is the
reader
``kbench/metrics/<metric>.py``, a ``read(record)`` that returns a number or
None.  Adding a configuration, a mix or a metric adds files and entries and
edits none.

The timed path is the one a keyed-camera server runs: ``load_keynet`` of a
snapshot in ``kbench/cache/`` (converted and saved by the first run in a
checkout), then one request = ``KeyedModel.forward(host cipher batch)``
followed by ``.cpu()`` of its output.
"""

import gc
import hashlib
import importlib.util
import json
import os
import sys
import time

import torch

from kbench import weights as kweights
from kbench import yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "keynet_tpu")
# the program's sources whose change makes another snapshot
SNAPSHOT_SOURCES = (("keynet_tpu_torch", (".py", ".cpp", ".cu", ".cuh")),
                    ("native", (".py", ".cpp", ".cu", ".cuh")))
# entries of keynet_tpu_torch.ops.block_ell -> the kernel they launch
KERNEL_ENTRIES = {"periodic_block_ell_matvec": "periodic",
                  "block_ell_matmul": "slot_walk",
                  "block_ell_matmul_xres2": "slot_walk",
                  "block_ell_matmul_xresd": "slot_walk"}


def log(*a):
    print("[kbench]", *a, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix and the
    metrics it reports (end-to-end with ``trace`` False, per-layer with
    True)."""

    def __init__(self, root, name, bench_file="BENCHMARK.json"):
        self.root = root
        with open(os.path.join(root, bench_file)) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in %s (have %s)" % (name, bench_file, sorted(cells)))
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config_path = os.path.join(root, self.config_entry["file"])
        with open(self.config_path) as f:
            self.cfg = json.load(f)
        self.recipe_path = self.config_path[:-len(".json")] + ".py"
        self.kbench_dir = os.path.join(root, "kbench")
        self.traffic_path = os.path.join(self.kbench_dir, "traffic",
                                         self.entry["traffic"] + ".json")
        with open(self.traffic_path) as f:
            self.traffic = json.load(f)
        with open(os.path.join(self.kbench_dir, "workloads", name + ".json")) as f:
            self.limits = {k: float(v) for k, v in json.load(f)["correct"].items()}

    def metrics(self, trace):
        """The metric entries this cell reports in a run with ``trace``: the
        end-to-end ones that list it or list no cells, the per-layer ones
        that list it (a per-layer metric names its ``workloads``)."""
        if not trace:
            return [m for m in self.bench["end_to_end"]
                    if self.name in m.get("workloads", (self.name,))]
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]

    def reader(self, metric):
        path = os.path.join(self.kbench_dir, "metrics", metric + ".py")
        return load_module(path, "kbench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def recipe(self):
        return load_module(self.recipe_path, "kbench_config_" + self.entry["config"]
                           .replace(".", "_").replace("-", "_"))

    def reference(self):
        name = self.cfg["reference"]
        return load_module(os.path.join(self.kbench_dir, "reference", name + ".py"),
                           "kbench_reference_" + name)


# ------------------------------------------------------------------ snapshot

def snapshot_digest(cell, root):
    """A digest of what the snapshot is made from: the configuration file
    and its recipe, the benchmark's weight maker, every source file of the
    program in the tree ``root`` it is imported from (SNAPSHOT_SOURCES), and
    the torch and numpy versions."""
    import numpy
    h = hashlib.sha256()
    own = [cell.config_path, cell.recipe_path,
           os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights.py")]
    files = []
    for top, exts in SNAPSHOT_SOURCES:
        for d, dirs, names in os.walk(os.path.join(root, top)):
            dirs[:] = sorted(x for x in dirs if x != "__pycache__")
            files += [os.path.join(d, n) for n in names if n.endswith(exts)]
    for path in own + sorted(files):
        h.update(os.path.basename(path).encode() if path in own
                 else os.path.relpath(path, root).encode())
        h.update(b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    h.update(("torch %s numpy %s" % (torch.__version__, numpy.__version__)).encode())
    return h.hexdigest()[:16]


def ensure_snapshot(kt, cell, cache_dir):
    """The path of the cell's snapshot in ``cache_dir``: converted with the
    configuration's recipe and saved with its sensor when absent (written
    to a temporary name and renamed; snapshots of the configuration with
    another digest are deleted).  Returns (path, converted)."""
    cfg_name = cell.entry["config"]
    program = os.path.dirname(os.path.dirname(os.path.abspath(kt.__file__)))
    path = os.path.join(cache_dir, "%s-%s.npz" % (cfg_name, snapshot_digest(cell, program)))
    if os.path.exists(path):
        return path, False
    os.makedirs(cache_dir, exist_ok=True)
    if not kt.native.available() or kt.native.spgemm_dr is None:
        raise RuntimeError("the native packer is not built (python setup.py build_ext "
                           "--inplace): the conversion would take hours in numpy")
    recipe = cell.recipe()
    net = recipe.source_model(kt, cell.cfg)
    w = kweights.he_normal(cell.cfg)
    want = kweights.state_dict(w)
    have = {"%s.%s" % (n, k) for n, p in net.params.items() for k in p}
    if have != set(want):
        raise ValueError("the zoo spec's parameters %s are not the configuration's %s"
                         % (sorted(have ^ set(want))[:4], cfg_name))
    net.load_torch_state_dict(want)
    t = time.perf_counter()
    sensor, knet = recipe.convert(kt, cell.cfg, net, "cpu")
    log("converted %s in %.1f s (host), nnz %d" % (cfg_name, time.perf_counter() - t,
                                                   knet.num_parameters()))
    t = time.perf_counter()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        kt.save_keynet(f, knet, sensor=sensor, include_keys=True)
    os.replace(tmp, path)
    log("saved %s (%d bytes) in %.1f s" % (path, os.path.getsize(path),
                                           time.perf_counter() - t))
    for n in os.listdir(cache_dir):
        if n.startswith(cfg_name + "-") and n.endswith(".npz") and \
                os.path.join(cache_dir, n) != path:
            os.remove(os.path.join(cache_dir, n))
    return path, True


# ------------------------------------------------------------------ the program

def make_images(cfg, n, seed, device):
    """``n`` images (n, C, H, W) in the configuration's input range, drawn on
    ``device`` from a generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    inp = cfg["input"]
    x = torch.rand((n, *cfg["inshape"]), generator=g, device=device)
    mean = torch.tensor(inp["mean"], device=device)[:, None, None]
    std = torch.tensor(inp["std"], device=device)[:, None, None]
    return (inp["low"] + (inp["high"] - inp["low"]) * x - mean) / std


class Served:
    """The program's side of a run: the keyed model loaded from its snapshot
    on ``device``, and the requests sent to it."""

    def __init__(self, kt, cell, snapshot, device):
        self.kt, self.cell, self.device = kt, cell, torch.device(device)
        self.batch = int(cell.traffic["batch"])
        self.sensor, self.knet = kt.load_keynet(snapshot, device=self.device)

    def pool(self, seed):
        """(plaintext images on the host, the cipher batches the window
        cycles through: host tensors, pinned on a card).  The keyed sensor,
        the camera's optics, encrypts them on the device."""
        B, P = self.batch, int(self.cell.traffic["pool"])
        x = make_images(self.cell.cfg, B * P, seed, self.device)
        batches = []
        for i in range(P):
            xc = self.sensor.fromtensor(x[i * B:(i + 1) * B]).encrypt().tensor().cpu()
            batches.append(xc.pin_memory() if self.device.type == "cuda" else xc)
        return x.cpu(), batches

    def drop_sensor(self):
        self.sensor = None

    def request(self, xc):
        """One request: the keyed forward of a host cipher batch and its
        output back on the host.  Returns (output, t_send, t_return,
        t_done)."""
        t0 = time.perf_counter()
        y = self.knet.forward(xc)
        t1 = time.perf_counter()
        y = y.cpu()
        return y, t0, t1, time.perf_counter()

    def warm(self, pool):
        """Every pool batch once, then ``warmup_requests`` more; the first
        request runs with the Block-ELL entries wrapped, which gives the
        yardstick's work of each kernel a request launches.  Returns
        {kernel: {"launches", "counted", "flops", "bytes", "bound_s"}}."""
        work = self._record_launches(lambda: self.request(pool[0]))
        for xc in pool[1:]:
            self.request(xc)
        for i in range(int(self.cell.traffic["warmup_requests"])):
            self.request(pool[i % len(pool)])
        return work

    def _record_launches(self, fn):
        from keynet_tpu_torch.ops import block_ell
        cfg = self.cell.cfg
        peak = yardstick.product_peak(cfg["tile_dtype"], self.kt.globals.GLOBAL["PRECISION"])
        work = {k: {"launches": 0, "counted": 0, "flops": 0.0, "bytes": 0, "bound_s": 0.0}
                for k in set(KERNEL_ENTRIES.values())}

        def wrap(name, fn):
            kernel = KERNEL_ENTRIES[name]

            def entry(x, tiles, tile_ids, col_blk, *rest, **kw):
                TM, TN = tiles.shape[1], tiles.shape[2]
                if kernel == "periodic":
                    w = yardstick.periodic_work(tile_ids, col_blk, TM, TN,
                                                tiles.element_size(), *rest[:3],
                                                B=x.shape[0])
                else:
                    w = yardstick.slot_walk_work(tile_ids, col_blk, TM, TN, rest[0],
                                                 x.shape[0], tiles.element_size())
                r = work[kernel]
                r["launches"] += 1
                r["flops"] += w["flops"]
                r["bytes"] += w["bytes"]
                r["bound_s"] += yardstick.bound_s(w["flops"], w["bytes"], peak)
                return fn(x, tiles, tile_ids, col_blk, *rest, **kw)
            return entry

        saved = {n: getattr(block_ell, n) for n in KERNEL_ENTRIES}
        before = dict(block_ell.LAUNCHES)
        try:
            for n, f in saved.items():
                setattr(block_ell, n, wrap(n, f))
            fn()
        finally:
            for n, f in saved.items():
                setattr(block_ell, n, f)
        for n, k in KERNEL_ENTRIES.items():
            work[k]["counted"] += block_ell.LAUNCHES[n] - before[n]
        return work

    def window(self, pool, seconds):
        """Requests back to back, cycling through the pool, until one
        completes at or after ``seconds``.  Returns (outputs, [(t_send,
        t_return, t_done, pool index)])."""
        outs, reqs = [], []
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            p = i % len(pool)
            y, t0, t1, t2 = self.request(pool[p])
            outs.append(y)
            reqs.append((t0, t1, t2, p))
            i += 1
            if t2 >= t_end:
                return outs, reqs

    def traced(self, pool, seconds, path):
        """The window under torch.profiler (CPU and CUDA activity) inside the
        span ``kbench.window``; the trace is written to ``path`` and reduced.
        Returns (outputs, requests, reduced trace)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(yardstick.WINDOW_SPAN):
                outs, reqs = self.window(pool, seconds)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            reduced = yardstick.reduce_trace(json.load(f))
        return outs, reqs, reduced

    def close(self):
        """Free the program's state on the device."""
        self.sensor = self.knet = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ correct

def compare(outs, reqs, refs, limit):
    """Each request's output against the reference's for its pool batch:
    max|y - ref| / max|ref|.  Returns (worst, failed): the widest relative
    gap over the requests and the number of requests above ``limit``
    (a wrong shape or a non-finite output counts as an infinite gap)."""
    worst, failed = 0.0, 0
    for y, r in zip(outs, reqs):
        ref = refs[r[3]]
        if tuple(y.shape) != tuple(ref.shape) or not bool(torch.isfinite(y).all()):
            gap = float("inf")
        else:
            gap = float((y - ref).abs().max()) / float(ref.abs().max())
        worst = max(worst, gap)
        failed += not gap <= limit
    return worst, failed


def reference_outputs(cell, plain, device):
    """The plain reference's outputs for each pool batch of ``plain``, the
    host images (B·P, C, H, W), with the benchmark's weights."""
    y = cell.reference().run(cell.cfg["layers"], kweights.he_normal(cell.cfg), plain, device)
    B = int(cell.traffic["batch"])
    return [y[i:i + B] for i in range(0, y.shape[0], B)]


def spread(refs):
    """How far the reference outputs of the pool's images stray from their
    mean, over their largest magnitude: the part of the output that depends
    on the image."""
    y = torch.cat(refs)
    return float((y - y.mean(0)).abs().max()) / float(y.abs().max())


# ------------------------------------------------------------------ one run

def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def cache_env(root):
    """Fixed cache directories inside the checkout for whatever compiles."""
    base = os.path.join(root, "kbench", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def serve(cell, device, cache_dir=None, mark=lambda phase: None):
    """The program set up for ``cell`` on ``device``: the configuration's
    tile dtype and PRECISION set, the CUDA kernels built on a card, the
    snapshot made if absent, and the keyed model loaded; ``mark`` is called
    with the name of each phase as it ends.  Returns (Served, whether this
    call converted)."""
    import keynet_tpu_torch as kt
    G = kt.globals.GLOBAL
    G["TILE_DTYPE"] = cell.cfg["tile_dtype"]
    G["PRECISION"] = cell.cfg["precision"]
    mark("import")
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        mark("cuda")
        from keynet_tpu_torch.ops import block_ell
        block_ell.build()
    mark("kernels")
    snapshot, converted = ensure_snapshot(
        kt, cell, cache_dir or os.path.join(cell.root, "kbench", "cache"))
    mark("snapshot")
    served = Served(kt, cell, snapshot, device)
    mark("load")
    return served, converted


def run_cell(name, seed, seconds, trace, t_start, root=ROOT, device="cuda",
             cache_dir=None, precision=None, bench_file="BENCHMARK.json"):
    """One run of the cell ``name``; returns (result dict for the last line,
    [(compared name, value, limit)]).  Without ``trace`` the window is
    measured for ``seconds``; with it the window is the traffic's
    ``trace_seconds`` under the profiler.  ``precision`` runs the program in
    another PRECISION mode than the configuration states (the control)."""
    cell = Cell(root, name, bench_file)
    cfg, traffic = cell.cfg, cell.traffic
    device = torch.device(device)
    cache_dir = cache_dir or os.path.join(root, "kbench", "cache")
    on_card = device.type == "cuda"
    phases = []

    def mark(phase):
        phases.append((phase, time.perf_counter() - t_start))

    served, converted = serve(cell, device, cache_dir, mark)
    plain, pool = served.pool(seed)
    served.drop_sensor()
    gc.collect()
    mark("pool")
    # the camera's side (the sensor, the images it encrypts) ends here: the
    # server's peak is read from here to the window's end
    pool_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    G = served.kt.globals.GLOBAL
    if precision:
        G["PRECISION"] = precision
    work = served.warm(pool)
    mark("warm")
    setup_s = time.perf_counter() - t_start
    log("set-up %.3f s%s, phases ended at %s; %s" % (
        setup_s, " (converted)" if converted else "",
        " ".join("%s %.3f" % p for p in phases), json.dumps(work)))
    reduced = None
    if trace:
        path = os.path.join(cache_dir, "traces", name + ".json")
        outs, reqs, reduced = served.traced(pool, traffic["trace_seconds"], path)
    else:
        outs, reqs = served.window(pool, seconds)
    window_s = reqs[-1][2] - reqs[0][0]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    nnz = served.knet.num_parameters()
    served.close()
    log("device peak: %d B to the end of the pool's encryption, %d B from there to the "
        "window's end" % (pool_peak, peak))

    t = time.perf_counter()
    refs = reference_outputs(cell, plain, device)
    limit = cell.limits["max_rel_err"]
    worst, failed = compare(outs, reqs, refs, limit)
    log("reference and comparison %.1f s; outputs' spread over the images %.6g"
        % (time.perf_counter() - t, spread(refs)))
    macs = yardstick.source_macs(cfg["layers"], cfg["inshape"])
    log("keyed nnz / source MACs = %d / %d = %.4f" % (nnz, macs, nnz / macs))

    B = int(traffic["batch"])
    record = dict(cell=name, batch=B, setup_s=setup_s,
                  window_s=window_s, requests=reqs, images=B * len(reqs),
                  memory_peak_bytes=peak, launch_work=work,
                  flops_per_image=yardstick.source_flops(cfg["layers"], cfg["inshape"]),
                  step_peak=yardstick.step_peak(G["PRECISION"]),
                  trace=reduced, trace_requests=reqs if trace else None)
    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(max(pool_peak, peak))}
    result = {"correct": failed == 0 and len(reqs) > 0,
              "attempted": len(reqs), "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = reduced["busy_us"] / 1e6
        dev["window_s"] = reduced["span_us"] / 1e6
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in reduced["top_kernels"]],
            "idle_gaps": [[n, us / 1e6] for n, us in reduced["idle_gaps"]]}
    compared = [("max_rel_err", worst, limit)]
    result["compared"] = {n: {"value": v, "limit": l} for n, v, l in compared}
    return result, compared
