#!/usr/bin/env python3
"""Smoke run of keynet_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

  1. build     the native packer (setup.py build_ext; a failed build raises:
               the VGG conversion needs it) and the four CUDA sources
               (csrc/block_ell.cu, block_ell_xres.cu, block_ell_grid.cu and
               periodic_block_ell.cu, one nvcc each for sm_90a, started
               together) from this checkout;
  2. parity    every slot-walk entry (block_ell_matmul, xres, xres2, xresd at
               depths 3 and 4, grid) against its plain PyTorch version on
               seeded random Block-ELL operands (f32 and bf16 tiles, B in
               {1, 5, 130}, KB not a multiple of the depth, n_rb not a
               multiple of 8, an all-zero row, id-0 slots, consecutive
               repeated ids, a, a, 0, a runs, rows that start on the last id
               of the row before, TM = 256, TN = 256), shape included, and
               the periodic kernel against its plain version (f32 and bf16,
               s = 0 and s > 0, P below 8 and P not a multiple of the 64-row
               tile, R in {1, 7, 31}, B in {1, 5, 32}, TM = 256, id-0 slots,
               an all-zero period row);
  3. main path, slice 1 (launch counts set to 0 just before, read just
               after): StochasticKeynet AllConvNet (3x32x32, alpha=2,
               blocksize 8, seed 0, AllConvNet(seed=1)) at B=64 and B=1024,
               the 3x16x16 test spec (a Block-ELL core with KB=7), and
               PermutationKeynet LeNet_AvgPool at B=64; each keyed forward
               is held against the source model on the card (IEEE f32)
               within 1e-5*max(1, scale); every entry that the driven
               Block-ELL cores route to must have launched, xres and grid
               never (no operator routes to them);
  4. main path, slice 2 (counts set to 0 just before, read just after):
               the Givens-orthogonal VGG-16 at 3x224x224 (Keynet with
               local_geometric='givens_orthogonal', alpha=2, blocksize 14,
               uniform_random_affine, memoryorder 'channel', seed 0,
               VGG16(seed=5), f32 tiles): conversion seconds, every layer's
               route, each Block-ELL core's (s, P, R), KB and unique tiles,
               device bytes; keyed vs source at B=1, 8 and 32 within
               1e-5*max(1, scale); the periodic kernel must have launched
               once per periodic core per forward; per-link ms at each B;
               then one torch.profiler trace of the forward at B=1
               (keynet_tpu_torch.profiling.trace) and the device's busy and
               idle share of the traced window;
  5. main path, slice 3 (counts set to 0 just before, read just after):
               the kernel bench, keynet_tpu_torch.bench_kernels, with fewer
               trials, in its three modes (kernel bench, depth sweep, depth
               bench at the 784 x 40 operand of 27,000 tiles); every row is
               held against the plain version; every entry it drives must
               have launched, xres and grid among them;
  6. kernels   one row per Pallas function: each slot-walk entry at the
               shape its main path gave it (the depth-1 entry, which no core
               routes to on this card, at the shape the JAX package routes
               it: AllConvNet conv1 at B=1024; xres and grid at the depth
               bench's operand at B=8), plus xres, grid and xresd at the
               full-width AllConvNet conv1 core at B=64 and the depth-2
               entry at that core, and the periodic kernel at the VGG core
               with the most period slots at B=1 and B=32: kernel, plain
               version and library times (BSR torch.sparse.mm; torch.bmm
               over pre-gathered operands for the periodic kernel, gathers
               not timed) with CUDA events, and the bound from the card's
               data-sheet rates.

The last lines are the card's name and power limit, a JSON line of kernels,
and {"ok": true, "device": {...}}.  Nothing here imports JAX or keynet_tpu.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_F32, TOL_BF16 = 1e-5, 1e-4

def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=5, warmup=1):
    """Median and all of ``reps`` CUDA-event timings of fn() (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def check(err, scale, tol, what):
    bound = tol * max(1.0, scale)
    if not err <= bound:
        raise AssertionError("%s: max|diff| %.3g > %.3g (scale %.3g)"
                             % (what, err, bound, scale))


# --------------------------------------------------------------- phase 1
def phase_build():
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "setup.py", "build_ext", "--inplace"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    log("[build] native packer: rc=%d in %.1f s" % (r.returncode, time.perf_counter() - t))
    if r.returncode:
        # numpy packing would turn the VGG conversion's minutes into hours
        raise RuntimeError("native packer build failed:\n" + r.stderr[-2000:])
    sys.path.insert(0, ROOT)
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.ops import block_ell
    if not kt.native.available() or kt.native.spgemm_dr is None:
        raise RuntimeError("the native packer did not load")
    t = time.perf_counter()
    block_ell.build(verbose=True)
    log("[build] nvcc %s (sm_90a, in parallel): %.1f s"
        % (" ".join(os.path.basename(v) for v in block_ell.SOURCES.values()),
           time.perf_counter() - t))
    from keynet_tpu_torch import bench_kernels
    return kt, block_ell, bench_kernels.card()


# --------------------------------------------------------------- phase 2
def random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb, TM, TN, dtype):
    import numpy as np
    import torch
    tiles = rng.standard_normal((n_uniq, TM, TN)).astype(np.float32)
    tiles[0] = 0.0
    ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)
    ids[n_rb // 2] = 0                        # an all-zero row
    cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
    x = rng.standard_normal((B, n_cb * TN)).astype(np.float32)
    dev = "cuda"
    return (torch.from_numpy(x).to(dev), torch.from_numpy(tiles).to(dev).to(dtype),
            torch.from_numpy(ids).to(dev), torch.from_numpy(cols).to(dev))


def with_repeats(ids):
    """tile_ids with consecutive repeats: every third row runs a, a, 0, a
    (as far as KB allows) and every row starts on the last id of the row
    before; the all-zero middle row stays zero."""
    ids = ids.clone()
    n_rb, KB = ids.shape
    if KB > 1:
        ids[::3, 1] = ids[::3, 0]
    if KB > 3:
        ids[::3, 2] = 0
        ids[::3, 3] = ids[::3, 0]
    ids[1:, 0] = ids[:-1, -1].clone()
    ids[n_rb // 2] = 0
    return ids


def phase_parity(block_ell):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    entries = [("block_ell_matmul", block_ell.block_ell_matmul, {}),
               ("block_ell_matmul_xres", block_ell.block_ell_matmul_xres, {}),
               ("block_ell_matmul_xres2", block_ell.block_ell_matmul_xres2, {}),
               ("block_ell_matmul_xresd", block_ell.block_ell_matmul_xresd, {"depth": 3}),
               ("block_ell_matmul_xresd", block_ell.block_ell_matmul_xresd, {"depth": 4}),
               ("block_ell_matmul_grid", block_ell.block_ell_matmul_grid, {})]
    # (B, n_rb, KB, n_uniq, n_cb, TM, TN, extra output columns)
    cases = [(1, 11, 7, 9, 6, 128, 128, 0), (5, 13, 9, 12, 7, 128, 128, 128),
             (130, 5, 3, 6, 4, 256, 128, 0), (130, 9, 16, 20, 10, 128, 256, 0),
             (5, 6, 5, 4, 3, 256, 256, 0)]
    worst = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for case in cases:
            B, n_rb, KB, n_uniq, n_cb, TM, TN, extra = case
            x, tiles, ids, cols = random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb,
                                                   TM, TN, dtype)
            ids = with_repeats(ids)
            n_out = n_rb * TM + extra
            ref = block_ell.block_ell_plain(x, tiles, ids, cols, n_out)
            for name, fn, kw in entries:
                y = fn(x, tiles, ids, cols, n_out, **kw)
                torch.cuda.synchronize()
                width = block_ell.out_width(n_rb, TM, n_out, grid=name.endswith("_grid"))
                if tuple(y.shape) != (B, width):
                    raise AssertionError("%s %s: shape %s, want %s"
                                         % (name, case, tuple(y.shape), (B, width)))
                err = float((y - ref[:, :width]).abs().max())
                scale = float(ref.abs().max())
                check(err, scale, tol, "%s%s %s %s" % (name, kw, str(dtype), case))
                key = (name, kw.get("depth"), str(dtype))
                worst[key] = max(worst.get(key, 0.0), err / max(1.0, scale))
    # periodic kernel: (B, s, P, R, KB, n_uniq, n_cb, TM, TN)
    pcases = [(1, 0, 3, 1, 4, 7, 9, 128, 128), (5, 2, 5, 7, 3, 9, 11, 128, 128),
              (32, 3, 13, 31, 5, 12, 17, 128, 128), (5, 1, 6, 7, 2, 5, 8, 256, 128),
              (32, 0, 9, 7, 19, 30, 40, 128, 256)]
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for case in pcases:
            B, s0, P, R, KB, n_uniq, n_cb, TM, TN = case
            n_rb = s0 + P * R + 2
            x, tiles, ids, cols = random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb,
                                                   TM, TN, dtype)
            ids[s0 + P // 2] = 0                    # an all-zero period row
            for j in range(1, R):                   # the periodicity contract
                ids[s0 + j * P:s0 + (j + 1) * P] = ids[s0:s0 + P]
            args = (x, tiles, ids, cols, s0, P, R)
            ref = block_ell.periodic_block_ell_plain(*args)
            y = block_ell.periodic_block_ell_matvec(*args)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            check(err, scale, tol, "periodic_block_ell_matvec %s %s" % (str(dtype), case))
            key = ("periodic_block_ell_matvec", None, str(dtype))
            worst[key] = max(worst.get(key, 0.0), err / max(1.0, scale))
    for (name, depth, dt), e in sorted(worst.items(), key=str):
        log("[parity] %-25s depth=%-4s %-15s worst max|diff|/max(1,scale) = %.3g"
            % (name, depth, dt, e))


# --------------------------------------------------------------- phase 3
def route_str(op):
    from keynet_tpu_torch.ops.operators import (ChainedOp, ChannelBroadcastOp,
                                                PermutedBlockSparseOp)
    if isinstance(op, ChainedOp):
        return "Chain[%s]" % ", ".join(route_str(o) for o in op.ops)
    if isinstance(op, PermutedBlockSparseOp):
        c = op.inner
        return "PermutedBlockSparseOp(Block-ELL %s, %d tiles, period %s)" % (
            tuple(c.tile_ids.shape), c.tiles.shape[0], c.period)
    if isinstance(op, ChannelBroadcastOp):
        return "ChannelBroadcastOp(C=%d, %s)" % (op.C, route_str(op.inner))
    return "%s%s" % (type(op).__name__, tuple(op.shape))


def block_ell_cores(sensor, knet):
    """The Block-ELL cores of a keyed sensor and its keyed net, as (layer,
    core, rows the core applies to per image: C for a channel-broadcast
    pool's spatial factor, else 1)."""
    from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChainedOp,
                                                ChannelBroadcastOp,
                                                PermutedBlockSparseOp)
    cores = []
    ops = [("sensor", sensor.op())] + [(k, l.op()) for k, l in knet.layers().items()
                                       if l != "relu"]
    for name, op in ops:
        for link in (op.ops if isinstance(op, ChainedOp) else (op,)):
            per_image = 1
            if isinstance(link, ChannelBroadcastOp):
                link, per_image = link.inner, link.C
            if isinstance(link, PermutedBlockSparseOp):
                link = link.inner
            if isinstance(link, BlockSparseOp):
                cores.append((name, link, per_image))
    return cores


def entries_of(block_ell, core, B):
    """The kernel entries one apply of ``core`` to B rows launches on the
    card (BlockSparseOp.apply): the periodic kernel for the mid-section
    when the period route is taken, none when the grouped-row einsum is,
    else the slot walk of route(KB) for the rows outside the period."""
    import torch
    n_rb, KB = core.tile_ids.shape
    if core.period is not None:
        s, P, R = core.period
        if B <= (R - 1) * core.tileshape[0] // R:
            rest = {block_ell.route(KB).__name__} if s or s + P * R < n_rb else set()
            return {"periodic_block_ell_matvec"} | rest
    elif core._rgroups is not None and core._grouped_wins(B, torch.device("cuda")):
        return set()
    return {block_ell.route(KB).__name__}


def never_routed(launches, where):
    """No operator routes to the xres and grid entries (as in keynet_tpu)."""
    for name in ("block_ell_matmul_xres", "block_ell_matmul_grid"):
        if launches[name]:
            raise AssertionError("%s launched %d times on %s" % (name, launches[name], where))


def keyed_vs_source(kt, net, sensor, knet, B, seed, label, timing=True, reps=5):
    """Encrypt a seeded batch, hold the keyed forward against the source
    forward, and time the keyed forward; returns (cipher batch, keyed
    forwards run)."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal((B, *net.inshape)).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    xc = sensor.fromtensor(xd).encrypt().tensor()
    y = knet.forward(xc)
    ys = net.forward(xd)
    torch.cuda.synchronize()
    if tuple(y.shape) != tuple(ys.shape) or not bool(torch.isfinite(y).all()):
        raise AssertionError("%s: bad output %s (finite=%s)"
                             % (label, tuple(y.shape), bool(torch.isfinite(y).all())))
    err = float((y - ys).abs().max())
    scale = float(ys.abs().max())
    check(err, scale, TOL_F32, "%s keyed vs source" % label)
    res = {"B": B, "max_abs_err": err, "scale": scale}
    forwards = 1
    if timing:
        ms, times = cuda_ms(lambda: knet.forward(xc), reps=reps, warmup=1)
        res.update(ms=ms, imgs_per_s=B / (ms / 1e3), reps_ms=times)
        forwards += 1 + reps
    log("[main] %s B=%d: %s" % (label, B, json.dumps(res)))
    return xc, forwards


def phase_main_allconv(kt, block_ell):
    import numpy as np
    import torch
    net = kt.models.AllConvNet(seed=1)
    t = time.perf_counter()
    sensor, knet = kt.StochasticKeynet((3, 32, 32), net, alpha=2, blocksize=8,
                                       seed=0, device="cuda")
    log("[main] AllConvNet StochasticKeynet conversion: %.1f s"
        % (time.perf_counter() - t))
    log("[main] route sensor: %s" % route_str(sensor.op()))
    for name, l in knet.layers().items():
        if l != "relu":
            log("[main] route %s: %s" % (name, route_str(l.op())))

    G = kt.globals.GLOBAL
    saved = {k: G.get(k) for k in ("DENSE_MAX_BYTES", "ELL_MAX_K")}
    G["DENSE_MAX_BYTES"], G["ELL_MAX_K"] = 1 << 20, 32
    try:
        m = kt.models
        narrow = m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                          m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                          m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)
        ns, nk = kt.StochasticKeynet((3, 16, 16), narrow, alpha=2, blocksize=8,
                                     seed=0, device="cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                G.pop(k, None)
            else:
                G[k] = v
    log("[main] route narrow conv1: %s" % route_str(nk.layers()["conv1"].op()))
    lenet = kt.models.LeNet_AvgPool(seed=0)
    ls, lk = kt.PermutationKeynet((1, 28, 28), lenet, seed=0, device="cuda")
    if lk.num_parameters() != 323491:
        raise AssertionError("LeNet_AvgPool nnz %d != 323491" % lk.num_parameters())
    log("[main] LeNet_AvgPool PermutationKeynet nnz = %d" % lk.num_parameters())

    block_ell.reset_launches()
    xcs = {B: keyed_vs_source(kt, net, sensor, knet, B, B, "AllConvNet")[0]
           for B in (64, 1024)}
    xn = keyed_vs_source(kt, narrow, ns, nk, 64, 7, "narrow 3x16x16 spec")[0]
    keyed_vs_source(kt, lenet, ls, lk, 64, 3, "LeNet_AvgPool")
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[main] launches: %s" % json.dumps(launches))
    routed = sorted({block_ell.route(c.tile_ids.shape[1]).__name__
                     for s, k in ((sensor, knet), (ns, nk), (ls, lk))
                     for _, c, _ in block_ell_cores(s, k)})
    log("[main] entries routed by the driven Block-ELL cores: %s" % routed)
    for name in routed:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the main path" % name)
    never_routed(launches, "the slice-1 path")
    for B in (64, 1024):
        layer_breakdown("AllConvNet", knet, xcs[B])
    return {"allconv": (knet, xcs), "narrow": (nk, xn)}, launches


def phase_main_vgg(kt, block_ell):
    """Slice 2: the Givens-orthogonal VGG-16 at 3x224x224 through kt.Keynet,
    keyed vs source at B=1, 8 and 32, with the launches read right after."""
    import torch
    net = kt.models.VGG16(seed=5)
    t = time.perf_counter()
    sensor, knet = kt.Keynet((3, 224, 224), net, global_geometric="identity",
                             local_geometric="givens_orthogonal", alpha=2.0,
                             blocksize=14, local_photometric="uniform_random_affine",
                             beta=1.0, gamma=1.0, memoryorder="channel", seed=0,
                             device="cuda")
    conv_s = time.perf_counter() - t
    log("[vgg] conversion: %.1f s (host), nnz %d" % (conv_s, knet.num_parameters()))
    log("[vgg] route sensor: %s" % route_str(sensor.op()))
    for name, l in knet.layers().items():
        if l != "relu":
            log("[vgg] route %s: %s" % (name, route_str(l.op())))
    cores = block_ell_cores(sensor, knet)
    for name, c, _ in cores:
        log("[vgg] core %s: %s" % (name, json.dumps(dict(
            rows=int(c.tile_ids.shape[0]), KB=int(c.tile_ids.shape[1]),
            unique_tiles=int(c.tiles.shape[0]), period=c.period,
            nonzero_slots=int((c.tile_ids > 0).sum())))))
    gate = int(kt.globals.GLOBAL.get("PERIODIC_EXPAND_BYTES", 512 << 20))
    texp = sum(c._expand_bytes() for _, c, _ in cores
               if c.period is not None and c._expand_bytes() <= gate)
    knet._build()
    log("[vgg] device_bytes: %d (keyed net on the card), sensor %d; the expanded "
        "period tiles keynet_tpu keeps besides (_Texp, within PERIODIC_EXPAND_BYTES): %d"
        % (knet.device_bytes(), sensor.device_bytes(), texp))

    block_ell.reset_launches()
    xcs, forwards = {}, {}
    for B in (1, 8, 32):
        xcs[B], forwards[B] = keyed_vs_source(kt, net, sensor, knet, B, 100 + B,
                                              "VGG16 orth", reps=5 if B < 32 else 3)
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[vgg] launches: %s" % json.dumps(launches))
    periodic = [(n, c, m) for n, c, m in cores if c.period is not None]
    if not periodic:
        raise AssertionError("no periodic Block-ELL core on the VGG path")
    want = sum(forwards[B] * sum("periodic_block_ell_matvec"
                                 in entries_of(block_ell, c, B * m)
                                 for n, c, m in periodic if n != "sensor")
               for B in forwards)
    log("[vgg] periodic cores: %s; periodic launches %d, at least %d wanted"
        % ([n for n, _, _ in periodic], launches["periodic_block_ell_matvec"], want))
    if launches["periodic_block_ell_matvec"] < want or want == 0:
        raise AssertionError("periodic_block_ell_matvec launched %d times, want >= %d"
                             % (launches["periodic_block_ell_matvec"], want))
    routed = sorted(set().union(*(entries_of(block_ell, c, B * m) for _, c, m in cores
                                  for B in forwards)))
    log("[vgg] entries routed by the driven Block-ELL cores: %s" % routed)
    for name in routed:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the VGG path" % name)
    never_routed(launches, "the VGG path")
    for B in (1, 8, 32):
        layer_breakdown("VGG16 orth", knet, xcs[B])
    trace_forward(kt, knet, xcs[1], "vgg_orth_forward_B1")
    return {"vgg": (knet, xcs, cores)}, launches


def trace_forward(kt, knet, xc, name):
    """One torch.profiler trace of a warm keyed forward (written to
    build/traces/<name>.json): the device's busy and idle share of the traced
    window and the kernels that took most device time."""
    import torch
    knet.forward(xc)
    torch.cuda.synchronize()
    with kt.profiling.trace(name, trace_dir=os.path.join(ROOT, "build", "traces")) as prof:
        knet.forward(xc)
        torch.cuda.synchronize()
    share = kt.profiling.device_busy(prof, name)
    by_name = {}
    for e in kt.profiling.device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("[trace] %s B=%d: %s" % (name, xc.shape[0], json.dumps(dict(
        share, top_device_ms=[[n[:80], ms] for n, ms in top]))))
    if not share["device_events"]:
        log("[trace] the profiler recorded no device event: busy and idle share "
            "not measured")
    return share


def layer_breakdown(label, knet, xc):
    """Device time of every link of every keyed layer (CUDA events, median
    of 3), fed the activations the forward gives it."""
    import torch
    from keynet_tpu_torch.ops.operators import ChainedOp
    knet._build()
    x, rows, i = xc, {}, 0
    for name, l in knet.layers().items():
        if l == "relu":
            x = torch.clamp_min(x, 0.0)
            continue
        op = knet._ops[i]
        i += 1
        links = op.ops if isinstance(op, ChainedOp) else (op,)
        for j, link in enumerate(links):
            rows["%s.%d.%s" % (name, j, type(link).__name__)] = \
                cuda_ms(lambda: link.apply(x), reps=3)[0]
            x = link.apply(x)
        if l._relu:
            x = torch.clamp_min(x, 0.0)
    log("[main] %s B=%d per-link ms (sum %.3f): %s"
        % (label, xc.shape[0], sum(rows.values()), json.dumps(rows)))


# --------------------------------------------------------------- phase 4
def core_input(knet, xc, layer="conv1"):
    """``layer``'s Block-ELL core and the padded x it receives in the
    forward of the cipher batch ``xc``."""
    import torch
    import torch.nn.functional as F
    from keynet_tpu_torch.ops.operators import ChainedOp, PermutedBlockSparseOp
    knet._build()
    x, i = xc, 0
    for name, l in knet.layers().items():
        if l == "relu":
            x = torch.clamp_min(x, 0.0)
            continue
        op = knet._ops[i]
        i += 1
        if name == layer:
            break
        x = op.apply(x)
        if l._relu:
            x = torch.clamp_min(x, 0.0)
    for pb in (op.ops if isinstance(op, ChainedOp) else (op,)):
        if isinstance(pb, PermutedBlockSparseOp):
            break
        x = pb.apply(x)
    xl = torch.cat([pb._to_layout(x[:, :-1], pb.layout_in), x[:, -1:]], dim=1)
    inner = pb.inner
    TN = inner.tileshape[1]
    n_cb = -(-inner.shape[1] // TN)
    return inner, F.pad(xl, (0, n_cb * TN - xl.shape[1])).contiguous()


def bsr_library_ms(tiles, tile_ids, col_blk, x):
    """torch.sparse.mm on a BSR tensor of the same expanded tiles (the
    yardstick; the port never calls it)."""
    import torch
    ids = tile_ids.long()
    cols = col_blk.long()
    n_rb, KB = ids.shape
    TM = tiles.shape[1]
    nz = ids > 0
    order = torch.argsort(torch.where(nz, cols, cols.max() + 1), dim=1)
    ids_s = torch.gather(ids, 1, order)
    cols_s = torch.gather(cols, 1, order)
    nz_s = ids_s > 0
    crow = torch.zeros(n_rb + 1, dtype=torch.int64, device=ids.device)
    crow[1:] = torch.cumsum(nz_s.sum(1), 0)
    W = torch.sparse_bsr_tensor(crow, cols_s[nz_s], tiles[ids_s[nz_s]].float(),
                                size=(n_rb * TM, x.shape[1]))
    xT = x.T.contiguous()
    y = torch.sparse.mm(W, xT).T
    ms, _ = cuda_ms(lambda: torch.sparse.mm(W, xT), reps=5)
    return ms, y


def measure_operand(block_ell, bk, fn, kw, tiles, ids, cols, x, where, peaks):
    """One entry on one Block-ELL operand: checked against the plain version
    (shape and values), then timed with the plain version and the BSR
    yardstick beside it."""
    import torch
    B = x.shape[0]
    TM, TN = tiles.shape[1], tiles.shape[2]
    n_out = ids.shape[0] * TM
    args = (x, tiles, ids, cols, n_out)
    y = fn(*args, **kw)
    ref = block_ell.block_ell_plain(*args)
    torch.cuda.synchronize()
    if y.shape != ref.shape:
        raise AssertionError("%s at %s: shape %s, plain %s"
                             % (fn.__name__, where, tuple(y.shape), tuple(ref.shape)))
    err = float((y - ref).abs().max())
    tol = TOL_F32 if tiles.dtype == torch.float32 else TOL_BF16
    check(err, float(ref.abs().max()), tol, "%s at %s" % (fn.__name__, where))
    del y
    ms, _ = cuda_ms(lambda: fn(*args, **kw), reps=10)
    plain_ms, _ = cuda_ms(lambda: block_ell.block_ell_plain(*args), reps=5)
    try:
        lib_ms, ylib = bsr_library_ms(tiles, ids, cols, x)
        lib_err = float((ylib - ref).abs().max())
        del ylib
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only
        log("[kernels] torch.sparse.mm BSR yardstick unavailable: %s" % e)
        lib_ms = lib_err = None
    w = bk.work(ids, TM, TN, x.shape[1], n_out, B, tiles.element_size(), peaks)
    log("[kernels] %s at %s: %s" % (fn.__name__, where, json.dumps(dict(
        w, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_max_abs_err=lib_err,
        achieved_tflops=w["flops"] / ms / 1e9))))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"], "library_ms": lib_ms}


def measure(block_ell, bk, fn, kw, model, xc, where, peaks):
    """One entry on conv1's core of ``model`` fed the activations of ``xc``."""
    inner, x = core_input(model, xc, "conv1")
    return measure_operand(block_ell, bk, fn, kw, inner.tiles, inner.tile_ids,
                           inner.col_blk, x, where, peaks)


def phase_kernels(block_ell, bk, paths, launches, peaks):
    """One row per Pallas function (launches: summed over the main paths)."""
    import numpy as np
    import torch
    knet, xcs = paths["allconv"]
    nk, xn = paths["narrow"]
    be = block_ell
    src = "keynet_tpu_torch/csrc/"
    rows = {}

    def row(fn, source, line, result):
        rows[fn.__name__] = dict({"name": fn.__name__, "route": "cuda", "source": src + source,
                                  "replaces": "keynet_tpu/ops/pallas_kernels.py:%d" % line,
                                  "launches": launches[fn.__name__]}, **result)

    # each slot-walk entry at the shape its main path gave it; the depth-1
    # entry is routed by no core here, so it runs where the JAX package
    # routes it (x past the TPU's VMEM budget: AllConvNet at B=1024)
    row(be.block_ell_matmul, "block_ell.cu", 94,
        measure(be, bk, be.block_ell_matmul, {}, knet, xcs[1024],
                "AllConvNet conv1 core, B=1024 (not routed on this card)", peaks))
    row(be.block_ell_matmul_xres2, "block_ell.cu", 289,
        measure(be, bk, be.block_ell_matmul_xres2, {}, nk, xn,
                "3x16x16 spec conv1 core, B=64 (coverage, toy shape)", peaks))
    row(be.block_ell_matmul_xresd, "block_ell.cu", 390,
        measure(be, bk, be.block_ell_matmul_xresd, {"depth": 4}, knet, xcs[64],
                "AllConvNet conv1 core, B=64", peaks))
    # full-width numbers beside them: xres2 and xresd at the other batch,
    # xres and grid on the operand xresd's row used
    measure(be, bk, be.block_ell_matmul_xres2, {}, knet, xcs[64],
            "AllConvNet conv1 core, B=64 (full width)", peaks)
    measure(be, bk, be.block_ell_matmul_xresd, {"depth": 4}, knet, xcs[1024],
            "AllConvNet conv1 core, B=1024", peaks)
    for fn in (be.block_ell_matmul_xres, be.block_ell_matmul_grid):
        measure(be, bk, fn, {}, knet, xcs[64], "AllConvNet conv1 core, B=64", peaks)
    # xres and grid (the kernel bench's path) at the depth bench's operand,
    # B=8, with xresd beside them
    tiles, ids, cols, rng = bk.depth_operand("cuda")
    x = torch.from_numpy(rng.normal(size=(8, ids.shape[0] * tiles.shape[2]))
                         .astype(np.float32)).cuda()
    where = "depth-bench operand (784 x 40, 27,000 tiles, f32), B=8"
    row(be.block_ell_matmul_xres, "block_ell_xres.cu", 186,
        measure_operand(be, bk, be.block_ell_matmul_xres, {}, tiles, ids, cols, x, where, peaks))
    row(be.block_ell_matmul_grid, "block_ell_grid.cu", 449,
        measure_operand(be, bk, be.block_ell_matmul_grid, {}, tiles, ids, cols, x, where, peaks))
    measure_operand(be, bk, be.block_ell_matmul_xresd, {"depth": 4}, tiles, ids, cols, x,
                    where, peaks)
    del tiles, x
    torch.cuda.empty_cache()
    # the periodic kernel at the VGG core with the most period slots
    vknet, vxcs, cores = paths["vgg"]
    name, core = max(((n, c) for n, c, _ in cores if c.period is not None),
                     key=lambda nc: periodic_work(nc[1])["slots"])
    for B in (32, 1):
        r = measure_periodic(be, vknet, vxcs[B], name, peaks)
    row(be.periodic_block_ell_matvec, "periodic_block_ell.cu", 551, r)
    return [rows[n] for n in be.ENTRIES]


def periodic_work(core, B=1):
    """Slots, FLOPs and least bytes of one periodic mid-section apply at
    batch B: each referenced tile read once, x read once, the f32 output
    written once, the period's ids and the mid rows' column blocks read."""
    import torch
    s, P, R = core.period
    ids = core.tile_ids[s:s + P]
    TM, TN = core.tileshape
    it = core.tiles.element_size()
    nz = int((ids > 0).sum())
    uniq = int(torch.unique(ids[ids > 0]).numel())
    n_cols = -(-core.shape[1] // TN) * TN
    return dict(slots=nz * R, flops=2.0 * TM * TN * B * R * nz,
                bytes=uniq * TM * TN * it + B * n_cols * it + B * P * R * TM * 4
                + ids.numel() * 4 + P * R * ids.shape[1] * 4,
                period_tile_bytes=nz * TM * TN * it, unique_tiles=uniq)


def bmm_library_ms(core, x):
    """One torch.bmm over the pre-gathered x blocks and the expanded period
    tiles, batch P, (R·B, KB·TN) x (KB·TN, TM) — the yardstick, timed
    without its gathers; the port never calls it.  None when the gathered
    operands would not fit the card beside the keyed net."""
    import torch
    s, P, R = core.period
    KB = core.tile_ids.shape[1]
    TM, TN = core.tileshape
    B = x.shape[0]
    need = 4 * P * (R * B * KB * TN + KB * TN * TM + R * B * TM)
    free = torch.cuda.mem_get_info()[0]
    if need > 0.8 * free:
        log("[kernels] torch.bmm yardstick at B=%d skipped: its gathered operands "
            "take %.1f GB, %.1f GB free" % (B, need / 1e9, free / 1e9))
        return None, None
    xb = x.float().reshape(B, -1, TN)
    cols = core.col_blk[s:s + P * R].long().reshape(R, P, KB).permute(1, 0, 2)
    b = torch.arange(B, device=x.device)
    Xg = xb[b[None, None, :, None], cols[:, :, None, :]]          # (P, R, B, KB, TN)
    Xg = Xg.reshape(P, R * B, KB * TN)
    Tg = core.tiles[core.tile_ids[s:s + P].long()].float()         # (P, KB, TM, TN)
    Tg = Tg.permute(0, 1, 3, 2).reshape(P, KB * TN, TM)
    y = torch.bmm(Xg, Tg)                                          # (P, R*B, TM)
    ms, _ = cuda_ms(lambda: torch.bmm(Xg, Tg), reps=5)
    y = y.reshape(P, R, B, TM).permute(2, 1, 0, 3).reshape(B, -1)
    return ms, y


def measure_periodic(block_ell, knet, xc, layer, peaks):
    """The periodic kernel on ``layer``'s core fed the activations of
    ``xc``: checked against the plain version, timed beside it and the
    torch.bmm yardstick."""
    import torch
    core, x = core_input(knet, xc, layer)
    B = x.shape[0]
    s, P, R = core.period
    args = (x, core.tiles, core.tile_ids, core.col_blk, s, P, R)
    y = block_ell.periodic_block_ell_matvec(*args)
    ref = block_ell.periodic_block_ell_plain(*args)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    where = "VGG16 orth %s core %s, B=%d" % (layer, core.period, B)
    check(err, float(ref.abs().max()), TOL_F32, "periodic_block_ell_matvec at " + where)
    ms, _ = cuda_ms(lambda: block_ell.periodic_block_ell_matvec(*args), reps=10)
    plain_ms, _ = cuda_ms(lambda: block_ell.periodic_block_ell_plain(*args), reps=3)
    lib_ms, ylib = bmm_library_ms(core, x)
    lib_err = None if ylib is None else float((ylib - ref).abs().max())
    del ylib
    work = periodic_work(core, B)
    peak = peaks["f32"] if core.tiles.dtype == torch.float32 else peaks["bf16"]
    t_ops, t_bytes = work["flops"] / peak, work["bytes"] / peaks["bw"]
    bms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log("[kernels] periodic_block_ell_matvec at %s: %s" % (where, json.dumps(dict(
        work, KB=int(core.tile_ids.shape[1]), ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, library_max_abs_err=lib_err, bound_ms=bms, bound_by=by,
        period_tiles_once_ms=work["period_tile_bytes"] / peaks["bw"] * 1e3,
        achieved_tflops=work["flops"] / ms / 1e9))))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}




def phase_bench(block_ell, bk):
    """Slice 3: the kernel bench in its three modes, with fewer trials; the
    counts are set to 0 just before and read just after."""
    import torch
    block_ell.reset_launches()
    rows = bk.kernel_bench(trials=3, target_ms=10.0)
    sweep, spread = bk.depth_sweep(trials=3, target_ms=10.0)
    rows += sweep
    rows += bk.depth_bench(trials=3, target_ms=20.0)
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[bench] launches: %s" % json.dumps(launches))
    driven = sorted({r["entry"] for r in rows})
    for name in driven + ["block_ell_matmul_xres", "block_ell_matmul_grid"]:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the bench path" % name)
    worst = {}
    for r in rows:
        key = "%s %s" % (r["entry"], r["dtype"])
        worst[key] = max(worst.get(key, 0.0), r["max_abs_err"] / max(1.0, r["scale"]))
    log("[bench] entries driven: %s; worst max|diff|/max(1,scale) vs plain: %s"
        % (driven, json.dumps(worst)))
    log("[bench] xresd D=2/4/8 spread (noise floor): %s"
        % json.dumps({"%s B=%d" % k: v for k, v in spread.items()}))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kt, block_ell, smi = phase_build()
    from keynet_tpu_torch import bench_kernels as bk
    kt.globals.precision("highest")
    name = torch.cuda.get_device_name(0)
    card, peaks = bk.card_peaks(name)
    log("[build] device %s (%d visible); bounds use %s data-sheet rates %s"
        % (name, torch.cuda.device_count(), card, json.dumps(peaks)))
    phase_parity(block_ell)
    paths, launches = phase_main_allconv(kt, block_ell)
    vgg_paths, vgg_launches = phase_main_vgg(kt, block_ell)
    paths.update(vgg_paths)
    bench_launches = phase_bench(block_ell, bk)
    total = {n: launches[n] + vgg_launches[n] + bench_launches[n] for n in block_ell.ENTRIES}
    log("[main] launches by path: %s" % json.dumps(
        {"slice 1": launches, "slice 2 (VGG)": vgg_launches, "slice 3 (bench)": bench_launches}))
    rows = phase_kernels(block_ell, bk, paths, total, peaks)
    log("[done] %.1f s" % (time.perf_counter() - t0))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
