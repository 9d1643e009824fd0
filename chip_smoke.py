#!/usr/bin/env python3
"""Smoke run of keynet_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

  1. build     the native packer (setup.py build_ext) and the Block-ELL CUDA
               kernel (nvcc, sm_90a) from the sources in this checkout;
  2. parity    every slot-walk entry against its plain PyTorch version on
               seeded random Block-ELL operands (f32 and bf16 tiles, B in
               {1, 5, 130}, KB not a multiple of the depth, n_rb not a
               multiple of 8, an all-zero row, id-0 slots, xresd at depths
               3 and 4);
  3. main path launch counts set to 0, then through the user entry points:
               StochasticKeynet AllConvNet (3x32x32, alpha=2, blocksize 8,
               seed 0, AllConvNet(seed=1)) at B=64 and B=1024, the 3x16x16
               test spec (a Block-ELL core with KB=7), and PermutationKeynet
               LeNet_AvgPool at B=64; each keyed forward is held against the
               source model on the card (IEEE f32) within 1e-5*max(1, scale);
               the counts are read right after, and every entry that the
               driven Block-ELL cores route to must have launched;
  4. kernels   each entry at the shape its main path gave it (the depth-1
               entry, which no core routes to on this card, at the shape the
               JAX package routes it: AllConvNet conv1 at B=1024), plus the
               depth-2 entry at the full-width conv1 core: kernel, plain
               version and torch.sparse.mm (BSR) times with CUDA events, and
               the bound from the card's data-sheet rates.

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

# Data-sheet rates (dense, no sparsity) at the full power limit:
# f32 outside the tensor cores, bf16 in them, device memory bandwidth.
PEAKS = {"H100 SXM": dict(f32=67e12, bf16=989e12, bw=3.35e12),
         "H100 PCIe": dict(f32=51e12, bf16=756e12, bw=2.0e12),
         "H100 NVL": dict(f32=60e12, bf16=835e12, bw=3.9e12),
         "H200": dict(f32=67e12, bf16=989e12, bw=4.8e12)}


def card_peaks(name):
    if "H200" in name:
        return "H200", PEAKS["H200"]
    if "PCIe" in name:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    if "NVL" in name:
        return "H100 NVL", PEAKS["H100 NVL"]
    return "H100 SXM", PEAKS["H100 SXM"]


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
        log("[build] native build failed, numpy packing takes over:\n"
            + r.stderr[-2000:])
    sys.path.insert(0, ROOT)
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.ops import block_ell
    log("[build] host packing path: %s" % ("native C++" if kt.native.available()
                                           else "numpy"))
    t = time.perf_counter()
    block_ell.build(verbose=True)
    log("[build] nvcc block_ell.cu (sm_90a): %.1f s" % (time.perf_counter() - t))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return kt, block_ell, smi


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


def phase_parity(block_ell):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    entries = [("block_ell_matmul", block_ell.block_ell_matmul, {}),
               ("block_ell_matmul_xres2", block_ell.block_ell_matmul_xres2, {}),
               ("block_ell_matmul_xresd", block_ell.block_ell_matmul_xresd, {"depth": 3}),
               ("block_ell_matmul_xresd", block_ell.block_ell_matmul_xresd, {"depth": 4})]
    # (B, n_rb, KB, n_uniq, n_cb, TM, TN, extra output columns)
    cases = [(1, 11, 7, 9, 6, 128, 128, 0), (5, 13, 9, 12, 7, 128, 128, 128),
             (130, 5, 3, 6, 4, 256, 128, 0), (130, 9, 16, 20, 10, 128, 256, 0)]
    worst = {}
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for case in cases:
            B, n_rb, KB, n_uniq, n_cb, TM, TN, extra = case
            x, tiles, ids, cols = random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb,
                                                   TM, TN, dtype)
            n_out = n_rb * TM + extra
            ref = block_ell.block_ell_plain(x, tiles, ids, cols, n_out)
            for name, fn, kw in entries:
                y = fn(x, tiles, ids, cols, n_out, **kw)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                scale = float(ref.abs().max())
                check(err, scale, tol, "%s%s %s %s" % (name, kw, str(dtype), case))
                key = (name, kw.get("depth"), str(dtype))
                worst[key] = max(worst.get(key, 0.0), err / max(1.0, scale))
    for (name, depth, dt), e in sorted(worst.items(), key=str):
        log("[parity] %-24s depth=%-4s %-15s worst max|diff|/max(1,scale) = %.3g"
            % (name, depth, dt, e))


# --------------------------------------------------------------- phase 3
def route_str(op):
    from keynet_tpu_torch.ops.operators import ChainedOp, PermutedBlockSparseOp
    if isinstance(op, ChainedOp):
        return "Chain[%s]" % ", ".join(route_str(o) for o in op.ops)
    if isinstance(op, PermutedBlockSparseOp):
        return "PermutedBlockSparseOp(Block-ELL %s, %d tiles)" % (
            tuple(op.inner.tile_ids.shape), op.inner.tiles.shape[0])
    return "%s%s" % (type(op).__name__, tuple(op.shape))


def block_ell_cores(sensor, knet):
    """The Block-ELL cores of a keyed sensor and its keyed net."""
    from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChainedOp,
                                                PermutedBlockSparseOp)
    cores = []
    ops = [sensor.op()] + [l.op() for l in knet.layers().values() if l != "relu"]
    for op in ops:
        for link in (op.ops if isinstance(op, ChainedOp) else (op,)):
            if isinstance(link, PermutedBlockSparseOp):
                link = link.inner
            if isinstance(link, BlockSparseOp):
                cores.append(link)
    return cores


def keyed_vs_source(kt, net, sensor, knet, B, seed, label, timing=True):
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
    if timing:
        ms, times = cuda_ms(lambda: knet.forward(xc), reps=5, warmup=1)
        res.update(ms=ms, imgs_per_s=B / (ms / 1e3), reps_ms=times)
    log("[main] %s B=%d: %s" % (label, B, json.dumps(res)))
    return xc


def phase_main(kt, block_ell):
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
    xcs = {B: keyed_vs_source(kt, net, sensor, knet, B, B, "AllConvNet")
           for B in (64, 1024)}
    xn = keyed_vs_source(kt, narrow, ns, nk, 64, 7, "narrow 3x16x16 spec")
    keyed_vs_source(kt, lenet, ls, lk, 64, 3, "LeNet_AvgPool")
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[main] launches: %s" % json.dumps(launches))
    routed = sorted({block_ell.route(c.tile_ids.shape[1]).__name__
                     for s, k in ((sensor, knet), (ns, nk), (ls, lk))
                     for c in block_ell_cores(s, k)})
    log("[main] entries routed by the driven Block-ELL cores: %s" % routed)
    for name in routed:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the main path" % name)
    for B in (64, 1024):
        layer_breakdown(knet, xcs[B])
    return {"allconv": (knet, xcs), "narrow": (nk, xn)}, launches


def layer_breakdown(knet, xc):
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
    log("[main] AllConvNet B=%d per-link ms (sum %.3f): %s"
        % (xc.shape[0], sum(rows.values()), json.dumps(rows)))


# --------------------------------------------------------------- phase 4
def core_input(knet, xc):
    """conv1's Block-ELL core and the padded x it receives in the forward."""
    import torch
    import torch.nn.functional as F
    chain = knet.layers()["conv1"].op()
    x1 = chain.ops[0].apply(xc)
    pb = chain.ops[1]
    xl = torch.cat([pb._to_layout(x1[:, :-1], pb.layout_in), x1[:, -1:]], dim=1)
    inner = pb.inner
    TN = inner.tileshape[1]
    n_cb = -(-inner.shape[1] // TN)
    return inner, F.pad(xl, (0, n_cb * TN - xl.shape[1])).contiguous()


def bsr_library_ms(inner, x):
    """torch.sparse.mm on a BSR tensor of the same expanded tiles (the
    yardstick; the port never calls it)."""
    import torch
    ids = inner.tile_ids.long()
    cols = inner.col_blk.long()
    n_rb, KB = ids.shape
    TM, TN = inner.tileshape
    nz = ids > 0
    order = torch.argsort(torch.where(nz, cols, cols.max() + 1), dim=1)
    ids_s = torch.gather(ids, 1, order)
    cols_s = torch.gather(cols, 1, order)
    nz_s = ids_s > 0
    crow = torch.zeros(n_rb + 1, dtype=torch.int64, device=ids.device)
    crow[1:] = torch.cumsum(nz_s.sum(1), 0)
    W = torch.sparse_bsr_tensor(crow, cols_s[nz_s], inner.tiles[ids_s[nz_s]].float(),
                                size=(n_rb * TM, x.shape[1]))
    xT = x.T.contiguous()
    y = torch.sparse.mm(W, xT).T
    ms, _ = cuda_ms(lambda: torch.sparse.mm(W, xT), reps=5)
    return ms, y


def bound(inner, B, peaks):
    import torch
    ids = inner.tile_ids
    n_rb, KB = ids.shape
    TM, TN = inner.tileshape
    it = inner.tiles.element_size()
    slots = int((ids > 0).sum())
    uniq = int(torch.unique(ids[ids > 0]).numel())
    n_cols = -(-inner.shape[1] // TN) * TN
    flops = 2.0 * TM * TN * B * slots
    nbytes = uniq * TM * TN * it + B * n_cols * it + B * n_rb * TM * 4 + 2 * ids.numel() * 4
    peak = peaks["f32"] if inner.tiles.dtype == torch.float32 else peaks["bf16"]
    t_ops, t_bytes = flops / peak, nbytes / peaks["bw"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), \
        dict(flops=flops, bytes=nbytes, nonzero_slots=slots, unique_tiles=uniq)


def measure(block_ell, fn, kw, model, xc, where, peaks):
    """One entry on conv1's core of ``model`` fed the activations of ``xc``:
    checked against the plain version, then timed with the plain version and
    the BSR yardstick beside it."""
    import torch
    inner, x = core_input(model, xc)
    B = x.shape[0]
    n_out = inner.tile_ids.shape[0] * inner.tileshape[0]
    args = (x, inner.tiles, inner.tile_ids, inner.col_blk, n_out)
    y = fn(*args, **kw)
    ref = block_ell.block_ell_plain(*args)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    check(err, float(ref.abs().max()), TOL_F32, "%s at %s" % (fn.__name__, where))
    ms, _ = cuda_ms(lambda: fn(*args, **kw), reps=10)
    plain_ms, _ = cuda_ms(lambda: block_ell.block_ell_plain(*args), reps=5)
    try:
        lib_ms, ylib = bsr_library_ms(inner, x)
        lib_err = float((ylib - ref).abs().max())
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only
        log("[kernels] torch.sparse.mm BSR yardstick unavailable: %s" % e)
        lib_ms = lib_err = None
    bms, by, work = bound(inner, B, peaks)
    log("[kernels] %s at %s: %s" % (fn.__name__, where, json.dumps(dict(
        work, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_max_abs_err=lib_err, bound_ms=bms,
        achieved_tflops=work["flops"] / ms / 1e9))))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def phase_kernels(block_ell, paths, launches, peaks):
    knet, xcs = paths["allconv"]
    nk, xn = paths["narrow"]
    be = block_ell
    # one row per entry, at the shape its main path gave it; the depth-1
    # entry is routed by no core here, so it runs where the JAX package
    # routes it (x past the TPU's VMEM budget: AllConvNet at B=1024)
    plan = [(be.block_ell_matmul, {}, knet, xcs[1024], "keynet_tpu/ops/pallas_kernels.py:94",
             "AllConvNet conv1 core, B=1024 (not routed on this card)"),
            (be.block_ell_matmul_xres2, {}, nk, xn, "keynet_tpu/ops/pallas_kernels.py:289",
             "3x16x16 spec conv1 core, B=64 (coverage, toy shape)"),
            (be.block_ell_matmul_xresd, {"depth": 4}, knet, xcs[64],
             "keynet_tpu/ops/pallas_kernels.py:390", "AllConvNet conv1 core, B=64")]
    rows = []
    for fn, kw, model, xc, replaces, where in plan:
        row = {"name": fn.__name__, "route": "cuda",
               "source": "keynet_tpu_torch/csrc/block_ell.cu", "replaces": replaces,
               "launches": launches[fn.__name__]}
        row.update(measure(be, fn, kw, model, xc, where, peaks))
        rows.append(row)
    # full-width numbers for the entries whose row above is at another size
    measure(be, be.block_ell_matmul_xres2, {}, knet, xcs[64],
            "AllConvNet conv1 core, B=64 (full width)", peaks)
    measure(be, be.block_ell_matmul_xresd, {"depth": 4}, knet, xcs[1024],
            "AllConvNet conv1 core, B=1024", peaks)
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kt, block_ell, smi = phase_build()
    kt.globals.precision("highest")
    name = torch.cuda.get_device_name(0)
    card, peaks = card_peaks(name)
    log("[build] device %s (%d visible); bounds use %s data-sheet rates %s"
        % (name, torch.cuda.device_count(), card, json.dumps(peaks)))
    phase_parity(block_ell)
    paths, launches = phase_main(kt, block_ell)
    rows = phase_kernels(block_ell, paths, launches, peaks)
    log("[done] %.1f s" % (time.perf_counter() - t0))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
