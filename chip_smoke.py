#!/usr/bin/env python3
"""Smoke run of keynet_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

  1. build     the native packer (setup.py build_ext; a failed build raises:
               the VGG conversion needs it) and the four CUDA sources
               (csrc/block_ell.cu, block_ell_xres.cu, block_ell_grid.cu and
               periodic_block_ell.cu, one nvcc each for sm_90a, started
               together) from this checkout; the tensor-core instructions
               (HGMMA, HMMA) of every kernel from cuobjdump -sass: each bf16
               and each tf32 kernel of the slot walk and the periodic kernel
               (five row tiles each) must have some, each f32 (FMA core)
               kernel none;
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
               an all-zero period row); xres and grid also at TN = 512 (f32
               and bf16), on runs of G > 1 row-blocks with n_rb not a
               multiple of G, with a, 0, a runs and repeats across row
               boundaries, at every row tile, the grid kernel's tile copies
               held equal to the count its plan's walk gives; then id-0 slots
               that point at an all-inf x block must add nothing, in every
               entry, f32 and bf16 tiles; every check above also runs under
               PRECISION='default' (slice 11): the slot walk and the periodic
               kernel as tf32 products held against plain(tf32=True) within
               1e-4*max(1, scale), xres and grid still IEEE (1e-5); then the
               tf32 rounding pin: on a diagonal tile whose entries and x
               carry chosen low mantissa bits, both kernels' outputs equal
               round_tf32's truncated products bit for bit;
  3. main path, slice 1 (launch counts set to 0 just before, read just
               after): StochasticKeynet AllConvNet (3x32x32, alpha=2,
               blocksize 8, seed 0, AllConvNet(seed=1)) at B=64 and B=1024,
               the 3x16x16 test spec (a Block-ELL core with KB=7), and
               PermutationKeynet LeNet_AvgPool at B=64; each keyed forward
               is held against the source model on the card (IEEE f32)
               within 1e-5*max(1, scale); every entry that the driven
               Block-ELL cores route to must have launched, xres and grid
               never (no operator routes to them);
               slice 11, [main] under PRECISION='default' (counts set to 0
               just before, read just after): AllConvNet at B=64 and 1024
               and LeNet_AvgPool at B=8192, keyed (encryption and forward in
               'default') vs the source in 'highest' within
               1e-3*max(1, scale); every launch of the routed entries tf32;
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
               slice 11, [vgg-default] (counts set to 0 just before, read
               just after the forwards): the same converted net under
               PRECISION='default' (the slot walk and the periodic kernel on
               tf32 wgmma, cuBLAS and cuDNN on TF32): keyed vs the source in
               'highest' at B=1, 8, 32 within 3e-2*max(1, scale) beside
               batch_spread; the periodic kernel once per periodic core per
               forward, every launch tf32; every kernel-routed core held
               against plain(tf32=True) at the operands the 'default'
               forward fed it within 1e-4*max(1, scale); per-link ms at B=1
               and 32; device memory after the phase equal to before it;
               slice 10, [vgg-bf16] (counts set to 0 just before, read just
               after): the same VGG-16 converted with TILE_DTYPE='bfloat16'
               (run_vgg_orth_224.py --tile-dtype bfloat16; the slot walk and
               the periodic kernel multiply on the tensor cores): conversion
               seconds, routes, cores, device memory beside the f32 net's;
               keyed vs source at B=1, 8, 32 within 3e-2*max(1, scale);
               launches as for slice 2; every kernel-routed core held
               against its plain version at the operands the bf16 forward
               fed it within 1e-4*max(1, scale); per-link ms at B=1 and 32;
  5. main path, slice 3 (counts set to 0 just before, read just after):
               the kernel bench, keynet_tpu_torch.bench_kernels, with fewer
               trials, in its three modes (kernel bench, depth sweep, depth
               bench at the 784 x 40 operand of 27,000 tiles); every row is
               held against the plain version; every entry it drives must
               have launched, xres and grid among them;
  6. main path, slice 6 (each part with the counts set to 0 just before and
               read just after):
               [train] the paper's workflow: AllConvNet(seed=1) trained 20
               steps at B=128 on synthetic CIFAR-10 with the CIFAR recipe
               (the loss over the batches trained on must fall), keyed as
               in phase 3 (conv1's core launches block_ell_matmul_xresd),
               validated plain against keyed on 512 test images (equal
               accuracies, logits within 1e-5*max(1, scale)), published
               with save_keynet and served with load_keynet (bitwise equal
               forward);
               [tiled] TiledOrthogonalKeynet LeNet_AvgPool and
               Keynet(tileshape=(t, t)) for t = 4, 32 and 16 (periodic):
               Block-ELL cores of sub-128 tiles take the einsum route,
               keyed == source;
               [vgg-identity] the identity VGG-16 at 3x224x224 on
               DirectConvOp and DenseOp, keyed == source at B=1, 8 and 32;
               slice 7, [vgg-stochastic] (counts set to 0 just before and
               read just after the forwards): VGG16(seed=5) at 3x224x224
               keyed with the stochastic recipe of
               scripts/run_vgg_stochastic_224.py (hierarchical permutation
               at levels 0, 1, 2, doubly-stochastic local keys, local affine,
               blocksize 14, f32 tiles, full depth):
               conversion seconds per layer, peak host RSS, nnz,
               device_bytes() beside torch.cuda.memory_allocated(), every
               layer's route against keynet_tpu's (STOCH_ROUTES), each
               Block-ELL core and how it applies at B=1, 8, 32 (grouped-row
               einsum, slot walk, periodic kernel); keyed == source at B=1, 8
               and 32 within 1e-5*max(1, scale); every entry the cores route
               to must have launched; per-link ms at B=1 and 32 and a trace of
               the B=1 forward;
               slice 8, [parallel] (the launches of the sharded forwards
               counted on every rank and summed): four ranks, dp=2 x tp=2,
               spawned by kt.parallel.launch on the one card over gloo,
               each loading the kernels built above, run the sections of
               __graft_entry__.dryrun_multichip: (a) StochasticKeynet
               AllConvNet at bench's config converted on every rank (the
               packed arrays' sha1 must agree), shard_keynet_ops at the
               default 32 MiB (conv1's Block-ELL and conv2-conv5's chains
               must shard; replication_report with no unjustified row),
               keyed_forward_dp_tp at B=64 and 256 held against the single
               forward within 1e-4*max(1, scale) and, decrypted, against the
               source within 1e-5*max(1, scale); (b) one
               make_sharded_train_step step (AllConvNet, B=128 synthetic
               CIFAR-10, the CIFAR recipe, fc1 tp-split) against one
               make_train_step step: loss and params within
               1e-5*max(1, |p|); (c)-(g) the 8 x 128-block block-diagonal
               Block-ELL, the Kron/TapSum/Kron chain, EllOp and
               RepeatedBlockDiagOp, the stochastic LeNet_AvgPool with
               STREAM_NNZ 60,000 and the streamed masked-chain conv
               8x16x16 (max_replication 1.01), each against its single
               apply within 1e-4*max(1, scale); every entry the shards
               route to must have launched (xresd among them);
               [challenge] a PermutationKeynet LeNet_AvgPool written in
               the 2020 release's pickle format under build/challenge/,
               load_challenge(device="cuda"), the public forward at B=64
               against the host scipy oracle within 1e-5*max(1, scale);
               slice 9, [programs] (counts set to 0 just before and read
               just after, the cold processes' counts added): the programs
               users run, from keynet_tpu_torch.entry, .examples and
               .scripts: entry() on the card against entry("cpu") within
               1e-5*max(1, scale), nnz 323,491; the challenge bundle
               (release_challenge.build_bundle, seed 2020) built on the
               card and its embedding reproduced bit for bit by a cold
               process holding only the bundle (--verify, no JAX loaded);
               attack_bundle on it (6 channels, conv1's value sets 6/6, the
               image recovered up to the dihedral group) and on its
               StochasticKeynet twin (no structure); the Fig.-6 protocol
               (1024 / 256 synthetic MNIST images, 2 epochs: keyed accuracy
               == source); the vgg16.ipynb sensor recipe at 3x224x224 (PNG
               round trip correlation > 0.95, in-memory decrypt < 1e-2);
               the StochasticKeynet AllConvNet saved with its sensor and
               served by python -m keynet_tpu_torch.scripts.serve in a cold
               process at B=64 and 1024 with --check allconv:1, its outputs
               bitwise equal to this process's, xresd launched in both;
  7. kernels   one row per Pallas function: each slot-walk entry at the
               shape its main path gave it (the depth-1 entry, which no core
               routes to on this card, at the shape the JAX package routes
               it: AllConvNet conv1 at B=1024; xres and grid at the depth
               bench's operand at B=8), plus xres, grid and xresd at the
               full-width AllConvNet conv1 core at B=64 and B=1024 (the
               share of the operations bound each reaches) and the depth-2
               entry at that core, and the periodic kernel at the VGG core
               with the most period slots at B=1, 8 and 32 (at B=1 also
               with the shared memory of one block an SM), and the slot
               walk on that core's head and tail rows at B=1, 8, 32, xres
               and grid at B=1, and the kernel of the stochastic VGG's
               largest kernel-routed core at B=1, 8 and 32; the bf16 rows:
               the periodic kernel and the head and tail rows of the bf16
               net's conv1_2 core at B=1, 8, 32, and the slot walk at
               AllConvNet conv1 with its tiles cast to bf16 (held equal to
               bf16 packing) at B=64 and 1024: kernel, plain
               version and library times (BSR torch.sparse.mm; torch.bmm over pre-gathered operands
               for the periodic kernel, gathers not timed) with CUDA events,
               the bound from the card's data-sheet rates, and for grid the
               tile copies it issued against the non-zero slots it walked;
               the tf32 rows under PRECISION='default': the periodic kernel
               and the head and tail rows of the f32 net's conv1_2 core at
               B=1, 8, 32 and the slot walk at AllConvNet conv1 at B=64 and
               1024, held against plain(tf32=True), bound at 494.7 TFLOP/s
               dense TF32 and f32 bytes, library torch.bmm over pre-gathered
               f32 operands with TF32 on (gathers not timed), launches the
               tf32 ones of the 'default' paths.

The last lines are the card's name and power limit, a JSON line of kernels
(bf16 and tf32 rows nested under the periodic and xresd rows), and
{"ok": true, "device": {...}}.  Nothing here imports JAX or keynet_tpu.

    python3 chip_smoke.py --ab TAG=SRC_DIR [...] [--rounds N]

builds the four kernels of other csrc/ directories and times them against
the checkout's, in turns, on one converted VGG-16 and AllConvNet and the
depth-bench operand (phase_ab).

    python3 chip_smoke.py --outputs FILE [--tree DIR] [--against FILE]

converts the orth VGG-16 and the AllConvNet with the keynet_tpu_torch of
DIR (default this checkout), with f32 and with bf16 tiles, saves their
keyed outputs and forward times, and holds them against another tree's
file (phase_outputs).

    python3 chip_smoke.py --only vgg-stochastic|vgg-stochastic-bf16|parallel|challenge|
                                 programs|serve-vgg

builds, then runs that phase alone ([vgg-stochastic] with its kernel row).
vgg-stochastic-bf16 is in no default run: the stochastic VGG-16 of slice 7
with TILE_DTYPE='bfloat16' (run_vgg_stochastic_224.py --tile-dtype
bfloat16), routes against STOCH_ROUTES_BF16, keyed vs source within
3e-2*max(1, scale), per-link ms, its largest kernel-routed core's bf16 row.
serve-vgg is in no default run: it converts the orth VGG-16 at 3x224x224,
saves it with its sensor (save_keynet, several minutes of zlib) and serves
it in a cold process at B=1, 8, 32 with --check vgg16:5, bitwise against the
converted net, the periodic kernel and xresd launched there.  Each phase's seconds are logged as "[time] ...".
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
START_ENV = dict(os.environ)   # what the cold child processes of [programs] inherit
TOL_F32, TOL_BF16 = 1e-5, 1e-4
# a tf32 kernel against its plain version with the same rounding
# (plain(tf32=True)): only the sum order differs
TOL_TF32 = 1e-4
# keyed under PRECISION='default' vs the source in 'highest' at AllConvNet
# and LeNet: the limit of scripts/run_vgg_orth_224.py:55 for f32 tiles
TOL_DEFAULT = 1e-3
# keyed vs source with bf16 tiles, the JAX scripts' limit for that mode
# (scripts/run_vgg_orth_224.py:55, run_vgg_stochastic_224.py:61)
TOL_SERVE_BF16 = 3e-2

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


class global_keys:
    """Set keynet_tpu_torch GLOBAL keys for a block, restored on exit, and
    torch's TF32 flags from PRECISION on entry and exit (kt.globals.precision),
    so that no later phase's IEEE checks run in 'default'.  Plain versions
    on the card run in PRECISION='highest': their einsum then sums in IEEE
    f32, whatever mode the kernel they check ran in."""

    def __init__(self, kt, **keys):
        self.kt, self.G, self.keys = kt, kt.globals.GLOBAL, keys

    def __enter__(self):
        self.saved = {k: self.G.get(k) for k in self.keys}
        self.G.update(self.keys)
        self.kt.globals.precision()

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                self.G.pop(k, None)
            else:
                self.G[k] = v
        self.kt.globals.precision()


# --------------------------------------------------------------- phase 1
def phase_build(root=ROOT):
    """Build the native packer and the CUDA kernels of the checkout at
    ``root`` (this one, or another tree to compare) and import its
    keynet_tpu_torch."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "setup.py", "build_ext", "--inplace"],
                       cwd=root, capture_output=True, text=True, timeout=600)
    log("[build] native packer: rc=%d in %.1f s" % (r.returncode, time.perf_counter() - t))
    if r.returncode:
        # numpy packing would turn the VGG conversion's minutes into hours
        raise RuntimeError("native packer build failed:\n" + r.stderr[-2000:])
    sys.path.insert(0, root)
    import keynet_tpu_torch as kt
    log("[build] keynet_tpu_torch from %s" % os.path.dirname(os.path.dirname(kt.__file__)))
    from keynet_tpu_torch.ops import block_ell
    if not kt.native.available() or kt.native.spgemm_dr is None:
        raise RuntimeError("the native packer did not load")
    t = time.perf_counter()
    block_ell.build(verbose=True)
    log("[build] nvcc %s (sm_90a, in parallel): %.1f s"
        % (" ".join(os.path.basename(v) for v in block_ell.SOURCES.values()),
           time.perf_counter() - t))
    if os.path.abspath(root) == ROOT:   # another tree's kernels are its own
        tensor_core_instructions(block_ell)
    from keynet_tpu_torch import bench_kernels
    return kt, block_ell, bench_kernels.card()


# the sources whose bf16 and tf32 instantiations multiply on the tensor cores
TENSOR_CORE_LIBS = ("block_ell", "periodic_block_ell")


def kernel_dtype(mangled):
    """The product of a kernel from its mangled name: the tensor-core
    configs bw::Cfg<BT, float> are 'tf32', bw::Cfg<BT, __nv_bfloat16> and
    the other __nv_bfloat16 instantiations 'bf16', bc::Cfg<float, ...> (the
    FMA core) 'f32'."""
    if re.search(r"bw3CfgILi\d+EfE", mangled):
        return "tf32"
    if "bw3Cfg" in mangled or "__nv_bfloat16" in mangled:
        return "bf16"
    return "f32" if "CfgIf" in mangled else None


def tensor_core_instructions(block_ell):
    """Count the tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) in
    each kernel of each built library, from cuobjdump -sass.  Every bf16 and
    tf32 kernel of the slot walk and the periodic kernel (one a row tile
    each) must have some, every f32 kernel none (the FMA core stays IEEE
    fmaf); xres and grid are printed (their bf16 stays on the FMA core)."""
    cuobjdump = os.path.join(os.path.dirname(block_ell._nvcc()), "cuobjdump")
    bad = []
    for name, lib in sorted(block_ell._LIBS.items()):
        sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts = {}
        for part in sass.split("Function : ")[1:]:
            fn = part.split()[0]
            counts[fn] = (part.count("HGMMA"), part.count("HMMA"))
        by = {}
        for fn, (hg, hm) in counts.items():
            dt = kernel_dtype(fn)
            by.setdefault(dt, []).append(hg + hm)
            if name in TENSOR_CORE_LIBS and ((dt != "f32") != (hg + hm > 0) or dt is None):
                bad.append("%s %s: %s, %d HGMMA, %d HMMA" % (name, fn, dt, hg, hm))
        log("[build] %s tensor-core instructions (HGMMA + HMMA) a kernel, by product: %s"
            % (name, json.dumps(by)))
        for dt in ("bf16", "tf32") if name in TENSOR_CORE_LIBS else ():
            if len(by.get(dt, [])) != 5:
                bad.append("%s: %d %s kernels, want one a row tile (5)"
                           % (name, len(by.get(dt, [])), dt))
    if bad:
        raise AssertionError("[build] tensor cores: every bf16 and tf32 kernel of the slot "
                             "walk and periodic kernel must use them, no f32 kernel may: "
                             + "; ".join(bad))


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


TOL_PRODUCT = {"ieee": TOL_F32, "bf16": TOL_BF16, "tf32": TOL_TF32}
# (tile dtype, PRECISION) of the parity checks: f32 tiles in 'highest' and
# 'default', bf16 tiles; each launch is held against the plain version with
# the rounding of block_ell.product (tf32=True for a tf32 product) within
# TOL_PRODUCT of that product
PARITY_MODES = (("float32", "highest"), ("bfloat16", "highest"), ("float32", "default"))


def phase_parity(kt, block_ell):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    entries = [("block_ell_matmul", block_ell.block_ell_matmul, {}),
               ("block_ell_matmul_xres", block_ell.block_ell_matmul_xres, {}),
               ("block_ell_matmul_xres2", block_ell.block_ell_matmul_xres2, {}),
               ("block_ell_matmul_xresd", block_ell.block_ell_matmul_xresd, {"depth": 3}),
               ("block_ell_matmul_xresd", block_ell.block_ell_matmul_xresd, {"depth": 4}),
               ("block_ell_matmul_grid", block_ell.block_ell_matmul_grid, {})]
    # (B, n_rb, KB, n_uniq, n_cb, TM, TN, extra output columns): B reaches
    # every row tile of the slot walk (8: 1, 5; 16: 9; 32: 31; 64: 33, 64;
    # 128: 65, 130, the last over two batch tiles), TM = TN = 256 among them
    cases = [(1, 11, 7, 9, 6, 128, 128, 0), (5, 13, 9, 12, 7, 128, 128, 128),
             (130, 5, 3, 6, 4, 256, 128, 0), (130, 9, 16, 20, 10, 128, 256, 0),
             (5, 6, 5, 4, 3, 256, 256, 0), (9, 7, 6, 8, 5, 128, 128, 0),
             (31, 5, 9, 10, 6, 256, 256, 0), (33, 6, 5, 7, 5, 128, 128, 0),
             (64, 5, 8, 9, 6, 128, 256, 0), (65, 4, 6, 7, 4, 256, 256, 0)]
    worst = {}
    for dt, mode in PARITY_MODES:
        dtype = getattr(torch, dt)
        for case in cases:
            B, n_rb, KB, n_uniq, n_cb, TM, TN, extra = case
            x, tiles, ids, cols = random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb,
                                                   TM, TN, dtype)
            ids = with_repeats(ids)
            n_out = n_rb * TM + extra
            refs = {}
            for name, fn, kw in entries:
                with global_keys(kt, PRECISION=mode):
                    product = block_ell.product(name, dtype)
                    y = fn(x, tiles, ids, cols, n_out, **kw)
                torch.cuda.synchronize()
                width = block_ell.out_width(n_rb, TM, n_out, grid=name.endswith("_grid"))
                if tuple(y.shape) != (B, width):
                    raise AssertionError("%s %s: shape %s, want %s"
                                         % (name, case, tuple(y.shape), (B, width)))
                tf32 = product == "tf32"
                if tf32 not in refs:
                    refs[tf32] = block_ell.block_ell_plain(x, tiles, ids, cols, n_out, tf32=tf32)
                ref = refs[tf32]
                err = float((y - ref[:, :width]).abs().max())
                scale = float(ref.abs().max())
                what = "%s%s %s in %r %s" % (name, kw, product, mode, case)
                check(err, scale, TOL_PRODUCT[product], what)
                key = (name, kw.get("depth"), product, mode)
                worst[key] = max(worst.get(key, 0.0), err / max(1.0, scale))
    # periodic kernel: (B, s, P, R, KB, n_uniq, n_cb, TM, TN); R·B reaches
    # every row tile (8: 1, 8; 16: 9, 16; 32: 31; 64: 35, 64; 128: 65, 224,
    # 992), TM = TN = 256 among them
    pcases = [(1, 0, 3, 1, 4, 7, 9, 128, 128), (5, 2, 5, 7, 3, 9, 11, 128, 128),
              (32, 3, 13, 31, 5, 12, 17, 128, 128), (5, 1, 6, 7, 2, 5, 8, 256, 128),
              (32, 0, 9, 7, 19, 30, 40, 128, 256), (1, 1, 4, 8, 5, 6, 7, 256, 256),
              (3, 0, 5, 3, 4, 7, 6, 128, 128), (2, 2, 3, 8, 6, 8, 9, 128, 256),
              (1, 1, 6, 31, 7, 9, 12, 128, 128), (8, 0, 4, 8, 5, 8, 7, 256, 256),
              (5, 3, 3, 13, 4, 6, 8, 128, 128)]
    for dt, mode in PARITY_MODES:
        dtype = getattr(torch, dt)
        for case in pcases:
            B, s0, P, R, KB, n_uniq, n_cb, TM, TN = case
            n_rb = s0 + P * R + 2
            x, tiles, ids, cols = random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb,
                                                   TM, TN, dtype)
            ids[s0 + P // 2] = 0                    # an all-zero period row
            for j in range(1, R):                   # the periodicity contract
                ids[s0 + j * P:s0 + (j + 1) * P] = ids[s0:s0 + P]
            args = (x, tiles, ids, cols, s0, P, R)
            with global_keys(kt, PRECISION=mode):
                product = block_ell.product("periodic", dtype)
                y = block_ell.periodic_block_ell_matvec(*args)
            ref = block_ell.periodic_block_ell_plain(*args, tf32=product == "tf32")
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            check(err, scale, TOL_PRODUCT[product], "periodic_block_ell_matvec %s in %r %s"
                  % (product, mode, case))
            key = ("periodic_block_ell_matvec", None, product, mode)
            worst[key] = max(worst.get(key, 0.0), err / max(1.0, scale))
    staged_parity(kt, block_ell, rng, worst)
    for (name, depth, product, mode), e in sorted(worst.items(), key=str):
        log("[parity] %-25s depth=%-4s %-5s in %-9r worst max|diff|/max(1,scale) = %.3g"
            % (name, depth, product, mode, e))
    zero_slots_skipped(kt, block_ell, entries)
    tf32_rounding_pin(kt, block_ell)


def expected_grid_copies(block_ell, ids, B, n_out, TM, TN, dtype):
    """The tile copies the grid kernel issues under launch_plan's plan: in
    keep mode one per change of non-zero id along each block's walk of G
    row-blocks (a, 0, a and runs across a row boundary keep the tile), in
    stream mode one per non-zero slot; times the batch tiles and 128-wide
    chunks.  Returns (copies, non-zero slot visits, plan)."""
    plan = block_ell.launch_plan(B, n_out, TM, TN, dtype, kernel="grid")
    n_rows = -(-n_out // TM)
    flat = ids[:n_rows].cpu().numpy()
    copies = slots = 0
    for r0 in range(0, n_rows, plan["G"]):
        seq = flat[r0:r0 + plan["G"]].ravel()
        seq = seq[seq > 0]
        slots += len(seq)
        if plan["keep"]:
            copies += int((seq[1:] != seq[:-1]).sum()) + (len(seq) > 0)
        else:
            copies += len(seq)
    blocks = plan["grid"][0] * (TM // 128)
    return copies * blocks, slots * blocks, plan


def staged_parity(kt, block_ell, rng, worst):
    """xres and grid against the plain version on the cases their designs
    turn on: TN = 512 (f32 and bf16: the grid kernel's stream mode; bf16
    TN = 256 keeps), runs of G > 1 row-blocks with n_rb not a multiple of
    G, repeated ids within a row and across row boundaries, a, 0, a runs,
    an all-zero row, every row tile; the grid kernel's tile copies must
    equal expected_grid_copies.  Under 'default' too, where both stay on
    the IEEE FMA core (block_ell.product)."""
    import torch
    # (B, n_rb, KB, n_uniq, n_cb, TM, TN): BT 8 (1, 5), 16 (9), 32 (20),
    # 64 (33), 128 (130, two batch tiles); G = 2 at 701 and 601 rows, 2 at
    # 301 rows x 2 batch tiles, 7 at 2000 rows
    cases = [(1, 9, 5, 7, 6, 128, 512), (33, 6, 4, 5, 4, 256, 512),
             (130, 5, 3, 6, 4, 128, 512), (5, 701, 3, 6, 9, 128, 128),
             (9, 601, 4, 5, 7, 128, 256), (130, 301, 3, 5, 6, 128, 128),
             (20, 2000, 2, 4, 8, 128, 128)]
    entries = (block_ell.block_ell_matmul_xres, block_ell.block_ell_matmul_grid)
    modes = set()
    for dt, mode in PARITY_MODES:
        dtype = getattr(torch, dt)
        for case in cases:
            B, n_rb, KB, n_uniq, n_cb, TM, TN = case
            x, tiles, ids, cols = random_block_ell(rng, B, n_rb, KB, n_uniq, n_cb, TM, TN, dtype)
            ids = with_repeats(ids)
            if KB >= 3:                               # a, 0, a runs
                ids[1::4, 1] = 0
                ids[1::4, 2] = ids[1::4, 0]
            n_out = n_rb * TM
            ref = block_ell.block_ell_plain(x, tiles, ids, cols, n_out)
            scale = float(ref.abs().max())
            for fn in entries:
                with global_keys(kt, PRECISION=mode):
                    product = block_ell.product(fn.__name__, dtype)
                    y = fn(x, tiles, ids, cols, n_out)
                torch.cuda.synchronize()
                tol = TOL_PRODUCT[product]
                what = "%s %s in %r %s" % (fn.__name__, product, mode, case)
                if tuple(y.shape) != tuple(ref.shape):
                    raise AssertionError("%s: shape %s, want %s" % (what, tuple(y.shape),
                                                                   tuple(ref.shape)))
                err = float((y - ref).abs().max())
                check(err, scale, tol, what)
                key = (fn.__name__, None, product, mode)
                worst[key] = max(worst.get(key, 0.0), err / max(1.0, scale))
            if mode != "highest":
                continue
            y, copies = block_ell.grid_tile_copies(x, tiles, ids, cols, n_out)
            want, slots, plan = expected_grid_copies(block_ell, ids, B, n_out, TM, TN, dtype)
            modes.add(("keep" if plan["keep"] else "stream", plan["G"]))
            if copies != want:
                raise AssertionError("grid %s %s: %d tile copies issued, the plan's walk has "
                                     "%d (%d slots)" % (str(dtype), case, copies, want, slots))
            check(float((y - ref).abs().max()), scale, tol, "grid (copies counted) %s" % (case,))
    log("[parity] xres and grid at TN = 512, G > 1 runs, a, 0, a and cross-row repeats: "
        "pass, under 'default' too (FMA core, IEEE); grid tile copies == the plan's count in "
        "every case; (mode, G) seen: %s" % sorted(modes))


def zero_slots_skipped(kt, block_ell, entries):
    """A slot with tile id 0 adds nothing, even where the x block it points
    at is not finite (the contract, pallas_kernels.py:15-16): every row's
    first slot reads an all-inf x block through tile 0, which no other slot
    reads; each entry and the periodic kernel must equal the plain version
    on x with that block zeroed, at row tiles 8, 64 and 128, with f32 tiles
    (FMA core, and tf32 under 'default') and with bf16 tiles (on the tensor
    cores 0 x inf is NaN, so a slot that is not skipped shows)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    s0, P, R, n_rb, TN = 1, 4, 2, 9, 128
    for (dt, mode), B in [(m, B) for m in PARITY_MODES for B in (1, 33, 130)]:
        dtype = getattr(torch, dt)
        x, tiles, ids, cols = random_block_ell(rng, B, n_rb, 6, 7, 7, 128, TN, dtype)
        for j in range(1, R):
            ids[s0 + j * P:s0 + (j + 1) * P] = ids[s0:s0 + P]
        cols = torch.remainder(cols, 6)
        ids[:, 0], cols[:, 0] = 0, 6
        x_zero = x.clone()
        x_zero[:, 6 * TN:] = 0.0
        x[:, 6 * TN:] = float("inf")
        n_out = n_rb * 128
        runs = []
        with global_keys(kt, PRECISION=mode):
            for name, fn, kw in entries:
                runs.append((name, kw, block_ell.product(name, dtype),
                             fn(x, tiles, ids, cols, n_out, **kw)))
            runs.append(("periodic_block_ell_matvec", {}, block_ell.product("periodic", dtype),
                         block_ell.periodic_block_ell_matvec(x, tiles, ids, cols, s0, P, R)))
        torch.cuda.synchronize()
        refs = {}
        for name, kw, product, y in runs:
            what = "%s%s %s in %r B=%d, id-0 slots on inf x" % (name, kw, product, mode, B)
            if not bool(torch.isfinite(y).all()):
                raise AssertionError("%s: a non-finite output" % what)
            tf32 = product == "tf32"
            if name == "periodic_block_ell_matvec":
                want = block_ell.periodic_block_ell_plain(x_zero, tiles, ids, cols, s0, P, R,
                                                          tf32=tf32)
            else:
                if tf32 not in refs:
                    refs[tf32] = block_ell.block_ell_plain(x_zero, tiles, ids, cols, n_out,
                                                           tf32=tf32)
                want = refs[tf32][:, :block_ell.out_width(n_rb, 128, n_out,
                                                          grid=name.endswith("_grid"))]
            check(float((y - want).abs().max()), float(want.abs().max()),
                  TOL_PRODUCT[product], what)
    log("[parity] id-0 slots on inf x add nothing: every slot-walk entry and the "
        "periodic kernel, f32 tiles (FMA core; tf32 on the tensor cores under 'default') "
        "and bf16 tiles (the tensor cores, where a zero tile times inf would be NaN), "
        "B = 1, 33, 130")


def rounding_operands():
    """x (1, 128) and a diagonal 128 x 128 tile whose entries separate the
    roundings an f32 operand could get on its way into a tf32 product: low
    13 mantissa bits below, at and above half of the tf32 unit, all of them
    set, on even and odd tf32 mantissas, of both signs, in x and in the
    tile (the other factor 1 or 2^e, so every product is exact)."""
    import numpy as np
    low = [0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x0001]
    vals = []
    for sign in (1, -1):
        for odd in (0, 1):
            for lb in low:
                for e in (-3, 0, 5):
                    bits = 0x3F800000 + (e << 23) + (odd << 13) + lb
                    vals.append(sign * float(np.array([bits], np.uint32).view(np.float32)[0]))
    vals = np.array(vals, np.float32)   # 60 values
    x = np.ones(128, np.float32)
    d = np.ones(128, np.float32)
    x[:60] = vals                       # x carries the bits, the tile 1 ...
    d[64:124] = vals                    # ... then the tile carries them, x 1
    return x[None, :], np.diag(d).astype(np.float32)


def tf32_rounding_pin(kt, block_ell):
    """The rounding the tensor cores give f32 operands in a tf32 product,
    pinned on the card: the slot walk and the periodic kernel under
    'default' on rounding_operands() (one non-zero product an output, so the
    output is that product, exact) must equal, bit for bit, the product of
    round_tf32's operands (truncation: the 13 low mantissa bits dropped);
    the round-to-nearest candidates (ties away, as cvt.rna.tf32.f32; ties to
    even) are printed beside it and must differ."""
    import numpy as np
    import torch
    x, tile = rounding_operands()

    def rn(v, ties_away):
        b = v.view(np.uint32).astype(np.uint64)
        low, half = b & 0x1FFF, 0x1000
        up = (low > half) | ((low == half) & (ties_away | ((b >> 13) & 1 == 1)))
        return ((b - low + np.where(up, 0x2000, 0)).astype(np.uint32)).view(np.float32)

    cands = {"truncate": lambda v: block_ell.round_tf32(torch.from_numpy(v)).numpy(),
             "nearest, ties away": lambda v: rn(v, True),
             "nearest, ties even": lambda v: rn(v, False)}
    want = {k: (f(x) * np.diag(f(tile))[None, :]).astype(np.float32) for k, f in cands.items()}
    tiles = torch.zeros((2, 128, 128), dtype=torch.float32, device="cuda")
    tiles[1] = torch.from_numpy(tile)
    ids = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    cols = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    xd = torch.from_numpy(x).cuda()
    with global_keys(kt, PRECISION="default"):
        ys = {"slot walk": block_ell.block_ell_matmul_xresd(xd, tiles, ids, cols, 128),
              "periodic": block_ell.periodic_block_ell_matvec(xd, tiles, ids, cols, 0, 1, 1)}
    torch.cuda.synchronize()
    agree = {k: {c: int((y.cpu().numpy()[:, :128].view(np.uint32)
                         == w.view(np.uint32)).sum()) for c, w in want.items()}
             for k, y in ys.items()}
    log("[parity] tf32 rounding pin: outputs (of 128) equal bit for bit to each candidate "
        "rounding's product: %s" % json.dumps(agree))
    for k, a in agree.items():
        if a["truncate"] != 128 or max(a["nearest, ties away"], a["nearest, ties even"]) == 128:
            raise AssertionError("tf32 rounding pin, %s: the card does not truncate as "
                                 "round_tf32 models it: %s" % (k, json.dumps(a)))


# --------------------------------------------------------------- phase 3
def route_str(op):
    """An op's kind down its chain; a Block-ELL core with its (n_rb, KB),
    unique tiles, tile shape, period, whether its schedule on its device
    launches kernels ("kernel", else "plain" on the CPU and "einsum" off
    it) and whether it holds a grouped-row plan; an EllOp with its row
    length K."""
    from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChainedOp,
                                                ChannelBroadcastOp, EllOp,
                                                PermutedBlockSparseOp)
    if isinstance(op, ChainedOp):
        return "Chain[%s]" % ", ".join(route_str(o) for o in op.ops)
    if isinstance(op, (PermutedBlockSparseOp, BlockSparseOp)):
        c = getattr(op, "inner", op)
        dev = c.tiles.device
        return "%s(Block-ELL %s, %d tiles of %dx%d, period %s, %s%s)" % (
            type(op).__name__, tuple(c.tile_ids.shape), c.tiles.shape[0], *c.tileshape,
            c.period, "kernel" if c._kernel_side(dev) else "plain" if dev.type == "cpu"
            else "einsum",
            "" if c._rgroups is None else ", grouped-row plan")
    if isinstance(op, ChannelBroadcastOp):
        return "ChannelBroadcastOp(C=%d, %s)" % (op.C, route_str(op.inner))
    if isinstance(op, EllOp):
        return "EllOp(%d, %d, K=%d)" % (*op.shape, op.cols.shape[1])
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


def entries_of(core, B):
    """The kernel entries one apply of ``core`` to B rows launches on the
    card: those its schedule names."""
    import torch
    return {step.entry for step in core.schedule(B, torch.device("cuda")) if step.entry}


def never_routed(launches, where):
    """No operator routes to the xres and grid entries (as in keynet_tpu)."""
    for name in ("block_ell_matmul_xres", "block_ell_matmul_grid"):
        if launches[name]:
            raise AssertionError("%s launched %d times on %s" % (name, launches[name], where))


def keyed_vs_source(kt, net, sensor, knet, B, seed, label, timing=True, reps=5, tag="main",
                    tol=TOL_F32, mode=None):
    """Encrypt a seeded batch, hold the keyed forward against the source
    forward within tol·max(1, scale), and time the keyed forward; returns
    (cipher batch, keyed forwards run).  With ``mode`` the encryption and
    the keyed forwards run under that PRECISION, the source forward in the
    caller's ('highest': IEEE f32 convs, the reference)."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal((B, *net.inshape)).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    ys = net.forward(xd)
    with global_keys(kt, PRECISION=mode or kt.globals.GLOBAL["PRECISION"]):
        xc = sensor.fromtensor(xd).encrypt().tensor()
        y = knet.forward(xc)
        torch.cuda.synchronize()
        if tuple(y.shape) != tuple(ys.shape) or not bool(torch.isfinite(y).all()):
            raise AssertionError("%s: bad output %s (finite=%s)"
                                 % (label, tuple(y.shape), bool(torch.isfinite(y).all())))
        err = float((y - ys).abs().max())
        scale = float(ys.abs().max())
        check(err, scale, tol, "%s keyed vs source" % label)
        # how far the source outputs of the batch stray from their mean: the part
        # of the output that depends on the image, which the error is set against
        res = {"B": B, "max_abs_err": err, "scale": scale, "limit": tol * max(1.0, scale),
               "batch_spread": float((ys - ys.mean(0)).abs().max())}
        if mode:
            res["precision"] = mode
        forwards = 1
        if timing:
            ms, times = cuda_ms(lambda: knet.forward(xc), reps=reps, warmup=1)
            res.update(ms=ms, imgs_per_s=B / (ms / 1e3), reps_ms=times)
            forwards += 1 + reps
    log("[%s] %s B=%d: %s" % (tag, label, B, json.dumps(res)))
    return xc, forwards


def allconv_keynet(kt):
    """The StochasticKeynet AllConvNet of bench.py's second configuration:
    (source net, keyed sensor, keyed net)."""
    net = kt.models.AllConvNet(seed=1)
    t = time.perf_counter()
    sensor, knet = kt.StochasticKeynet((3, 32, 32), net, alpha=2, blocksize=8,
                                       seed=0, device="cuda")
    log("[main] AllConvNet StochasticKeynet conversion: %.1f s"
        % (time.perf_counter() - t))
    return net, sensor, knet


def vgg_keynet(kt, tag="vgg"):
    """The Givens-orthogonal VGG-16 at 3x224x224 of
    scripts/run_vgg_orth_224.py, its tiles in GLOBAL['TILE_DTYPE']: (source
    net, keyed sensor, keyed net)."""
    net = kt.models.VGG16(seed=5)
    t = time.perf_counter()
    sensor, knet = kt.Keynet((3, 224, 224), net, global_geometric="identity",
                             local_geometric="givens_orthogonal", alpha=2.0,
                             blocksize=14, local_photometric="uniform_random_affine",
                             beta=1.0, gamma=1.0, memoryorder="channel", seed=0,
                             device="cuda")
    log("[%s] conversion: %.1f s (host), nnz %d" % (tag, time.perf_counter() - t,
                                                    knet.num_parameters()))
    return net, sensor, knet


def phase_main_allconv(kt, block_ell):
    import numpy as np
    import torch
    net, sensor, knet = allconv_keynet(kt)
    log("[main] route sensor: %s" % route_str(sensor.op()))
    for name, l in knet.layers().items():
        if l != "relu":
            log("[main] route %s: %s" % (name, route_str(l.op())))

    m = kt.models
    narrow = m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                      m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                      m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)
    with global_keys(kt, DENSE_MAX_BYTES=1 << 20, ELL_MAX_K=32):
        ns, nk = kt.StochasticKeynet((3, 16, 16), narrow, alpha=2, blocksize=8,
                                     seed=0, device="cuda")
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
    # the B=1 image of the cold serve's --check in [programs] (serve.serve),
    # so that phase_kernels holds xresd at that operand too
    x1 = np.random.default_rng(0).standard_normal((1, *net.inshape)).astype(np.float32)
    xcs[1] = sensor.fromtensor(torch.from_numpy(x1).cuda()).encrypt().tensor()
    return {"allconv": (knet, xcs), "allconv keynet": (net, sensor, knet),
            "lenet keynet": (lenet, ls, lk), "narrow": (nk, xn)}, launches


def default_launches(block_ell, cores, where):
    """The counts read right after a PRECISION='default' run: every kernel
    entry the driven Block-ELL ``cores`` ((core, rows an image, batches))
    route to must have launched, each launch of the slot walk and the
    periodic kernel a tf32 one (f32 tiles); xres and grid never.  Returns
    (launches, tf32 launches)."""
    import torch
    import keynet_tpu_torch as kt
    torch.cuda.synchronize()
    launches, tf32 = dict(block_ell.LAUNCHES), dict(block_ell.TF32_LAUNCHES)
    with global_keys(kt, PRECISION="default"):   # the routes the runs took
        routed = sorted(set().union(*(entries_of(c, B * m) for c, m, bs in cores
                                      for B in bs)))
    log("[%s] launches: %s; tf32 launches: %s; entries routed by the driven Block-ELL "
        "cores: %s" % (where, json.dumps(launches), json.dumps(tf32), routed))
    for name in routed:
        if launches[name] <= 0 or tf32[name] != launches[name]:
            raise AssertionError("%s: %s launched %d times, %d of them tf32; want > 0, all "
                                 "tf32" % (where, name, launches[name], tf32[name]))
    never_routed(launches, where)
    return launches, tf32


def phase_main_default(kt, block_ell, paths):
    """Slice 11, [main] under PRECISION='default' (the counterpart of
    bench.py:146-160's bf16-mode diagnostic): StochasticKeynet AllConvNet at
    B=64 and 1024 (conv1's core on the tf32 slot walk, the Kronecker and
    TapSum chains on cuBLAS TF32) and PermutationKeynet LeNet_AvgPool at
    B=8192 (Dense and ELL only: no kernel), keyed vs the source computed in
    'highest' within TOL_DEFAULT·max(1, scale).  Counts set to 0 just
    before, read just after (default_launches).  Returns (launches, tf32
    launches)."""
    net, sensor, knet = paths["allconv keynet"]
    lenet, ls, lk = paths.pop("lenet keynet")
    block_ell.reset_launches()
    for B in (64, 1024):
        keyed_vs_source(kt, net, sensor, knet, B, B, "AllConvNet 'default'", tol=TOL_DEFAULT,
                        mode="default")
    keyed_vs_source(kt, lenet, ls, lk, 8192, 3, "LeNet_AvgPool 'default'", tol=TOL_DEFAULT,
                    mode="default")
    cores = [(c, m, (64, 1024)) for _, c, m in block_ell_cores(sensor, knet)]
    return default_launches(block_ell, cores, "main 'default'")


def phase_main_vgg(kt, block_ell, bf16=False, f32_memory=None):
    """Slice 2: the Givens-orthogonal VGG-16 at 3x224x224 through kt.Keynet,
    keyed vs source at B=1, 8 and 32, with the launches read right after.
    With ``bf16``, slice 10's [vgg-bf16]: the same net converted with
    TILE_DTYPE='bfloat16' (run_vgg_orth_224.py --tile-dtype bfloat16), its
    device memory beside slice 2's (``f32_memory``), keyed vs source within
    TOL_SERVE_BF16, every kernel-routed core held against its plain version
    at the operand the bf16 forward fed it (TOL_BF16), per-link ms at B=1
    and 32, no trace."""
    import torch
    tag, label = ("vgg-bf16", "VGG16 orth bf16") if bf16 else ("vgg", "VGG16 orth")
    alloc0 = torch.cuda.memory_allocated()
    with global_keys(kt, TILE_DTYPE="bfloat16" if bf16 else "float32"):
        net, sensor, knet = vgg_keynet(kt, tag)
    log("[%s] route sensor: %s" % (tag, route_str(sensor.op())))
    for name, l in knet.layers().items():
        if l != "relu":
            log("[%s] route %s: %s" % (tag, name, route_str(l.op())))
    cores = block_ell_cores(sensor, knet)
    for name, c, per_image in cores:
        res = dict(rows=int(c.tile_ids.shape[0]), KB=int(c.tile_ids.shape[1]),
                   unique_tiles=int(c.tiles.shape[0]), period=c.period,
                   nonzero_slots=int((c.tile_ids > 0).sum()))
        if bf16:
            res.update(tiles=str(c.tiles.dtype), apply={
                "B=%d" % B: core_apply(c, B * per_image) for B in (1, 8, 32)})
        log("[%s] core %s: %s" % (tag, name, json.dumps(res)))
    gate = int(kt.globals.GLOBAL.get("PERIODIC_EXPAND_BYTES", 512 << 20))
    texp = sum(c._expand_bytes() for _, c, _ in cores
               if c.period is not None and c._expand_bytes() <= gate)
    knet._build()
    log("[%s] device_bytes: %d (keyed net on the card), sensor %d; the expanded "
        "period tiles keynet_tpu keeps besides (_Texp, within PERIODIC_EXPAND_BYTES): %d"
        % (tag, knet.device_bytes(), sensor.device_bytes(), texp))
    memory = device_memory(tag, label, sensor, knet, alloc0)
    if f32_memory is not None:
        log("[vgg-bf16] device memory against the f32 net's ([vgg]): %s" % json.dumps({
            k: [memory[k], f32_memory[k], memory[k] / f32_memory[k]]
            for k in ("memory_allocated", "device_bytes")}))

    block_ell.reset_launches()
    xcs, forwards = {}, {}
    for B in (1, 8, 32):
        xcs[B], forwards[B] = keyed_vs_source(
            kt, net, sensor, knet, B, 100 + B, label, reps=5 if B < 32 else 3, tag=tag,
            tol=TOL_SERVE_BF16 if bf16 else TOL_F32)
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[%s] launches: %s" % (tag, json.dumps(launches)))
    periodic = [(n, c, m) for n, c, m in cores if c.period is not None]
    if not periodic:
        raise AssertionError("no periodic Block-ELL core on the %s path" % label)
    want = sum(forwards[B] * sum("periodic_block_ell_matvec"
                                 in entries_of(c, B * m)
                                 for n, c, m in periodic if n != "sensor")
               for B in forwards)
    log("[%s] periodic cores: %s; periodic launches %d, at least %d wanted"
        % (tag, [n for n, _, _ in periodic], launches["periodic_block_ell_matvec"], want))
    if launches["periodic_block_ell_matvec"] < want or want == 0:
        raise AssertionError("periodic_block_ell_matvec launched %d times, want >= %d"
                             % (launches["periodic_block_ell_matvec"], want))
    routed = sorted(set().union(*(entries_of(c, B * m) for _, c, m in cores
                                  for B in forwards)))
    log("[%s] entries routed by the driven Block-ELL cores: %s" % (tag, routed))
    for name in routed:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the %s path" % (name, label))
    never_routed(launches, "the %s path" % label)
    if bf16:
        hold_cores_at_forward(block_ell, sensor, knet, cores, xcs, net.inshape)
    for B in ((1, 32) if bf16 else (1, 8, 32)):
        layer_breakdown(label, knet, xcs[B])
    if not bf16:
        trace_forward(kt, knet, xcs[1], "vgg_orth_forward_B1")
    return {tag: (knet, xcs, cores), tag + " memory": memory,
            tag + " keynet": (net, sensor, knet)}, launches


def phase_vgg_default(kt, block_ell, paths):
    """Slice 11, [vgg-default]: the orth VGG-16 that [vgg] converted (f32
    tiles; no second conversion) under PRECISION='default': the slot walk
    and the periodic kernel on tf32 wgmma, the Kronecker chains, pools and
    fc layers on cuBLAS TF32.  Counts set to 0 just before and read just
    after the forwards: keyed vs the source computed in 'highest' at B=1, 8,
    32 within TOL_SERVE_BF16 (the output hardly depends on the image at 224,
    PERF.md §5: batch_spread beside it; the per-core holds carry the check),
    the periodic kernel launched once per periodic core per forward, every
    launch of the slot walk and the periodic kernel tf32
    (default_launches); then every kernel-routed core held against
    plain(tf32=True) at the operands the 'default' forward fed it
    (TOL_TF32), per-link ms at B=1 and 32, and the device memory held after
    the phase (the sensor's image put back) equal to before it: the mode
    adds no device state; device_bytes() equal to [vgg]'s.  Returns
    (launches, tf32 launches)."""
    import torch
    tag, label = "vgg-default", "VGG16 orth 'default'"
    net, sensor, knet = paths["vgg keynet"]
    _, _, cores = paths["vgg"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    held = sensor.tensor()   # the image the sensor holds: put back before the count
    block_ell.reset_launches()
    xcs, forwards = {}, {}
    for B in (1, 8, 32):
        xcs[B], forwards[B] = keyed_vs_source(
            kt, net, sensor, knet, B, 100 + B, label, reps=5 if B < 32 else 3, tag=tag,
            tol=TOL_SERVE_BF16, mode="default")
    launches, tf32 = default_launches(
        block_ell, [(c, m, tuple(forwards)) for _, c, m in cores], tag)
    want = sum(forwards[B] * sum("periodic_block_ell_matvec" in entries_of(c, B * m)
                                 for n, c, m in cores if c.period is not None and n != "sensor")
               for B in forwards)
    log("[%s] periodic launches %d (tf32 %d), at least %d wanted"
        % (tag, launches["periodic_block_ell_matvec"], tf32["periodic_block_ell_matvec"], want))
    if launches["periodic_block_ell_matvec"] < want or want == 0:
        raise AssertionError("periodic_block_ell_matvec launched %d times, want >= %d"
                             % (launches["periodic_block_ell_matvec"], want))
    with global_keys(kt, PRECISION="default"):
        hold_cores_at_forward(block_ell, sensor, knet, cores, xcs, net.inshape, tag)
        for B in (1, 32):
            layer_breakdown(label, knet, xcs[B])
    del xcs
    sensor.fromtensor(held)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    f32 = paths["vgg memory"]
    counted = knet.device_bytes() + sensor.device_bytes()
    log("[%s] device memory: %s" % (tag, json.dumps(dict(
        memory_allocated_before=before, memory_allocated_after=after,
        device_bytes=counted, f32_net_device_bytes=f32["device_bytes"],
        f32_net_memory_allocated=f32["memory_allocated"]))))
    if after != before or counted != f32["device_bytes"]:
        raise AssertionError("[%s] the mode changed the device memory held: %d -> %d bytes "
                             "allocated, device_bytes %d against [vgg]'s %d"
                             % (tag, before, after, counted, f32["device_bytes"]))
    return launches, tf32


def hold_cores_at_forward(block_ell, sensor, knet, cores, xcs, inshape, tag="vgg-bf16"):
    """Every Block-ELL core of a keyed sensor and net that routes to a kernel,
    held against the kernel's plain version at the operands the keyed
    forward (and the encryption) fed it at each batch of ``xcs``, under the
    caller's PRECISION: the operands are recorded as the cores hand them on
    (fed_operands), then go through the routed wrapper and the plain
    version (hold_fed: TOL_BF16 for bf16 tiles, plain(tf32=True) and
    TOL_TF32 for tf32 launches).  Fails where a kernel-routed core was fed
    nothing."""
    import numpy as np
    import torch
    held = {}
    for B, xc in xcs.items():
        x = np.random.default_rng(100 + B).standard_normal((B, *inshape)).astype(np.float32)
        with fed_operands((name, c) for name, c, _ in cores) as rec:
            sensor.fromtensor(torch.from_numpy(x).cuda()).encrypt()
            knet.forward(xc)
        torch.cuda.synchronize()
        for entry, line in hold_fed(block_ell, rec.calls, "B=%d" % B):
            log("[%s] held %s" % (tag, line))
            held[entry] = held.get(entry, 0) + 1
        fed = {name for name, _, _, _ in rec.calls}
        for name, c, m in cores:
            if entries_of(c, B * m) and name not in fed:
                raise AssertionError("[%s] %s routes to a kernel at B=%d and was fed "
                                     "nothing" % (tag, name, B))
        del rec
    log("[%s] kernel-routed cores held against their plain versions at the forward's "
        "operands (B = %s): %s" % (tag, sorted(xcs), json.dumps(held)))


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
    yardstick; the port never calls it): f32 values for f32 tiles, bf16
    values and x for bf16 tiles."""
    import torch
    dt = torch.float32 if tiles.dtype == torch.float32 else tiles.dtype
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
    W = torch.sparse_bsr_tensor(crow, cols_s[nz_s], tiles[ids_s[nz_s]].to(dt),
                                size=(n_rb * TM, x.shape[1]))
    xT = x.to(dt).T.contiguous()
    y = torch.sparse.mm(W, xT).T.float()
    ms, _ = cuda_ms(lambda: torch.sparse.mm(W, xT), reps=5)
    return ms, y


def measure_operand(block_ell, bk, fn, kw, tiles, ids, cols, x, where, peaks):
    """One entry on one Block-ELL operand: checked against the plain version
    (shape and values), then timed with the plain version and the BSR
    yardstick beside it.  Under PRECISION='default' with f32 tiles the slot
    walk runs tf32: held against plain(tf32=True), bound at the TF32 rate,
    the yardstick torch.bmm with TF32 on (bmm_slot_library_ms)."""
    import torch
    import keynet_tpu_torch as kt
    B = x.shape[0]
    TM, TN = tiles.shape[1], tiles.shape[2]
    n_out = ids.shape[0] * TM
    args = (x, tiles, ids, cols, n_out)
    product = block_ell.product(fn.__name__, tiles.dtype)
    tf32 = product == "tf32"
    y = fn(*args, **kw)
    with global_keys(kt, PRECISION="highest"):
        ref = block_ell.block_ell_plain(*args, tf32=tf32)
    torch.cuda.synchronize()
    if y.shape != ref.shape:
        raise AssertionError("%s at %s: shape %s, plain %s"
                             % (fn.__name__, where, tuple(y.shape), tuple(ref.shape)))
    err = float((y - ref).abs().max())
    check(err, float(ref.abs().max()), TOL_PRODUCT[product], "%s at %s" % (fn.__name__, where))
    del y
    ms, _ = cuda_ms(lambda: fn(*args, **kw), reps=10)
    with global_keys(kt, PRECISION="highest"):
        plain_ms, _ = cuda_ms(lambda: block_ell.block_ell_plain(*args, tf32=tf32), reps=5)
    extra = {}
    try:
        if tf32:
            lib_ms, ylib = bmm_slot_library_ms(tiles, ids, cols, x)
            if ylib is not None:
                # the yardstick's rounding: its error beside the IEEE result's
                with global_keys(kt, PRECISION="highest"):
                    extra["library_vs_ieee_max_abs_err"] = float(
                        (ylib - block_ell.block_ell_plain(*args)).abs().max())
        else:
            lib_ms, ylib = bsr_library_ms(tiles, ids, cols, x)
        lib_err = None if ylib is None else float((ylib - ref).abs().max())
        del ylib
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only
        log("[kernels] torch.sparse.mm BSR yardstick unavailable: %s" % e)
        lib_ms = lib_err = None
    w = bk.work(ids, cols, TM, TN, n_out, B, tiles.element_size(), peaks,
                rate="tf32" if tf32 else None)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": w["bound_ms"], "bound_by": w["bound_by"], "library_ms": lib_ms}
    if fn is block_ell.block_ell_matmul_grid:
        # the dedup's effect: tile copies issued against non-zero slots walked
        _, copies = block_ell.grid_tile_copies(*args)
        want, slots, plan = expected_grid_copies(block_ell, ids, B, n_out, TM, TN, tiles.dtype)
        if copies != want:
            raise AssertionError("grid at %s: %d tile copies issued, the plan's walk has %d"
                                 % (where, copies, want))
        res.update(tile_copies=copies, slots_walked=slots, G=plan["G"],
                   mode="keep" if plan["keep"] else "stream")
    log("[kernels] %s at %s: %s" % (fn.__name__, where, json.dumps(dict(
        w, **res, **extra, product=product, library_max_abs_err=lib_err,
        achieved_tflops=w["flops"] / ms / 1e9))))
    return res


def bmm_slot_library_ms(tiles, tile_ids, col_blk, x):
    """One torch.bmm in the tile dtype over the slot walk's pre-gathered
    operands, batch n_rb, (B, KB·TN) x (KB·TN, TM) (id-0 slots gather the
    zero tile) — the yardstick of the tf32 rows, which run it with TF32 on;
    timed without its gathers; the port never calls it.  (None, None) when
    the gathered operands would not fit the card."""
    import torch
    n_rb, KB = tile_ids.shape
    TM, TN = tiles.shape[1], tiles.shape[2]
    B = x.shape[0]
    need = tiles.element_size() * n_rb * (B * KB * TN + KB * TN * TM + B * TM)
    free = torch.cuda.mem_get_info()[0]
    if need > 0.8 * free:
        log("[kernels] torch.bmm yardstick at B=%d skipped: its gathered operands take "
            "%.1f GB, %.1f GB free" % (B, need / 1e9, free / 1e9))
        return None, None
    xb = x.to(tiles.dtype).reshape(B, -1, TN)
    Xg = xb[:, col_blk.long()].permute(1, 0, 2, 3).reshape(n_rb, B, KB * TN)
    Tg = tiles[tile_ids.long()].permute(0, 1, 3, 2).reshape(n_rb, KB * TN, TM)
    y = torch.bmm(Xg, Tg)                                          # (n_rb, B, TM)
    ms, _ = cuda_ms(lambda: torch.bmm(Xg, Tg), reps=5)
    return ms, y.permute(1, 0, 2).reshape(B, n_rb * TM).float()


def measure(block_ell, bk, fn, kw, model, xc, where, peaks):
    """One entry on conv1's core of ``model`` fed the activations of ``xc``."""
    inner, x = core_input(model, xc, "conv1")
    return measure_operand(block_ell, bk, fn, kw, inner.tiles, inner.tile_ids,
                           inner.col_blk, x, where, peaks)


def phase_kernels(kt, block_ell, bk, paths, by_path, peaks, tf32_launches=None):
    """One row per Pallas function (launches: summed over the main paths,
    and each path's count), the stochastic VGG's kernel row, and the bf16
    and tf32 rows of the slot walk and the periodic kernel
    (bf16_kernel_rows; tf32_kernel_rows, with the tf32 launches of the
    'default' paths)."""
    import numpy as np
    import torch
    launches = {n: sum(p[n] for p in by_path.values()) for n in block_ell.ENTRIES}
    knet, xcs = paths["allconv"]
    nk, xn = paths["narrow"]
    be = block_ell
    src = "keynet_tpu_torch/csrc/"
    rows = {}

    def row(fn, source, line, result):
        rows[fn.__name__] = dict({"name": fn.__name__, "route": "cuda", "source": src + source,
                                  "replaces": "keynet_tpu/ops/pallas_kernels.py:%d" % line,
                                  "launches": launches[fn.__name__],
                                  "launches_by_path": {p: n[fn.__name__]
                                                       for p, n in by_path.items()}}, **result)

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
    measure(be, bk, be.block_ell_matmul_xresd, {"depth": 4}, knet, xcs[1],
            "AllConvNet conv1 core, B=1 (the cold serve's --check in [programs])", peaks)
    for fn in (be.block_ell_matmul_xres, be.block_ell_matmul_grid):
        measure(be, bk, fn, {}, knet, xcs[64], "AllConvNet conv1 core, B=64", peaks)
    # xres and grid where the slot walk is FMA-bound: the share of the
    # operations bound each reaches, the slot walk's beside them
    for fn, kw in ((be.block_ell_matmul_xresd, {"depth": 4}), (be.block_ell_matmul_xres, {}),
                   (be.block_ell_matmul_grid, {})):
        r = measure(be, bk, fn, kw, knet, xcs[1024], "AllConvNet conv1 core, B=1024", peaks)
        log("[kernels] %s at AllConvNet conv1 core, B=1024: %.1f%% of the %s bound"
            % (fn.__name__, 100 * r["bound_ms"] / r["ms"], r["bound_by"]))
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
    for B in (32, 8, 1):
        r = measure_periodic(be, vknet, vxcs[B], name, peaks)
    row(be.periodic_block_ell_matvec, "periodic_block_ell.cu", 551, r)
    periodic_resident_blocks(be, vknet, vxcs[1], name)
    # the slot walk on the rows of that core outside its period, as the
    # forward launches it: the head rows [0, s) and the tail rows [s+P·R, n_rb)
    for B in (1, 8, 32):
        core, x = core_input(vknet, vxcs[B], name)
        fn = be.route(core.tile_ids.shape[1])
        parts = [measure_operand(be, bk, fn, {}, core.tiles, core.tile_ids[a:b],
                                 core.col_blk[a:b], x, "VGG16 orth %s core %s rows [%d, %d), "
                                 "B=%d" % (name, part, a, b, B), peaks)
                 for part, (a, b) in zip(("head", "tail"), outside_period(core))]
        log("[kernels] %s at VGG16 orth %s core head + tail rows, B=%d: %s"
            % (fn.__name__, name, B, json.dumps(summed(parts))))
    head_tail_staged(be, bk, vknet, vxcs[1], name, peaks)
    if "vgg-stochastic" in paths:
        stochastic_kernel_rows(be, bk, *paths["vgg-stochastic"], peaks)
        grouped_kernel_rows(be, bk, *paths["vgg-stochastic"], peaks)
    if "vgg-bf16" in paths:
        bf16 = bf16_kernel_rows(kt, be, bk, paths, by_path[BF16_PATH], peaks)
        for n in bf16:
            rows[n]["bf16"] = [dict(r, name=n, route="cuda", source=rows[n]["source"],
                                    replaces=rows[n]["replaces"]) for r in bf16[n]]
    if tf32_launches is not None:
        tf32 = tf32_kernel_rows(kt, be, bk, paths, tf32_launches, peaks)
        for n in ("periodic_block_ell_matvec", "block_ell_matmul_xresd"):
            rows[n]["tf32"] = [dict(r, name=n, route="cuda", source=rows[n]["source"],
                                    replaces=rows[n]["replaces"]) for r in tf32[n]]
    return [rows[n] for n in be.ENTRIES if n in rows]


DEFAULT_PATHS = ("slice 11 (AllConvNet, LeNet 'default')", "slice 11 (VGG orth 'default')")


def tf32_kernel_rows(kt, block_ell, bk, paths, launches, peaks):
    """The tf32 (tensor-core) rows of the slot walk and the periodic kernel,
    under PRECISION='default' with the f32 nets' tiles: the periodic kernel
    at the orth VGG-16's conv1_2 core and the slot walk on that core's head
    and tail rows at B = 1, 8, 32, fed as the 'default' forward feeds them;
    the slot walk at AllConvNet conv1 at B = 64 and 1024.  Each: kernel,
    plain (tf32=True) and library ms (torch.bmm over pre-gathered f32
    operands with TF32 on, gathers untimed), the bound at the TF32 rate and
    4 bytes a tile element, and the entry's tf32 launches on the 'default'
    paths (``launches``).  Returns {entry: [rows]}."""
    be = block_ell
    knet, xcs, cores = paths["vgg"]
    name = max((n for n, c, _ in cores if c.period is not None),
               key=lambda n: periodic_work(next(c for m, c, _ in cores if m == n))["slots"])
    out = {"periodic_block_ell_matvec": [], "block_ell_matmul_xresd": []}
    aknet, axcs = paths["allconv"]
    with global_keys(kt, PRECISION="default"):
        for B in (1, 8, 32):
            r = measure_periodic(be, knet, xcs[B], name, peaks, label="VGG16 orth 'default'")
            out["periodic_block_ell_matvec"].append(dict(
                r, where="VGG16 orth %s core, 'default' (tf32), B=%d" % (name, B),
                launches=launches["periodic_block_ell_matvec"]))
        for B in (1, 8, 32):
            core, x = core_input(knet, xcs[B], name)
            fn = be.route(core.tile_ids.shape[1])
            parts = [measure_operand(be, bk, fn, {}, core.tiles, core.tile_ids[a:b],
                                     core.col_blk[a:b], x, "VGG16 orth %s core %s rows "
                                     "[%d, %d), 'default' (tf32), B=%d" % (name, part, a, b, B),
                                     peaks)
                     for part, (a, b) in zip(("head", "tail"), outside_period(core))]
            out[fn.__name__].append(dict(summed(parts), launches=launches[fn.__name__],
                                         where="VGG16 orth %s core head + tail rows, 'default' "
                                         "(tf32), B=%d" % (name, B)))
        for B in (64, 1024):
            core, x = core_input(aknet, axcs[B], "conv1")
            where = "AllConvNet conv1 core, 'default' (tf32), B=%d" % B
            r = measure_operand(be, bk, be.block_ell_matmul_xresd, {"depth": 4}, core.tiles,
                                core.tile_ids, core.col_blk, x, where, peaks)
            out["block_ell_matmul_xresd"].append(dict(
                r, where=where, launches=launches["block_ell_matmul_xresd"]))
    for n, rs in out.items():
        log("[kernels] %s tf32 (tensor cores): %s" % (n, json.dumps(rs)))
    return out


BF16_PATH = "slice 10 (VGG orth bf16)"


def summed(parts):
    """Head and tail rows measured apart, as one row: times and bounds
    added, the worst error, the bound's kind where the parts agree."""
    out = {}
    for r in parts:
        for k, v in r.items():
            if k == "max_abs_err":
                out[k] = max(out.get(k, 0.0), v)
            elif isinstance(v, float):
                out[k] = out.get(k, 0.0) + v
            elif v is None and k.endswith("_ms"):
                out[k] = None
            elif k not in out:
                out[k] = v
            elif out[k] != v:
                out[k] = "mixed"
    return out


def bf16_kernel_rows(kt, block_ell, bk, paths, launches, peaks):
    """The bf16 (tensor-core) rows of the slot walk and the periodic kernel:
    the periodic kernel at the orth VGG-16's conv1_2 core and the slot walk
    on that core's head and tail rows at B = 1, 8, 32, fed as the bf16
    forward feeds them; the slot walk at AllConvNet conv1 with its f32 tiles
    cast to bf16 at B = 64 and 1024 (the cast is first held equal to a
    TILE_DTYPE='bfloat16' conversion's conv1 core).  Each: kernel, plain and
    library ms, the bound at the bf16 rate and 2 bytes a tile element, and
    the entry's launches on the bf16 path; xres and grid (bench only) at
    that operand at B=64.  Returns {entry: [rows]}."""
    import torch
    be = block_ell
    knet, xcs, cores = paths["vgg-bf16"]
    name = max((n for n, c, _ in cores if c.period is not None),
               key=lambda n: periodic_work(next(c for m, c, _ in cores if m == n))["slots"])
    out = {"periodic_block_ell_matvec": [], "block_ell_matmul_xresd": []}
    for B in (1, 8, 32):
        r = measure_periodic(be, knet, xcs[B], name, peaks, label="VGG16 orth bf16")
        out["periodic_block_ell_matvec"].append(dict(
            r, where="VGG16 orth bf16 %s core, B=%d" % (name, B),
            launches=launches["periodic_block_ell_matvec"]))
    for B in (1, 8, 32):
        core, x = core_input(knet, xcs[B], name)
        fn = be.route(core.tile_ids.shape[1])
        parts = [measure_operand(be, bk, fn, {}, core.tiles, core.tile_ids[a:b],
                                 core.col_blk[a:b], x, "VGG16 orth bf16 %s core %s rows "
                                 "[%d, %d), B=%d" % (name, part, a, b, B), peaks)
                 for part, (a, b) in zip(("head", "tail"), outside_period(core))]
        out[fn.__name__].append(dict(summed(parts), launches=launches[fn.__name__],
                                     where="VGG16 orth bf16 %s core head + tail rows, B=%d"
                                     % (name, B)))
    # AllConvNet conv1: the f32 core's tiles cast to bf16 equal a bf16 conversion's
    aknet, axcs = paths["allconv"]
    core, _ = core_input(aknet, axcs[64], "conv1")
    tiles = core.tiles.to(torch.bfloat16)
    with global_keys(kt, TILE_DTYPE="bfloat16"):
        _, _, knet16 = allconv_keynet(kt)
    core16, _ = core_input(knet16, axcs[64], "conv1")
    same = (core16.tiles.dtype == torch.bfloat16 and torch.equal(core16.tiles, tiles)
            and torch.equal(core16.tile_ids, core.tile_ids)
            and torch.equal(core16.col_blk, core.col_blk))
    log("[kernels] AllConvNet conv1 core: f32 tiles cast to bf16 == TILE_DTYPE='bfloat16' "
        "packing (tiles, tile_ids, col_blk): %s" % same)
    if not same:
        raise AssertionError("AllConvNet conv1: the cast tiles differ from bf16 packing")
    del knet16, core16
    for B in (64, 1024):
        _, x = core_input(aknet, axcs[B], "conv1")
        r = measure_operand(be, bk, be.block_ell_matmul_xresd, {"depth": 4}, tiles,
                            core.tile_ids, core.col_blk, x,
                            "AllConvNet conv1 core, bf16 tiles, B=%d" % B, peaks)
        out["block_ell_matmul_xresd"].append(dict(
            r, where="AllConvNet conv1 core, bf16 tiles, B=%d" % B,
            launches=launches["block_ell_matmul_xresd"]))
    # xres and grid (bench only; their bf16 widens to f32 on the FMA core) at
    # the same operand, B=64, beside the slot walk's row above
    _, x = core_input(aknet, axcs[64], "conv1")
    for fn in (be.block_ell_matmul_xres, be.block_ell_matmul_grid):
        where = "AllConvNet conv1 core, bf16 tiles, B=64"
        r = measure_operand(be, bk, fn, {}, tiles, core.tile_ids, core.col_blk, x, where, peaks)
        out[fn.__name__] = [dict(r, where=where, launches=launches[fn.__name__])]
    for n, rs in out.items():
        log("[kernels] %s bf16: %s" % (n, json.dumps(rs)))
    return out


def head_tail_staged(block_ell, bk, knet, xc, layer, peaks):
    """xres and grid on the head and tail rows of ``layer``'s periodic core
    at B=1 (bytes bound them), summed over both parts: times and bounds,
    and the grid kernel's tile copies against the non-zero slots it walked
    and the unique tiles."""
    import torch
    core, x = core_input(knet, xc, layer)
    total = {}
    for part, (a, b) in zip(("head", "tail"), outside_period(core)):
        ids, cols = core.tile_ids[a:b], core.col_blk[a:b]
        where = "VGG16 orth %s core %s rows [%d, %d), B=%d" % (layer, part, a, b, x.shape[0])
        for fn in (block_ell.block_ell_matmul_xres, block_ell.block_ell_matmul_grid):
            res = measure_operand(block_ell, bk, fn, {}, core.tiles, ids, cols, x, where, peaks)
            t = total.setdefault(fn.__name__, {})
            for k in ("ms", "bound_ms", "tile_copies", "slots_walked"):
                if k in res:
                    t[k] = t.get(k, 0) + res[k]
        g = total["block_ell_matmul_grid"]
        g["unique_tiles"] = g.get("unique_tiles", 0) + int(torch.unique(ids[ids > 0]).numel())
    log("[kernels] xres and grid at VGG16 orth %s core head + tail rows, B=%d: %s"
        % (layer, x.shape[0], json.dumps(total)))


def outside_period(core):
    """The row-block ranges of a periodic core that the slot walk runs:
    [0, s) and [s+P·R, n_rb), the empty ones left out."""
    s, P, R = core.period
    n_rb = core.tile_ids.shape[0]
    return [(a, b) for a, b in ((0, s), (s + P * R, n_rb)) if b > a]


def periodic_work(core, B=1):
    """Slots, FLOPs and least bytes of one periodic mid-section apply at
    batch B: each referenced tile read once, each x block a non-zero slot
    of the mid rows reads once, the f32 output written once, the period's
    ids and the mid rows' column blocks read."""
    import torch
    s, P, R = core.period
    ids = core.tile_ids[s:s + P]
    TM, TN = core.tileshape
    it = core.tiles.element_size()
    nz = int((ids > 0).sum())
    uniq = int(torch.unique(ids[ids > 0]).numel())
    cols = core.col_blk[s:s + P * R].reshape(R, P, -1)
    x_blocks = int(torch.unique(cols[(ids > 0).expand(R, -1, -1)]).numel())
    return dict(slots=nz * R, flops=2.0 * TM * TN * B * R * nz,
                bytes=uniq * TM * TN * it + B * x_blocks * TN * it + B * P * R * TM * 4
                + ids.numel() * 4 + P * R * ids.shape[1] * 4,
                period_tile_bytes=nz * TM * TN * it, unique_tiles=uniq)


def bmm_library_ms(core, x):
    """One torch.bmm in the tile dtype over the pre-gathered x blocks and the
    expanded period tiles, batch P, (R·B, KB·TN) x (KB·TN, TM) — the
    yardstick, timed without its gathers; the port never calls it.  None
    when the gathered operands would not fit the card beside the keyed
    net."""
    import torch
    s, P, R = core.period
    KB = core.tile_ids.shape[1]
    TM, TN = core.tileshape
    B = x.shape[0]
    dt = core.tiles.dtype
    need = core.tiles.element_size() * P * (R * B * KB * TN + KB * TN * TM + R * B * TM)
    free = torch.cuda.mem_get_info()[0]
    if need > 0.8 * free:
        log("[kernels] torch.bmm yardstick at B=%d skipped: its gathered operands "
            "take %.1f GB, %.1f GB free" % (B, need / 1e9, free / 1e9))
        return None, None
    xb = x.to(dt).reshape(B, -1, TN)
    cols = core.col_blk[s:s + P * R].long().reshape(R, P, KB).permute(1, 0, 2)
    b = torch.arange(B, device=x.device)
    Xg = xb[b[None, None, :, None], cols[:, :, None, :]]          # (P, R, B, KB, TN)
    Xg = Xg.reshape(P, R * B, KB * TN)
    Tg = core.tiles[core.tile_ids[s:s + P].long()]                 # (P, KB, TM, TN)
    Tg = Tg.permute(0, 1, 3, 2).reshape(P, KB * TN, TM)
    y = torch.bmm(Xg, Tg)                                          # (P, R*B, TM)
    ms, _ = cuda_ms(lambda: torch.bmm(Xg, Tg), reps=5)
    y = y.reshape(P, R, B, TM).permute(2, 1, 0, 3).reshape(B, -1).float()
    return ms, y


def measure_periodic(block_ell, knet, xc, layer, peaks, label="VGG16 orth"):
    """The periodic kernel on ``layer``'s core of the net ``label`` fed the
    activations of ``xc``: checked against the plain version, timed beside
    it and the torch.bmm yardstick."""
    import torch
    import keynet_tpu_torch as kt
    core, x = core_input(knet, xc, layer)
    B = x.shape[0]
    s, P, R = core.period
    args = (x, core.tiles, core.tile_ids, core.col_blk, s, P, R)
    product = block_ell.product("periodic", core.tiles.dtype)
    tf32 = product == "tf32"
    y = block_ell.periodic_block_ell_matvec(*args)
    with global_keys(kt, PRECISION="highest"):
        ref = block_ell.periodic_block_ell_plain(*args, tf32=tf32)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    where = "%s %s core %s, B=%d" % (label, layer, core.period, B)
    check(err, float(ref.abs().max()), TOL_PRODUCT[product],
          "periodic_block_ell_matvec at " + where)
    ms, _ = cuda_ms(lambda: block_ell.periodic_block_ell_matvec(*args), reps=10)
    with global_keys(kt, PRECISION="highest"):
        plain_ms, _ = cuda_ms(lambda: block_ell.periodic_block_ell_plain(*args, tf32=tf32),
                              reps=3)
    lib_ms, ylib = bmm_library_ms(core, x)
    lib_err = None if ylib is None else float((ylib - ref).abs().max())
    extra = {}
    if tf32 and ylib is not None:   # the yardstick's rounding, beside the IEEE result's
        with global_keys(kt, PRECISION="highest"):
            extra["library_vs_ieee_max_abs_err"] = float(
                (ylib - block_ell.periodic_block_ell_plain(*args)).abs().max())
    del ylib
    work = periodic_work(core, B)
    peak = peaks[{"ieee": "f32"}.get(product, product)]
    t_ops, t_bytes = work["flops"] / peak, work["bytes"] / peaks["bw"]
    bms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log("[kernels] periodic_block_ell_matvec at %s: %s" % (where, json.dumps(dict(
        work, KB=int(core.tile_ids.shape[1]), ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, library_max_abs_err=lib_err, **extra, product=product,
        bound_ms=bms, bound_by=by,
        period_tiles_once_ms=work["period_tile_bytes"] / peaks["bw"] * 1e3,
        achieved_tflops=work["flops"] / ms / 1e9))))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def periodic_resident_blocks(block_ell, knet, xc, layer):
    """The periodic kernel on ``layer``'s core launched with launch_plan's
    shared memory and with 120,000 B, which leaves room for one block an SM
    (228 KB a multiprocessor): its time and the rate at which it streams the
    per-slot period tiles, as the blocks an SM can hold change.  The output
    must not change."""
    import torch
    core, x = core_input(knet, xc, layer)
    s, P, R = core.period
    args = (x, core.tiles, core.tile_ids, core.col_blk, s, P, R)
    plan_fn = block_ell.launch_plan
    plan = plan_fn(R * x.shape[0], P * core.tileshape[0], *core.tileshape,
                   core.tiles.dtype, kernel="periodic")
    tile_bytes = periodic_work(core, x.shape[0])["period_tile_bytes"]
    res = {"BT": plan["BT"]}
    y = block_ell.periodic_block_ell_matvec(*args)
    for smem in (plan["smem"], 120000):
        block_ell.launch_plan = lambda *a, **k: dict(plan_fn(*a, **k), smem=smem)
        try:
            if not torch.equal(block_ell.periodic_block_ell_matvec(*args), y):
                raise AssertionError("periodic kernel at %d B of shared memory: another "
                                     "output" % smem)
            ms = cuda_ms(lambda: block_ell.periodic_block_ell_matvec(*args), reps=10)[0]
        finally:
            block_ell.launch_plan = plan_fn
        res["smem %d" % smem] = {"ms": ms, "period_tile_TBps": tile_bytes / ms / 1e9}
    log("[kernels] periodic_block_ell_matvec at VGG16 orth %s core %s, B=%d, by shared "
        "memory asked: %s" % (layer, core.period, x.shape[0], json.dumps(res)))


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


# --------------------------------------------------------------- slice 6
def log_routes(tag, sensor, knet, what=""):
    pre = "[%s] %s" % (tag, what + ": " if what else "")
    log("%sroute sensor: %s" % (pre, route_str(sensor.op())))
    for name, l in knet.layers().items():
        if l != "relu":
            log("%sroute %s: %s" % (pre, name, route_str(l.op())))


def phase_train(kt, block_ell):
    """Slice 6, the paper's workflow (the counts set to 0 just before and
    read just after): train AllConvNet(seed=1) at 3x32x32 on synthetic
    CIFAR-10 with the CIFAR recipe (SGD lr 0.01, momentum 0.9, weight decay
    1e-3; keynet_tpu/train.py:3-6) for 20 steps at B=128 (the loss over the
    20 batches must fall); key it with bench.py's second configuration
    (StochasticKeynet alpha 2, blocksize 8, seed 0); validate plain against
    keyed on 512 synthetic test images at
    B=128 (equal accuracies, logits within 1e-5*max(1, scale)); publish it
    with save_keynet and serve it with load_keynet(device="cuda"), whose
    forward must be bitwise equal.  The keyed conv1 core (KB 16) launches
    block_ell_matmul_xresd."""
    import numpy as np
    import torch
    block_ell.reset_launches()
    net = kt.models.AllConvNet(seed=1)
    x, y = kt.datasets.load_cifar10(root=None, synthetic_n=20 * 128)
    params = kt.train.params_tree(net, "cuda")
    step = kt.train.make_train_step(net, *kt.train.make_optimizer(
        params, lr=0.01, momentum=0.9, weight_decay=1e-3))
    train = [(torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda())
             for xb, yb in kt.datasets.batches(x, y, batch_size=128)(0)]

    def train_loss():
        """The loss over the 20 training batches (no step)."""
        with torch.no_grad():
            return statistics.mean(float(kt.train.log_softmax_nll(
                net.forward(xb, params=params), yb)) for xb, yb in train)
    before = train_loss()
    losses, step_ms = [], []
    for xb, yb in train:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(params, xb, yb)
        b.record()
        b.synchronize()
        losses.append(float(loss))
        step_ms.append(a.elapsed_time(b))
    after = train_loss()
    net.params = {k: {kk: v.detach().cpu().numpy() for kk, v in d.items()}
                  for k, d in params.items()}
    log("[train] AllConvNet CIFAR-10 recipe, %d steps at B=128: %s" % (len(losses), json.dumps(
        dict(first_loss=losses[0], last_loss=losses[-1], losses=losses,
             train_loss_before=before, train_loss_after=after,
             ms_per_step_median=statistics.median(step_ms), first_step_ms=step_ms[0],
             steps_2_on_ms_mean=statistics.mean(step_ms[1:])))))
    # From this init the net sits near ln 10 for many more than 20 steps, so a
    # step's loss is mostly the noise of its batch: the check is the loss
    # over the batches trained on, before and after.
    if not (len(losses) == 20 and np.isfinite(losses).all() and after < before):
        raise AssertionError("[train] the loss over the training batches did not fall: "
                             "%.7f -> %.7f" % (before, after))

    t = time.perf_counter()
    sensor, knet = kt.StochasticKeynet((3, 32, 32), net, alpha=2, blocksize=8, seed=0,
                                       device="cuda")
    knet._build()
    log("[train] keyed the trained net (StochasticKeynet alpha 2, blocksize 8, seed 0): "
        "%.1f s conversion" % (time.perf_counter() - t))
    log_routes("train", sensor, knet)

    xt, yt = kt.datasets.load_cifar10(root=None, train=False, synthetic_n=512)
    test = list(kt.datasets.batches(xt, yt, batch_size=128, shuffle=False)(0))
    acc_plain = kt.train.validate(net, test, verbose=False, device="cuda")
    acc_keyed = kt.train.validate(net, test, secret_sensor=sensor, secret_knet=knet,
                                  verbose=False)
    worst = 0.0
    for xb, _ in test:
        yk = knet.forward(sensor.fromtensor(xb).encrypt().tensor())
        ys = net.forward(xb, device="cuda")
        err, scale = float((yk - ys).abs().max()), float(ys.abs().max())
        check(err, scale, TOL_F32, "[train] keyed vs plain logits")
        worst = max(worst, err / max(1.0, scale))
    log("[train] validate on %d test images: plain %.6f, keyed %.6f; logits worst "
        "max|diff|/max(1, scale) %.3g" % (len(test) * 128, acc_plain, acc_keyed, worst))
    if acc_plain != acc_keyed:
        raise AssertionError("[train] keyed accuracy %r != plain %r" % (acc_keyed, acc_plain))

    path = os.path.join(ROOT, "build", "bundles", "allconv_trained.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = time.perf_counter()
    kt.save_keynet(path, knet)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    _, served = kt.load_keynet(path, device="cuda")
    served._build()
    load_s = time.perf_counter() - t
    xc = sensor.fromtensor(test[0][0]).encrypt().tensor()
    if not torch.equal(served.forward(xc), knet.forward(xc)):
        raise AssertionError("[train] the loaded bundle's forward is not bitwise equal")
    log("[train] save_keynet %.2f s, %d bytes; load_keynet(device='cuda') %.2f s; the "
        "served forward is bitwise equal at B=128" % (save_s, os.path.getsize(path), load_s))
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[train] launches: %s" % json.dumps(launches))
    if launches["block_ell_matmul_xresd"] <= 0:
        raise AssertionError("block_ell_matmul_xresd was not launched on the slice-6 path")
    return launches


def small_tile_keynet(kt, t):
    """Keynet(tileshape=(t, t)) on the card: for t = 4 and 32 a 3x32x32 net
    (DENSE_MAX_BYTES 64 KiB) whose conv2, and at t = 4 conv1, packs as
    Block-ELL with t x t tiles; for t = 16 a narrow VGG-shaped 3x56x56 net
    streamed into periodic cores of 16 x 16 tiles (as tests/test_torch_card.py
    keys them).  Returns (source net, sensor, keyed net)."""
    m = kt.models
    if t == 16:
        net = m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                       m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                       m.AvgPool2d("pool2", 3, 2),
                       m.Conv2d("conv3", 8, 8, 3), m.ReLU("relu3"),
                       m.Linear("fc4", 8 * 28 * 28, 10)], inshape=(3, 56, 56), seed=5)
        with global_keys(kt, STREAM_NNZ=1000, KRON_FACTORED="never", POOL_FACTOR_MIN_N=1):
            return (net,) + kt.Keynet((3, 56, 56), net, tileshape=(16, 16), blocksize=16,
                                      local_geometric="givens_orthogonal", alpha=2.0,
                                      local_photometric="uniform_random_affine", beta=1.0,
                                      gamma=1.0, seed=0, device="cuda")
    net = m.Model([m.Conv2d("conv1", 3, 4, 3), m.ReLU("relu1"),
                   m.Conv2d("conv2", 4, 4, 3), m.ReLU("relu2"),
                   m.AvgPool2d("pool2", 3, 2),
                   m.Linear("fc1", 4 * 16 * 16, 10)], inshape=(3, 32, 32), seed=1)
    with global_keys(kt, DENSE_MAX_BYTES=1 << 16):
        return (net,) + kt.Keynet((3, 32, 32), net, tileshape=(t, t), blocksize=t,
                                  local_photometric="uniform_random_affine", beta=1.0,
                                  gamma=1.0, seed=0, device="cuda")


def phase_tiled(kt, block_ell):
    """Slice 6, Block-ELL tiles that are not multiples of 128 (the counts set
    to 0 just before and read just after): TiledOrthogonalKeynet on
    LeNet_AvgPool at 1x28x28, tilesize 14 (DENSE_MAX_BYTES 1 MiB, so conv2
    packs as Block-ELL with 16x16 tiles), and Keynet(tileshape=(t, t)) for
    t = 4, 32 and 16 (periodic) at B=64 (the periodic one also at B=8, where
    its mid-sections take the period route); keyed == source within
    1e-5*max(1, scale), every such core routed to the einsum."""
    import torch
    nets = []
    t = time.perf_counter()
    with global_keys(kt, DENSE_MAX_BYTES=1 << 20):
        lenet = kt.models.LeNet_AvgPool(seed=0)
        nets.append(("TiledOrthogonalKeynet LeNet_AvgPool tilesize 14", (lenet,) +
                     kt.TiledOrthogonalKeynet((1, 28, 28), lenet, tilesize=14, seed=0,
                                              device="cuda"), (64,)))
    for tile in (4, 32, 16):
        nets.append(("Keynet tileshape (%d, %d)" % (tile, tile), small_tile_keynet(kt, tile),
                     (64, 8) if tile == 16 else (64,)))
    log("[tiled] conversions: %.1f s" % (time.perf_counter() - t))
    block_ell.reset_launches()
    for label, (net, sensor, knet), batches in nets:
        log_routes("tiled", sensor, knet, label)
        cores = block_ell_cores(sensor, knet)
        small = [c for _, c, _ in cores if c.tileshape[0] % 128 or c.tileshape[1] % 128]
        if not small or any(entries_of(c, B) for c in small for B in batches):
            raise AssertionError("[tiled] %s: no einsum-routed sub-128 core" % label)
        for B in batches:
            keyed_vs_source(kt, net, sensor, knet, B, 200 + B, label, tag="tiled")
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[tiled] launches: %s" % json.dumps(launches))
    return launches


def phase_vgg_identity(kt, block_ell):
    """Slice 6, the identity recipe of scripts/run_vgg_identity_224.py:32 at
    3x224x224 (VGG16(seed=5), IdentityKeynet seed 0; the counts set to 0 just
    before and read just after): every conv and pool routes to DirectConvOp
    and fc6-8 to DenseOp; keyed == source within 1e-5*max(1, scale) at B=1,
    8 and 32, with the forward times."""
    import torch
    net = kt.models.VGG16(seed=5)
    t = time.perf_counter()
    sensor, knet = kt.IdentityKeynet((3, 224, 224), net, seed=0, device="cuda")
    knet._build()
    log("[vgg-identity] conversion: %.2f s (host), nnz %d, device_bytes %d"
        % (time.perf_counter() - t, knet.num_parameters(), knet.device_bytes()))
    log_routes("vgg-identity", sensor, knet)
    for name, l in knet.layers().items():
        want = "DenseOp" if name.startswith("fc") else "DirectConvOp"
        if l != "relu" and type(l.op()).__name__ != want:
            raise AssertionError("[vgg-identity] %s routes to %s, want %s"
                                 % (name, type(l.op()).__name__, want))
    block_ell.reset_launches()
    for B in (1, 8, 32):
        keyed_vs_source(kt, net, sensor, knet, B, 300 + B, "VGG16 identity",
                        reps=5 if B < 32 else 3, tag="vgg-identity")
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[vgg-identity] launches: %s" % json.dumps(launches))
    return launches


# --------------------------------------------------------------- slice 7
# The stochastic recipe of scripts/run_vgg_stochastic_224.py:39-46.
STOCH_RECIPE = dict(global_geometric="hierarchical_permutation",
                    hierarchical_blockshape=(2, 2), hierarchical_permute_at_level=(0, 1, 2),
                    local_geometric="doubly_stochastic", alpha=2.0, blocksize=14,
                    local_photometric="uniform_random_affine", beta=1.0, gamma=1.0,
                    memoryorder="channel", seed=0)
_KRON = "Chain[KroneckerOp, TapSumOp, KroneckerOp]"
_SPLIT_KRON = "Chain[RepeatedBlockDiagOp, KroneckerOp, TapSumOp, KroneckerOp]"
_SPLIT_MASKED = "Chain[RepeatedBlockDiagOp, EllOp, PermutedBlockSparseOp]"
# keynet_tpu's route per layer for this recipe at 3x224x224 (route_kinds of
# each layer's op): the masked streamed chains of conv1_1 and conv2_1 (the
# dense-inverse split, the F2 EllOp mask factor, the core), conv3_1 on the
# wide-range Kron gate, conv4_x/conv5_x Kron chains (split where the input
# key has dense inverse blocks), the other convs streamed, the pools
# channel-broadcast (ELL spatial factors where the output key carries the
# global permutation: pool1_2, pool2_2), fc6-8 dense
# (docs/SERVING.md:160-174, docs/STATUS_R3.md:34-37); the host code that
# decides them is the JAX package's, held equal layer by layer at 3x56x56 by
# tests/test_torch_vgg_stochastic.py.
STOCH_ROUTES = {
    "sensor": "BlockSparseOp",
    "conv1_1": _SPLIT_MASKED, "conv1_2": "PermutedBlockSparseOp",
    "pool1_2": "ChannelBroadcastOp[EllOp]",
    "conv2_1": _SPLIT_MASKED, "conv2_2": "PermutedBlockSparseOp",
    "pool2_2": "ChannelBroadcastOp[EllOp]",
    "conv3_1": _SPLIT_KRON, "conv3_2": "PermutedBlockSparseOp",
    "conv3_3": "PermutedBlockSparseOp", "pool3_3": "ChannelBroadcastOp[DenseOp]",
    "conv4_1": _SPLIT_KRON, "conv4_2": _KRON, "conv4_3": _KRON,
    "pool4_3": "ChannelBroadcastOp[DenseOp]",
    "conv5_1": _SPLIT_KRON, "conv5_2": _KRON, "conv5_3": _KRON,
    "pool5_3": "ChannelBroadcastOp[DenseOp]",
    "fc6": "DenseOp", "fc7": "DenseOp", "fc8": "DenseOp"}
# The same recipe with TILE_DTYPE='bfloat16' (run_vgg_stochastic_224.py
# --tile-dtype bfloat16).  Two gates read the tile itemsize, and neither
# changes a layer's route at 224: the grouped-row plan's slot bytes
# (ROWGROUP_MIN_SLOT_BYTES) and the schedule decide how a core applies, not
# the layer's links (conv1_1's and conv2_1's cores keep the grouped-row
# apply at B = 1, 8, 32 in both dtypes: the grouped kernel with f32 tiles,
# the einsum, to B <= 396 and 520 x itemsize, with bf16 ones), and
# the periodic expansion (PERIODIC_EXPAND_BYTES) is not kept beside
# kernel-routed tiles on the card.  So the table is STOCH_ROUTES; each core's
# apply at B = 1, 8, 32 is printed beside it.  tests/test_torch_bf16.py holds
# the routes and these gates equal to keynet_tpu's in bf16 at 3x56x56.
STOCH_ROUTES_BF16 = dict(STOCH_ROUTES)


def route_kinds(op):
    """An op's link kinds, e.g. 'Chain[RepeatedBlockDiagOp, EllOp, ...]'."""
    from keynet_tpu_torch.ops.operators import ChainedOp, ChannelBroadcastOp
    if isinstance(op, ChainedOp):
        return "Chain[%s]" % ", ".join(route_kinds(o) for o in op.ops)
    if isinstance(op, ChannelBroadcastOp):
        return "ChannelBroadcastOp[%s]" % route_kinds(op.inner)
    return type(op).__name__


def index_bytes_beyond_count(op):
    """Bytes of the port's index tensors past what device_bytes() counts for
    them (keynet_tpu's count, which holds them as int32): the layout
    permutations of PermutedBlockSparseOp, the grouped-row plan (its int32
    patterns and rows, less the count of keynet_tpu's patterns, column
    blocks and order: negative), and the Kronecker gathers (uncounted in
    both packages)."""
    from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChainedOp, ChannelBroadcastOp,
                                                KroneckerOp, PermutedBlockSparseOp)
    if isinstance(op, ChainedOp):
        return sum(index_bytes_beyond_count(o) for o in op.ops)
    if isinstance(op, ChannelBroadcastOp):
        return index_bytes_beyond_count(op.inner)
    if isinstance(op, PermutedBlockSparseOp):
        return 4 * (op.perm_in.numel() + op.perm_out_pos.numel()) \
            + index_bytes_beyond_count(op.inner)
    if isinstance(op, BlockSparseOp) and op._rgroups is not None:
        n_rb, KB = op.tile_ids.shape
        return 4 * sum(t.numel() for t in op._rgroups) \
            - 4 * (sum(G for _, G in op._rgroup_meta) * KB + n_rb * KB + n_rb)
    if isinstance(op, KroneckerOp):
        return 8 * sum(p.numel() for p in (op.perm_in, op.perm_out) if p is not None)
    return 0


def device_memory(tag, label, sensor, knet, before):
    """Print torch.cuda.memory_allocated() taken by a keyed net (sensor and
    net; ``before`` is the count before either was built) beside
    device_bytes() of the published ops, that of the run plan's ops (the
    card holds the plan: a folded chain's links stay on the host) and the
    int64 index bytes that count leaves out."""
    import torch
    knet._build()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    counted = knet.device_bytes() + sensor.device_bytes()
    plan = sum(op.device_bytes() for op in knet._ops) + sensor.device_bytes()
    extra = index_bytes_beyond_count(sensor.op()) + sum(
        index_bytes_beyond_count(op) for op in knet._ops)
    res = dict(memory_allocated=held, device_bytes=counted, plan_device_bytes=plan,
               gap=held - plan, int64_index_bytes_beyond_count=extra,
               gap_unexplained=held - plan - extra)
    log("[%s] %s device memory: %s" % (tag, label, json.dumps(res)))
    return res


def stochastic_keynet(kt, tile_dtype="float32"):
    """VGG16(seed=5) keyed with the stochastic recipe at 3x224x224, tiles in
    ``tile_dtype``: (source net, keyed sensor, keyed net, conversion
    seconds)."""
    net = kt.models.VGG16(seed=5)
    t = time.perf_counter()
    with global_keys(kt, TILE_DTYPE=tile_dtype):
        sensor, knet = kt.Keynet((3, 224, 224), net, device="cuda", **STOCH_RECIPE)
    return net, sensor, knet, time.perf_counter() - t


def phase_vgg_stochastic(kt, block_ell, bf16=False):
    """Slice 7, the stochastic VGG-16 at 3x224x224 (f32 tiles): conversion
    seconds (total and per layer), peak host RSS, nnz, device_bytes() beside
    torch.cuda.memory_allocated(); every layer's route held against
    keynet_tpu's (STOCH_ROUTES), each Block-ELL core's shape, KB, unique
    tiles, period and its apply (grouped-row einsum, slot walk or periodic
    kernel) at B=1, 8 and 32; keyed == source within 1e-5*max(1, scale) at
    B=1, 8 and 32 with the counts set to 0 just before and read just after
    (every entry the cores route to must have launched, and one at least);
    per-link ms at B=1 and 32 and a trace of the B=1 forward.  A route that
    differs from the table raises at the end of the phase.  ``bf16``: slice
    10's --only vgg-stochastic-bf16, the same with TILE_DTYPE='bfloat16',
    keyed vs source within TOL_SERVE_BF16, routes against
    STOCH_ROUTES_BF16, no trace."""
    import gc
    import resource
    import torch
    gc.collect()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    alloc0 = torch.cuda.memory_allocated()
    tag, label = ("vgg-stochastic-bf16", "VGG16 stochastic bf16") if bf16 \
        else ("vgg-stochastic", "VGG16 stochastic")
    table = STOCH_ROUTES_BF16 if bf16 else STOCH_ROUTES
    net, sensor, knet, secs = stochastic_keynet(kt, "bfloat16" if bf16 else "float32")
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    layer_s = {k: round(v, 2) for k, v in knet.layer_seconds.items()}
    log("[%s] conversion: %.1f s (host); per layer %s; sensor and the rest "
        "%.1f s; peak host RSS %.2f GiB (%.2f GiB before); nnz %d"
        % (tag, secs, json.dumps(layer_s),
           secs - sum(knet.layer_seconds.values()), rss1, rss0, knet.num_parameters()))
    device_memory(tag, label, sensor, knet, alloc0)
    log_routes(tag, sensor, knet)
    wrong = {}
    for name, op in [("sensor", sensor.op())] + [(k, l.op()) for k, l in knet.layers().items()
                                                 if l != "relu"]:
        if route_kinds(op) != table[name]:
            wrong[name] = (route_kinds(op), table[name])
    cores = block_ell_cores(sensor, knet)
    for name, c, per_image in cores:
        log("[%s] core %s: %s" % (tag, name, json.dumps(dict(
            shape=list(c.shape), rows=int(c.tile_ids.shape[0]), KB=int(c.tile_ids.shape[1]),
            unique_tiles=int(c.tiles.shape[0]), period=c.period,
            nonzero_slots=int((c.tile_ids > 0).sum()), tiles=str(c.tiles.dtype),
            grouped_row_plan=None if c._rgroups is None else dict(
                buckets=len(c._rgroup_meta), patterns=sum(G for _, G in c._rgroup_meta),
                tile_gather_bytes=sum(G for _, G in c._rgroup_meta) * c.tile_ids.shape[1]
                * c.tileshape[0] * c.tileshape[1] * c.tiles.element_size()),
            apply={"B=%d" % B: core_apply(c, B * per_image) for B in (1, 8, 32)}))))

    block_ell.reset_launches()
    xcs, forwards = {}, {}
    for B in (1, 8, 32):
        xcs[B], forwards[B] = keyed_vs_source(kt, net, sensor, knet, B, 400 + B, label,
                                              reps=5 if B < 32 else 3, tag=tag,
                                              tol=TOL_SERVE_BF16 if bf16 else TOL_F32)
    torch.cuda.synchronize()
    launches = dict(block_ell.LAUNCHES)
    log("[%s] launches: %s" % (tag, json.dumps(launches)))
    transient = {}
    for B in (1, 32):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        knet.forward(xcs[B])
        torch.cuda.synchronize()
        transient["B=%d" % B] = torch.cuda.max_memory_allocated() - base
    log("[%s] device memory a forward takes beyond what the net holds (its "
        "activations and transients, the grouped-row tile gathers among them): %s"
        % (tag, json.dumps(transient)))
    routed = sorted(set().union(*(entries_of(c, B * m) for _, c, m in cores
                                  for B in forwards)))
    log("[%s] entries routed by the driven Block-ELL cores: %s" % (tag, routed))
    if not routed:
        raise AssertionError("no Block-ELL core of the %s routes to a kernel" % label)
    for name in routed:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the %s path" % (name, label))
    never_routed(launches, "the %s path" % label)
    for B in (1, 32):
        layer_breakdown(label, knet, xcs[B])
    if not bf16:
        trace_forward(kt, knet, xcs[1], "vgg_stochastic_forward_B1")
    if wrong:
        raise AssertionError("[%s] routes differ from keynet_tpu's: %s"
                             % (tag, json.dumps(wrong)))
    return {tag: (knet, xcs, cores)}, launches


def core_apply(core, rows):
    """How BlockSparseOp.apply runs ``core`` for ``rows`` rows on the card:
    the kernel entries its schedule launches, or the einsum it takes
    instead."""
    import torch
    steps = core.schedule(rows, torch.device("cuda"))
    entries = {step.entry for step in steps if step.entry}
    if entries:
        return sorted(entries)
    if any(step.kind == "grouped" for step in steps):
        return "grouped-row einsum"     # bf16 tiles or 'default'
    return "einsum (sub-128 tiles)"


def stochastic_kernel_rows(block_ell, bk, knet, xcs, cores, peaks, label="VGG16 stochastic"):
    """The kernel at the largest Block-ELL core of the stochastic VGG that
    routes to the slot walk or the periodic kernel (by non-zero slots, a
    conv's core), at B=1, 8 and 32: kernel, plain and library times and the
    bound, as phase_kernels' rows (grouped_kernel_rows times the grouped
    kernel)."""
    from keynet_tpu_torch.ops.operators import PermutedBlockSparseOp
    convs = {k for k, l in knet.layers().items() if l != "relu"
             and any(isinstance(o, PermutedBlockSparseOp) for o in getattr(l.op(), "ops",
                                                                          [l.op()]))}
    name, core = max(((n, c) for n, c, m in cores if n in convs
                      and any(entries_of(c, B) - {"grouped_block_ell_matmul"}
                              for B in (1, 8, 32))),
                     key=lambda nc: int((nc[1].tile_ids > 0).sum()))
    out = {}
    for B in (1, 8, 32):
        entries = entries_of(core, B)
        if "periodic_block_ell_matvec" in entries:
            out[B] = measure_periodic(block_ell, knet, xcs[B], name, peaks, label=label)
            continue
        c, x = core_input(knet, xcs[B], name)
        fn = block_ell.route(c.tile_ids.shape[1])
        out[B] = measure_operand(block_ell, bk, fn, {}, c.tiles, c.tile_ids, c.col_blk, x,
                                 "%s %s core, B=%d" % (label, name, B), peaks)
    log("[kernels] %s: the largest kernel-routed core is %s's %s, KB %d"
        % (label, name, tuple(core.tile_ids.shape), core.tile_ids.shape[1]))
    return name, out


def grouped_kernel_rows(block_ell, bk, knet, xcs, cores, peaks, label="VGG16 stochastic"):
    """The grouped kernel at each core of the net's layers whose grouped-row
    apply launches it, at B=1, 8 and 32 on the operand the forward feeds it:
    checked against the grouped einsum (the plain version), and timed with
    it, the library (torch.bmm a bucket over pre-gathered (G, m·B, KB·TN) x
    and (G, KB·TN, TM) tiles, gathers untimed) and the slot walk beside the
    bound (bench_kernels.work); returns {(layer, B): row}."""
    import torch
    from keynet_tpu_torch.profiling import GROUPED_ROWS
    out = {}
    for name, core, _ in cores:
        if name not in knet.layers() or \
                "grouped_block_ell_matmul" not in entries_of(core, 32):
            continue
        for B in (1, 8, 32):
            c, x = core_input(knet, xcs[B], name)
            TM, TN = c.tileshape
            n_rb = c.tile_ids.shape[0]
            xb = x.reshape(B, -1, TN)
            step = c.schedule(B, x.device)[0]    # the grouped kernel's, as at B=32
            plain = step._replace(entry=None)
            walk = block_ell.route(c.tile_ids.shape[1])
            block_ell.reset_launches()
            chunks = GROUPED_ROWS["chunks"]
            y = c.run_step(step, x)
            launches = GROUPED_ROWS["chunks"] - chunks
            ref = c.run_step(plain, x)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            where = "%s %s core %s, B=%d" % (label, name, tuple(c.tile_ids.shape), B)
            check(err, float(ref.abs().max()), TOL_PRODUCT["ieee"],
                  "grouped kernel at " + where)
            if launches != block_ell.LAUNCHES["grouped_block_ell_matmul"] or \
                    not torch.equal(y, c.run_step(step, x)):
                raise AssertionError("grouped kernel at %s: %d launches counted %d, or a "
                                     "rerun differs" % (where, launches, block_ell.LAUNCHES[
                                         "grouped_block_ell_matmul"]))
            del y, ref
            patterns, rws = (t.long() for t in c._rgroups)
            ops, p0, r0 = [], 0, 0
            for m, G in c._rgroup_meta:
                cols = c.col_blk[rws[r0:r0 + G * m]].long().reshape(G, m, -1)
                X = xb[:, cols].permute(1, 2, 0, 3, 4).reshape(G, m * B, -1)
                T = c.tiles[patterns[p0:p0 + G]].permute(0, 1, 3, 2).reshape(G, -1, TM)
                ops.append((X.contiguous(), T.contiguous()))
                p0, r0 = p0 + G, r0 + G * m
            lib_ms, _ = cuda_ms(lambda: [torch.bmm(a, b) for a, b in ops], reps=5)
            del ops
            w = bk.work(c.tile_ids, c.col_blk, TM, TN, n_rb * TM, B, c.tiles.element_size(),
                        peaks)
            r = dict(max_abs_err=err, launches=launches,
                     ms=cuda_ms(lambda: c.run_step(step, x), reps=10)[0],
                     plain_ms=cuda_ms(lambda: c.run_step(plain, x), reps=5)[0],
                     library_ms=lib_ms, slot_walk_ms=cuda_ms(
                         lambda: walk(x, c.tiles, c.tile_ids, c.col_blk, n_rb * TM),
                         reps=3)[0],
                     bound_ms=w["bound_ms"], bound_by=w["bound_by"])
            r["roofline_pct"] = 100.0 * r["bound_ms"] / r["ms"]
            log("[kernels] grouped_block_ell_matmul at %s: %s" % (where, json.dumps(r)))
            out[name, B] = r
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- slice 8
PARALLEL_SHAPE = (2, 2)   # (dp, tp): four ranks on the one card
PARALLEL_DEADLINE = 600   # seconds for the four ranks to import, convert and check
SHARED = "4 ranks sharing one card over gloo, not a multi-card time"


class fed_operands:
    """While active, records what a forward feeds the slot walk and the
    periodic steps of the BlockSparseOp cores of ``owned`` ((owner, core)
    pairs: a TpShardedBlockEllOp and its local core, or a layer name and its
    core) through run_step: (owner, core, the step, the padded x), copied as
    the core hands them on."""

    def __init__(self, owned):
        self.owned, self.calls = list(owned), []

    def __enter__(self):
        for owner, core in self.owned:

            def run(step, x, owner=owner, core=core, run_step=core.run_step):
                if step.kind != "grouped":      # grouped_kernel_rows holds that kernel
                    self.calls.append((owner, core, step, x.clone()))
                return run_step(step, x)
            core.run_step = run
        return self

    def __exit__(self, *exc):
        for _, core in self.owned:
            del core.run_step


def hold_fed(block_ell, calls, what):
    """Each recorded kernel operand through the entry its step names (under
    the caller's PRECISION) and through the kernel's plain version (in
    'highest': IEEE f32 sums of the product's operands), held within the
    parity phase's tolerance for the product; returns (entry, line) a call.
    Steps that name no entry (sub-128 tiles, the CPU) have no kernel to
    hold."""
    import keynet_tpu_torch as kt
    lines = []
    for owner, core, step, x in calls:
        if step.entry is None:
            continue
        TM = core.tileshape[0]
        fn = getattr(block_ell, step.entry)
        if step.kind == "periodic":
            args = (x, core.tiles, core.tile_ids, core.col_blk, *core.period)
            ref = block_ell.periodic_block_ell_plain
        else:
            a, b = step.a, step.b
            args = (x, core.tiles, core.tile_ids[a:b], core.col_blk[a:b], (b - a) * TM)
            ref = block_ell.block_ell_plain
        product = block_ell.product(step.entry, core.tiles.dtype)
        y = fn(*args)
        with global_keys(kt, PRECISION="highest"):
            want = ref(*args, tf32=product == "tf32")
        sync(x.device)
        err, scale = float((y - want).abs().max()), float(want.abs().max())
        tol = TOL_PRODUCT[product]
        check(err, scale, tol, "%s%s: %s vs its plain version"
              % ("" if isinstance(owner, str) else "[parallel] ", what, step.entry))
        if isinstance(owner, str):
            zero = "%s, %s tiles, %s" % (owner, str(core.tiles.dtype).replace("torch.", ""),
                                         product)
        else:
            zero = "a zero tile put first, ids shifted" if owner.zero_tile_added \
                else "local id 0 the zero tile"
        span = step.kind if step.kind == "periodic" else "%d-%d" % step[1:3]
        lines.append((step.entry, "%s: %s at the forward's operand (B=%d, row-blocks %s of "
                      "%d, KB %d, %d tiles, %s), max|diff| %.3g vs the plain version "
                      "(scale %.3g)" % (what, step.entry, x.shape[0], span,
                                        core.tile_ids.shape[0], core.tile_ids.shape[1],
                                        core.tiles.shape[0], zero, err, scale)))
    return lines


def parallel_rank(rank, world, device="cuda"):
    """One rank of the [parallel] phase (spawned by kt.parallel.launch,
    sharing cuda:0 with the others over gloo): the sections of
    __graft_entry__.dryrun_multichip (:100-302) on the port.  Every operand
    a sharded forward feeds a Block-ELL kernel is also run through that
    kernel and its plain version (hold_fed).  Returns (log lines, the
    kernel launches of the sharded forwards, the entries their Block-ELL
    shards route to on the card, the operands held, bytes, section seconds).
    ``device="cpu"`` rehearses it on the CPU (the kernels' plain versions)."""
    import hashlib
    import numpy as np
    import scipy.sparse
    import torch
    dev = torch.device(device)
    import keynet_tpu_torch as kt
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_parallel_ranks as ranks   # the dryrun's toy nets, as the tests build them
    from keynet_tpu_torch.ops import block_ell
    from keynet_tpu_torch.ops import operators as O
    from keynet_tpu_torch.parallel import sharding as S
    kt.globals.precision("highest")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        block_ell.build()     # the parent built them: this loads build/kernels/
    mesh = S.Mesh(PARALLEL_SHAPE, ("dp", "tp"), device=dev)
    dp = mesh.size("dp")
    lines, secs, routed, fed = [], {}, set(), []
    launches = {n: 0 for n in block_ell.ENTRIES}
    say = lambda s: lines.append(s)

    def sharded(fn, *args, tps=(), what=None):
        """fn(*args) with its kernel launches counted for the path; the
        operands it feeds the Block-ELL kernels of the sharded ops ``tps``
        then go through each kernel and its plain version (hold_fed; those
        launches are not counted)."""
        sync(dev)
        before = dict(block_ell.LAUNCHES)
        with fed_operands((tp, tp.local) for tp in tps) as rec:
            out = fn(*args)
        sync(dev)
        for n in launches:
            launches[n] += block_ell.LAUNCHES[n] - before[n]
        unfed = [tp for tp in tps if any(step.entry for step in tp.local.schedule(1, dev))
                 and not any(c[0] is tp for c in rec.calls)]
        if unfed:
            raise AssertionError("[parallel] %s: %d kernel-routed shards of the plan were "
                                 "not applied by the forward" % (what, len(unfed)))
        fed.extend(hold_fed(block_ell, rec.calls, what))
        return out

    def held(y, ref, what, tol=1e-4):
        err, scale = float((y - ref).abs().max()), float(ref.abs().max())
        check(err, scale, tol, "[parallel] rank %d %s" % (rank, what))
        return err

    def route(plan, B):
        for tp in S.tp_block_ops(plan):
            routed.update(entries_of(tp.local, B // dp))

    # (a) the full-width cell: StochasticKeynet AllConvNet at bench's config
    t = time.perf_counter()
    net = kt.models.AllConvNet(seed=1)
    sensor, knet = kt.StochasticKeynet((3, 32, 32), net, alpha=2, blocksize=8, seed=0,
                                       device=dev)
    h = hashlib.sha1()
    for op in [sensor.op()] + knet.published_ops():
        for k, v in sorted(op.arrays().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    digests = [None] * world
    torch.distributed.all_gather_object(digests, h.hexdigest())
    if len(set(digests)) != 1:
        raise AssertionError("[parallel] the ranks' conversions differ: %s" % digests)
    say("AllConvNet conversion %.1f s on each rank; packed arrays' sha1 %s on all %d "
        "ranks" % (time.perf_counter() - t, digests[0][:16], world))
    f = S.keyed_forward_dp_tp(knet, mesh)
    plan = f.ops
    names = [n for n, l in knet.layers().items() if l != "relu"]
    routes = dict(zip(names, map(ranks.decision, plan)))
    for name in names:
        say("%s: %s" % (name, routes[name]))
    if "PermutedBlockSparseOp(TpShardedBlockEllOp)" not in routes["conv1"]:
        raise AssertionError("[parallel] conv1's Block-ELL did not shard: %s" % routes["conv1"])
    for name in ("conv2", "conv3", "conv4", "conv5"):
        if "TpShardedTapSumOp" not in routes[name]:
            raise AssertionError("[parallel] %s's chain did not shard: %s" % (name, routes[name]))
    held_bytes = S.plan_local_bytes(plan)
    full_bytes = sum(op.device_bytes() for op in knet.published_ops())
    audit = S.replication_report(plan)
    say("replication_report: %s" % json.dumps(audit))
    if [r for r in audit if r[3] is None]:
        raise AssertionError("[parallel] replicated without a reason: %r" % audit)
    for B in (64, 256):
        x = np.random.default_rng(B).standard_normal((B, 3, 32, 32)).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        xc = sensor.fromtensor(xd).encrypt().tensor()
        ref = knet.run(xc)
        y = sharded(f, xc, tps=S.tp_block_ops(plan), what="AllConvNet conv1 shard")
        err = held(y, ref, "AllConvNet dp x tp B=%d vs single" % B)
        out = kt.homogeneous.linear_to_affine(knet.decrypt(y), None)
        src = net.forward(xd)
        err_src = held(out, src, "AllConvNet dp x tp B=%d keyed vs source" % B, TOL_F32)
        route(plan, B)
        ms = statistics.median(sharded(_wall_ms, dev, f, xc) for _ in range(3))
        ms_single = statistics.median(_wall_ms(dev, knet.run, xc) for _ in range(3))
        say("AllConvNet B=%d: dp x tp vs single max|diff| %.3g, keyed vs source %.3g "
            "(scale %.3g); forward %.3f ms dp x tp, %.3f ms single (%s)"
            % (B, err, err_src, float(src.abs().max()), ms, ms_single, SHARED))
    secs["a AllConvNet"] = time.perf_counter() - t
    del f, plan, knet, sensor

    # (b) one sharded train step against one single-process step: the loss,
    # every leaf's gradient and every updated param; the gradient check must
    # fail each fault planted in the step (ranks.planted_fault)
    t = time.perf_counter()
    net = kt.models.AllConvNet(seed=1)
    xb, yb = kt.datasets.load_cifar10(root=None, synthetic_n=128)
    opt = dict(lr=0.01, momentum=0.9, weight_decay=1e-3)
    loss, p_shard, got, grads = ranks.sharded_step(kt, net, mesh, xb, yb, **opt)
    loss1, single, grads1 = ranks.single_step(kt, net, dev, xb, yb, **opt)
    check(abs(loss - loss1), abs(loss1), TOL_F32, "[parallel] sharded step loss")
    for what, tree, want in (("gradient", grads, grads1), ("param", got, single)):
        leaf, err, bound = ranks.worst_leaf(tree, want, TOL_F32)
        if not err <= bound:
            raise AssertionError("[parallel] sharded step %s %s: max|diff| %.3g > %.3g"
                                 % (what, leaf, err, bound))
    g_leaf, g_err, g_bound = ranks.worst_leaf(grads, grads1, TOL_F32)
    say("train step AllConvNet B=128 (fc1 %s): loss %.7f sharded, %.7f single; gradients "
        "worst leaf %s max|diff| %.3g (bound %.3g); params max|diff| %.3g"
        % (p_shard["fc1"]["weight"], loss, loss1, g_leaf, g_err, g_bound,
           ranks.worst_leaf(got, single, TOL_F32)[1]))
    for fault in ranks.FAULTS:
        _, _, _, bad = ranks.sharded_step(kt, net, mesh, xb, yb, fault=fault, **opt)
        leaf, err, bound = ranks.worst_leaf(bad, grads1, TOL_F32)
        if not err > bound:
            raise AssertionError("[parallel] the gradient check passes the planted fault %s"
                                 % fault)
        say("planted fault %s: gradient check fails as it must, worst leaf %s max|diff| %.3g "
            "> bound %.3g" % (fault, leaf, err, bound))
    secs["b train step"] = time.perf_counter() - t

    # (c)-(g) the dryrun's toy sections, each against the single apply
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    A = scipy.sparse.block_diag([rng.normal(size=(128, 128)).astype(np.float32)
                                 for _ in range(8)], format="csr")
    bop = O.BlockSparseOp.from_scipy(A, tileshape=(128, 128)).to(mesh.device)
    tpop = S.tp_shard_block_op(bop, mesh, "tp")
    xb = torch.from_numpy(rng.normal(size=(4, A.shape[1])).astype(np.float32)).to(dev)
    held(sharded(tpop.apply, xb, tps=[tpop], what="block-diagonal shard"), bop.apply(xb),
         "block-diagonal Block-ELL")
    routed.update(entries_of(tpop.local, 4))
    say("(c) 8 x 128 block-diagonal Block-ELL: %d B of tiles a rank of %d B"
        % (tpop.per_chip_tile_bytes(), bop.device_bytes()))
    C, p, T = 8, 16, 9
    mk = lambda *s: (rng.normal(size=s) / np.sqrt(s[-1])).astype(np.float32)
    chain = O.ChainedOp([O.KroneckerOp(mk(C, C), mk(p, p), mk(C * p)),
                         O.TapSumOp(mk(T, C, C), mk(T, p, p), mk(C * p)),
                         O.KroneckerOp(mk(C, C), mk(p, p), mk(C * p))]).to(mesh.device)
    tpc = S.tp_shard_chain_op(chain, mesh, "tp")
    xk = torch.from_numpy(rng.normal(size=(4, C * p + 1)).astype(np.float32)).to(dev)
    held(sharded(tpc.apply, xk), chain.apply(xk), "Kron/TapSum chain")
    say("(d) Kron/TapSum/Kron chain: %s" % ranks.decision(tpc))
    eop = O.EllOp.from_scipy(scipy.sparse.random(600, 512, density=0.02, random_state=1,
                                                 dtype=np.float32, format="csr")).to(mesh.device)
    tpe = S.TpShardedEllOp.from_ell_op(eop, mesh, "tp")
    xe = torch.from_numpy(rng.normal(size=(4, 512)).astype(np.float32)).to(dev)
    held(sharded(tpe.apply, xe), eop.apply(xe), "EllOp")
    rop = O.RepeatedBlockDiagOp(rng.normal(size=(4, 4)).astype(np.float32),
                                rng.normal(size=64).astype(np.float32), 64).to(mesh.device)
    tpr = S.TpShardedRepeatedBlockDiagOp.from_op(rop, mesh, "tp")
    xr = torch.from_numpy(rng.normal(size=(4, 65)).astype(np.float32)).to(dev)
    held(sharded(tpr.apply, xr), rop.apply(xr), "RepeatedBlockDiagOp")
    say("(e) EllOp %d B a rank of %d B; RepeatedBlockDiagOp over %d ranks"
        % (tpe.per_chip_bytes(), eop.device_bytes(), mesh.size("tp")))
    ls, lk = ranks.stochastic_lenet(kt, dev)
    fl = S.keyed_forward_dp_tp(lk, mesh, min_tp_bytes=1 << 14)
    lplan = fl.ops
    audit = S.replication_report(lplan, min_bytes=1 << 14)
    if [r for r in audit if r[3] is None]:
        raise AssertionError("[parallel] LeNet replicated without a reason: %r" % audit)
    xl = ls.fromtensor(torch.from_numpy(rng.normal(size=(8, 1, 28, 28))
                                        .astype(np.float32)).to(dev)).encrypt().tensor()
    held(sharded(fl, xl, tps=S.tp_block_ops(lplan), what="stochastic LeNet shard"),
         lk.run(xl), "stochastic LeNet_AvgPool dp x tp")
    route(lplan, 8)
    say("(f) stochastic LeNet_AvgPool (STREAM_NNZ 60,000): %s; %d justified "
        "replications" % (", ".join(map(ranks.decision, lplan)), len(audit)))
    sop = ranks.streamed_layer(kt, rng.normal(size=(8, 8, 3, 3)).astype(np.float32),
                               rng.normal(size=8).astype(np.float32)).to(dev)
    tps = S.tp_shard_chain_op(sop, mesh, "tp", max_replication=1.01)
    if tps is None or not S.tp_block_ops([tps]):
        raise AssertionError("[parallel] the streamed chain's Block-ELL did not shard")
    xs = torch.from_numpy(rng.normal(size=(4, sop.shape[1])).astype(np.float32)).to(dev)
    held(sharded(tps.apply, xs, tps=S.tp_block_ops([tps]), what="streamed core shard"),
         sop.apply(xs), "streamed masked chain")
    routed.update(*(entries_of(t.local, 4) for t in S.tp_block_ops([tps])))
    say("(g) streamed masked-chain conv 8x16x16: %s" % ranks.decision(tps))
    secs["c-g toy sections"] = time.perf_counter() - t
    return dict(lines=lines, launches=launches, routed=sorted(routed), fed=fed,
                held_bytes=held_bytes, full_bytes=full_bytes, secs=secs)


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _wall_ms(dev, fn, *args):
    """fn(*args) on the host clock, synchronised (ms)."""
    sync(dev)
    t = time.perf_counter()
    fn(*args)
    sync(dev)
    return 1e3 * (time.perf_counter() - t)


def phase_parallel(kt, block_ell, device="cuda"):
    """Slice 8: four ranks, dp=2 x tp=2, on the one card over gloo
    (parallel_rank).  Logs rank 0's lines, every rank's bytes and the
    sections' seconds; returns the launches summed over the ranks.  Fails
    if a rank fails or misses the deadline, or if an entry the shards route
    to was not launched."""
    world = PARALLEL_SHAPE[0] * PARALLEL_SHAPE[1]
    res = kt.parallel.launch(parallel_rank, world, args=(device,), backend="gloo",
                             deadline=PARALLEL_DEADLINE)
    for line in res[0]["lines"]:
        log("[parallel] %s" % line)
    for r, out in enumerate(res):
        log("[parallel] rank %d holds %d B of keyed ops (shards and replicated ops) beside "
            "device_bytes() %d B of the whole net" % (r, out["held_bytes"], out["full_bytes"]))
    log("[parallel] section seconds on rank 0 (%s): %s" % (SHARED, json.dumps(res[0]["secs"])))
    launches = {n: sum(out["launches"][n] for out in res) for n in block_ell.ENTRIES}
    routed = sorted(set().union(*(out["routed"] for out in res)))
    log("[parallel] launches (4 ranks): %s; routed: %s" % (json.dumps(launches), routed))
    for r, out in enumerate(res):
        for _, line in out["fed"]:
            log("[parallel] rank %d %s" % (r, line))
    unheld = set(routed) - {e for out in res for e, _ in out["fed"]}
    if unheld:
        raise AssertionError("[parallel] no operand of the sharded forwards was held "
                             "against the plain version for %s" % sorted(unheld))
    if "block_ell_matmul_xresd" not in routed:
        raise AssertionError("[parallel] no shard routes to block_ell_matmul_xresd")
    for name in routed:
        if launches[name] <= 0:
            raise AssertionError("%s was not launched on the slice-8 path" % name)
    never_routed(launches, "the slice-8 path")
    return launches


def phase_challenge(kt):
    """Slice 8, [challenge]: a PermutationKeynet LeNet_AvgPool(seed=0)
    written in the 2020 release's pickle format (tests/legacy_challenge.py)
    under build/, loaded with load_challenge on the card, its public
    forward held against the host scipy oracle within 1e-5·max(1, scale)."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import legacy_challenge
    net = kt.models.LeNet_AvgPool(seed=0)
    sensor, knet = kt.PermutationKeynet((1, 28, 28), net, seed=0, device="cuda")
    layers = legacy_challenge.layers_of(knet)
    path = os.path.join(ROOT, "build", "challenge", "keynet_challenge_lenet.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    legacy_challenge.write(path, (1, 28, 28), layers)
    t = time.perf_counter()
    _, served = kt.challenge.load_challenge(path, device="cuda")
    load_s = time.perf_counter() - t
    x = np.random.default_rng(0).standard_normal((64, 1, 28, 28)).astype(np.float32)
    xc = sensor.fromtensor(torch.from_numpy(x).cuda()).encrypt().tensor()
    y = served.forward(xc)
    want = torch.from_numpy(legacy_challenge.oracle(layers, xc.cpu().numpy())).cuda()
    err = float((y - want).abs().max())
    check(err, float(want.abs().max()), TOL_F32, "[challenge] public forward vs scipy oracle")
    log("[challenge] %s (%d B): loaded in %.2f s on %s; nnz %s; B=64 public forward vs the "
        "host scipy oracle max|diff| %.3g" % (
            os.path.relpath(path, ROOT), os.path.getsize(path), load_s, y.device,
            json.dumps({n: l.nnz() for n, l in served.layers().items() if l != "relu"}), err))


# --------------------------------------------------------------- slice 9
def run_child(kt, module_args, what, timeout=900):
    """python -m MODULE ARGS --device cuda in a fresh process: the checkout of
    ``kt`` first on its path, the environment this script started with (no
    variable a phase set since), the kernels loaded from build/kernels/ as
    [build] left them.  Raises on a non-zero exit; returns (stdout, s)."""
    tree = os.path.dirname(os.path.dirname(os.path.abspath(kt.__file__)))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m"] + module_args + ["--device", "cuda"],
                       cwd=tree, env=dict(START_ENV, PYTHONPATH=tree),
                       capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t
    if r.returncode:
        raise AssertionError("%s: %s exited %d:\n%s\n%s" % (
            what, " ".join(module_args), r.returncode, r.stdout[-4000:], r.stderr[-4000:]))
    return r.stdout, secs


def tagged(stdout, tag):
    """The JSON after the last line of ``stdout`` that starts with ``tag``."""
    lines = [l for l in stdout.splitlines() if l.startswith(tag)]
    if not lines:
        raise AssertionError("no %r line in:\n%s" % (tag, stdout[-4000:]))
    return json.loads(lines[-1][len(tag):])


def cold_serve(kt, snap, batches, check, in_process, what):
    """Serve ``snap`` with python -m keynet_tpu_torch.scripts.serve in a cold
    process on the card; its outputs must be bitwise equal to
    ``in_process(B, inputs)``'s and it must launch xresd.  Returns (the
    child's launches, its summary, its seconds)."""
    import numpy as np
    ypath = snap[:-len(".npz")] + "_served.npz"
    out, secs = run_child(kt, ["keynet_tpu_torch.scripts.serve", "--snapshot", snap,
                               "--batches", ",".join(map(str, batches)), "--check", check,
                               "--out", ypath], what, timeout=1800)
    for line in out.splitlines():
        if line.startswith("[serve] ") and not line.startswith("[serve] summary"):
            log("[%s] child: %s" % (what, line[len("[serve] "):]))
    summary, launches = tagged(out, "[serve] summary "), tagged(out, "[serve] launches ")
    with np.load(ypath) as z:
        for B in batches:
            want = in_process(B)
            if not np.array_equal(z["B%d" % B], want):
                raise AssertionError("[%s] B=%d: the cold process's output is not bitwise "
                                     "equal to this process's (max|diff| %.3g)"
                                     % (what, B, float(np.abs(z["B%d" % B] - want).max())))
    log("[%s] cold serve (%.1f s with the process start): outputs bitwise equal to this "
        "process's at B = %s; check %s; launches %s" % (what, secs, batches,
                                                         json.dumps(summary["check"]),
                                                         json.dumps(launches)))
    if launches["block_ell_matmul_xresd"] <= 0:
        raise AssertionError("[%s] the cold process launched no block_ell_matmul_xresd" % what)
    return launches, summary, secs


def phase_programs(kt, block_ell, allconv=None):
    """Slice 9, [programs] (the counts set to 0 just before, read just after;
    the cold processes' counts added): entry() on the card against the CPU;
    the challenge bundle built on the card, reproduced bitwise by a cold
    process, and attacked with its stochastic twin; the Fig.-6 protocol; the
    vgg16.ipynb sensor recipe at 3x224x224; a cold serve of the AllConvNet
    bundle, bitwise against this process's forward.  ``allconv`` is [main]'s
    (net, sensor, knet) from allconv_keynet; None converts it here."""
    import torch
    from keynet_tpu_torch import bench_kernels
    from keynet_tpu_torch.entry import entry
    from keynet_tpu_torch.examples import release_challenge, vgg16_sensor_demo
    from keynet_tpu_torch.scripts import attack_bundle, run_fiberbundle_fig6, serve
    base = os.path.join(ROOT, "build", "programs")
    block_ell.reset_launches()
    secs = {}

    t = time.perf_counter()
    fn, (x,) = entry("cuda")
    y = fn(x)
    fn_cpu, (x_cpu,) = entry("cpu")
    y_cpu = fn_cpu(x_cpu)
    err, scale = float((y.cpu() - y_cpu).abs().max()), float(y_cpu.abs().max())
    check(err, scale, TOL_F32, "[programs] entry cuda vs cpu")
    if fn.knet.num_parameters() != 323491:
        raise AssertionError("[programs] entry nnz %d != 323491" % fn.knet.num_parameters())
    secs["entry"] = time.perf_counter() - t
    log("[programs] entry: fn(x) %s on %s vs cpu max|diff| %.3g (scale %.3g), nnz %d"
        % (tuple(y.shape), y.device, err, scale, fn.knet.num_parameters()))

    t = time.perf_counter()
    bdir = os.path.join(base, "challenge", "perm")
    bundle = release_challenge.build_bundle(bdir, seed=2020, device="cuda", verbose=False)
    secs["release"] = time.perf_counter() - t
    out, secs["cold verify"] = run_child(
        kt, ["keynet_tpu_torch.examples.release_challenge", "--verify", bdir], "programs")
    v = tagged(out, "VERIFY ")
    log("[programs] challenge bundle built on the card (nnz %d, %d B npz, %.2f s); cold "
        "process (%.1f s): %s" % (bundle["nnz"], os.path.getsize(bundle["keynet"]),
                                  secs["release"], secs["cold verify"], json.dumps(v)))
    if not v["equal"] or v["jax_loaded"]:
        raise AssertionError("[programs] the cold process did not reproduce the embedding "
                             "bit for bit: %s" % v)

    t = time.perf_counter()
    rep = attack_bundle.run(os.path.join(base, "attack"), seed=2020,
                            secret_image=bundle["secret_image"], perm_dir=bdir,
                            device="cuda", verbose=False)
    secs["attack"] = time.perf_counter() - t
    log("[programs] attack: %s" % json.dumps(rep))
    perm, stoch = rep["permutation"], rep["stochastic"]
    if not (perm.get("channels_found") == 6 and perm.get("conv1_valuesets_exact") == "6/6"
            and perm.get("image_corr_best_dihedral", 0) > 0.99):
        raise AssertionError("[programs] the permutation bundle was not broken: %s" % perm)
    if stoch["channels_found"] or not stoch["status"].startswith("no permutation structure"):
        raise AssertionError("[programs] the attack found structure in the stochastic "
                             "bundle: %s" % stoch)

    t = time.perf_counter()
    fig6 = run_fiberbundle_fig6.run(epochs=2, n_train=1024, n_test=256, device="cuda",
                                    verbose=False)
    secs["fig6"] = time.perf_counter() - t
    y, yk = fig6["logits_source"], fig6["logits_keyed"]
    err, scale = float(abs(yk - y).max()), float(abs(y).max())
    log("[programs] Fig. 6 (1024 train / 256 test synthetic MNIST, 2 epochs): %s; test-set "
        "logits %s, keyed vs source max|diff| %.3g (scale %.3g), %d distinct argmax" % (
            json.dumps({k: v for k, v in fig6.items()
                        if k not in ("params", "logits_source", "logits_keyed")}),
            y.shape, err, scale, len(set(y.argmax(1).tolist()))))
    if fig6["retrained_keyed"] != fig6["retrained_on_sim"]:
        raise AssertionError("[programs] Fig. 6: keyed accuracy %r != source %r"
                             % (fig6["retrained_keyed"], fig6["retrained_on_sim"]))
    if y.shape != (256, 10):
        raise AssertionError("[programs] Fig. 6: test-set logits of shape %s" % (y.shape,))
    check(err, scale, TOL_F32, "[programs] Fig. 6 keyed vs source logits on the test set")

    t = time.perf_counter()
    sr = vgg16_sensor_demo.run(out=os.path.join(base, "vgg16_sensor_demo"), device="cuda",
                               verbose=False)
    secs["sensor 224"] = time.perf_counter() - t
    log("[programs] sensor recipe 3x224x224: %s" % json.dumps(
        {k: sr[k] for k in ("route", "key_shape", "keygen_s", "encrypt_ms",
                            "decrypt_first_ms", "encrypt_warm_ms", "decrypt_warm_ms",
                            "png_corr", "decrypt_max_err")}))
    if not (sr["png_corr"] > 0.95 and sr["decrypt_max_err"] < 1e-2):
        raise AssertionError("[programs] the sensor recipe's round trip failed: corr %.4f, "
                             "max err %.3g" % (sr["png_corr"], sr["decrypt_max_err"]))

    t = time.perf_counter()
    net, sensor, knet = allconv or allconv_keynet(kt)
    snap = os.path.join(ROOT, "build", "bundles", "allconv_keyed.npz")
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    t_save = time.perf_counter()
    kt.save_keynet(snap, knet, sensor=sensor, include_keys=True)
    save_s = time.perf_counter() - t_save
    del net, sensor, knet
    here = serve.serve(snap, [64, 1024], reps=1, device="cuda", verbose=False)
    child, summary, _ = cold_serve(kt, snap, [64, 1024], "allconv:1",
                                   lambda B: here["outputs"][B], "programs")
    secs["serve"] = time.perf_counter() - t
    torch.cuda.synchronize()
    parent = dict(block_ell.LAUNCHES)
    log("[programs] serve AllConvNet bundle %d B (save_keynet with its sensor %.2f s; load "
        "%.2f s in the cold process) on %s: %s" % (
            os.path.getsize(snap), save_s, summary["load_s"], bench_kernels.card(), json.dumps(
                {B: {k: r[k] for k in ("warm_ms", "imgs_per_s", "cold_ms")}
                 for B, r in summary["batches"].items()})))
    if parent["block_ell_matmul_xresd"] <= 0:
        raise AssertionError("block_ell_matmul_xresd was not launched on the slice-9 path")
    launches = {n: parent[n] + child[n] for n in block_ell.ENTRIES}
    log("[programs] launches: this process %s, the cold serve %s" % (
        json.dumps(parent), json.dumps(child)))
    never_routed(launches, "the slice-9 path")
    log("[programs] seconds: %s" % json.dumps(secs))
    return launches


def phase_serve_vgg(kt, block_ell):
    """--only serve-vgg: the orth VGG-16 at 3x224x224 converted, saved with
    its sensor, and served in a cold process at B = 1, 8, 32 with --check
    vgg16:5; the outputs bitwise equal to the converted net's in this
    process, the periodic kernel and xresd launched in the child."""
    import torch
    from keynet_tpu_torch import bench_kernels
    from keynet_tpu_torch.scripts import serve
    net, sensor, knet = vgg_keynet(kt)
    knet._build()   # the ops on the card: kernel-routed cores drop the host's _Texp
    snap = os.path.join(ROOT, "build", "bundles", "vgg_orth.npz")
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    t = time.perf_counter()
    kt.save_keynet(snap, knet, sensor=sensor, include_keys=True)
    save_s = time.perf_counter() - t
    log("[serve-vgg] save_keynet with its sensor: %.1f s, %d B (device_bytes %d on the card)"
        % (save_s, os.path.getsize(snap), knet.device_bytes()))
    knet_in = next(l for l in knet.layers().values() if l != "relu").shape[1]

    def in_process(B):
        xc = serve.inputs(sensor, knet_in, B, net.inshape, "cuda")
        return knet.forward(xc).cpu().numpy()
    child, summary, secs = cold_serve(kt, snap, [1, 8, 32], "vgg16:5", in_process,
                                      "serve-vgg")
    log("[serve-vgg] load %.1f s in the cold process (%.1f s in all) on %s; %s" % (
        summary["load_s"], secs, bench_kernels.card(), json.dumps(summary["batches"])))
    if child["periodic_block_ell_matvec"] <= 0:
        raise AssertionError("[serve-vgg] the cold process launched no periodic kernel")
    torch.cuda.synchronize()
    return child


def phase_outputs(kt, path, against=None):
    """The keyed outputs and forward times of the orth VGG-16 (B=1, 8, 32)
    and the StochasticKeynet AllConvNet (B=64, 1024) on chip_smoke's seeded
    batches, with f32 tiles and with bf16 tiles (tags "... bf16"), written
    to ``path`` (npz).  With ``against`` (such a file from another tree),
    prints each output's max|diff| from it and the ratio of the times."""
    import numpy as np
    import torch
    out, ms = {}, {}
    for tag, make, batches in (("vgg", vgg_keynet, (1, 8, 32)),
                               ("allconv", allconv_keynet, (64, 1024)),
                               ("vgg bf16", vgg_keynet, (1, 8, 32)),
                               ("allconv bf16", allconv_keynet, (64, 1024))):
        with global_keys(kt, TILE_DTYPE="bfloat16" if tag.endswith("bf16") else "float32"):
            net, sensor, knet = make(kt)
        for B in batches:
            x = np.random.default_rng(B if tag.startswith("allconv") else 100 + B) \
                .standard_normal((B, *net.inshape)).astype(np.float32)
            xc = sensor.fromtensor(torch.from_numpy(x).cuda()).encrypt().tensor()
            key = "%s B=%d" % (tag, B)
            out[key] = knet.forward(xc).cpu().numpy()
            ms[key] = cuda_ms(lambda: knet.forward(xc), reps=5 if B < 32 else 3)[0]
        del net, sensor, knet
        torch.cuda.empty_cache()
    np.savez(path, **out, **{"ms " + k: np.float64(v) for k, v in ms.items()})
    log("[outputs] %s: %s" % (path, json.dumps(ms)))
    if against:
        with np.load(against) as ref:
            theirs = {k for k in ref.files if not k.startswith("ms ")}
            if theirs != set(out):
                raise AssertionError("[outputs] %s holds %s, this run %s: both come from this "
                                     "script, so the keys must agree"
                                     % (against, sorted(theirs), sorted(out)))
            for k in out:
                log("[outputs] %s: max|diff| from %s %.3g (bitwise equal: %s), ms %.3f "
                    "against %.3f" % (k, against, float(np.abs(out[k] - ref[k]).max()),
                                      bool(np.array_equal(out[k], ref[k])), ms[k],
                                      float(ref["ms " + k])))


# --------------------------------------------------------------- A/B
# library -> (a marker of the checkout's launch signature, int arguments of
# an older launch that lacks it)
AB_LIBS = {"block_ell": ("int BT, int smem", 8), "periodic_block_ell": ("int n_uniq", 11),
           "block_ell_xres": ("int n_uniq", 8), "block_ell_grid": ("int n_uniq", 8)}


class _LegacyLib:
    """A library built from an older source whose launch takes the first
    ``n_int`` of the checkout's int arguments and the stream: the slot walk
    before launch_plan (no row tile, no shared memory), the periodic kernel
    before its f32 TMA ring (no n_uniq), xres and grid before their TMA
    versions (no n_uniq, row tile, shared memory, G, mode or copy counter)."""

    def __init__(self, block_ell, name, lib, n_int):
        import ctypes
        fn_name = block_ell._LAUNCH_FN[name][0]
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        setattr(self, fn_name, lambda *a: fn(*a[:5 + n_int], a[-1]))
        setattr(self, name + "_error_string", getattr(lib, name + "_error_string"))


class _FmaPlanLib:
    """A build whose bf16 slot walk and periodic kernel ran on the FMA core
    (before block_ell_wgmma.cuh): its bf16 launches get the shared memory
    its plan asked for, the f32 plan's at the same row tile (the same
    128-byte panels, 16 bytes of padding a row), not the tensor cores'."""

    def __init__(self, block_ell, name, lib):
        import torch
        fn_name = block_ell._LAUNCH_FN[name][0]
        fn = getattr(lib, fn_name)
        kernel = "periodic" if name == "periodic_block_ell" else "slot_walk"

        def launch(*a):
            *a, bf16, BT, smem, stream = a
            if bf16:
                smem = block_ell.launch_plan(BT, 128, 128, 128, torch.float32, kernel)["smem"]
            return fn(*a, bf16, BT, smem, stream)
        setattr(self, fn_name, launch)
        setattr(self, name + "_error_string", getattr(lib, name + "_error_string"))


def build_version(block_ell, src_dir):
    """src_dir's four kernels, built and loaded: {library name: library};
    a source with an older launch is wrapped, and so is a slot walk or
    periodic kernel whose bf16 ran on the FMA core."""
    libs = block_ell.build(verbose=True, src_dir=src_dir, names=list(AB_LIBS))
    for name, (marker, n_int) in AB_LIBS.items():
        with open(os.path.join(src_dir, name + ".cu")) as f:
            src = f.read()
        if marker not in src:
            libs[name] = _LegacyLib(block_ell, name, libs[name], n_int)
        elif name in TENSOR_CORE_LIBS and "block_ell_wgmma.cuh" not in src:
            libs[name] = _FmaPlanLib(block_ell, name, libs[name])
    return libs


def phase_ab(kt, block_ell, versions, rounds):
    """Kernels and forwards of several builds of the four kernels, on one
    converted VGG-16 and AllConvNet and the depth-bench operand, in turns
    (round r runs the versions in order, round r+1 in reverse: A B B A ...);
    prints the medians, each version's max|diff| from the first version's
    outputs, and one JSON line."""
    import torch
    vnet, vsensor, vknet = vgg_keynet(kt)
    anet, asensor, aknet = allconv_keynet(kt)
    cores = [(n, c) for n, c, _ in block_ell_cores(vsensor, vknet)
             if c.period is not None and n != "sensor"]
    rng_x = {}
    import numpy as np
    for B in (1, 8, 32):
        x = np.random.default_rng(100 + B).standard_normal((B, 3, 224, 224)).astype(np.float32)
        rng_x["vgg", B] = vsensor.fromtensor(torch.from_numpy(x).cuda()).encrypt().tensor()
    for B in (64, 1024):
        x = np.random.default_rng(B).standard_normal((B, 3, 32, 32)).astype(np.float32)
        rng_x["allconv", B] = asensor.fromtensor(torch.from_numpy(x).cuda()).encrypt().tensor()
    items = {}   # name -> callable returning a tensor
    for B in (1, 8, 32):
        items["VGG16 orth forward B=%d" % B] = (lambda k=vknet, x=rng_x["vgg", B]: k.forward(x))
    for B in (64, 1024):
        items["AllConvNet forward B=%d" % B] = (lambda k=aknet, x=rng_x["allconv", B]:
                                               k.forward(x))
    for B in (1, 8, 32):
        for name, _ in cores:
            core, x = core_input(vknet, rng_x["vgg", B], name)
            s, P, R = core.period
            args = (x, core.tiles, core.tile_ids, core.col_blk, s, P, R)
            items["periodic %s B=%d" % (name, B)] = (
                lambda a=args: block_ell.periodic_block_ell_matvec(*a))
            fn = block_ell.route(core.tile_ids.shape[1])
            for a, b in outside_period(core):
                items["slot walk %s rows [%d, %d) B=%d" % (name, a, b, B)] = (
                    lambda f=fn, c=core, x=x, a=a, b=b: f(x, c.tiles, c.tile_ids[a:b],
                                                          c.col_blk[a:b], (b - a) * c.tileshape[0]))
    for B in (64, 1024):
        core, x = core_input(aknet, rng_x["allconv", B], "conv1")
        items["slot walk AllConvNet conv1 B=%d" % B] = (
            lambda c=core, x=x: block_ell.block_ell_matmul_xresd(
                x, c.tiles, c.tile_ids, c.col_blk, c.tile_ids.shape[0] * c.tileshape[0]))
    # bf16 tiles (the f32 tiles cast: the same values and ids as packing in
    # bf16): the tensor-core slot walk and periodic kernel against a build
    # whose bf16 ran on the FMA core, and xres and grid, whose bf16 did not move
    import torch
    bf = torch.bfloat16
    for B in (1, 8, 32):
        core, x = core_input(vknet, rng_x["vgg", B], "conv1_2")
        s, P, R = core.period
        t16 = core.tiles.to(bf)
        items["bf16 periodic conv1_2 B=%d" % B] = (
            lambda a=(x, t16, core.tile_ids, core.col_blk, s, P, R):
            block_ell.periodic_block_ell_matvec(*a))
        for a, b in outside_period(core):
            items["bf16 slot walk conv1_2 rows [%d, %d) B=%d" % (a, b, B)] = (
                lambda c=core, t=t16, x=x, a=a, b=b: block_ell.block_ell_matmul_xresd(
                    x, t, c.tile_ids[a:b], c.col_blk[a:b], (b - a) * c.tileshape[0]))
    for B in (64, 1024):
        core, x = core_input(aknet, rng_x["allconv", B], "conv1")
        fns = [("slot walk", block_ell.block_ell_matmul_xresd)]
        if B == 64:
            fns += [("xres", block_ell.block_ell_matmul_xres),
                    ("grid", block_ell.block_ell_matmul_grid)]
        for short, fn in fns:
            items["bf16 %s AllConvNet conv1 B=%d" % (short, B)] = (
                lambda f=fn, c=core, t=core.tiles.to(bf), x=x: f(
                    x, t, c.tile_ids, c.col_blk, c.tile_ids.shape[0] * c.tileshape[0]))
    from keynet_tpu_torch import bench_kernels as bk
    tiles, ids, cols, rng = bk.depth_operand("cuda")
    xd = torch.from_numpy(rng.normal(size=(8, ids.shape[0] * tiles.shape[2]))
                          .astype(np.float32)).cuda()
    items["slot walk depth-bench operand B=8"] = (
        lambda: block_ell.block_ell_matmul_xresd(xd, tiles, ids, cols, ids.shape[0] * 128))
    core, x = core_input(aknet, rng_x["allconv", 64], "conv1")
    for fn in (block_ell.block_ell_matmul_xres, block_ell.block_ell_matmul_grid):
        short = fn.__name__.rsplit("_", 1)[1]
        items["%s depth-bench operand B=8" % short] = (
            lambda f=fn: f(xd, tiles, ids, cols, ids.shape[0] * 128))
        items["%s AllConvNet conv1 B=64" % short] = (
            lambda f=fn, c=core, x=x: f(x, c.tiles, c.tile_ids, c.col_blk,
                                        c.tile_ids.shape[0] * c.tileshape[0]))

    saved = {n: block_ell._LIBS[n] for n in AB_LIBS}
    times = {(v, k): [] for v, _ in versions for k in items}
    first, diff = {}, {}
    try:
        for r in range(rounds):
            for tag, libs in (versions if r % 2 == 0 else versions[::-1]):
                block_ell._LIBS.update(libs)
                for k, fn in items.items():
                    y = fn()
                    torch.cuda.synchronize()
                    if k not in first:
                        first[k] = (tag, y.float(), float(y.abs().max()))
                    elif r == 0 or (tag, k) not in diff:
                        diff[tag, k] = float((y.float() - first[k][1]).abs().max())
                    del y
                    ms, _ = cuda_ms(fn, reps=3 if "forward B=32" in k or "1024" in k else 5)
                    times[tag, k].append(ms)
    finally:
        block_ell._LIBS.update(saved)
    summary = {}
    for k in items:
        summary[k] = {tag: statistics.median(times[tag, k]) for tag, _ in versions}
        summary[k]["max_abs_diff"] = {tag: diff.get((tag, k), 0.0) for tag, _ in versions}
        summary[k]["scale"] = first[k][2]
        log("[ab] %s: %s" % (k, json.dumps(summary[k])))
    for tag, _ in versions:
        for agg, pre in (("periodic", "periodic "), ("slot walk VGG", "slot walk conv")):
            tot = {B: sum(summary[k][tag] for k in items
                          if k.startswith(pre) and k.endswith(" B=%d" % B)) for B in (1, 8, 32)}
            log("[ab] %s: %s summed over the VGG cores: %s" % (tag, agg, json.dumps(tot)))
    print(json.dumps({"ab": summary, "rounds": rounds,
                      "order": [t for t, _ in versions]}), flush=True)


def timed(phase, fn, *args):
    """fn(*args), with the phase's seconds logged."""
    t = time.perf_counter()
    out = fn(*args)
    log("[time] %s: %.1f s" % (phase, time.perf_counter() - t))
    return out


def main(argv=None):
    """python3 chip_smoke.py: the smoke run above.  python3 chip_smoke.py
    --ab TAG=SRC_DIR [...] [--rounds N]: the checkout's build ("change")
    against builds of other csrc/ directories (e.g. the parent commit's,
    unpacked with git archive), in turns (phase_ab).  python3 chip_smoke.py
    --outputs FILE [--tree DIR] [--against FILE]: the keyed outputs and
    forward times of the orth VGG-16 and AllConvNet of the keynet_tpu_torch
    in DIR (default this checkout), saved and held against another tree's
    (phase_outputs)."""
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", nargs="+", metavar="TAG=SRC_DIR")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--outputs", metavar="FILE")
    ap.add_argument("--tree", metavar="DIR", default=ROOT)
    ap.add_argument("--against", metavar="FILE")
    ap.add_argument("--only", choices=["vgg-stochastic", "vgg-stochastic-bf16", "parallel",
                                       "challenge", "programs", "serve-vgg"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kt, block_ell, smi = timed("build", phase_build, os.path.abspath(args.tree))
    kt.globals.precision("highest")
    name = torch.cuda.get_device_name(0)
    rows = None
    if args.outputs:
        phase_outputs(kt, args.outputs, args.against)
    elif args.only in ("vgg-stochastic", "vgg-stochastic-bf16"):
        from keynet_tpu_torch import bench_kernels as bk
        peaks = bk.card_peaks(name)[1]
        bf16 = args.only.endswith("bf16")
        what = "slice 10 (VGG stochastic bf16)" if bf16 else "slice 7 (VGG stochastic)"
        paths, launches = timed(what, phase_vgg_stochastic, kt, block_ell, bf16)
        log("[main] launches by path: %s" % json.dumps({what: launches}))
        label = "VGG16 stochastic bf16" if bf16 else "VGG16 stochastic"
        timed("kernels", stochastic_kernel_rows, block_ell, bk, *paths[args.only], peaks,
              label)
        timed("grouped kernel", grouped_kernel_rows, block_ell, bk, *paths[args.only], peaks,
              label)
    elif args.only == "parallel":
        log("[main] launches by path: %s" % json.dumps(
            {"slice 8 (parallel)": timed("slice 8 (parallel)", phase_parallel, kt, block_ell)}))
    elif args.only == "challenge":
        timed("slice 8 (challenge)", phase_challenge, kt)
    elif args.only == "programs":
        log("[main] launches by path: %s" % json.dumps(
            {"slice 9 (programs)": timed("slice 9 (programs)", phase_programs, kt, block_ell)}))
    elif args.only == "serve-vgg":
        log("[main] launches by path: %s" % json.dumps(
            {"slice 9 (serve-vgg)": timed("slice 9 (serve-vgg)", phase_serve_vgg, kt,
                                          block_ell)}))
    elif args.ab:
        versions = [(tag, build_version(block_ell, os.path.abspath(d)))
                    for tag, d in (a.split("=", 1) for a in args.ab)]
        versions.insert(1, ("change", {n: block_ell._LIBS[n] for n in AB_LIBS}))
        phase_ab(kt, block_ell, versions, args.rounds)
    else:
        from keynet_tpu_torch import bench_kernels as bk
        card, peaks = bk.card_peaks(name)
        log("[build] device %s (%d visible); bounds use %s data-sheet rates %s"
            % (name, torch.cuda.device_count(), card, json.dumps(peaks)))
        timed("parity", phase_parity, kt, block_ell)
        paths, launches = timed("slice 1", phase_main_allconv, kt, block_ell)
        main_default, main_tf32 = timed(DEFAULT_PATHS[0], phase_main_default, kt, block_ell,
                                        paths)
        vgg_paths, vgg_launches = timed("slice 2 (VGG orth)", phase_main_vgg, kt, block_ell)
        paths.update(vgg_paths)
        vgg_default, vgg_tf32 = timed(DEFAULT_PATHS[1], phase_vgg_default, kt, block_ell,
                                      paths)
        bf16_paths, bf16_launches = timed(BF16_PATH, phase_main_vgg, kt, block_ell, True,
                                          paths["vgg memory"])
        paths.update(bf16_paths)
        bench_launches = timed("slice 3 (bench)", phase_bench, block_ell, bk)
        by_path = {"slice 1": launches, DEFAULT_PATHS[0]: main_default,
                   "slice 2 (VGG)": vgg_launches, DEFAULT_PATHS[1]: vgg_default,
                   BF16_PATH: bf16_launches, "slice 3 (bench)": bench_launches,
                   "slice 6 (train)": timed("slice 6 (train)", phase_train, kt, block_ell),
                   "slice 6 (tiled)": timed("slice 6 (tiled)", phase_tiled, kt, block_ell),
                   "slice 6 (VGG identity)": timed("slice 6 (VGG identity)",
                                                   phase_vgg_identity, kt, block_ell)}
        stoch_paths, by_path["slice 7 (VGG stochastic)"] = timed(
            "slice 7 (VGG stochastic)", phase_vgg_stochastic, kt, block_ell)
        paths.update(stoch_paths)
        by_path["slice 8 (parallel)"] = timed("slice 8 (parallel)", phase_parallel, kt,
                                              block_ell)
        timed("slice 8 (challenge)", phase_challenge, kt)
        by_path["slice 9 (programs)"] = timed("slice 9 (programs)", phase_programs, kt,
                                              block_ell, paths.pop("allconv keynet"))
        log("[main] launches by path: %s" % json.dumps(by_path))
        tf32_launches = {n: main_tf32[n] + vgg_tf32[n] for n in block_ell.ENTRIES}
        log("[main] tf32 launches on the 'default' paths: %s" % json.dumps(tf32_launches))
        rows = timed("kernels", phase_kernels, kt, block_ell, bk, paths, by_path, peaks,
                     tf32_launches)
    log("[done] %.1f s" % (time.perf_counter() - t0))
    print(smi)
    if rows is not None:
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
