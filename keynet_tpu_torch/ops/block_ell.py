"""Block-ELL kernels: wrappers, plain versions and launch counts.

The counterpart of keynet_tpu/ops/pallas_kernels.py.  Six entries keep the
JAX names and signatures (without ``interpret``).  Three launch the slot-walk
kernel (csrc/block_ell.cu):

  block_ell_matmul(x_padded, tiles, tile_ids, col_blk, n_out_padded)
  block_ell_matmul_xres2(x_padded, tiles, tile_ids, col_blk, n_out_padded)
  block_ell_matmul_xresd(x_padded, tiles, tile_ids, col_blk, n_out_padded, depth=4)

On the TPU they differ in where x lives and in how many slots one dot fuses
(``depth``); the CUDA kernel walks the slots one by one, so ``depth`` is
checked and changes nothing.  Two more have kernels of their own, which no
operator routes to (as in keynet_tpu; the kernel bench drives them):

  block_ell_matmul_xres(...)   the slot walk with a TMA tile ring
                               (csrc/block_ell_xres.cu)
  block_ell_matmul_grid(...)   the slot walk that keeps a staged tile slice
                               over repeated ids, across row boundaries
                               (csrc/block_ell_grid.cu)

The sixth launches the periodic kernel (csrc/periodic_block_ell.cu):

  periodic_block_ell_matvec(x_padded, tiles, tile_ids, col_blk, s, P, R)

A seventh has no Pallas counterpart: the grouped-row apply of a core whose
row-blocks share tile_ids rows (BlockSparseOp's grouped-row plan), each
pattern's tiles read through its ids (csrc/grouped_block_ell.cu):

  grouped_block_ell_matmul(x_padded, tiles, patterns, rows, col_blk, buckets,
                           n_out_padded, tables=None)

Contract (pallas_kernels.py:15-16, :96-98): x is (B, n_cb·TN) and is cast
to the tile dtype; tiles are (n_uniq, TM, TN) f32 or bf16 with tile 0 all
zeros; tile_ids and col_blk are (n_rb, KB) int32;
y[:, r·TM:(r+1)·TM] = Σ_k x[:, col_blk[r,k]·TN : +TN] @ tiles[tile_ids[r,k]]ᵀ,
accumulated and returned in f32.  The width is the JAX entry's
(``out_width``): min(n_out_padded, ⌈n_rb/8⌉·8·TM) for the four entries that
pad rows to groups of 8 (pallas_kernels.py:122, :130), min(n_out_padded,
n_rb·TM) for the grid entry (:481, :484); columns past n_rb·TM are zero.  A
slot with tile id 0 adds nothing.  The periodic entry computes rows
[s, s+P·R) of an operator whose rows s+ρ+j·P share row s+ρ's tile ids
(pallas_kernels.py:550-595) and returns them as (B, P·R·TM), rep-major.

On a CPU tensor each entry computes its plain version (``block_ell_plain``,
``periodic_block_ell_plain``, ``grouped_block_ell_plain``); on a CUDA
tensor it launches its kernel or raises.  ``LAUNCHES[name]`` counts kernel
launches only, ``TF32_LAUNCHES`` those of them that ran tf32 products.  The
kernels are compiled with nvcc at first use into build/kernels/ (one nvcc per source,
started together) and bound with ctypes.  Every kernel is launched with the
row tile, shared memory and grid that ``launch_plan`` chooses for it
(csrc/block_ell_core.cuh); it raises beforehand on a plan the card cannot
launch.  The slot walk and the periodic kernel read the product at each
launch from ``globals.kernel_precision`` (GLOBAL['PRECISION'] and the tile
dtype), as the Pallas wrappers read ``kernel_precision()`` at call: bf16
tiles multiply on the tensor cores in every mode (csrc/block_ell_wgmma.cuh:
bf16 products, f32 sums, as the Pallas dot with bf16 tiles); f32 tiles on
the IEEE f32 FMA core under 'highest' and 'high', and as tf32 products on
the tensor cores under 'default' (the Pallas dot at Precision.DEFAULT).
xres, grid and the grouped kernel run the FMA core in every mode.  On the
CPU every entry keeps f32 products in every mode, as torch's CPU matmul and JAX on the CPU do;
``tf32=True`` makes a plain version round its operands as the tensor cores
do (``round_tf32``), which is what the card checks hold a tf32 launch
against.  ``grid_tile_copies`` runs the grid kernel with a device counter
of the tile copies it issues.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..globals import GLOBAL, kernel_precision

ENTRIES = ("block_ell_matmul", "block_ell_matmul_xres", "block_ell_matmul_xres2",
           "block_ell_matmul_xresd", "block_ell_matmul_grid", "periodic_block_ell_matvec",
           "grouped_block_ell_matmul")
LAUNCHES = {name: 0 for name in ENTRIES}
TF32_LAUNCHES = {name: 0 for name in ENTRIES}   # the launches of LAUNCHES that ran tf32
GROUP = 8  # row-blocks per grid step of the row-padded Pallas entries

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "keynet_tpu_torch", "csrc")
# library name -> CUDA source; each source builds into its own library
SOURCES = {"block_ell": os.path.join(_CSRC, "block_ell.cu"),
           "block_ell_xres": os.path.join(_CSRC, "block_ell_xres.cu"),
           "block_ell_grid": os.path.join(_CSRC, "block_ell_grid.cu"),
           "periodic_block_ell": os.path.join(_CSRC, "periodic_block_ell.cu"),
           "grouped_block_ell": os.path.join(_CSRC, "grouped_block_ell.cu")}
# library name -> (launch function, pointer arguments, int arguments, pointer
# arguments after them: the stream, and for grid first its copy counter)
_LAUNCH_FN = {"block_ell": ("block_ell_slot_walk", 5, 10, 1),
              "block_ell_xres": ("block_ell_xres", 5, 11, 1),
              "block_ell_grid": ("block_ell_grid", 5, 13, 2),
              "periodic_block_ell": ("periodic_block_ell", 5, 12, 1),
              "grouped_block_ell": ("grouped_block_ell", 7, 10, 1)}
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")
_SMEM_MAX = 232448  # shared memory one block may use on sm_90
_GRID_X_MAX, _GRID_Y_MAX = 2 ** 31 - 1, 65535

# The row tiles instantiated in csrc/block_ell_core.cuh -> threads a block
# (16 column threads x BT/8 row groups x k groups), and the ring's depth.
TILE_THREADS = {8: 64, 16: 128, 32: 128, 64: 128, 128: 256}
WGMMA_THREADS = 256  # the tensor-core slot walk and periodic kernel: two warpgroups
GRID_CONSUMERS = 256  # the grid kernel's consumer threads (it runs one block an SM)
STAGES = 3
# the periodic kernel's f32 (IEEE) ring on TMA and mbarriers: its depth at
# each row tile (csrc/periodic_block_ell.cu, fma_stages)
PERIODIC_STAGES = {8: 4, 16: 6, 32: 5, 64: 4, 128: 7}
_PANEL_BYTES = 128  # contraction bytes one ring step stages (32 f32, 64 bf16)
_BM = 128           # output columns a block owns
_TMA_ALIGN = 1024   # slack to align swizzled TMA and wgmma panels
_SMS = 132          # multiprocessors of the H100 SXM (the grid kernel's G)
KERNELS = ("slot_walk", "periodic", "xres", "grid", "grouped")
KERNEL_OF = {"block_ell_matmul": "slot_walk", "block_ell_matmul_xres": "xres",
             "block_ell_matmul_xres2": "slot_walk", "block_ell_matmul_xresd": "slot_walk",
             "block_ell_matmul_grid": "grid", "periodic_block_ell_matvec": "periodic",
             "grouped_block_ell_matmul": "grouped"}
# product() -> the kind number the libraries take (xres, grid, grouped: 1 = bf16 tiles)
KIND = {"ieee": 0, "bf16": 1, "tf32": 2}
TF32_DROPPED_BITS = 13  # f32 mantissa bits the tensor cores ignore in a tf32 operand
_LIBS = {}
_LOCK = threading.Lock()


def reset_launches():
    for name in ENTRIES:
        LAUNCHES[name] = TF32_LAUNCHES[name] = 0


def route(KB):
    """The slot-walk entry for rows of KB slots, whatever the batch: xresd
    (depth 4) when KB >= 8, else xres2, as operators.py:442-447 routes the
    Pallas entries (the TPU's VMEM fit gates have no counterpart here)."""
    if KB >= 8:
        return block_ell_matmul_xresd
    return block_ell_matmul_xres2


def product(kernel, dtype):
    """The product a launch of ``kernel`` (one of KERNELS, or an entry of
    ENTRIES) with ``dtype`` tiles runs under the mode set now: the slot walk
    and the periodic kernel run kernel_precision(dtype); xres, grid and the
    grouped kernel run the FMA core in every mode, "bf16" for bf16 tiles
    (products of bf16 values, exact in f32) and "ieee" for f32 tiles."""
    kernel = KERNEL_OF.get(kernel, kernel)
    if kernel in ("slot_walk", "periodic"):
        return kernel_precision(dtype)
    return "bf16" if dtype == torch.bfloat16 else "ieee"


def launch_plan(rows, cols, TM, TN, dtype, kernel="slot_walk"):
    """How one of the five kernels is launched (csrc/block_ell_core.cuh):
    ``kernel`` is "slot_walk", "xres" or "grid" (rows = B, cols = n_out),
    "periodic" (rows = R·B (rep, image) pairs, cols = P·TM) or "grouped"
    (rows = m·B (row, image) pairs of one group, cols = TM).  Returns
    dict(BT, stages, threads, smem, grid, kind), kind the KIND number of
    product(kernel, dtype), read now, and for "grid" also G and keep:

    - BT, the row tile: the least of TILE_THREADS's tiles that holds
      ``rows``, capped at 128; threads a block from TILE_THREADS, but for
      grid k groups (at most 8) up to GRID_CONSUMERS consumer threads plus
      its producer, a warp beside 128 consumers, a warpgroup beside 256;
    - smem, the dynamic shared memory of a block (the launch refuses fewer
      bytes than the layout needs).  Slot walk and grouped on the FMA
      core: the cp.async ring, STAGES x (BT + 128) panel rows of 128 + 16
      bytes, or the k groups' fold if larger, + the grouped kernel's two
      slots of row offsets.  Periodic with an "ieee" product: its TMA ring,
      1024 bytes of slack, PERIODIC_STAGES[BT] (stages in the plan)
      swizzled stages of (BT + 128) rows of 128 bytes and two mbarriers a
      stage (the fold reuses the ring).  With a "bf16" or "tf32"
      product the slot walk and periodic kernel run on the tensor cores
      (csrc/block_ell_wgmma.cuh): WGMMA_THREADS threads at every BT, the
      ring's STAGES x (BT + 128) rows of 128 bytes, 128-byte swizzled, after
      1024 bytes of slack that align it, no fold, + the periodic kernel's
      row offsets (a stage is 128 bytes of contraction either way: 64 bf16
      or 32 f32 columns).  xres: 1024 bytes of slack to align the swizzled TMA
      stages, STAGES x (BT + 128) rows of 128 bytes and an mbarrier a stage
      (the fold reuses the ring).  grid: the slack, then in keep mode two
      128 x TN tile slices and STAGES x panels of BT x 128 bytes, else (two
      slices do not fit) STAGES stages as in xres; then the fold and
      2·STAGES + 4 mbarriers;
    - grid: (ceil(rows / BT), ceil(cols / 128)), for "grouped" that of one
      group (grouped_tables lays a launch's groups out on x); for "grid"
      the y extent is ceil(n_rows / G) runs of G row-blocks x TM / 128 chunks, n_rows =
      ceil(cols / TM), and G is the largest run that still gives at least
      two blocks for each of the card's _SMS multiprocessors (1 where even
      G = 1 gives fewer).

    Raises ValueError on a plan the card cannot launch."""
    rows, cols = int(rows), int(cols)
    if kernel not in KERNELS:
        raise ValueError("launch_plan: kernel %r is none of %s" % (kernel, KERNELS))
    if rows < 1 or cols < 1 or TM % _BM or TN % 128:
        raise ValueError("launch_plan: rows %d, cols %d, TM %d, TN %d" % (rows, cols, TM, TN))
    itemsize = torch.empty((), dtype=dtype).element_size()
    if itemsize not in (2, 4):
        raise TypeError("launch_plan: tiles must be float32 or bfloat16, got %s" % dtype)
    kind = KIND[product(kernel, dtype)]
    tensor_cores = kernel in ("slot_walk", "periodic") and kind != KIND["ieee"]
    BT = next((t for t in sorted(TILE_THREADS) if t >= rows), max(TILE_THREADS))
    group = 16 * (BT // 8)                    # threads of one k group
    k_groups = TILE_THREADS[BT] // group
    if kernel == "grid":                      # k groups up to GRID_CONSUMERS threads
        k_groups = min(8, max(k_groups, GRID_CONSUMERS // group))
    threads = group * k_groups
    fold = (k_groups - 1) * group * 64 * 4
    x_panel, tile_panel = BT * _PANEL_BYTES, _BM * _PANEL_BYTES
    grid = (-(-rows // BT), -(-cols // _BM))
    plan = dict(BT=BT, stages=STAGES, kind=kind)
    if tensor_cores:
        threads = WGMMA_THREADS
        smem = _TMA_ALIGN + STAGES * (BT + _BM) * _PANEL_BYTES \
            + (2 * BT * 8 if kernel == "periodic" else 0)
    elif kernel == "periodic":
        plan["stages"] = PERIODIC_STAGES[BT]
        smem = _TMA_ALIGN + plan["stages"] * ((BT + _BM) * _PANEL_BYTES + 2 * 8)
    elif kernel in ("slot_walk", "grouped"):
        ring = STAGES * (BT + _BM) * (_PANEL_BYTES + 16)
        smem = max(ring, fold) + (2 * BT * 8 if kernel != "slot_walk" else 0)
    elif kernel == "xres":
        smem = _TMA_ALIGN + STAGES * (x_panel + tile_panel) + STAGES * 8
    else:
        n_rows, per_rb = -(-cols // TM), TM // _BM
        need = -(-2 * _SMS // (grid[0] * per_rb))   # runs that give 2 blocks an SM
        G = max(1, n_rows // need)
        while G < n_rows and -(-n_rows // (G + 1)) >= need:
            G += 1
        tail = fold + (2 * STAGES + 4) * 8
        keep_smem = _TMA_ALIGN + 2 * _BM * TN * itemsize + STAGES * x_panel + tail
        keep = keep_smem <= _SMEM_MAX
        smem = keep_smem if keep else _TMA_ALIGN + STAGES * (x_panel + tile_panel) + tail
        grid = (grid[0], -(-n_rows // G) * per_rb)
        threads += 128 if threads >= 256 else 32   # the producer
        plan.update(G=G, keep=keep)
    if smem > _SMEM_MAX:
        raise ValueError("launch_plan: %d bytes of shared memory a block, the card "
                         "allows %d" % (smem, _SMEM_MAX))
    if grid[0] > _GRID_X_MAX or grid[1] > _GRID_Y_MAX:
        raise ValueError("launch_plan: grid %s exceeds (%d, %d)" % (grid, _GRID_X_MAX,
                                                                   _GRID_Y_MAX))
    plan.update(threads=threads, smem=smem, grid=grid)
    return plan


# ------------------------------------------------------------------ plain

def out_width(n_rb, TM, n_out_padded, grid=False):
    """The width a JAX entry returns: its natural width, n_rb·TM for the grid
    entry and ⌈n_rb/GROUP⌉·GROUP·TM for the others, cut to n_out_padded."""
    natural = n_rb * TM if grid else -(-n_rb // GROUP) * GROUP * TM
    return min(int(n_out_padded), natural)


def round_tf32(t):
    """f32 values as the tensor cores read them for a tf32 product: sign,
    exponent and the upper 10 mantissa bits kept, the TF32_DROPPED_BITS low
    bits dropped, i.e. truncated toward zero (csrc/block_ell_wgmma.cuh; the
    rounding pin of the card checks holds the kernels to it)."""
    bits = t.float().contiguous().view(torch.int32)
    return (bits & -(1 << TF32_DROPPED_BITS)).view(torch.float32)


def _tf32(t, tf32):
    """``t`` rounded as a tf32 operand where ``tf32`` is set and t is f32
    (bf16 values are exact in tf32), else ``t``."""
    return round_tf32(t) if tf32 and t.dtype == torch.float32 else t


def block_ell_plain(x_padded, tiles, tile_ids, col_blk, n_out_padded, tf32=False):
    """The contract in plain PyTorch: gather + einsum (operators.py:453-458),
    chunked over row-blocks so the gathered tiles and x blocks stay under
    GLOBAL['PERIODIC_X_CHUNK_BYTES'].  bf16 operands are widened to f32
    after rounding, so products and sums are f32 as in the kernel; with
    ``tf32`` f32 operands are first rounded as the tensor cores round them
    (round_tf32), the tf32 kernels' products.  Returns (B, out_width(n_rb,
    TM, n_out_padded)), the row-padded entries' width."""
    B = x_padded.shape[0]
    n_rb, KB = tile_ids.shape
    TM, TN = tiles.shape[1], tiles.shape[2]
    n_out_padded = out_width(n_rb, TM, n_out_padded)
    xb = _tf32(x_padded.to(tiles.dtype), tf32).reshape(B, -1, TN)
    out = torch.zeros((B, n_out_padded), dtype=torch.float32, device=x_padded.device)
    budget = int(GLOBAL.get("PERIODIC_X_CHUNK_BYTES", 256 << 20))
    rc = max(1, budget // max(1, KB * TN * 4 * (TM + B)))
    ids, cols = tile_ids.long(), col_blk.long()
    n_rows = min(n_rb, -(-n_out_padded // TM))
    for r0 in range(0, n_rows, rc):
        r1 = min(n_rows, r0 + rc)
        xg = xb[:, cols[r0:r1]].float()              # (B, rc, KB, TN)
        tg = _tf32(tiles[ids[r0:r1]], tf32).float()  # (rc, KB, TM, TN)
        y = torch.einsum("brkn,rkmn->brm", xg, tg).reshape(B, -1)
        c1 = min(n_out_padded, r1 * TM)
        out[:, r0 * TM:c1] = y[:, :c1 - r0 * TM]
    return out


def periodic_block_ell_plain(x_padded, tiles, tile_ids, col_blk, s, P, R,
                             texp=None, tf32=False):
    """The periodic contract in plain PyTorch: the period's tiles
    tiles[tile_ids[s:s+P]] gathered once (or ``texp``, that expansion made
    beforehand) and one einsum per chunk of reps over the x blocks each rep's
    columns pick, the chunk sized so the gathered x blocks stay under
    GLOBAL['PERIODIC_X_CHUNK_BYTES'] (operators.py:460-482); ``tf32`` as in
    block_ell_plain.  Returns (B, P·R·TM) f32, column block j·P+ρ for rep j
    of period row ρ."""
    B = x_padded.shape[0]
    KB = tile_ids.shape[1]
    TN = tiles.shape[2]
    xb = _tf32(x_padded.to(tiles.dtype), tf32).reshape(B, -1, TN)
    T = _tf32(texp if texp is not None else tiles[tile_ids[s:s + P].long()], tf32).float()
    cols = col_blk[s:s + P * R].long().reshape(R, P, KB)
    budget = int(GLOBAL.get("PERIODIC_X_CHUNK_BYTES", 256 << 20))
    rc = max(1, min(R, budget // max(1, B * P * KB * TN * tiles.element_size())))
    parts = []
    for j0 in range(0, R, rc):
        Xt = xb[:, cols[j0:j0 + rc]].float()            # (B, rj, P, KB, TN)
        y = torch.einsum("brpkn,pkmn->brpm", Xt, T)
        parts.append(y.reshape(B, -1))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def grouped_chunk(B, m, G, KB, TN, itemsize):
    """The patterns of a bucket (m, G) that one grouped einsum takes: as
    many as keep its gathered x blocks under GLOBAL['PERIODIC_X_CHUNK_BYTES']."""
    budget = int(GLOBAL.get("PERIODIC_X_CHUNK_BYTES", 256 << 20))
    return max(1, min(G, budget // max(1, B * m * KB * TN * itemsize)))


def grouped_block_ell_plain(x_padded, tiles, patterns, rows, col_blk, buckets, n_out_padded):
    """The grouped contract in plain PyTorch (grouped_block_ell_matmul):
    for each bucket (m, G) of ``buckets`` the G patterns' tiles gathered
    once and one einsum over the x blocks of their rows, grouped_chunk
    patterns at a time, each row-block's output put at its place.  Returns
    (B, min(n_out_padded, n_rb·TM)) f32."""
    B = x_padded.shape[0]
    TM, TN = tiles.shape[1], tiles.shape[2]
    n_rb, KB = col_blk.shape
    xb = x_padded.to(tiles.dtype).reshape(B, -1, TN)
    out = torch.zeros((B, n_rb, TM), dtype=torch.float32, device=x_padded.device)
    g0 = r0 = 0
    for m, G in buckets:
        T = tiles[patterns[g0:g0 + G].long()].float()           # (G, KB, TM, TN)
        rg = rows[r0:r0 + G * m].long().reshape(G, m)
        gc = grouped_chunk(B, m, G, KB, TN, tiles.element_size())
        for a in range(0, G, gc):
            r = rg[a:a + gc]
            Xt = xb[:, col_blk[r].long()].float()                # (B, g, m, KB, TN)
            y = torch.einsum("bgmkn,gktn->bgmt", Xt, T[a:a + gc])
            out[:, r.reshape(-1)] = y.reshape(B, -1, TM)
        g0, r0 = g0 + G, r0 + G * m
    return out.reshape(B, n_rb * TM)[:, :min(int(n_out_padded), n_rb * TM)]


def grouped_tables(buckets, patterns, B, TM, TN, dtype, device=None):
    """The launches of the grouped kernel for a plan's ``buckets`` ((m, G),
    ...) at batch B: {"B": B, "launches": [(launch_plan, table)]}, one
    launch a row tile (each bucket at the least that holds its m·B pairs),
    widest first.  A table is (n_blocks, 4) int32 on ``device``, one
    {pattern, its first row in rows, m, first pair} a block: each group's
    ceil(m·B / BT) pair chunks side by side, so that they share its tiles
    in L2, and the groups with the most non-zero slots first, so that the
    longest blocks start first and fewer run alone at the launch's end.
    ``patterns``: the (n_patterns, KB) tile ids."""
    nz = (torch.as_tensor(patterns).cpu() > 0).sum(1)
    by_tile = {}
    g0 = r0 = 0
    for m, G in buckets:
        if m * B + 128 > 2 ** 31 - 1:
            raise ValueError("grouped_tables: %d x %d pairs of one group overflow int32"
                             % (m, B))
        plan = launch_plan(m * B, TM, TM, TN, dtype, "grouped")
        BT, chunks = plan["BT"], plan["grid"][0]
        e = torch.empty((G, chunks, 4), dtype=torch.int32)
        e[..., 0] = torch.arange(g0, g0 + G, dtype=torch.int32)[:, None]
        e[..., 1] = (r0 + m * torch.arange(G, dtype=torch.int32))[:, None]
        e[..., 2] = m
        e[..., 3] = BT * torch.arange(chunks, dtype=torch.int32)
        _, es, ns = by_tile.setdefault(BT, (plan, [], []))
        es.append(e.reshape(-1, 4))
        ns.append(nz[g0:g0 + G].repeat_interleave(chunks))
        g0, r0 = g0 + G, r0 + G * m
    launches = []
    for BT in sorted(by_tile, reverse=True):
        plan, es, ns = by_tile[BT]
        # stable: a group's chunks, side by side, share its key and stay so
        table = torch.cat(es)[torch.argsort(-torch.cat(ns), stable=True)]
        if table.shape[0] > _GRID_X_MAX:
            raise ValueError("grouped_tables: %d blocks exceed grid.x" % table.shape[0])
        launches.append((plan, table.to(device) if device is not None else table))
    return {"B": int(B), "launches": launches}


# ------------------------------------------------------------------ build

def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Block-ELL CUDA kernel needs the CUDA toolkit")


def _headers(csrc):
    """The shared headers in csrc (part of every source's build digest)."""
    return sorted(os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh"))


def _bind(name, lib):
    """Set the ctypes signature of a library's launch and error functions."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn_name, n_ptr, n_int, n_tail = _LAUNCH_FN[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr] * n_tail
    fn.restype = i32
    err = getattr(lib, name + "_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return lib


def build(verbose=False, src_dir=None, names=None):
    """Compile the CUDA sources for sm_90a (once per source content, one
    nvcc process per source, all started together) and load them; returns
    {library name: ctypes library}.  By default every source of csrc/, kept
    for the entries; with ``src_dir`` the libraries ``names`` built from
    another csrc directory (an earlier version, to compare), returned only."""
    csrc = _CSRC if src_dir is None else src_dir
    with _LOCK:
        jobs = []
        for name in names or SOURCES:
            if src_dir is None and name in _LIBS:
                continue
            src = os.path.join(csrc, name + ".cu")
            h = hashlib.sha1()
            for path in [src] + _headers(csrc):
                with open(path, "rb") as f:
                    h.update(f.read())
            digest = h.hexdigest()[:12]
            so = os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, digest))
            proc = tmp = None
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = "%s.%d.tmp" % (so, os.getpid())
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", tmp, src]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
            jobs.append((name, so, tmp, proc))
        failed = []
        for name, so, tmp, proc in jobs:
            if proc is None:
                continue
            try:
                _, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            src = os.path.join(csrc, name + ".cu")
            if proc.returncode != 0:
                failed.append("nvcc %s failed (%d):\n%s" % (src, proc.returncode, err))
                continue
            if verbose:
                print("[build] %s:\n%s" % (src, err.strip()))
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        libs = {name: _bind(name, ctypes.CDLL(so)) for name, so, _, _ in jobs}
        if src_dir is not None:
            return libs
        _LIBS.update(libs)
        return dict(_LIBS)


def _lib(name):
    lib = _LIBS.get(name)
    return lib if lib is not None else build()[name]


# ------------------------------------------------------------------ launch

def _operands(name, x_padded, tiles, tile_ids, col_blk, same_rows=True):
    """Check the operands of a CUDA launch (device, dtypes, shapes) and
    return them contiguous, x cast to the tile dtype.  Without
    ``same_rows`` tile_ids (the grouped kernel's patterns) and col_blk need
    only the same number of slots a row."""
    dev = x_padded.device
    if dev.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, dev))
    if tiles.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s: tiles must be float32 or bfloat16, got %s" % (name, tiles.dtype))
    for t, what in ((tiles, "tiles"), (tile_ids, "tile_ids"), (col_blk, "col_blk")):
        if t.device != dev:
            raise ValueError("%s: %s on %s, x on %s" % (name, what, t.device, dev))
    if tile_ids.dtype != torch.int32 or col_blk.dtype != torch.int32:
        raise TypeError("%s: tile_ids and col_blk must be int32" % name)
    TM, TN = tiles.shape[1], tiles.shape[2]
    if TM % 128 or TN % 128:
        raise ValueError("%s: TM and TN must be multiples of 128, got %s"
                         % (name, (TM, TN)))
    shapes = (tuple(col_blk.shape), tuple(tile_ids.shape)) if same_rows \
        else (col_blk.shape[1:], tile_ids.shape[1:])
    if x_padded.shape[1] % TN or shapes[0] != shapes[1]:
        raise ValueError("%s: x width %d / col_blk %s do not fit TN=%d, tile_ids %s"
                         % (name, x_padded.shape[1], tuple(col_blk.shape), TN,
                            tuple(tile_ids.shape)))
    ops = (x_padded.to(tiles.dtype).contiguous(), tiles.contiguous(),
           tile_ids.contiguous(), col_blk.contiguous())
    # the kernels read x and tiles 16 bytes at a time (cp.async, float4)
    if ops[0].data_ptr() % 16 or ops[1].data_ptr() % 16:
        raise ValueError("%s: x and tiles must start on a 16-byte boundary "
                         "(x at %#x, tiles at %#x)" % (name, ops[0].data_ptr(),
                                                       ops[1].data_ptr()))
    return ops


def _launched(name, lib_name, err, kind):
    """Raise on a refused launch (err = cudaGetLastError() after it), else
    count it (and, for a tf32 ``kind``, count it as tf32)."""
    if err != 0:
        msg = getattr(_LIBS[lib_name], lib_name + "_error_string")(err).decode()
        raise RuntimeError("%s: kernel launch failed: %s" % (name, msg))
    LAUNCHES[name] += 1
    TF32_LAUNCHES[name] += kind == KIND["tf32"]


def _slot_walk(name, lib_name, x_padded, tiles, tile_ids, col_blk, n_out_padded,
               kernel="slot_walk", copies=None):
    """One slot-walk entry: the plain version on a CPU tensor, else the
    launch of library ``lib_name``'s kernel (``kernel``, as launch_plan
    names it; ``copies``: the grid kernel's int64 copy counter, or None);
    (B, out_width(..., grid)) f32."""
    n_out = out_width(tile_ids.shape[0], tiles.shape[1], n_out_padded, kernel == "grid")
    if x_padded.device.type == "cpu":
        return block_ell_plain(x_padded, tiles, tile_ids, col_blk, n_out)
    x, tiles, ids, cols = _operands(name, x_padded, tiles, tile_ids, col_blk)
    n_uniq, TM, TN = tiles.shape
    n_rb, KB = ids.shape
    B, n_cols = x.shape
    out = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    if B == 0 or n_out == 0:
        return out
    plan = launch_plan(B, n_out, TM, TN, tiles.dtype, kernel)
    ints = [B, n_cols, n_rb, KB, TM, TN, n_out, plan["kind"]]
    ints += ([] if kernel == "slot_walk" else [n_uniq]) + [plan["BT"], plan["smem"]]
    tail = []
    if kernel == "grid":
        ints += [plan["G"], int(plan["keep"])]
        tail = [None if copies is None else copies.data_ptr()]
    _launched(name, lib_name, getattr(_lib(lib_name), _LAUNCH_FN[lib_name][0])(
        x.data_ptr(), tiles.data_ptr(), ids.data_ptr(), cols.data_ptr(), out.data_ptr(),
        *ints, *tail, torch.cuda.current_stream(x.device).cuda_stream), plan["kind"])
    return out


def block_ell_matmul(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul."""
    return _slot_walk("block_ell_matmul", "block_ell", x_padded, tiles, tile_ids,
                      col_blk, n_out_padded)


def block_ell_matmul_xres(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul_xres: the slot walk whose
    tile and x panels stream through a TMA ring (csrc/block_ell_xres.cu)."""
    return _slot_walk("block_ell_matmul_xres", "block_ell_xres", x_padded, tiles,
                      tile_ids, col_blk, n_out_padded, "xres")


def block_ell_matmul_xres2(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul_xres2."""
    return _slot_walk("block_ell_matmul_xres2", "block_ell", x_padded, tiles, tile_ids,
                      col_blk, n_out_padded)


def block_ell_matmul_xresd(x_padded, tiles, tile_ids, col_blk, n_out_padded,
                           depth=4):
    """Replaces pallas_kernels.block_ell_matmul_xresd; ``depth`` (>= 1) is
    the TPU's slot fusion and does not change the result."""
    if int(depth) != depth or depth < 1:
        raise ValueError("block_ell_matmul_xresd: depth must be a positive "
                         "integer, got %r" % (depth,))
    return _slot_walk("block_ell_matmul_xresd", "block_ell", x_padded, tiles,
                      tile_ids, col_blk, n_out_padded)


def block_ell_matmul_grid(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul_grid: the slot walk that
    keeps a staged tile slice while consecutive non-zero slots share its id,
    across row boundaries too (csrc/block_ell_grid.cu).  Returns
    (B, min(n_out_padded, n_rb·TM))."""
    return _slot_walk("block_ell_matmul_grid", "block_ell_grid", x_padded, tiles,
                      tile_ids, col_blk, n_out_padded, "grid")


def grid_tile_copies(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """block_ell_matmul_grid on a CUDA tensor with the kernel's tile copies
    counted on the device: (y, tile slices copied, summed over blocks; in
    stream mode every non-zero slot a block walks is one)."""
    if x_padded.device.type != "cuda":
        raise ValueError("grid_tile_copies: counts the CUDA kernel's copies; x is on %s"
                         % x_padded.device)
    copies = torch.zeros(1, dtype=torch.int64, device=x_padded.device)
    y = _slot_walk("block_ell_matmul_grid", "block_ell_grid", x_padded, tiles, tile_ids,
                   col_blk, n_out_padded, "grid", copies)
    return y, int(copies.item())


def periodic_block_ell_matvec(x_padded, tiles, tile_ids, col_blk, s, P, R):
    """Replaces pallas_kernels.periodic_block_ell_matvec: rows [s, s+P·R)
    of a row-block-periodic Block-ELL operator (tile_ids[s+ρ+j·P] ==
    tile_ids[s+ρ]; only rows [s, s+P) of tile_ids are read), returned as
    (B, P·R·TM) f32 with column block j·P+ρ for rep j of period row ρ."""
    name = "periodic_block_ell_matvec"
    s, P, R = int(s), int(P), int(R)
    if s < 0 or P < 1 or R < 1 or s + P * R > tile_ids.shape[0]:
        raise ValueError("%s: period (%d, %d, %d) does not fit %d row-blocks"
                         % (name, s, P, R, tile_ids.shape[0]))
    if x_padded.device.type == "cpu":
        return periodic_block_ell_plain(x_padded, tiles, tile_ids, col_blk, s, P, R)
    x, tiles, ids, cols = _operands(name, x_padded, tiles, tile_ids, col_blk)
    n_uniq, TM, TN = tiles.shape
    KB = ids.shape[1]
    B, n_cols = x.shape
    out = torch.empty((B, P * R * TM), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    plan = launch_plan(R * B, P * TM, TM, TN, tiles.dtype, "periodic")
    _launched(name, "periodic_block_ell", _lib("periodic_block_ell").periodic_block_ell(
        x.data_ptr(), tiles.data_ptr(), ids.data_ptr(), cols.data_ptr(),
        out.data_ptr(), B, n_cols, KB, TM, TN, s, P, R, plan["kind"], plan["BT"], plan["smem"],
        n_uniq, torch.cuda.current_stream(x.device).cuda_stream), plan["kind"])
    return out


def grouped_block_ell_matmul(x_padded, tiles, patterns, rows, col_blk, buckets,
                             n_out_padded, tables=None):
    """The grouped-row apply of a Block-ELL core (no Pallas counterpart):
    ``buckets`` lists (m, G) of a grouped-row plan, ``patterns``
    (ΣG, KB) int32 the G tile_ids rows of each bucket in turn, ``rows``
    (n_rb,) int32 the row-blocks of each bucket's groups in turn (group g of
    a bucket at rows[g·m : (g+1)·m], every row-block once), col_blk
    (n_rb, KB) int32.  Each row-block r of group g gives
    y[:, r·TM:(r+1)·TM] = Σ_k x[:, col_blk[r,k]·TN : +TN] @ tiles[patterns[g,k]]ᵀ,
    accumulated and returned in f32 as (B, min(n_out_padded, n_rb·TM)).
    On a CUDA tensor one launch of csrc/grouped_block_ell.cu a row tile, as
    ``tables`` (grouped_tables at this B, on the card; made now if None)
    lays them out: each pattern's tiles read through its ids, x through
    col_blk, id-0 slots skipped, each output written once, in place."""
    name = "grouped_block_ell_matmul"
    buckets = [(int(m), int(G)) for m, G in buckets]
    n_rb, KB = col_blk.shape
    if tuple(rows.shape) != (n_rb,) or sum(m * G for m, G in buckets) != n_rb \
            or tuple(patterns.shape) != (sum(G for _, G in buckets), KB):
        raise ValueError("%s: buckets %s, patterns %s and rows %s do not fit col_blk %s"
                         % (name, buckets, tuple(patterns.shape), tuple(rows.shape),
                            tuple(col_blk.shape)))
    if x_padded.device.type == "cpu":
        return grouped_block_ell_plain(x_padded, tiles, patterns, rows, col_blk, buckets,
                                       n_out_padded)
    x, tiles, patterns, cols = _operands(name, x_padded, tiles, patterns, col_blk,
                                         same_rows=False)
    if rows.device != x.device or rows.dtype != torch.int32:
        raise ValueError("%s: rows must be int32 on %s" % (name, x.device))
    rows = rows.contiguous()
    TM, TN = tiles.shape[1], tiles.shape[2]
    B, n_cols = x.shape
    out = torch.empty((B, n_rb * TM), dtype=torch.float32, device=x.device)
    n_out = min(int(n_out_padded), n_rb * TM)
    if B == 0:
        return out[:, :n_out]
    if tables is None:
        tables = grouped_tables(buckets, patterns, B, TM, TN, tiles.dtype, x.device)
    if tables["B"] != B:
        raise ValueError("%s: tables made for B=%d, x has B=%d" % (name, tables["B"], B))
    launch = _lib("grouped_block_ell").grouped_block_ell
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for plan, table in tables["launches"]:
        _launched(name, "grouped_block_ell", launch(
            x.data_ptr(), tiles.data_ptr(), patterns.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), table.data_ptr(), out.data_ptr(), B, n_cols, KB, TM, TN, n_rb,
            table.shape[0], plan["kind"], plan["BT"], plan["smem"], stream), plan["kind"])
    return out[:, :n_out]
