"""Block-ELL slot-walk kernels: wrappers, plain versions and launch counts.

The counterpart of keynet_tpu/ops/pallas_kernels.py.  Three entries keep the
JAX names and signatures and launch one CUDA kernel (csrc/block_ell.cu):

  block_ell_matmul(x_padded, tiles, tile_ids, col_blk, n_out_padded)
  block_ell_matmul_xres2(x_padded, tiles, tile_ids, col_blk, n_out_padded)
  block_ell_matmul_xresd(x_padded, tiles, tile_ids, col_blk, n_out_padded, depth=4)

On the TPU they differ in where x lives and in how many slots one dot fuses
(``depth``); the CUDA kernel walks the slots one by one, so ``depth`` is
checked and changes nothing.  Each entry keeps its own launch count.

Contract (pallas_kernels.py:15-16, :96-98): x is (B, n_cb·TN) and is cast
to the tile dtype; tiles are (n_uniq, TM, TN) f32 or bf16 with tile 0 all
zeros; tile_ids and col_blk are (n_rb, KB) int32;
y[:, r·TM:(r+1)·TM] = Σ_k x[:, col_blk[r,k]·TN : +TN] @ tiles[tile_ids[r,k]]ᵀ,
accumulated and returned in f32 as (B, n_out_padded); columns past n_rb·TM
are zero.  A slot with tile id 0 adds nothing.

On a CPU tensor each entry computes ``block_ell_plain``; on a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES[name]`` counts kernel launches
only.  The kernel is compiled with nvcc at first use into build/kernels/ and
bound with ctypes.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..globals import GLOBAL

ENTRIES = ("block_ell_matmul", "block_ell_matmul_xres2", "block_ell_matmul_xresd")
LAUNCHES = {name: 0 for name in ENTRIES}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "keynet_tpu_torch", "csrc", "block_ell.cu")
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")
_LIB = None
_LOCK = threading.Lock()


def reset_launches():
    for name in ENTRIES:
        LAUNCHES[name] = 0


def route(KB):
    """The slot-walk entry for rows of KB slots, whatever the batch: xresd
    (depth 4) when KB >= 8, else xres2, as operators.py:442-447 routes the
    Pallas entries (the TPU's VMEM fit gates have no counterpart here)."""
    if KB >= 8:
        return block_ell_matmul_xresd
    return block_ell_matmul_xres2


# ------------------------------------------------------------------ plain

def block_ell_plain(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """The contract in plain PyTorch: gather + einsum (operators.py:453-458),
    chunked over row-blocks so the gathered tiles and x blocks stay under
    GLOBAL['PERIODIC_X_CHUNK_BYTES'].  bf16 operands are widened to f32
    after rounding, so products and sums are f32 as in the kernel."""
    B = x_padded.shape[0]
    n_rb, KB = tile_ids.shape
    TM, TN = tiles.shape[1], tiles.shape[2]
    xb = x_padded.to(tiles.dtype).reshape(B, -1, TN)
    out = torch.zeros((B, n_out_padded), dtype=torch.float32, device=x_padded.device)
    budget = int(GLOBAL.get("PERIODIC_X_CHUNK_BYTES", 256 << 20))
    rc = max(1, budget // max(1, KB * TN * 4 * (TM + B)))
    ids, cols = tile_ids.long(), col_blk.long()
    n_rows = min(n_rb, -(-n_out_padded // TM))
    for r0 in range(0, n_rows, rc):
        r1 = min(n_rows, r0 + rc)
        xg = xb[:, cols[r0:r1]].float()              # (B, rc, KB, TN)
        tg = tiles[ids[r0:r1]].float()               # (rc, KB, TM, TN)
        y = torch.einsum("brkn,rkmn->brm", xg, tg).reshape(B, -1)
        c1 = min(n_out_padded, r1 * TM)
        out[:, r0 * TM:c1] = y[:, :c1 - r0 * TM]
    return out


# ------------------------------------------------------------------ build

def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Block-ELL CUDA kernel needs the CUDA toolkit")


def build(verbose=False):
    """Compile csrc/block_ell.cu for sm_90a (once per source content) and
    load it; returns the ctypes library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        so = os.path.join(BUILD_DIR, "libblock_ell_%s.so" % digest)
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (so, os.getpid())
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", tmp, SOURCE]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed (%d):\n%s" % (res.returncode, res.stderr))
            if verbose:
                print(res.stderr.strip())
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        fn = lib.block_ell_slot_walk
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.block_ell_error_string.argtypes = [ctypes.c_int]
        lib.block_ell_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


# ------------------------------------------------------------------ launch

def _slot_walk(name, x_padded, tiles, tile_ids, col_blk, n_out_padded):
    dev = x_padded.device
    if dev.type == "cpu":
        return block_ell_plain(x_padded, tiles, tile_ids, col_blk, n_out_padded)
    if dev.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, dev))
    if tiles.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s: tiles must be float32 or bfloat16, got %s" % (name, tiles.dtype))
    for t, what in ((tiles, "tiles"), (tile_ids, "tile_ids"), (col_blk, "col_blk")):
        if t.device != dev:
            raise ValueError("%s: %s on %s, x on %s" % (name, what, t.device, dev))
    if tile_ids.dtype != torch.int32 or col_blk.dtype != torch.int32:
        raise TypeError("%s: tile_ids and col_blk must be int32" % name)
    n_uniq, TM, TN = tiles.shape
    n_rb, KB = tile_ids.shape
    B, n_cols = x_padded.shape
    if TM % 128 or TN % 128:
        raise ValueError("%s: TM and TN must be multiples of 128, got %s"
                         % (name, (TM, TN)))
    if n_cols % TN or tuple(col_blk.shape) != (n_rb, KB):
        raise ValueError("%s: x width %d / col_blk %s do not fit TN=%d"
                         % (name, n_cols, tuple(col_blk.shape), TN))
    n_out = int(n_out_padded)
    if -(-n_out // 128) > 65535:
        raise ValueError("%s: n_out_padded %d exceeds the grid" % (name, n_out))
    x = x_padded.to(tiles.dtype).contiguous()
    tiles = tiles.contiguous()
    ids, cols = tile_ids.contiguous(), col_blk.contiguous()
    out = torch.empty((B, n_out), dtype=torch.float32, device=dev)
    if B == 0 or n_out == 0:
        return out
    lib = build()
    err = lib.block_ell_slot_walk(
        x.data_ptr(), tiles.data_ptr(), ids.data_ptr(), cols.data_ptr(),
        out.data_ptr(), B, n_cols, n_rb, KB, TM, TN, n_out,
        int(tiles.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("%s: kernel launch failed: %s"
                           % (name, lib.block_ell_error_string(err).decode()))
    LAUNCHES[name] += 1
    return out


def block_ell_matmul(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul."""
    return _slot_walk("block_ell_matmul", x_padded, tiles, tile_ids,
                      col_blk, n_out_padded)


def block_ell_matmul_xres2(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul_xres2."""
    return _slot_walk("block_ell_matmul_xres2", x_padded, tiles, tile_ids,
                      col_blk, n_out_padded)


def block_ell_matmul_xresd(x_padded, tiles, tile_ids, col_blk, n_out_padded,
                           depth=4):
    """Replaces pallas_kernels.block_ell_matmul_xresd; ``depth`` (>= 1) is
    the TPU's slot fusion and does not change the result."""
    if int(depth) != depth or depth < 1:
        raise ValueError("block_ell_matmul_xresd: depth must be a positive "
                         "integer, got %r" % (depth,))
    return _slot_walk("block_ell_matmul_xresd", x_padded, tiles,
                      tile_ids, col_blk, n_out_padded)
