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

  block_ell_matmul_xres(...)   the slot walk with a cp.async tile ring
                               (csrc/block_ell_xres.cu)
  block_ell_matmul_grid(...)   the slot walk that keeps a staged tile over
                               repeated ids (csrc/block_ell_grid.cu)

The sixth launches the periodic kernel (csrc/periodic_block_ell.cu):

  periodic_block_ell_matvec(x_padded, tiles, tile_ids, col_blk, s, P, R)

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
``periodic_block_ell_plain``); on a CUDA tensor it launches its kernel or
raises.  ``LAUNCHES[name]`` counts kernel launches only.  The kernels are
compiled with nvcc at first use into build/kernels/ (one nvcc per source,
started together) and bound with ctypes.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..globals import GLOBAL

ENTRIES = ("block_ell_matmul", "block_ell_matmul_xres", "block_ell_matmul_xres2",
           "block_ell_matmul_xresd", "block_ell_matmul_grid", "periodic_block_ell_matvec")
LAUNCHES = {name: 0 for name in ENTRIES}
GROUP = 8  # row-blocks per grid step of the row-padded Pallas entries

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "keynet_tpu_torch", "csrc")
# library name -> CUDA source; each source builds into its own library
SOURCES = {"block_ell": os.path.join(_CSRC, "block_ell.cu"),
           "block_ell_xres": os.path.join(_CSRC, "block_ell_xres.cu"),
           "block_ell_grid": os.path.join(_CSRC, "block_ell_grid.cu"),
           "periodic_block_ell": os.path.join(_CSRC, "periodic_block_ell.cu")}
# library name -> (launch function, number of int arguments)
_LAUNCH_FN = {"block_ell": ("block_ell_slot_walk", 8), "block_ell_xres": ("block_ell_xres", 8),
              "block_ell_grid": ("block_ell_grid", 8),
              "periodic_block_ell": ("periodic_block_ell", 9)}
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")
_SMEM_MAX = 232448  # shared memory one block may use on sm_90
_LIBS = {}
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

def out_width(n_rb, TM, n_out_padded, grid=False):
    """The width a JAX entry returns: its natural width, n_rb·TM for the grid
    entry and ⌈n_rb/GROUP⌉·GROUP·TM for the others, cut to n_out_padded."""
    natural = n_rb * TM if grid else -(-n_rb // GROUP) * GROUP * TM
    return min(int(n_out_padded), natural)


def block_ell_plain(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """The contract in plain PyTorch: gather + einsum (operators.py:453-458),
    chunked over row-blocks so the gathered tiles and x blocks stay under
    GLOBAL['PERIODIC_X_CHUNK_BYTES'].  bf16 operands are widened to f32
    after rounding, so products and sums are f32 as in the kernel.  Returns
    (B, out_width(n_rb, TM, n_out_padded)), the row-padded entries' width."""
    B = x_padded.shape[0]
    n_rb, KB = tile_ids.shape
    TM, TN = tiles.shape[1], tiles.shape[2]
    n_out_padded = out_width(n_rb, TM, n_out_padded)
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


def periodic_block_ell_plain(x_padded, tiles, tile_ids, col_blk, s, P, R,
                             texp=None):
    """The periodic contract in plain PyTorch: the period's tiles
    tiles[tile_ids[s:s+P]] gathered once (or ``texp``, that expansion made
    beforehand) and one einsum per chunk of reps over the x blocks each rep's
    columns pick, the chunk sized so the gathered x blocks stay under
    GLOBAL['PERIODIC_X_CHUNK_BYTES'] (operators.py:460-482).  Returns
    (B, P·R·TM) f32, column block j·P+ρ for rep j of period row ρ."""
    B = x_padded.shape[0]
    KB = tile_ids.shape[1]
    TN = tiles.shape[2]
    xb = x_padded.to(tiles.dtype).reshape(B, -1, TN)
    T = (texp if texp is not None else tiles[tile_ids[s:s + P].long()]).float()
    cols = col_blk[s:s + P * R].long().reshape(R, P, KB)
    budget = int(GLOBAL.get("PERIODIC_X_CHUNK_BYTES", 256 << 20))
    rc = max(1, min(R, budget // max(1, B * P * KB * TN * tiles.element_size())))
    parts = []
    for j0 in range(0, R, rc):
        Xt = xb[:, cols[j0:j0 + rc]].float()            # (B, rj, P, KB, TN)
        y = torch.einsum("brpkn,pkmn->brpm", Xt, T)
        parts.append(y.reshape(B, -1))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


# ------------------------------------------------------------------ build

def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Block-ELL CUDA kernel needs the CUDA toolkit")


def _headers():
    """The shared headers in csrc/ (part of every source's build digest)."""
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh"))


def _bind(name, lib):
    """Set the ctypes signature of a library's launch and error functions."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn_name, n_int = _LAUNCH_FN[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ptr] * 5 + [i32] * n_int + [ptr]
    fn.restype = i32
    err = getattr(lib, name + "_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return lib


def build(verbose=False):
    """Compile every CUDA source for sm_90a (once per source content, one
    nvcc process per source, all started together) and load them; returns
    {library name: ctypes library}."""
    with _LOCK:
        jobs = []
        for name, src in SOURCES.items():
            if name in _LIBS:
                continue
            h = hashlib.sha1()
            for path in [src] + _headers():
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
            if proc.returncode != 0:
                failed.append("nvcc %s failed (%d):\n%s" % (name, proc.returncode, err))
                continue
            if verbose:
                print(err.strip())
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, so, _, _ in jobs:
            _LIBS[name] = _bind(name, ctypes.CDLL(so))
        return dict(_LIBS)


def _lib(name):
    lib = _LIBS.get(name)
    return lib if lib is not None else build()[name]


# ------------------------------------------------------------------ launch

def _operands(name, x_padded, tiles, tile_ids, col_blk):
    """Check the operands of a CUDA launch (device, dtypes, shapes) and
    return them contiguous, x cast to the tile dtype."""
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
    if x_padded.shape[1] % TN or tuple(col_blk.shape) != tuple(tile_ids.shape):
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


def _launched(name, lib_name, err):
    """Raise on a refused launch (err = cudaGetLastError() after it), else
    count it."""
    if err != 0:
        msg = getattr(_LIBS[lib_name], lib_name + "_error_string")(err).decode()
        raise RuntimeError("%s: kernel launch failed: %s" % (name, msg))
    LAUNCHES[name] += 1


def _slot_walk(name, lib_name, x_padded, tiles, tile_ids, col_blk, n_out_padded,
               grid=False):
    """One slot-walk entry: the plain version on a CPU tensor, else the
    launch of library ``lib_name``'s kernel; (B, out_width(..., grid)) f32."""
    n_out = out_width(tile_ids.shape[0], tiles.shape[1], n_out_padded, grid)
    if x_padded.device.type == "cpu":
        return block_ell_plain(x_padded, tiles, tile_ids, col_blk, n_out)
    x, tiles, ids, cols = _operands(name, x_padded, tiles, tile_ids, col_blk)
    _, TM, TN = tiles.shape
    n_rb, KB = ids.shape
    B, n_cols = x.shape
    if -(-n_out // 128) > 65535:
        raise ValueError("%s: n_out_padded %d exceeds the grid" % (name, n_out))
    if grid and (128 + 64) * (TN * tiles.element_size() + 16) > _SMEM_MAX:
        raise ValueError("%s: a %d-wide tile slice does not fit a block's shared "
                         "memory" % (name, TN))
    out = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    if B == 0 or n_out == 0:
        return out
    _launched(name, lib_name, getattr(_lib(lib_name), _LAUNCH_FN[lib_name][0])(
        x.data_ptr(), tiles.data_ptr(), ids.data_ptr(), cols.data_ptr(),
        out.data_ptr(), B, n_cols, n_rb, KB, TM, TN, n_out,
        int(tiles.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream))
    return out


def block_ell_matmul(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul."""
    return _slot_walk("block_ell_matmul", "block_ell", x_padded, tiles, tile_ids,
                      col_blk, n_out_padded)


def block_ell_matmul_xres(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """Replaces pallas_kernels.block_ell_matmul_xres: the slot walk whose
    tile panels stream through a cp.async ring (csrc/block_ell_xres.cu)."""
    return _slot_walk("block_ell_matmul_xres", "block_ell_xres", x_padded, tiles,
                      tile_ids, col_blk, n_out_padded)


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
    keeps a staged tile slice while consecutive non-zero slots share its id
    (csrc/block_ell_grid.cu).  Returns (B, min(n_out_padded, n_rb·TM))."""
    return _slot_walk("block_ell_matmul_grid", "block_ell_grid", x_padded, tiles,
                      tile_ids, col_blk, n_out_padded, grid=True)


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
    _, TM, TN = tiles.shape
    KB = ids.shape[1]
    B, n_cols = x.shape
    if P * (TM // 128) > 65535 or -(-R * B // 64) > 2 ** 31 - 1:
        raise ValueError("%s: P=%d, R=%d, B=%d exceed the grid" % (name, P, R, B))
    out = torch.empty((B, P * R * TM), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    _launched(name, "periodic_block_ell", _lib("periodic_block_ell").periodic_block_ell(
        x.data_ptr(), tiles.data_ptr(), ids.data_ptr(), cols.data_ptr(),
        out.data_ptr(), B, n_cols, KB, TM, TN, s, P, R,
        int(tiles.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream))
    return out
