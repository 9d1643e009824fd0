"""Global configuration for keynet_tpu_torch.

The same GLOBAL keys as the JAX package, so a configuration carries across.
``precision()`` sets PyTorch's float32 flags instead of returning a
``lax.Precision``; ``resolve_device`` is the one place that decides where the
entry points run.
"""

import torch

GLOBAL = {
    "PROCESSES": 1,     # accepted for API parity; keygen parallelism comes from vectorization
    "VERBOSE": False,   # print per-layer progress during keying
    "DTYPE": "float32",  # on-device dtype for keyed matrices
    "DENSE_MAX_BYTES": 256 * 1024 * 1024,  # auto-format threshold: dense below this
    "KEEP_HOST_NNZ": 50_000_000,  # keep host CSR for keyed matrices up to this nnz
    "USE_PALLAS": "auto",  # kept for configuration parity; the port always routes by device
    # conv layers whose Toeplitz nnz exceeds this stream strip-wise instead of
    # materializing
    "STREAM_NNZ": 30_000_000,
    # float32 matmul/conv precision: 'highest' = IEEE f32 everywhere (the
    # exact-equivalence contract, atol 1e-5); 'high'/'default' allow TF32
    "PRECISION": "highest",
    # keep freed large buffers on the process heap (see tune_allocator);
    # disable with KEYNET_TPU_MALLOPT=0
    "MALLOPT": True,
    # opt-in debug pass: assert A @ Ainv == I for every generated keypair
    "SELFCHECK": False,
    # Block-ELL tile storage dtype: 'float32' (exact, atol 1e-5 contract) or
    # 'bfloat16' (~1e-3 relative); f32 accumulation either way
    "TILE_DTYPE": "float32",
    # periodic apply path: cap on the gathered x-blocks materialized per einsum
    "PERIODIC_X_CHUNK_BYTES": 256 << 20,
    # grouped-row apply (find_row_groups): only plan row-pattern dedup for
    # non-periodic Block-ELL ops whose per-forward slot traffic exceeds this
    "ROWGROUP_MIN_SLOT_BYTES": 64 << 20,
    # Kronecker-factored keyed convs (ops/kronfactor.py): 'auto' | 'never'
    "KRON_FACTORED": "auto",
    # dense spatial factors are (npix, npix); cap the pixel count
    "KRON_NPIX_MAX": 1024,
    # strength floor of the secret conversion-time THIN masks
    # (ops/streaming.split_dense_inverse), see _mask_rotations
    "MASK_ALPHA": 2,
    # dense-Haar mask affordability gate for materialized layers
    "MASK_DENSE_MAX_BYTES": 64 << 20,
}


def tune_allocator():
    """Keep large freed buffers on the glibc heap (warm pages) instead of
    munmap-ing them back to the OS: host conversion churns multi-GB numpy
    temporaries, and first-touch page faults dominate emission-bound layers.
    Opt out with KEYNET_TPU_MALLOPT=0."""
    import os
    if os.environ.get("KEYNET_TPU_MALLOPT", "1") == "0" or not GLOBAL["MALLOPT"]:
        return False
    try:
        import ctypes
        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        ok = libc.mallopt(M_TRIM_THRESHOLD, ctypes.c_int(2**31 - 1))
        ok &= libc.mallopt(M_MMAP_THRESHOLD, ctypes.c_int(2**31 - 1))
        ok &= libc.mallopt(M_MMAP_MAX, ctypes.c_int(0))
        _madvise_heap_hugepages(libc)
        return bool(ok)
    except Exception:
        return False


def _madvise_heap_hugepages(libc=None):
    """MADV_HUGEPAGE every [heap] VMA so heap pages are THP-backed (best
    effort: a no-op if /proc/self/maps is unreadable or the call fails)."""
    try:
        import ctypes
        if libc is None:
            libc = ctypes.CDLL(None)
        MADV_HUGEPAGE = 14
        with open("/proc/self/maps") as f:
            for line in f:
                if line.rstrip().endswith("[heap]"):
                    lo, hi = (int(a, 16) for a in line.split()[0].split("-"))
                    libc.madvise(ctypes.c_void_p(lo),
                                 ctypes.c_size_t(hi - lo), MADV_HUGEPAGE)
    except Exception:
        pass


def precision(p=None):
    """Set PyTorch's float32 matmul and cuDNN conv precision from
    GLOBAL['PRECISION'] and return the mode name.  'highest' means IEEE f32
    in cuBLAS and cuDNN alike: cuDNN's TF32 default would otherwise make the
    source-model convs drift from the keyed path."""
    if p is not None:
        GLOBAL["PRECISION"] = p
    mode = GLOBAL["PRECISION"]
    ieee = mode == "highest"
    torch.backends.cuda.matmul.allow_tf32 = not ieee
    torch.backends.cudnn.allow_tf32 = not ieee
    torch.set_float32_matmul_precision("highest" if ieee else "high")
    fp32 = "ieee" if ieee else "tf32"
    if hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        torch.backends.cuda.matmul.fp32_precision = fp32
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        conv.fp32_precision = fp32
    return mode


def resolve_device(device="cuda"):
    """The torch.device an entry point runs on.  A CUDA device without a
    card raises: the port never falls back to the CPU on its own, the caller
    asks for it with device='cpu'."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run keynet_tpu_torch on the CPU")
    return device


def backend():
    """The compute backend for keyed inference (the reference returned 'scipy')."""
    return "torch"


def num_processes(n=None, backend="torch"):
    if n is not None:
        GLOBAL["PROCESSES"] = int(n)
    return GLOBAL["PROCESSES"]


def verbose(b=None):
    if b is not None:
        GLOBAL["VERBOSE"] = bool(b)
    return GLOBAL["VERBOSE"]


def vprint(*args, **kwargs):
    if GLOBAL["VERBOSE"]:
        print(*args, **kwargs)
