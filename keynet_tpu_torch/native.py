"""Loader for the optional C++ host-runtime extension (native/packer.cpp),
built as ``keynet_tpu_torch._native`` from the same source as the JAX
package's extension.

Build with ``python setup.py build_ext --inplace``.  When absent, callers use
the vectorized numpy fallbacks; when present, strip packing runs ~5-10x faster
(single-pass scatter + dedup hash instead of sort-based numpy unique).  This
is host code: the numpy fallbacks give the same operators, and only the
order of deduplicated tiles (so ``tile_ids``) may differ between the paths.
"""


def _autobuild():
    """Build the extension in place on first import when the source tree is
    present but the .so is not (fresh checkouts: *.so is gitignored);
    failures fall through silently to the numpy path."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.exists(os.path.join(root, "setup.py")) \
            or not os.path.exists(os.path.join(root, "native", "packer.cpp")):
        return
    try:
        subprocess.run([sys.executable, "setup.py", "build_ext", "--inplace"],
                       cwd=root, capture_output=True, timeout=300, check=True)
    except (OSError, subprocess.SubprocessError):
        pass


try:
    import numpy as _np

    try:
        from keynet_tpu_torch import _native  # built in-place into the package dir
    except ImportError:
        _autobuild()
        from keynet_tpu_torch import _native

    # stale-build probe: pack_strip must return (pairs, tiles, counts)
    _z = _np.zeros(1, dtype=_np.int64)
    if len(_native.pack_strip(_z, _z, _np.zeros(1, dtype=_np.float32), 8, 8, 1)) != 3:
        raise ImportError("stale _native build: rebuild with "
                          "`python setup.py build_ext --inplace`")

    def available():
        return True

    pack_strip = _native.pack_strip
    tile_hashes = _native.tile_hashes
    # newer symbols resolve to None on a stale build (numpy/older-path fallback)
    toeplitz_fill = getattr(_native, "toeplitz_fill", None)
    pack_strip_hash = getattr(_native, "pack_strip_hash", None)
    take_tiles = getattr(_native, "take_tiles", None)
    tile_hashes128 = getattr(_native, "tile_hashes128", None)
    emit_pba_fill = getattr(_native, "emit_pba_fill", None)
    pack_csr_hash = getattr(_native, "pack_csr_hash", None)
    spgemm_dr = getattr(_native, "spgemm_dr", None)
    if spgemm_dr is not None:
        # stale-build probe: newer builds accept d=None (plain S*R product)
        try:
            _ip = _np.zeros(2, dtype=_np.int64)
            spgemm_dr(_ip, _np.zeros(0, dtype=_np.int32),
                      _np.zeros(0, dtype=_np.float32), None,
                      _np.zeros(1, dtype=_np.int64),
                      _np.zeros(0, dtype=_np.int32),
                      _np.zeros(0, dtype=_np.float32),
                      _ip.copy(), _np.zeros(0, dtype=_np.int32),
                      _np.zeros(0, dtype=_np.float32))
        except TypeError:
            raise ImportError("stale _native build: rebuild with "
                              "`python setup.py build_ext --inplace`")
except ImportError:  # pragma: no cover - exercised when ext is not built
    _native = None

    def available():
        return False

    pack_strip = None
    tile_hashes = None
    toeplitz_fill = None
    pack_strip_hash = None
    take_tiles = None
    tile_hashes128 = None
    emit_pba_fill = None
    pack_csr_hash = None
    spgemm_dr = None
