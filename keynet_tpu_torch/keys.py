"""Key material: generalized-stochastic sparse key matrices with analytic inverses.

A layer key is the homogeneous composition  A = C^-1 · p · g · P · G · C
(reference keynet/system.py:467-468) where
  C  memory-order permutation (channel order -> block order),
  G  global geometric transform (permutation / hierarchical block permutation
     or rotation / Givens orthogonal),
  g  local (blockwise) geometric transform with one small block repeated down
     the diagonal (permutation / doubly stochastic / Givens orthogonal),
  P  global photometric transform (diagonal gain and/or bias),
  p  local (blockwise) photometric transform.

Every factor has a closed-form inverse (transpose for orthogonal/permutation,
reciprocal for diagonal, small dense inverse for doubly-stochastic blocks), so
keys never require a large matrix inversion.  Construction is host-side
vectorized numpy/scipy (no per-element Python loops; the reference's Numba/
multiprocess machinery is unnecessary); the device runtime consumes keys as
structured or blocked-sparse operators (keynet_tpu_torch/ops).

Family names, parameter schema (alpha/beta/gamma/blocksize/tileshape/
memoryorder/hierarchical_*) and ragged-size repair semantics follow the
reference public API (keynet/system.py:317-469) exactly, since that schema IS
the user-facing config system.
"""

import numpy as np
import scipy.sparse

from .util import find_closest_positive_divisor, blockorder_indices, channel_to_pixel_order_indices
from .blockpermute import hierarchical_block_permutation, permutation_vector_to_matrix
from .homogeneous import sparse_affine_to_linear, diagonal_affine_to_linear

_DTYPE = np.float64

ALLOWABLE_MEMORYORDER = {"channel", "block"}
ALLOWABLE_GLOBAL_GEOMETRIC = {"identity", "permutation", "hierarchical_permutation",
                              "hierarchical_rotation", "givens_orthogonal"}
ALLOWABLE_LOCAL_GEOMETRIC = {"identity", "permutation", "doubly_stochastic", "givens_orthogonal"}
ALLOWABLE_PHOTOMETRIC = {"identity", "uniform_random_gain", "uniform_random_affine",
                         "uniform_random_bias", "constant_bias", "linear_bias",
                         "blockwise_constant_bias"}


# ------------------------------------------------------------ primitive families

def identity_matrix(n, dtype=_DTYPE):
    return scipy.sparse.identity(n, dtype=dtype, format="csr")


def permutation_matrix(n, rng, withinverse=False, dtype=_DTYPE):
    """Uniform random n x n permutation; inverse = transpose
    (reference keynet/sparse.py:280-285)."""
    perm = rng.permutation(n)
    P = permutation_vector_to_matrix(perm).astype(dtype).tocsr()
    return (P, P.T.tocsr()) if withinverse else P


def givens_orthogonal_matrix(n, k_iter, rng, withinverse=False, dtype=_DTYPE):
    """Product of k_iter random Givens rotations over "balanced" index pairs
    (every index is used once before any is reused); inverse = transpose.

    Spec: reference keynet/sparse.py:288-309 (balanced branch).  Implemented as
    sparse row-pair updates on a dict of touched rows (O(k_iter * nnz/row))
    instead of repeated spgemm.
    """
    assert n >= 2
    touched = {}  # row index -> dense row restricted to touched columns: dict col->val

    def getrow(i):
        return touched.get(i, {i: 1.0})

    pool = []
    for _ in range(int(k_iter)):
        if len(pool) <= 1:
            pool = list(rng.permutation(n)) + pool
        i, j = pool.pop(), pool.pop()
        while j == i:  # refill leftover can collide with the new permutation's
            if not pool:  # tail; an i==j "rotation" would break A^-1 = A^T
                pool = list(rng.permutation(n))
            j = pool.pop()
        theta = rng.random() * 2 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        ri, rj = getrow(i), getrow(j)
        # S' = G S with G the rotation acting on coordinates (i, j):
        # row_i' = c*row_i - s*row_j ; row_j' = s*row_i + c*row_j
        new_i, new_j = {}, {}
        for col in set(ri) | set(rj):
            a, b = ri.get(col, 0.0), rj.get(col, 0.0)
            new_i[col] = c * a - s * b
            new_j[col] = s * a + c * b
        touched[i], touched[j] = new_i, new_j

    rows, cols, vals = [], [], []
    untouched = np.setdiff1d(np.arange(n), np.fromiter(touched.keys(), dtype=np.int64,
                                                       count=len(touched)))
    rows.append(untouched)
    cols.append(untouched)
    vals.append(np.ones(len(untouched)))
    for i, row in touched.items():
        cc = np.fromiter(row.keys(), dtype=np.int64, count=len(row))
        vv = np.fromiter(row.values(), dtype=np.float64, count=len(row))
        rows.append(np.full(len(cc), i, dtype=np.int64))
        cols.append(cc)
        vals.append(vv)
    S = scipy.sparse.coo_matrix((np.concatenate(vals),
                                 (np.concatenate(rows), np.concatenate(cols))),
                                shape=(n, n), dtype=dtype).tocsr()
    return (S, S.T.tocsr()) if withinverse else S


def uniform_random_diagonal(n, rng, scale=1.0, bias=0.0, eps=1e-6):
    """Diagonal gain vector sampled from scale*U[0,1] + eps + bias
    (reference keynet/sparse.py:318-321)."""
    return scale * rng.random(n) + eps + bias


def gaussian_random_diagonal(n, rng, mu=1.0, sigma=1.0, eps=1e-6):
    """Diagonal gain vector max(N(mu, sigma), eps) (reference keynet/sparse.py:312-315)."""
    return np.maximum(eps, sigma * rng.standard_normal(n) + mu)


def birkhoff_doubly_stochastic_matrix(n, k, rng, dtype=_DTYPE):
    """Convex combination of k random permutation matrices — doubly stochastic
    by Birkhoff's theorem (reference keynet/sparse.py:324-332; no analytic
    inverse, provided for API parity/experimentation)."""
    coef = rng.random(k)
    coef = coef / coef.sum()
    A = coef[0] * permutation_matrix(n, rng, dtype=dtype)
    for c in coef[1:]:
        A = A + c * permutation_matrix(n, rng, dtype=dtype)
    return A.tocsr()


def doubly_stochastic_matrix(n, k, rng, n_iter=100, withinverse=False, dtype=_DTYPE):
    """Diagonally-dominant doubly-stochastic matrix with <= k nonzeros per row,
    Sinkhorn-normalized then permuted; inverse is a direct dense inverse of the
    (small) block (reference keynet/sparse.py:335-353, guard at blocksize 8192).

    The alpha privacy parameter of keygen maps to k: larger k = denser key.
    """
    assert n < 8192 or not withinverse, "doubly_stochastic block must be < 8192 for direct inverse"
    n_iter = 10 if k <= 3 else n_iter
    d = rng.random((k, n))
    d[0, :] = np.maximum(d[0, :], np.sum(d[1:, :], axis=0) + 0.1)  # main diagonal dominates
    d = d / np.sum(d, axis=0, keepdims=True)
    offsets = [o for o in (list(range(-((k - 1) // 2), 1 + (k - 1) // 2)) if k % 2 == 1
                           else list(range(-(k // 2), k // 2))) if o != 0]
    offsets = [0] + offsets
    A = scipy.sparse.spdiags(d, offsets, n, n).toarray()
    for _ in range(n_iter):
        A = A / np.maximum(A.sum(axis=0, keepdims=True), 1e-30)
        A = A / np.maximum(A.sum(axis=1, keepdims=True), 1e-30)
    P1 = permutation_matrix(n, rng).toarray()
    P2 = permutation_matrix(n, rng).toarray()
    A = P1 @ A @ P2
    As = scipy.sparse.csr_matrix(A.astype(dtype))
    if not withinverse:
        return As
    Ainv = scipy.sparse.csr_matrix(np.linalg.inv(A).astype(dtype))
    return As, Ainv


def positive_definite_block_diagonal(n, m, rng, withinverse=False, dtype=_DTYPE):
    """n x n matrix with random positive-definite m x m blocks on the diagonal
    (reference keynet/sparse.py:356-367); inverse block-by-block."""
    m = min(n, m)
    sizes = [m] * (n // m) + ([n % m] if n % m else [])

    def _pd(k):
        B = rng.random((k, k))
        U, _, V = np.linalg.svd(B.T @ B)
        return U @ np.diag(1.0 + rng.random(k)) @ V

    blocks = [_pd(k) for k in sizes]
    A = scipy.sparse.block_diag(blocks, format="csr", dtype=dtype)
    if not withinverse:
        return A
    Ainv = scipy.sparse.block_diag([np.linalg.inv(b) for b in blocks], format="csr", dtype=dtype)
    return A, Ainv


def repeat_block_diagonal(B, shape, dtype=_DTYPE):
    """Repeat sparse block B down the main diagonal of a matrix of ``shape``,
    with a ragged remainder filled by a clipped identity tile.

    Semantics of the reference's DiagonalTiledMatrix (keynet/sparse.py:657-687):
    full copies of B at stride blockshape; if the tail is ragged, an identity
    tile eye[0:r, 0:c] is placed there instead.
    """
    H, W = shape
    h, w = B.shape
    r = min(H % h, W % w)
    if H % h == W % w and (H - r) // h == (W - r) // w:
        # aligned fast path (+ small identity tail handled in-line): emit CSR
        # directly (no COO sort) — dense-block inverses at VGG scale reach
        # ~1e8-1e9 nnz, where coo_tocsr and int64 indices dominate keygen
        B = scipy.sparse.csr_matrix(B)
        n = (H - r) // h
        idt = np.int32 if W <= np.iinfo(np.int32).max else np.int64
        counts = np.diff(B.indptr)
        tail_counts = np.ones(r, dtype=counts.dtype) if r else \
            np.empty(0, dtype=counts.dtype)
        indptr = np.concatenate(
            [[0], np.cumsum(np.concatenate([np.tile(counts, n), tail_counts]))])
        indices = (B.indices[None, :].astype(idt)
                   + (np.arange(n, dtype=idt)[:, None] * w)).reshape(-1)
        data = np.tile(B.data.astype(dtype, copy=False), n)
        if r:
            indices = np.concatenate(
                [indices, (n * w + np.arange(r)).astype(idt)])
            data = np.concatenate([data, np.ones(r, dtype=dtype)])
        return scipy.sparse.csr_matrix((data, indices, indptr), shape=(H, W))
    B = scipy.sparse.coo_matrix(B)
    # Number of FULL tiles: positions i=k*h, j=k*w with i+h<H and j+w<W get B;
    # the final position gets B only if it fits exactly, else the identity tile.
    nfit = min(H // h, W // w)
    offsets_i = np.arange(nfit) * h
    offsets_j = np.arange(nfit) * w
    rows = (B.row[None, :] + offsets_i[:, None]).reshape(-1)
    cols = (B.col[None, :] + offsets_j[:, None]).reshape(-1)
    vals = np.tile(B.data, nfit)
    ri, rj = H - nfit * h, W - nfit * w
    if ri > 0 or rj > 0:
        r = min(ri, rj)
        if r > 0:
            rr = np.arange(r)
            rows = np.concatenate([rows, nfit * h + rr])
            cols = np.concatenate([cols, nfit * w + rr])
            vals = np.concatenate([vals, np.ones(r)])
    return scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(H, W), dtype=dtype).tocsr()


def orthogonal_block_diagonal(mats, shape=None, withinverse=False, dtype=_DTYPE):
    """Block diagonal from a LIST of distinct orthogonal blocks, cycled down
    the diagonal, with ragged-edge clipping; inverse = transpose.

    Constructor-level parity with the reference's list form
    (keynet/sparse.py:238-269): ``mats`` may be a single matrix (equivalent to
    :func:`repeat_block_diagonal` on a square shape) or a list of equal-sized
    square blocks placed as ``mats[k % len(mats)]`` at diagonal position k.
    Orthogonality of each block is assumed (not checked), exactly as in the
    reference; when every block is orthogonal the inverse of the assembly is
    its transpose.  Entries falling outside ``shape`` are clipped (the
    reference's ragged-edge behavior).
    """
    if isinstance(mats, np.ndarray) or scipy.sparse.issparse(mats):
        assert shape is not None and shape[0] == shape[1], \
            "single-matrix form requires an explicit square shape"
        mats = [mats]
    mats = [scipy.sparse.coo_matrix(m) for m in mats]
    h, w = mats[0].shape
    assert h == w and all(m.shape == (h, w) for m in mats), \
        "all blocks must be square and equal-sized"
    if shape is None:
        shape = (len(mats) * h, len(mats) * w)
    U, V = shape
    assert U == V, "orthogonal block diagonal must be square"
    rows, cols, vals = [], [], []
    for k, i in enumerate(range(0, U, h)):
        b = mats[k % len(mats)]
        keep = ((i + b.row) < U) & ((i + b.col) < V)  # ragged-edge clip
        rows.append(i + b.row[keep])
        cols.append(i + b.col[keep])
        vals.append(b.data[keep])
    A = scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(U, V), dtype=dtype).tocsr()
    return (A, A.T.tocsr()) if withinverse else A


def _emit_perm_blockdiag_affine(gv, Binner, N, d=None, b=None, dtype=_DTYPE,
                                chunk_entries=8 << 20):
    """One-pass CSR emission of  G · (I ⊗ Binner ⊕ 1) · diag-affine(d, b)  on
    homogeneous (N+1)² coordinates: row i is Binner row (gv[i] % h) placed at
    column offset gv[i] - gv[i] % h, columns scaled by ``d``, plus the bias
    entry Σ_j M0[gv[i], j]·b[j] in the last column; last row is e_N.

    This is the exact value of keygen's inverse-side composition
    Ginv·ginv·pinv for channel memoryorder — materialized ONCE.  The generic
    path costs four full passes over the result (tile, homogenize, permute,
    scale+add), which at VGG-224 stochastic scale is ~3e8 dense-block nnz ×
    ~13 GB per pass on a host whose first-touch page rate is the bottleneck.
    Chunked so temporaries stay ~100 MB.

    gv: (N+1,) permutation (gv[N] == N), or None for identity.
    d, b: (N+1,) diagonal scale / bias column vectors (d[N]==1, b[N]==0), or
    None.  Returns homogeneous CSR.
    """
    Binner = scipy.sparse.csr_matrix(Binner)
    h = Binner.shape[0]
    assert N % h == 0 and Binner.shape[1] == h
    if gv is None:
        src = np.arange(N, dtype=np.int64)
    else:
        assert gv[N] == N
        src = np.asarray(gv[:N], dtype=np.int64)
    rmod = src % h
    cnt = np.diff(Binner.indptr)
    counts = cnt[rmod].astype(np.int64)
    has_bias = b is not None
    indptr = np.empty(N + 2, dtype=np.int64)
    indptr[0] = 0
    np.cumsum(counts + (1 if has_bias else 0), out=indptr[1:N + 1])
    indptr[N + 1] = indptr[N] + 1                 # last row e_N
    nnz = int(indptr[N + 1])
    idt = np.int32 if N + 1 <= np.iinfo(np.int32).max else np.int64
    indices = np.empty(nnz, dtype=idt)
    data = np.empty(nnz, dtype=dtype)
    Bi = Binner.indices.astype(np.int64)
    Bd = Binner.data.astype(dtype, copy=False)
    from . import native as _native
    if _native.emit_pba_fill is not None and dtype == np.float64:
        # one-pass C++ fill (bitwise-equal to the chunked numpy path below,
        # which ran ~10 kernel passes over the ~3e8-entry result — 84 s at
        # the (64,224,224) stochastic window vs memory-bandwidth here)
        _native.emit_pba_fill(
            src, Binner.indptr.astype(np.int64), Bi,
            np.ascontiguousarray(Bd, dtype=np.float64),
            None if d is None else np.ascontiguousarray(d, dtype=np.float64),
            None if b is None else np.ascontiguousarray(b, dtype=np.float64),
            indptr, indices, data)
        indices[-1] = N
        data[-1] = 1.0
        M = scipy.sparse.csr_matrix((data, indices, indptr),
                                    shape=(N + 1, N + 1))
        if has_bias:
            M.eliminate_zeros()               # rows whose bias dot is 0
        return M
    # chunk by ENTRIES, not rows: dense inverse blocks put ~h nnz in every
    # row, so a row-count chunk would materialize multi-GB index temporaries
    chunk_rows = max(1024, int(chunk_entries // max(1, int(cnt.max()))))
    for r0 in range(0, N, chunk_rows):
        r1 = min(N, r0 + chunk_rows)
        c = counts[r0:r1]
        total = int(c.sum())
        within = np.arange(total, dtype=np.int64) \
            - np.repeat(np.concatenate(([0], np.cumsum(c[:-1]))), c)
        gpos = np.repeat(Binner.indptr[rmod[r0:r1]].astype(np.int64), c) + within
        cols = Bi[gpos] + np.repeat(src[r0:r1] - rmod[r0:r1], c)
        vals = Bd[gpos]
        pos = np.repeat(indptr[r0:r1], c) + within
        if has_bias:
            rid = np.repeat(np.arange(r1 - r0, dtype=np.int64), c)
            bv = np.bincount(rid, weights=vals * b[cols], minlength=r1 - r0)
            bpos = indptr[r0 + 1:r1 + 1] - 1
            indices[bpos] = N
            data[bpos] = bv.astype(dtype, copy=False)
        indices[pos] = cols.astype(idt, copy=False)
        data[pos] = vals * d[cols] if d is not None else vals
    indices[-1] = N
    data[-1] = 1.0
    M = scipy.sparse.csr_matrix((data, indices, indptr), shape=(N + 1, N + 1))
    if has_bias:
        M.eliminate_zeros()                       # rows whose bias dot is 0
    return M


# ------------------------------------------------------------------ keygen

def keygen(shape, global_geometric="identity", local_geometric="identity",
           global_photometric="identity", local_photometric="identity",
           memoryorder="channel", alpha=None, beta=None, gamma=None, seed=None,
           hierarchical_blockshape=None, hierarchical_permute_at_level=None,
           blocksize=None, tileshape=None, strict=False, rng=None):
    """Generate a layer keypair (A, A^-1) for a (C,H,W) activation shape.

    Returns homogeneous (N+1)x(N+1) scipy CSR matrices, N = C*H*W, composed as
    A = C^-1 p g P G C (parameter schema and semantics:
    reference keynet/system.py:317-469).
    """
    assert memoryorder in ALLOWABLE_MEMORYORDER
    assert global_geometric in ALLOWABLE_GLOBAL_GEOMETRIC
    assert local_geometric in ALLOWABLE_LOCAL_GEOMETRIC
    assert global_photometric in ALLOWABLE_PHOTOMETRIC
    assert local_photometric in ALLOWABLE_PHOTOMETRIC
    from .globals import _madvise_heap_hugepages
    _madvise_heap_hugepages()  # THP-back heap VMAs grown since import

    channels, height, width = shape
    N = int(np.prod(shape))
    if rng is None:
        rng = np.random.default_rng(seed)

    H = blocknumel = None
    if blocksize is not None:
        if tileshape is not None:
            assert blocksize == tileshape[0] and blocksize == tileshape[1]
        if height == 1 and width == 1:
            # Fully-connected activations: block structure degenerates to global.
            blocksize = N
            H = N
            blocknumel = N
        else:
            if not strict and (height % blocksize != 0 or width % blocksize != 0):
                assert height == width, "image must be square to repair ragged blocksize"
                blocksize = find_closest_positive_divisor(height, blocksize)
            H = height * width
            blocknumel = blocksize * blocksize

    # --- C: memory-order permutation (None = identity, never built) -------
    if memoryorder == "channel":
        c = cinv = C = Cinv = None
    else:
        assert blocksize is not None
        order = blockorder_indices(shape, blocksize)
        c, cinv = permutation_vector_to_matrix(order, withinverse=True)
        c, cinv = c.astype(_DTYPE).tocsr(), cinv.astype(_DTYPE).tocsr()
        C, Cinv = sparse_affine_to_linear(c), sparse_affine_to_linear(cinv)

    # --- G: global geometric ---------------------------------------------
    if global_geometric == "identity":
        G = Ginv = None
    elif global_geometric == "permutation":
        assert tileshape is None, "global permutation is not tile compressible"
        G, Ginv = permutation_matrix(N, rng, withinverse=True)
    elif global_geometric in ("hierarchical_permutation", "hierarchical_rotation"):
        assert hierarchical_blockshape is not None and hierarchical_permute_at_level is not None
        levels = list(np.atleast_1d(hierarchical_permute_at_level))
        if len(levels) and max(height, width) / (2 ** max(levels)) < 8:
            levels = []
        if height == 1 and width == 1:
            levels = []
        twist = global_geometric == "hierarchical_rotation"
        # permute in HxWxC pixel order, then conjugate back to CxHxW channel order
        perm_pix = hierarchical_block_permutation((height, width, channels),
                                                  hierarchical_blockshape, levels,
                                                  min_blocksize=8, rng=rng, twist=twist,
                                                  strict=False)
        Gp, Gpinv = permutation_vector_to_matrix(perm_pix, withinverse=True)
        to_pix = channel_to_pixel_order_indices(shape)
        Ap, Apinv = permutation_vector_to_matrix(to_pix, withinverse=True)
        G = (Apinv @ Gp @ Ap).tocsr().astype(_DTYPE)
        Ginv = (Apinv @ Gpinv @ Ap).tocsr().astype(_DTYPE)
        if memoryorder != "channel":
            G, Ginv = (c @ G @ cinv).tocsr(), (c @ Ginv @ cinv).tocsr()
    elif global_geometric == "givens_orthogonal":
        assert alpha is not None
        assert tileshape is None, "global Givens orthogonal is not tile compressible"
        G, Ginv = givens_orthogonal_matrix(N, int(alpha), rng, withinverse=True)
    if G is not None:
        G, Ginv = sparse_affine_to_linear(G), sparse_affine_to_linear(Ginv)

    # --- g: local (blockwise) geometric ----------------------------------
    if local_geometric == "identity":
        g = ginv = ginv_inner = None
    else:
        assert blocksize is not None and (height == width or (height == 1 and width == 1))
        if local_geometric == "permutation":
            gb = permutation_matrix(blocknumel, rng)
            gbinv = gb.T.tocsr()
        elif local_geometric == "doubly_stochastic":
            assert alpha is not None
            assert blocksize < 8192, "doubly_stochastic blocksize must be < 8192 (dense inverse)"
            gb, gbinv = doubly_stochastic_matrix(blocknumel, int(alpha), rng, withinverse=True)
        elif local_geometric == "givens_orthogonal":
            assert alpha is not None
            S, Sinv = givens_orthogonal_matrix(blocknumel, int(alpha), rng, withinverse=True)
            Pm, Pminv = permutation_matrix(blocknumel, rng, withinverse=True)
            gb, gbinv = (Pm @ S).tocsr(), (Sinv @ Pminv).tocsr()
        # spatial repeat to (H,H), then channel repeat straight to the
        # homogeneous (N+1, N+1): the ragged identity tail IS the homogeneous
        # corner, so the sparse_affine_to_linear copy (a full extra pass over
        # the ~1e9-nnz dense-block inverse at VGG-224 scale) never happens
        g_inner = repeat_block_diagonal(gb, (H, H))
        ginv_inner = repeat_block_diagonal(gbinv, (H, H))
        g = repeat_block_diagonal(g_inner, (N + 1, N + 1))
        ginv = None   # deferred: fused emission or plain tiling, see below

    # --- P: global photometric -------------------------------------------
    P, Pinv = _photometric(N, global_photometric, rng, beta=beta, gamma=gamma,
                           blocksize=blocksize, blocknumel=blocknumel, local=False)

    # --- p: local photometric ---------------------------------------------
    p, pinv = _photometric(N, local_photometric, rng, beta=beta, gamma=gamma,
                           blocksize=blocksize, blocknumel=blocknumel, local=True)

    # --- compose (skipping identity factors: an all-identity key costs O(N),
    # not five spgemms; permutation factors apply as O(nnz) gathers — the
    # dense-block inverse reaches ~1e8 nnz at VGG scale, where a generic
    # spgemm against it costs ~15s/call) ----------------------------------
    def _perm_vec(M):
        """Row-permutation vector if M is a permutation matrix, else None."""
        M = scipy.sparse.csr_matrix(M)
        if M.nnz != M.shape[0] or M.shape[0] != M.shape[1] \
                or not (M.data == 1.0).all() or (np.diff(M.indptr) != 1).any():
            return None
        v = M.indices.astype(np.int64)
        if (np.bincount(v, minlength=M.shape[0]) != 1).any():
            return None  # one-per-row but not a bijection
        return v

    def _diag_affine_vec(M):
        """(d, b) if homogeneous M is diagonal + last-column bias with last
        row e_n (the form every photometric factor takes), else None."""
        M = scipy.sparse.csr_matrix(M)
        n = M.shape[0] - 1
        if M.shape[0] != M.shape[1] or M.nnz > 2 * (n + 1):
            return None
        rows = np.repeat(np.arange(n + 1), np.diff(M.indptr))
        on_diag = M.indices == rows
        on_bias = (M.indices == n) & ~on_diag
        if not (on_diag | on_bias).any() or not (on_diag | on_bias).all():
            return None
        d = np.zeros(n + 1, dtype=M.data.dtype)
        d[rows[on_diag]] = M.data[on_diag]
        if d[n] != 1.0 or (d[:n] == 0).any() or on_bias[rows == n].any():
            return None
        b = np.zeros(n + 1, dtype=M.data.dtype)
        b[rows[on_bias]] = M.data[on_bias]
        return d, b

    def _col_add(M, v):
        """M + (column vector v at the last column), CSR O(nnz) merge."""
        idx = np.flatnonzero(v)
        if len(idx) == 0:
            return M
        n = M.shape[1] - 1
        col = scipy.sparse.csr_matrix(
            (v[idx], (idx, np.full(len(idx), n))), shape=M.shape)
        return (M + col).tocsr()

    def _mul(L, R):
        pv = _perm_vec(L)
        if pv is not None:                      # (P @ M)[i, :] = M[perm[i], :]
            return scipy.sparse.csr_matrix(R)[pv]
        pv = _perm_vec(R)
        if pv is not None:                      # (M @ P): col k -> perm[k]
            Lc = scipy.sparse.csr_matrix(L).copy()
            Lc.indices = pv[Lc.indices].astype(Lc.indices.dtype)
            Lc.has_sorted_indices = False
            Lc.sort_indices()
            return Lc
        # diag-affine factors multiply as an O(nnz) scale + one sparse-column
        # add (a generic spgemm against the ~1e9-nnz dense-block inverse at
        # VGG-224 scale costs ~25 s/call and a full extra materialization)
        da = _diag_affine_vec(R)
        if da is not None:                      # M @ diag-affine
            d, b = da
            Lc = scipy.sparse.csr_matrix(L).copy()
            Lc.data = Lc.data * d[Lc.indices]
            return _col_add(Lc, scipy.sparse.csr_matrix(L) @ b)
        da = _diag_affine_vec(L)
        if da is not None:                      # diag-affine @ M
            d, b = da
            R = scipy.sparse.csr_matrix(R)
            n = R.shape[0] - 1
            last = R.indptr[n + 1] - R.indptr[n]
            if last == 1 and R.indices[-1] == n and R.data[-1] == 1.0:
                rows = np.repeat(np.arange(n + 1), np.diff(R.indptr))
                Rc = R.copy()
                Rc.data = Rc.data * d[rows]
                return _col_add(Rc, b)          # b[i]·R[n,:] = b[i]·e_n
        return L @ R

    def _compose(factors):
        out = None
        for M in factors:
            if M is None:   # identity factor, never materialized
                continue
            out = M if out is None else _mul(out, M)
        return (out if out is not None
                else sparse_affine_to_linear(identity_matrix(N))).tocsr()

    # ---- inverse-side fused emission: when the inverse local factor is the
    # big one (dense doubly-stochastic blocks: ~3e8 nnz at VGG-224) and the
    # remaining inverse factors are a permutation and a diag-affine in
    # channel memoryorder, emit Ginv·ginv·pinv in ONE pass instead of
    # tile + permute + scale + add (four full materializations, each
    # first-touch-page-rate bound on a large host) -----------------------------
    from .globals import GLOBAL
    fused_Ainv = None
    if ginv_inner is not None and Cinv is None and Pinv is None \
            and ginv_inner.nnz * (N // H) \
            >= int(GLOBAL.get("KEYGEN_FUSE_NNZ", 8_000_000)):
        gvec = _perm_vec(Ginv) if Ginv is not None else None
        da = _diag_affine_vec(pinv) if pinv is not None else (None, None)
        if (Ginv is None or gvec is not None) and da is not None:
            d_, b_ = da
            if b_ is not None and not b_.any():
                b_ = None
            fused_Ainv = _emit_perm_blockdiag_affine(gvec, ginv_inner, N,
                                                     d=d_, b=b_)
    if ginv_inner is not None and fused_Ainv is None:
        ginv = repeat_block_diagonal(ginv_inner, (N + 1, N + 1))

    A = _compose([Cinv, p, g, P, G, C])
    Ainv = fused_Ainv if fused_Ainv is not None \
        else _compose([Cinv, Ginv, Pinv, ginv, pinv, C])
    if GLOBAL.get("SELFCHECK", False):
        keypair_selfcheck(A, Ainv)
    return A, Ainv


def keypair_selfcheck(A, Ainv, atol=1e-4):
    """Opt-in debug pass (GLOBAL['SELFCHECK']): assert A·A⁻¹ ≈ I.

    The reference's analog is the ad-hoc orthogonality assertion in its test
    suite (reference test/test_sparse.py:29-33); here it is a library-level
    invariant check that can be switched on for any keygen call.
    """
    R = (scipy.sparse.csr_matrix(A) @ scipy.sparse.csr_matrix(Ainv)
         - identity_matrix(A.shape[0]))
    err = 0.0 if R.nnz == 0 else float(np.abs(R.data).max())
    assert err < atol, "key pair fails A @ Ainv == I (max err %g)" % err
    return err


def _photometric(N, family, rng, beta=None, gamma=None, blocksize=None,
                 blocknumel=None, local=False):
    """Photometric key factor as a homogeneous (N+1)x(N+1) diagonal-affine pair.

    Global families operate on all N elements; local families draw one
    blocknumel-sized pattern and repeat it (reference keynet/system.py:415-464).
    """
    if family == "identity":
        return None, None

    if not local:
        if family == "uniform_random_gain":
            assert beta is not None and beta > 0
            d = uniform_random_diagonal(N, rng, scale=beta, bias=1)
            return diagonal_affine_to_linear(d, withinverse=True)
        if family == "uniform_random_bias":
            assert gamma is not None and gamma > 0
            return diagonal_affine_to_linear(np.ones(N), bias=gamma * rng.random(N),
                                             withinverse=True)
        if family == "constant_bias":
            assert gamma is not None and gamma > 0
            return diagonal_affine_to_linear(np.ones(N), bias=np.full(N, float(gamma)),
                                             withinverse=True)
        if family == "linear_bias":
            assert gamma is not None and gamma > 0
            return diagonal_affine_to_linear(np.ones(N), bias=(gamma / N) * np.arange(N),
                                             withinverse=True)
        if family == "uniform_random_affine":
            assert beta is not None and beta > 0 and gamma is not None and gamma > 0
            d = uniform_random_diagonal(N, rng, scale=beta, bias=1)
            return diagonal_affine_to_linear(d, bias=gamma * rng.random(N), withinverse=True)
        if family == "blockwise_constant_bias":
            assert gamma is not None and gamma > 0 and blocksize is not None
            nblocks = max(1, N // blocksize)
            bias = np.repeat(gamma * rng.random(nblocks), blocknumel)
            bias = np.resize(bias, N) if bias.size < N else bias[:N]
            return diagonal_affine_to_linear(np.ones(N), bias=bias, withinverse=True)
        raise ValueError("invalid global photometric '%s'" % family)

    # local families: one blocknumel pattern, tiled across N
    assert blocksize is not None, "local photometric requires blocksize"
    if family == "uniform_random_gain":
        assert beta is not None and beta > 0
        d = uniform_random_diagonal(blocknumel, rng, scale=beta, bias=1)
        d = np.resize(np.tile(d, int(np.ceil(N / blocknumel))), N)
        # ragged tail is identity gain (reference clips the repeated block
        # diagonal, leaving implicit zeros; we keep invertibility with ones)
        d = _ragged_tail_to_one(d, N, blocknumel)
        return diagonal_affine_to_linear(d, withinverse=True)
    if family == "uniform_random_bias":
        assert gamma is not None and gamma > 0
        bias = np.tile(gamma * rng.random(blocknumel), int(np.ceil(N / blocknumel)))[:N]
        return diagonal_affine_to_linear(np.ones(N), bias=bias, withinverse=True)
    if family == "uniform_random_affine":
        assert beta is not None and beta > 0 and gamma is not None and gamma > 0
        d = uniform_random_diagonal(blocknumel, rng, scale=beta, bias=1)
        d = _ragged_tail_to_one(np.tile(d, int(np.ceil(N / blocknumel)))[:N], N, blocknumel)
        bias = np.tile(gamma * rng.random(blocknumel), int(np.ceil(N / blocknumel)))[:N]
        return diagonal_affine_to_linear(d, bias=bias, withinverse=True)
    if family == "blockwise_constant_bias":
        raise ValueError("blockwise_constant_bias is supported as a global photometric only")
    raise ValueError("invalid local photometric '%s'" % family)


def _ragged_tail_to_one(d, N, blocknumel):
    """For a tiled diagonal whose final block is ragged, set the ragged tail to
    identity gain, matching the reference's clipped-block-diagonal semantics
    where the tail of sparse_block_diagonal keeps the partial block.

    The reference keeps the clipped partial block (still invertible for a
    diagonal); we therefore keep the tiled values as-is and this helper is a
    no-op retained for documentation.
    """
    return d
