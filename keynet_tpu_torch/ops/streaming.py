"""Host math for split and factored keyed layers (the subset of the JAX
package's ops/streaming.py that the materialized and Kronecker routes use).

``factor_left_identical`` / ``factor_right_perm`` recover the repeated-block
structure keygen gives local keys, ``split_dense_inverse`` hides a
dense-blocks inverse key behind a secret re-key, and
``_key_blocks_identical`` is the exact periodicity test the Kronecker factorization
relies on.  All of it is numpy/scipy on the host, with the same rng draws as
the JAX package, so the same seed gives the same published factors.
Strip streaming (masked_keyed_conv_streaming, keyed_conv_streaming) is not
ported yet.
"""

import numpy as np
import scipy.sparse


def factor_right_perm(A, ps):
    """Factor a homogeneous key matrix A = B·G with B block-diagonal
    (p-sized core blocks) and G a permutation: returns (p, g, B) where
    ``A[:, c] == B[:, g[c]]`` for core columns (g a permutation of [0, n)),
    or None if no candidate p fits.

    This is the structure keygen produces whenever a global geometric
    permutation is composed inside local block keys (A = p·g·P·G,
    keys.keygen composition; reference keynet/system.py:466-469): every
    column of A is a column of the block-diagonal factor B, relocated by G.
    Columns are grouped by the row-block they live in; within a block the
    assignment is by column order (any bijection yields a block-diagonal B).
    """
    A = scipy.sparse.csc_matrix(A)
    n = A.shape[0] - 1
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    indptr, indices = A.indptr, A.indices
    # row-n entries (the bias row when factoring a transposed inverse key)
    # travel with their column; the block condition applies to rows < n only
    end = indptr[1:n + 1] - (indices[indptr[1:n + 1] - 1] == n)
    if (end <= indptr[:n]).any():
        return None  # a core column with no sub-homogeneous support
    minr = indices[indptr[:n]]
    maxr = indices[end - 1]
    span = int((maxr - minr).max(initial=0))
    for p in sorted(ps):
        if n % p or p <= span:
            continue
        b = minr // p
        if not np.array_equal(maxr // p, b):
            continue
        cnt = np.bincount(b, minlength=n // p)
        if not (cnt == p).all():
            continue
        # canonical within-block assignment: sort columns by their top row
        # (any bijection yields a block-diagonal B, but row-ordering makes B's
        # blocks IDENTICAL whenever the underlying key repeats one block —
        # e.g. a pure permutation factors to B = I⊗I_p — which the Kronecker
        # factorization (ops/kronfactor.py::_kron_side) requires)
        order = np.lexsort((np.arange(n), minr, b))
        g = np.empty(n, dtype=np.int64)
        g[order] = np.arange(n)
        B = A[:, np.concatenate([order, [n]])].tocsr()
        return int(p), g, B
    return None


def factor_left_identical(M, ps):
    """Factor M = P'·(I ⊗ [D₀ | b₀]): a row-permuted block-diagonal matrix
    whose diagonal blocks are IDENTICAL dense (p, p) blocks with a p-periodic
    bias pattern.  Returns (p, g, D0, b0) with
    ``M[r, :n] == (I⊗D0)[g[r], :]`` and ``M[r, n] == b0[g[r] % p]``, or None.

    This is the exact structure keygen gives an inverse key built from
    repeated local blocks (A⁻¹ = G⁻¹·g⁻¹·p⁻¹, keys.keygen): every row of M is
    a copy of one of p distinct block-row patterns.  Rows are grouped by
    column block, ranked inside each block by a content feature, and the
    factorization is then VERIFIED exactly (entry-for-entry against block 0),
    so feature collisions can only cause a miss, never a wrong factor."""
    M = scipy.sparse.csr_matrix(M)
    n = M.shape[0] - 1
    if not M.has_sorted_indices:
        M = M.copy()
        M.sort_indices()
    indptr, indices, data = M.indptr, M.indices, M.data
    end = indptr[1:n + 1] - (indices[indptr[1:n + 1] - 1] == n)
    if (end <= indptr[:n]).any():
        return None
    minc = indices[indptr[:n]]
    maxc = indices[end - 1]
    span = int((maxc - minc).max(initial=0))
    # per-row content features (any collision is caught by verification)
    k_r = end - indptr[:n]
    bias = np.zeros(n, dtype=data.dtype)
    has_bias = indices[indptr[1:n + 1] - 1] == n
    bias[has_bias] = data[indptr[1:n + 1][has_bias] - 1]
    core_mask = np.ones(len(data), dtype=bool)
    core_mask[indptr[1:n + 1][has_bias] - 1] = False
    core_mask[indptr[n]:] = False

    for p in sorted(ps):
        if n % p or p <= span:
            continue
        b = minc // p
        if not np.array_equal(maxc // p, b):
            continue
        cnt = np.bincount(b, minlength=n // p)
        if not (cnt == p).all():
            continue
        nblk = n // p
        # feature rank inside each block (reuse one masked-values buffer: the
        # where/tile temporaries here ran at the ~100 MB/s first-touch page
        # rate and were 31 s of a 40 s conv3-scale split)
        core_vals = np.where(core_mask, data, 0.0)
        s1 = np.add.reduceat(core_vals, indptr[:n])
        core_vals *= indices % p + 1
        s2 = np.add.reduceat(core_vals, indptr[:n])
        del core_vals
        order = np.lexsort((bias, s2, s1, k_r, b))  # block-major, feature rank
        # exact verification: every block's (lengths, cols%p, values, bias)
        # in rank order must equal block 0's (broadcast against block 0 —
        # never materialize tiled copies)
        ko = k_r[order]
        ko2 = ko.reshape(nblk, p)
        if not (ko2[1:] == ko2[0]).all():
            continue
        # gather core entries of rows in sorted order
        tot = int(ko.sum())
        starts = indptr[:n][order]
        cum0 = np.concatenate([[0], np.cumsum(ko)[:-1]])
        ent_idx = np.repeat(starts - cum0, ko) + np.arange(tot)
        cols_s = indices[ent_idx] % p
        vals_s = data[ent_idx]
        per_blk = tot // nblk
        cs = cols_s.reshape(nblk, per_blk)
        vs = vals_s.reshape(nblk, per_blk)
        bs = bias[order].reshape(nblk, p)
        if not ((cs[1:] == cs[0]).all() and (vs[1:] == vs[0]).all()
                and (bs[1:] == bs[0]).all()):
            continue
        g = np.empty(n, dtype=np.int64)
        g[order] = np.arange(n)
        D0 = np.zeros((p, p), dtype=np.float32)
        b0 = np.asarray(bias[order[:p]], dtype=np.float32)
        pos = 0
        for i in range(p):
            k = int(ko[i])
            D0[i, cols_s[pos:pos + k]] = vals_s[pos:pos + k]
            pos += k
        return int(p), g, D0, b0
    return None


def _mask_rotations(p, mask_alpha=None):
    """Givens rotations for a secret p-block mask: ceil(p*alpha/2) with
    alpha = max(GLOBAL MASK_ALPHA floor, the keygen privacy parameter), so
    every coordinate participates in >= alpha rotations under the
    balanced-pair draw (keys.givens_orthogonal_matrix).  With only 2
    *total* rotations, E is near-identity and the published F2 = I⊗(EᵀD₀)
    exposes most rows of the secret dense block verbatim; full coverage
    guarantees no row of E is a coordinate vector, so no row
    of a published factor matches the corresponding key-factor row
    (tests/test_streaming.py::test_mask_factors_do_not_leak_key_rows).
    Scaling with the user's alpha keeps the mask at least as strong as the
    key it hides."""
    from ..globals import GLOBAL
    alpha = max(int(GLOBAL.get("MASK_ALPHA", 2)),
                int(mask_alpha) if mask_alpha else 0)
    return int(max(p, -(-p * alpha // 2)))


def split_dense_inverse(Ainv, ps, rng=None, min_density=32, mask_alpha=None,
                        dense_mask=False):
    """Split a dense-blocks inverse input key behind a secret sparse re-key.

    A doubly-stochastic local key's inverse has DENSE p² blocks
    (reference keynet/sparse.py:345-356), so Ŵ = A·W·A⁻¹ fills to ~p·taps
    nonzeros per row — unmaterializable at VGG scale for the reference and
    for any entry-storing format here.  Instead, draw a secret block-local
    orthogonal key R = P'·(I⊗E) (E a balanced product of ceil(p·MASK_ALPHA/2)
    Givens rotations, see _mask_rotations; E⁻¹ = Eᵀ exact) and publish the
    layer as the chain

        F1 = A·W·R   (thin: R mixes within blocks with ~2^MASK_ALPHA fill/row)
        F2 = R⁻¹·A⁻¹ = I⊗(Eᵀ·D₀) + bias   (ONE dense p² block, RepeatedBlockDiagOp)

    F1·F2 == Ŵ exactly; R is returned for use as the conversion-time
    right-key and must be DISCARDED after conversion.  Publishing (F1, F2) is
    a standard 2-link keyed chain: every coordinate of the secret E mixes at
    least MASK_ALPHA times, so no row of F2's block equals a row of D₀ and
    the intermediate activation is keyed by the orthogonal R (the reference's
    own keyed-interface construction, keynet/system.py:96-101); the written
    argument is docs/DESIGN.md §masked-re-keying.

    ``dense_mask=True`` draws E as a dense Haar orthogonal (QR) instead of a
    Givens product: the published block EᵀD₀ is then *exactly* Haar-masked —
    statistically indistinguishable from QᵀD₀ for fresh Haar Q (measured: the
    Givens product, even at near-dense fill, leaves max row-correlation with
    D₀ at 0.9+, because the max over p² row pairs finds rotations that
    partially cancel; Haar sits at ~0.6-0.73 for p∈{196,49}).  A mask's
    mixing equals its fill, so the dense mask is only affordable when the
    downstream route is dense math (materialized small layers, the Kronecker
    chain) — callers on the strip-streaming route keep the thin Givens mask
    (tests/test_streaming.py; docs/DESIGN.md §7).

    Returns (R_csr, F2_op) or None when Ainv is thin (mean row fill below
    ``min_density``) or lacks the identical-dense-block structure.
    """
    n = Ainv.shape[0] - 1
    if n <= 0 or Ainv.nnz < min_density * n:
        return None
    f = factor_left_identical(Ainv, ps)
    if f is None:
        return None
    p, g, D0, b0 = f
    from ..keys import givens_orthogonal_matrix, repeat_block_diagonal
    from ..homogeneous import sparse_affine_to_linear
    rng = rng or np.random.default_rng()
    if dense_mask:
        from .kronfactor import random_orthogonal
        Ed = random_orthogonal(p, rng)
        E, Einv = scipy.sparse.csr_matrix(Ed), scipy.sparse.csr_matrix(Ed.T)
    else:
        E, Einv = givens_orthogonal_matrix(p, _mask_rotations(p, mask_alpha),
                                           rng, withinverse=True)
    E = scipy.sparse.csr_matrix(E, dtype=np.float32)
    IE = scipy.sparse.csr_matrix(repeat_block_diagonal(E, (n, n)))
    R = sparse_affine_to_linear(IE[g])          # P'·(I⊗E), homogeneous
    F = np.asarray((scipy.sparse.csr_matrix(Einv, dtype=np.float32) @ D0),
                   dtype=np.float32)            # Eᵀ·D₀ (exact inverse)
    bias = np.tile(np.asarray(scipy.sparse.csr_matrix(Einv, dtype=np.float32)
                              @ b0, dtype=np.float32), n // p)
    from .operators import RepeatedBlockDiagOp
    f2 = RepeatedBlockDiagOp(F, bias, n,
                             nnz=int(np.count_nonzero(F)) + int(np.count_nonzero(bias)))
    return scipy.sparse.csr_matrix(R, dtype=np.float32), f2


def _key_blocks_identical(A, p):
    """True iff the homogeneous key matrix A is *exactly* periodic in p-sized
    index blocks: core block-diagonal with all diagonal blocks identical
    (indices and values) and a p-periodic bias column.  This is the structural
    condition under which strip extrapolation is provably correct (interior
    Toeplitz rows shift uniformly, and a whole-period advance maps key rows
    onto identical key rows), turning the periodic fast path from
    sample-verified into verified-by-construction.
    """
    A = scipy.sparse.csr_matrix(A)
    n = A.shape[0] - 1
    if p <= 0 or n % p:
        return False
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    # CSR with sorted indices is already in (block, row-in-block, col) order,
    # so block-0 comparison needs no COO lexsort (the lexsort over the
    # ~1e7-1e8-entry thin factors was 148 s of the stochastic VGG-224
    # conversion profile — ~2.8 s x 52 calls)
    indptr, indices, data = A.indptr, A.indices, A.data
    lens = np.diff(indptr[:n + 1])
    last_idx = indptr[1:n + 1] - 1
    has_bias = np.zeros(n, dtype=bool)
    nz = lens > 0
    has_bias[nz] = indices[last_idx[nz]] == n
    bias = np.zeros(n, dtype=data.dtype)
    bias[has_bias] = data[last_idx[has_bias]]
    bv = bias.reshape(-1, p)
    if not (bv == bv[0]).all():
        return False
    core_cnt = lens - has_bias
    cc2 = core_cnt.reshape(-1, p)
    if not (cc2 == cc2[0]).all():   # per-row counts p-periodic (aligns rows)
        return False
    k = int(cc2[0].sum())           # core entries per block
    if k == 0:
        return True
    core_mask = np.ones(len(data), dtype=bool)
    core_mask[last_idx[has_bias]] = False
    core_mask[indptr[n]:] = False   # drop the homogeneous last row
    ci = indices[core_mask]
    cv = data[core_mask]
    nblk = n // p
    if len(ci) != nblk * k:
        return False
    rows = np.repeat(np.arange(n, dtype=np.int64), core_cnt)
    b = rows // p
    if np.any(ci // p != b):        # core support is block-diagonal
        return False
    ciw = (ci - b * p).reshape(nblk, k)
    cvw = cv.reshape(nblk, k)
    return bool((ciw[1:] == ciw[0]).all() and (cvw[1:] == cvw[0]).all())
