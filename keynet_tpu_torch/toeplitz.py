"""Sparse Toeplitz lowering of conv2d / avgpool2d to homogeneous matrices.

Functional spec: reference keynet/sparse.py:122-212 — a Numba nopython kernel
that loops over every (output pixel, in-channel, kernel tap, out-channel) and
emits one COO entry.  Here the same matrix is produced by vectorized numpy
broadcasting over index grids: the spatial sparsity pattern is computed once
(independent of channels), the (out-channel, in-channel) axes are expanded by
outer addressing, and the CSR is emitted pre-sorted (row-major emission order,
no COO->CSR sort).  Explicit zero filter taps
are *kept* as stored entries so the sparsity structure is preserved for
channel-broadcast tiling (the reference achieves this with a +offset/-offset
trick, keynet/sparse.py:184-186; scipy keeps explicit zeros natively when
constructing from COO triplets, so no trick is needed).

Conventions (identical to the reference):
  * input shape (C,U,V) vectorized channel-major; filter (M,C,P,Q), P==Q odd;
  * spatial correlation with implicit zero padding P//2 and output size
    (U//stride, V//stride) sampled at multiples of stride;
  * with bias, the result is the homogeneous matrix [W b_tiled; 0 1] of shape
    (M*(U//s)*(V//s)+1, C*U*V+1).
"""

import numpy as np
import scipy.sparse

from . import native


def _pool_buffer(pool, name, dtype, size, growth=1.25):
    """Reused emission buffer: grown geometrically, never shrunk.  Keeping the
    buffers warm matters more than their size on a conversion host — first-touch
    page faults run ~60x slower than warm writes (see globals.tune_allocator).
    """
    buf = pool.get(name)
    if buf is None or buf.size < size:
        buf = np.empty(int(max(size, (buf.size if buf is not None else 0) * growth)),
                       dtype=dtype)
        pool[name] = buf
    return buf


def _toeplitz_rows_native(inshape, f, bias, stride, out_rows, pool=None):
    """Single-pass C++ CSR emission of the requested Toeplitz rows
    (native/packer.cpp toeplitz_fill).  ``pool``: optional dict of reused
    buffers — the returned CSR then *aliases* pool memory and is only valid
    until the next pooled call (the streaming strip loop's contract).
    """
    C, U, V = inshape
    M, _, P, Q = f.shape
    Us, Vs = U // stride, V // stride
    n_body, n_in = M * Us * Vs, C * U * V
    out_rows = np.ascontiguousarray(out_rows, dtype=np.int64)

    # exact stored-entry count (valid taps per requested row)
    hp, hq = (P - 1) // 2, (Q - 1) // 2
    ku = np.arange(Us, dtype=np.int64) * stride
    kv = np.arange(Vs, dtype=np.int64) * stride
    nu = np.minimum(U, ku - hp + P) - np.maximum(0, ku - hp)
    nv = np.minimum(V, kv - hq + Q) - np.maximum(0, kv - hq)
    body = out_rows < n_body
    pix = np.where(body, out_rows % (Us * Vs), 0)
    counts = np.where(body, nu[pix // Vs] * nv[pix % Vs] * C
                      + (1 if bias is not None else 0), 1)
    total = int(counts.sum())

    fT = np.ascontiguousarray(np.moveaxis(
        np.asarray(f, dtype=np.float32).reshape(M, C, P * Q), 1, 2))
    bias32 = None if bias is None \
        else np.ascontiguousarray(np.asarray(bias, dtype=np.float32).reshape(-1))
    n_rows = out_rows.shape[0]
    if pool is None:
        cols = np.empty(total, dtype=np.int32)
        vals = np.empty(total, dtype=np.float32)
        indptr = np.empty(n_rows + 1, dtype=np.int64)
    else:
        cols = _pool_buffer(pool, "cols", np.int32, total)
        vals = _pool_buffer(pool, "vals", np.float32, total)
        indptr = _pool_buffer(pool, "indptr", np.int64, n_rows + 1)
    wrote = native.toeplitz_fill(out_rows, fT, bias32, U, V, stride,
                                 cols, vals, indptr)
    assert wrote == total, (wrote, total)
    S = scipy.sparse.csr_matrix((vals[:total], cols[:total], indptr[:n_rows + 1]),
                                shape=(n_rows, n_in + 1))
    return S


def _spatial_pattern(inshape, P, Q, stride, ku_range=None):
    """Spatial COO skeleton shared by every (out-channel, in-channel) pair.

    Returns (sp_rows, sp_cols, tap) where for each valid (output pixel, kernel
    tap): sp_rows = output pixel index in (U//s)*(V//s), sp_cols = input pixel
    index in U*V, tap = kernel tap index in P*Q.  ``ku_range=(k0,k1)`` restricts
    to output pixel rows k0..k1 (for streaming strip-wise emission); row
    indices stay global.
    """
    C, U, V = inshape
    Us, Vs = U // stride, V // stride
    k0, k1 = ku_range if ku_range is not None else (0, Us)
    ku = np.arange(k0, k1, dtype=np.int64)
    kv = np.arange(Vs, dtype=np.int64)
    dp = np.arange(P, dtype=np.int64) - (P - 1) // 2
    dq = np.arange(Q, dtype=np.int64) - (Q - 1) // 2

    nk = len(ku)
    u = ku[:, None, None, None] * stride + dp[None, None, :, None]     # (nk,1,P,1)
    v = kv[None, :, None, None] * stride + dq[None, None, None, :]     # (1,Vs,1,Q)
    valid = np.broadcast_to((u >= 0) & (u < U), (nk, Vs, P, Q)) \
        & np.broadcast_to((v >= 0) & (v < V), (nk, Vs, P, Q))

    out_pix = np.broadcast_to((ku[:, None] * Vs + kv[None, :])[:, :, None, None], valid.shape)
    in_pix = np.broadcast_to(u * V + v, valid.shape)
    tap = np.broadcast_to(
        (np.arange(P, dtype=np.int64)[:, None] * Q + np.arange(Q, dtype=np.int64)[None, :])[None, None],
        valid.shape)

    m = valid.reshape(-1)
    return out_pix.reshape(-1)[m], in_pix.reshape(-1)[m], tap.reshape(-1)[m]


def _rowmajor_block_csr(inshape, f, stride, ku_range, bias=None, cache=None):
    """CSR over the generated rows only (no sort: entries are emitted in
    row-major order directly; the bias column entry is interleaved at the end
    of each row segment so no csr merge is needed).  Returns
    (row_ids_global, csr of shape (len(row_ids), C*U*V+1)) for output pixel
    rows ku in ku_range.

    ``cache``: a dict reused across calls.  Interior strips (no top/bottom
    kernel overhang) have identical structure up to a column shift of
    stride*V per output pixel row, so their emission is materialized once and
    shifted thereafter — the hot path for streaming non-extrapolable keys.
    """
    C, U, V = inshape
    M, _, P, Q = f.shape
    if cache is not None:
        hw = (P - 1) // 2
        k0, k1 = ku_range
        Vs = V // stride
        interior = k0 * stride - hw >= 0 and (k1 - 1) * stride + hw < U
        ckey = ("interior", k1 - k0)
        if interior and ckey in cache:
            base_k0, row_ids0, S0 = cache[ckey]
            # identical sparsity skeleton shifted by whole pixel rows: the
            # within-channel column index moves by stride*V per output row
            # (never crossing a channel boundary for interior strips); the
            # bias column (C*U*V) is pinned
            shift = (k0 - base_k0) * stride * V
            cols = S0.indices.copy()
            body = cols < C * U * V
            cols[body] += np.int32(shift)
            S = scipy.sparse.csr_matrix((S0.data, cols, S0.indptr), shape=S0.shape)
            return row_ids0 + (k0 - base_k0) * Vs, S
        out = _rowmajor_block_csr(inshape, f, stride, ku_range, bias=bias, cache=None)
        if interior:
            cache[ckey] = (k0, out[0], out[1])
        return out
    Us, Vs = U // stride, V // stride
    k0, k1 = ku_range
    sp_rows, sp_cols, tap = _spatial_pattern(inshape, P, Q, stride, ku_range)
    npix = (k1 - k0) * Vs
    n_in = C * U * V

    # per-(m, spatial-entry) the C in-channel entries are contiguous:
    # row = m*Us*Vs + sp_rows[e]  (non-decreasing in (m, e))
    cols_block = (sp_cols[:, None].astype(np.int32)
                  + (np.arange(C, dtype=np.int32) * (U * V))[None, :]).reshape(-1)
    cols_body = np.tile(cols_block, M)
    vals_body = np.swapaxes(f.reshape(M, C, P * Q)[:, :, tap], 1, 2) \
        .reshape(-1).astype(np.float32)
    # row lengths: taps-per-pixel * C, identical for every out-channel m
    perpix = (np.bincount(sp_rows - k0 * Vs, minlength=npix) * C).astype(np.int64)
    perrow = np.tile(perpix, M)
    n_rows = M * npix
    row_ids = ((np.arange(M, dtype=np.int64) * (Us * Vs))[:, None]
               + np.arange(k0 * Vs, k1 * Vs, dtype=np.int64)[None, :]).reshape(-1)

    if bias is None:
        indptr = np.concatenate([[0], np.cumsum(perrow, dtype=np.int64)])
        S = scipy.sparse.csr_matrix((vals_body, cols_body, indptr),
                                    shape=(n_rows, n_in + 1))
        return row_ids, S

    bias = np.asarray(bias, dtype=np.float32).reshape(-1)
    indptr = np.concatenate([[0], np.cumsum(perrow + 1, dtype=np.int64)])
    total = int(indptr[-1])
    cols_full = np.empty(total, dtype=np.int32)
    vals_full = np.empty(total, dtype=np.float32)
    body_pos = np.arange(vals_body.size, dtype=np.int64) \
        + np.repeat(np.arange(n_rows, dtype=np.int64), perrow)
    cols_full[body_pos] = cols_body
    vals_full[body_pos] = vals_body
    bias_pos = indptr[1:] - 1
    cols_full[bias_pos] = np.int32(n_in)
    vals_full[bias_pos] = np.repeat(bias, npix)
    S = scipy.sparse.csr_matrix((vals_full, cols_full, indptr),
                                shape=(n_rows, n_in + 1))
    return row_ids, S


def toeplitz_conv2d_rows(inshape, f, bias, stride, out_rows, cache=None, pool=None):
    """Sparse CSR holding only the given (global) output rows of the
    homogeneous conv Toeplitz matrix — the streaming-emission building block
    (rows include the bias column; the final [0..0 1] row is row M*Us*Vs).

    out_rows may be any subset in any order.  With the native extension the
    rows are emitted by a single-pass C++ fill (optionally into pooled reused
    buffers — see _toeplitz_rows_native for the aliasing contract); the numpy
    fallback generates the covering output-pixel-row range and slices.
    """
    f = np.asarray(f, dtype=np.float32)
    if native.toeplitz_fill is not None \
            and int(np.prod(inshape)) + 1 <= np.iinfo(np.int32).max:
        return _toeplitz_rows_native(inshape, f, bias, stride, out_rows, pool=pool)
    C, U, V = inshape
    M, _, P, Q = f.shape
    Us, Vs = U // stride, V // stride
    n_out, n_in = M * Us * Vs, C * U * V
    out_rows = np.asarray(out_rows, dtype=np.int64)

    body_mask = out_rows < n_out
    body = out_rows[body_mask]
    if body.size:
        pix = body % (Us * Vs)
        k0, k1 = int((pix // Vs).min()), int((pix // Vs).max()) + 1
        if cache is not None:
            # canonicalize the range width so interior strips whose requested
            # row sets jitter by a row or two still hit the emission cache
            want = k1 - k0
            width = cache.setdefault(("width",), max(want, 2))
            if want > width:
                width = cache[("width",)] = want
            k1 = min(k0 + width, Us)
            k0 = max(0, k1 - width)
        row_ids, S = _rowmajor_block_csr(inshape, f, stride, (k0, k1), bias=bias,
                                         cache=cache)
        pos = np.searchsorted(row_ids, body)
        assert np.array_equal(row_ids[pos], body)
        out = S[pos]
    else:
        out = scipy.sparse.csr_matrix((0, n_in + 1), dtype=np.float32)

    n_req = out_rows.shape[0]
    if body.size == n_req:
        return out

    # non-body requested rows are the homogeneous last row (value 1 at n_in)
    req_index_of_body = np.nonzero(body_mask)[0]
    hom = np.nonzero(~body_mask)[0]
    if body.size == 0 or np.array_equal(req_index_of_body, np.arange(body.size)):
        # hom rows trail (sorted request, the streaming path): cheap vstack
        hom_block = scipy.sparse.csr_matrix(
            (np.ones(hom.size, dtype=np.float32),
             (np.arange(hom.size), np.full(hom.size, n_in, dtype=np.int64))),
            shape=(hom.size, n_in + 1))
        return scipy.sparse.vstack([out, hom_block], format="csr") if body.size \
            else hom_block
    # general scattered request (small/testing sizes): permute + add
    expand = scipy.sparse.csr_matrix(
        (np.ones(body.size, dtype=np.float32),
         (req_index_of_body, np.arange(body.size))),
        shape=(n_req, int(body.size)))
    extra = scipy.sparse.csr_matrix(
        (np.ones(hom.size, dtype=np.float32),
         (hom, np.full(hom.size, n_in, dtype=np.int64))),
        shape=(n_req, n_in + 1))
    return scipy.sparse.csr_matrix(expand @ out + extra)


def toeplitz_conv2d(inshape, f, bias=None, stride=1, format="csr"):
    """Sparse matrix W such that conv2d(x, f) (correlation, padding k//2) equals
    (W @ x.flatten()) for x of shape inshape=(C,U,V).

    With ``bias`` the homogeneous matrix [W b;0 1] is returned.  See the module
    docstring for the exact semantics (spec: keynet/sparse.py:163-203).
    """
    f = np.asarray(f, dtype=np.float32)
    assert len(inshape) == 3 and f.ndim == 4
    C, U, V = inshape
    M, C2, P, Q = f.shape
    assert C2 == C, "in-channel mismatch"
    assert P == Q and P % 2 == 1, "filter must be square with odd size"
    if bias is not None:
        bias = np.asarray(bias, dtype=np.float32).reshape(-1)
        assert bias.shape[0] == M
    Us, Vs = U // stride, V // stride
    n_out, n_in = M * Us * Vs, C * U * V

    if native.toeplitz_fill is not None and n_in + 1 <= np.iinfo(np.int32).max:
        rows = np.arange(n_out + (1 if bias is not None else 0), dtype=np.int64)
        S = _toeplitz_rows_native(inshape, f, bias, stride, rows)
        if bias is None:
            # no bias entries were emitted, so the (n_out, n_in+1) CSR can be
            # reinterpreted as the plain (n_out, n_in) conv matrix
            S = scipy.sparse.csr_matrix((S.data, S.indices, S.indptr),
                                        shape=(n_out, n_in))
        return S.asformat(format) if format != "csr" else S

    _, S = _rowmajor_block_csr(inshape, f, stride, (0, Us))  # pre-sorted CSR

    body = S[:, :n_in]
    if bias is None:
        A = body
    else:
        # assemble by stacking (scipy's csr addition would prune the explicit
        # zero entries that the channel-broadcast tile structure relies on)
        bias_col = scipy.sparse.csr_matrix(
            (np.repeat(bias, Us * Vs).astype(np.float32),
             (np.arange(n_out, dtype=np.int64), np.zeros(n_out, dtype=np.int64))),
            shape=(n_out, 1))
        last = scipy.sparse.csr_matrix(
            (np.ones(1, dtype=np.float32), (np.zeros(1, dtype=np.int64),
                                            np.array([n_in], dtype=np.int64))),
            shape=(1, n_in + 1))
        A = scipy.sparse.vstack(
            [scipy.sparse.hstack([body, bias_col], format="csr"), last], format="csr")
    return A.asformat(format) if format != "csr" else A


def toeplitz_avgpool2d(inshape, kernelsize, stride, format="csr"):
    """Homogeneous sparse matrix of avgpool2d = conv2d with a constant
    1/k^2 channel-diagonal filter and zero bias (spec: keynet/sparse.py:206-212).

    Only the channel-diagonal entries are emitted (the off-diagonal filter taps
    are structurally zero for pooling; emitting them — as lowering the full
    (C,C,k,k) filter would — inflates nnz by a factor of C).
    """
    C, U, V = inshape
    Us, Vs = U // stride, V // stride
    sp_rows, sp_cols, _ = _spatial_pattern(inshape, kernelsize, kernelsize, stride)
    n_sp = sp_rows.shape[0]
    ch = np.arange(C, dtype=np.int64)
    rows = (ch[:, None] * (Us * Vs) + sp_rows[None, :]).reshape(-1)
    cols = (ch[:, None] * (U * V) + sp_cols[None, :]).reshape(-1)
    vals = np.full(C * n_sp, 1.0 / (kernelsize * kernelsize), dtype=np.float32)
    n_out, n_in = C * Us * Vs, C * U * V
    # homogeneous augmentation (zero bias column + [0..0 1] row)
    rows = np.concatenate([rows, [n_out]])
    cols = np.concatenate([cols, [n_in]])
    vals = np.concatenate([vals, [np.float32(1.0)]])
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n_out + 1, n_in + 1))
    return A.asformat(format) if format != "coo" else A


def toeplitz_global_avgpool2d(inshape, format="csr"):
    """Homogeneous sparse matrix of the global average pool: the (C, C·H·W)
    mean of each channel's map, entries 1/(H·W), with the [0..0 1] row."""
    C, U, V = inshape
    npix = U * V
    rows = np.concatenate([np.repeat(np.arange(C, dtype=np.int64), npix), [C]])
    cols = np.concatenate([np.arange(C * npix, dtype=np.int64), [C * npix]])
    vals = np.concatenate([np.full(C * npix, 1.0 / npix, dtype=np.float32),
                           [np.float32(1.0)]])
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(C + 1, C * npix + 1))
    return A.asformat(format) if format != "coo" else A


def toeplitz_shortcut(inshape, outshape, format="csr"):
    """Homogeneous selection matrix of the option-A shortcut
    (models/specs.shortcut_apply): output pixel (c, i, j) of the first C
    channels reads input (c, s·i, s·j), the appended channels read nothing.
    The homogeneous row and column are zero, so a residual sum keeps the
    branch's trailing 1 alone."""
    from .models.specs import shortcut_shape
    C, U, V = inshape
    Co, Uo, Vo = outshape
    s = shortcut_shape(inshape, outshape)
    ch, i, j = np.meshgrid(np.arange(C, dtype=np.int64), np.arange(Uo, dtype=np.int64),
                           np.arange(Vo, dtype=np.int64), indexing="ij")
    rows = ((ch * Uo + i) * Vo + j).reshape(-1)
    cols = ((ch * U + s * i) * V + s * j).reshape(-1)
    vals = np.ones(rows.size, dtype=np.float32)
    A = scipy.sparse.coo_matrix((vals, (rows, cols)),
                                shape=(Co * Uo * Vo + 1, C * U * V + 1))
    return A.asformat(format) if format != "coo" else A
