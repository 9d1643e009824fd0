"""Sparsity visualization (reference keynet/sparse.py:382-415 `spy`).

The port's own copy of keynet_tpu/visualize.py: numpy uint8 heatmaps instead
of vipy images; block-mean downsampling for large matrices is vectorized
with bincount."""

import numpy as np
import scipy.sparse


def spy(A, mindim=256, showdim=1024, rng=None, eps=None):
    """Render the sparsity pattern of sparse matrix A as an (h, w) uint8 image.

    Large matrices are downsampled by block-averaging nonzero values; small
    ones are shown densely.  ``rng=(i,j)`` restricts to the A[i:j, i:j] block;
    ``eps`` zeroes out entries with |v| <= eps."""
    A = scipy.sparse.coo_matrix(A)
    if rng is not None:
        i, j = rng
        A = scipy.sparse.coo_matrix(A.tocsr()[i:j, i:j])
    if eps is not None:
        keep = np.abs(A.data) > eps
        A = scipy.sparse.coo_matrix((A.data[keep], (A.row[keep], A.col[keep])), shape=A.shape)

    scale = float(mindim) / max(1, min(A.shape))
    if scale >= 1:
        img = np.asarray(A.todense(), dtype=np.float32)
    else:
        n = 1.0 / scale
        h = int(np.ceil(A.shape[0] * scale)) + 1
        w = int(np.ceil(A.shape[1] * scale)) + 1
        bi = (A.row / n).astype(np.int64)
        bj = (A.col / n).astype(np.int64)
        flat = bi * w + bj
        sums = np.bincount(flat, weights=A.data, minlength=h * w)
        counts = np.bincount(flat, minlength=h * w)
        img = np.zeros(h * w, dtype=np.float32)
        nz = counts > 0
        img[nz] = (sums[nz] / counts[nz]).astype(np.float32)
        img = img.reshape(h, w)

    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-12)
    # nearest-neighbor upsample to ~showdim
    rep = max(1, int(showdim // max(img.shape)))
    if rep > 1:
        img = np.repeat(np.repeat(img, rep, axis=0), rep, axis=1)
    return (255 * img).astype(np.uint8)
