"""Homogeneous-coordinate algebra.

A Key-Net replaces every affine layer ``y = Wx + b`` with the square-ish linear
map ``[W b; 0 1]`` acting on vectors ``[x; 1]`` so that keys can be composed and
inverted as single matrices (reference: keynet/torch.py:65-89,
keynet/sparse.py:87-119).  This module provides:

  * tensor-side helpers in torch (device) and numpy (host),
  * matrix-side helpers on scipy.sparse (host key construction),
  * the closed-form inverse of a diagonal-affine homogeneous matrix
    ``[D b; 0 1]^-1 = [D^-1 -D^-1 b; 0 1]`` (the reference reaches the same
    result through the Woodbury identity, keynet/sparse.py:99-119).
"""

import numpy as np
import scipy.sparse
import torch


# ---------------------------------------------------------------- tensor side

def affine_to_linear(x):
    """(N,C,H,W) or (C,H,W) tensor -> (N, C*H*W+1) with trailing ones, on
    x's device."""
    x = torch.as_tensor(x)
    if x.ndim == 3:
        x = x[None]
    N = x.shape[0]
    flat = x.reshape(N, -1)
    return torch.cat([flat, torch.ones((N, 1), dtype=flat.dtype,
                                       device=flat.device)], dim=1)


def linear_to_affine(x, outshape=None, atol=1e-3):
    """(N, D+1) -> (N, D) dropping the trailing homogeneous one; optionally
    reshape to (N, *outshape).  Raises if the trailing column is not ~1
    (mirrors reference keynet/torch.py:71-77)."""
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError("expected a (N, D+1) homogeneous batch, got %s"
                         % (tuple(x.shape),))
    last = x[:, -1].detach().cpu().numpy()
    if not np.allclose(last, 1.0, atol=atol):
        raise ValueError("invalid homogeneous vector: trailing column is not 1 (max err %g)"
                         % float(np.abs(last - 1.0).max()))
    y = x[:, :-1]
    return y.reshape((x.shape[0], *outshape)) if outshape is not None else y


def numpy_homogenize(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x.reshape(-1), np.ones(1, dtype=x.dtype)])


def numpy_dehomogenize(x: np.ndarray) -> np.ndarray:
    return x.reshape(-1)[:-1]


# ---------------------------------------------------------------- matrix side

def affine_to_linear_matrix(W: np.ndarray, bias=None) -> np.ndarray:
    """Dense [W b; 0 1] of shape (out+1, in+1) for an affine map y = Wx + b.

    This is the homogeneous matrix of a torch ``nn.Linear`` layer; it matches
    the transpose of reference keynet/torch.py:80-89 (which stores the
    right-multiply form).
    """
    out_f, in_f = W.shape
    M = np.zeros((out_f + 1, in_f + 1), dtype=np.float64)
    M[:out_f, :in_f] = W
    if bias is not None:
        M[:out_f, in_f] = np.asarray(bias).reshape(-1)
    M[out_f, in_f] = 1.0
    return M


def sparse_affine_to_linear(A, bias=None, dtype=np.float64):
    """scipy.sparse A (n_out x n_in), optional bias (n_out,) -> [A b; 0 1]."""
    if bias is None and scipy.sparse.issparse(A):
        # CSR fast path: append the homogeneous row without a COO sort
        # (repeated dense-block inverses reach ~1e8 nnz at VGG scale)
        A = scipy.sparse.csr_matrix(A)
        n_out, n_in = A.shape
        indptr = np.concatenate([A.indptr, [A.indptr[-1] + 1]])
        idt = A.indices.dtype if n_in + 1 <= np.iinfo(A.indices.dtype).max \
            else np.int64
        indices = np.concatenate([A.indices.astype(idt, copy=False),
                                  np.asarray([n_in], dtype=idt)])
        data = np.concatenate([A.data.astype(dtype, copy=False),
                               np.asarray([1.0], dtype=dtype)])
        return scipy.sparse.csr_matrix((data, indices, indptr),
                                       shape=(n_out + 1, n_in + 1))
    A = scipy.sparse.coo_matrix(A)
    n_out, n_in = A.shape
    if bias is not None:
        b = np.asarray(bias).reshape(-1)
        assert b.shape[0] == n_out
        rows = np.concatenate([A.row, np.arange(n_out), [n_out]])
        cols = np.concatenate([A.col, np.full(n_out, n_in), [n_in]])
        vals = np.concatenate([A.data, b, [1.0]])
    else:
        rows = np.concatenate([A.row, [n_out]])
        cols = np.concatenate([A.col, [n_in]])
        vals = np.concatenate([A.data, [1.0]])
    return scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n_out + 1, n_in + 1), dtype=dtype).tocsr()


def diagonal_affine_to_linear(diag: np.ndarray, bias=None, withinverse=False, dtype=np.float64):
    """Homogeneous matrix of the diagonal-affine map y = diag*x + bias and
    its closed-form inverse [D b;0 1]^-1 = [1/D, -b/D; 0 1].

    Replaces the reference's rank-one Woodbury construction
    (keynet/sparse.py:99-119) with the exact algebraic inverse.
    """
    d = np.asarray(diag, dtype=np.float64).reshape(-1)
    n = d.shape[0]
    A = sparse_affine_to_linear(scipy.sparse.diags(d), bias=bias, dtype=dtype)
    if not withinverse:
        return A
    dinv = 1.0 / d
    binv = -dinv * np.asarray(bias).reshape(-1) if bias is not None else None
    Ainv = sparse_affine_to_linear(scipy.sparse.diags(dinv), bias=binv, dtype=dtype)
    return A, Ainv


def mat2gray_key(x: np.ndarray, dtype=np.float64):
    """Normalization-as-key: the [min,max]->[0,1] rescale of a vector is a
    diagonal-affine homogeneous key (gain, bias) with analytic inverse
    (reference keynet/sparse.py:25-33).  Returns (A, Ainv) of size (n+1, n+1)
    for n = x.size."""
    xmin, xmax = float(np.min(x)), float(np.max(x))
    gain = 1.0 / (xmax - xmin)
    bias = -xmin / (xmax - xmin)
    n = x.size
    return diagonal_affine_to_linear(np.full(n, gain), bias=np.full(n, bias),
                                     withinverse=True, dtype=dtype)
