"""Small numeric utilities shared across keynet_tpu_torch.

Functional parity targets (reference): keynet/util.py:16-45 (divisor repair and
block views) and keynet/util.py:48-78 (independent numpy conv/pool oracles used
by the test suite).  Implementations here are written fresh in vectorized
numpy; the oracles intentionally use a *different* algorithm (direct padded
window summation) from both the Toeplitz lowering and torch so tests are a
genuine three-way check.
"""

import numpy as np


def find_closest_positive_divisor(a: int, b: int) -> int:
    """Return the non-trivial divisor of ``a`` closest to ``b``.

    Used to repair ragged block/tile sizes (reference keynet/util.py:16-28).
    """
    assert a > 0 and b > 0
    if a <= b:
        return a
    divisors = np.array([d for d in range(2, a + 1) if a % d == 0])
    return int(divisors[np.argmin(np.abs(divisors - b))])


def blockview(A: np.ndarray, n: int) -> np.ndarray:
    """View (H,W) array as (H//n, W//n, n, n) blocks (reference keynet/util.py:40-45)."""
    assert A.ndim == 2 and A.shape[0] % n == 0 and A.shape[1] % n == 0
    H, W = A.shape
    return A.reshape(H // n, n, W // n, n).swapaxes(1, 2)


def blockorder_indices(shape, blocksize: int) -> np.ndarray:
    """Index vector ``idx`` such that ``x.flatten()[idx]`` converts a CxHxW
    channel-order vector into Cx(H//B)x(W//B)xBxB block order.

    Permutation-vector equivalent of the reference's sparse matrix
    (keynet/sparse.py:65-84), including the ragged (H*W % B != 0) case where the
    padded block ordering is truncated to the first H*W entries per channel.
    """
    C, H, W = shape
    Hp = int(blocksize * np.ceil(H / blocksize))
    Wp = int(blocksize * np.ceil(W / blocksize))
    img = np.arange(Hp * Wp).reshape(Hp, Wp)
    order = blockview(img, blocksize).reshape(-1)[: H * W]
    return (order[None, :] + (np.arange(C) * H * W)[:, None]).reshape(-1)


def channel_to_pixel_order_indices(shape) -> np.ndarray:
    """Index vector converting CxHxW (channel order) to HxWxC (pixel order).

    Permutation-vector equivalent of reference keynet/sparse.py:53-62:
    result[i] = flat index into the CxHxW vector of the i-th HxWxC entry.
    """
    C, H, W = shape
    img = np.arange(C * H * W).reshape(C, H, W)
    return np.moveaxis(img, 0, 2).reshape(-1)


def matrix_blockview(W, inshape, n):
    """Reorder sparse W so that W @ x.flatten() == matrix_blockview(W, x.shape, n)
    @ blockview(x, n).flatten() (reference keynet/util.py:31-37), via the
    block-order permutation of both index spaces."""
    import scipy.sparse
    idx = blockview(np.arange(int(np.prod(inshape))).reshape(inshape), n).reshape(-1)
    pos = np.empty_like(idx)
    pos[idx] = np.arange(idx.size)
    W = scipy.sparse.coo_matrix(W)
    return scipy.sparse.coo_matrix((W.data, (pos[W.row], pos[W.col])), shape=W.shape)


def conv2d_oracle(x: np.ndarray, f: np.ndarray, b=None, stride: int = 1) -> np.ndarray:
    """Reference-free numpy conv2d (spatial correlation, padding=k//2).

    x: (N,C,U,V), f: (M,C,P,Q) with P==Q odd, b: (M,) or None.
    Matches torch.nn.functional.conv2d(x, f, b, stride=stride, padding=P//2)
    restricted to output size (U//stride, V//stride).
    """
    N, C, U, V = x.shape
    M, C2, P, Q = f.shape
    assert C2 == C and P == Q and P % 2 == 1
    pad = P // 2
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    Us, Vs = U // stride, V // stride
    out = np.zeros((N, M, Us, Vs), dtype=np.float64)
    for i in range(P):
        for j in range(Q):
            patch = xp[:, :, i : i + U : stride, j : j + V : stride][:, :, :Us, :Vs]
            out += np.einsum("ncuv,mc->nmuv", patch, f[:, :, i, j])
    if b is not None:
        out += b[None, :, None, None]
    return out.astype(np.float32)


def avgpool2d_oracle(x: np.ndarray, kernelsize: int, stride: int) -> np.ndarray:
    """numpy avgpool2d with padding k//2 and count_include_pad semantics,
    i.e. a conv with a constant 1/k^2 per-channel filter (reference
    keynet/util.py:48-61 and keynet/sparse.py:206-212)."""
    N, C, U, V = x.shape
    f = np.zeros((C, C, kernelsize, kernelsize), dtype=np.float32)
    for c in range(C):
        f[c, c] = 1.0 / (kernelsize * kernelsize)
    return conv2d_oracle(x, f, stride=stride)
