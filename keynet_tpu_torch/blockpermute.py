"""Hierarchical block permutations (global geometric key material).

Functional spec: reference keynet/blockpermute.py — a top-down recursion that
splits an HxWxC image into a (rows, cols) grid of blocks, optionally permutes
(or 90-degree-rotates, "twist") the grid at selected recursion levels, and
recurses into each block.  The matrix form is obtained by permuting an index
image (keynet/blockpermute.py:71-79); here we return permutation *vectors*
(never materializing NxN matrices) and provide a scipy adapter for tests.
"""

import numpy as np
import scipy.sparse

from .util import find_closest_positive_divisor


def block_permute(img, cropshape, rng):
    """Randomly permute the non-overlapping cropshape=(h,w) blocks of an
    (H,W,...) array, preserving content within each block
    (spec: keynet/blockpermute.py:6-19: independent row/col grid permutations)."""
    H, W = img.shape[0], img.shape[1]
    assert H % cropshape[0] == 0 and W % cropshape[1] == 0
    bh, bw = H // cropshape[0], W // cropshape[1]
    rowperm = rng.permutation(bh)
    colperm = rng.permutation(bw)
    # destination block (i,j) receives source block (rowperm[i], colperm[j]) --
    # equivalently blocks move under independent row/col permutations.
    blocks = img.reshape(bh, cropshape[0], bw, cropshape[1], *img.shape[2:])
    blocks = blocks[rowperm][:, :, colperm]
    return blocks.reshape(img.shape)


def hierarchical_block_permute(img, blockshape, permute_at_level, min_blocksize=8,
                               rng=None, seed=None, twist=False, strict=True):
    """Top-down hierarchical block permutation of an (H,W,...) array.

    permute_at_level: iterable of recursion depths at which the grid is
    permuted (0 = whole image).  twist restricts each permutation to a random
    90-degree rotation.  Non-strict mode repairs ragged blockshapes with the
    closest even divisor (spec: keynet/blockpermute.py:22-68).
    """
    permute_at_level = list(np.atleast_1d(permute_at_level))
    if rng is None:
        rng = np.random.default_rng(seed)
    if len(permute_at_level) == 0 or tuple(blockshape) == img.shape[:2]:
        return np.copy(img)

    if img.shape[0] % blockshape[0] != 0 or img.shape[1] % blockshape[1] != 0:
        if strict:
            raise ValueError("image %s not divisible by block layout %s"
                             % (img.shape[:2], tuple(blockshape)))
        blockshape = (find_closest_positive_divisor(img.shape[0], blockshape[0]),
                      find_closest_positive_divisor(img.shape[1], blockshape[1]))

    cropshape = (img.shape[0] // blockshape[0], img.shape[1] // blockshape[1])
    out = np.copy(img)
    if 0 in permute_at_level:
        if twist:
            out = np.rot90(out, k=int(rng.choice([1, 3])))
        else:
            out = block_permute(out, cropshape, rng)
    if max(permute_at_level) <= 0:
        return out

    deeper = [l - 1 for l in permute_at_level]
    for i in range(0, img.shape[0], cropshape[0]):
        for j in range(0, img.shape[1], cropshape[1]):
            sub = out[i:i + cropshape[0], j:j + cropshape[1]]
            if min(cropshape) >= min_blocksize:
                out[i:i + cropshape[0], j:j + cropshape[1]] = hierarchical_block_permute(
                    sub, blockshape, deeper, min_blocksize=min_blocksize, rng=rng, twist=twist)
            else:
                raise ValueError("recursive block %s below min_blocksize %d"
                                 % (sub.shape[:2], min_blocksize))
    return out


def hierarchical_block_permutation(imgshape, blockshape, permute_at_level, min_blocksize=8,
                                   rng=None, seed=None, twist=False, strict=True):
    """Permutation vector perm with x_permuted.flatten() == x.flatten()[perm]
    for x of shape imgshape=(H,W,C) (matrix-free analog of
    keynet/blockpermute.py:71-79)."""
    idx = np.arange(int(np.prod(imgshape))).reshape(imgshape)
    permuted = hierarchical_block_permute(idx, blockshape, permute_at_level,
                                          min_blocksize=min_blocksize, rng=rng,
                                          seed=seed, twist=twist, strict=strict)
    return permuted.reshape(-1)


def permutation_vector_to_matrix(perm, withinverse=False):
    """scipy COO matrix P with P @ x == x[perm] (rows i, cols perm[i])."""
    n = len(perm)
    P = scipy.sparse.coo_matrix((np.ones(n, dtype=np.float32),
                                 (np.arange(n), np.asarray(perm))), shape=(n, n))
    return (P, P.T.tocoo()) if withinverse else P
