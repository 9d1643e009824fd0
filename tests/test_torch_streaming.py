"""Strip streaming and channel-broadcast pools of the port against keynet_tpu
on the CPU: from the same keys, weights and rng seeds,
keyed_conv_streaming, masked_keyed_conv_streaming and
channel_broadcast_keyed_pool give array-equal packed operators (tiles,
tile_ids, col_blk, period, layouts, streaming_stats) and the JAX package's
forward within 1e-5 * max(1, scale).  The cases are those of
tests/test_streaming.py and tests/test_poolfactor.py."""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
import keynet_tpu as kj
from keynet_tpu import keys
from keynet_tpu.ops import kronfactor as jk, streaming as js

import keynet_tpu_torch as kt
from keynet_tpu_torch.ops import kronfactor as tk, streaming as ts
from keynet_tpu_torch.ops.operators import ChannelBroadcastOp, PermutedBlockSparseOp

TOL = 1e-5

GIVENS = dict(local_geometric="givens_orthogonal", alpha=2, blocksize=14,
              local_photometric="uniform_random_affine", beta=1.0, gamma=1.0)
STOCHASTIC = dict(global_geometric="hierarchical_permutation",
                  hierarchical_blockshape=(2, 2), hierarchical_permute_at_level=(0, 1),
                  local_geometric="doubly_stochastic", alpha=2, blocksize=14,
                  local_photometric="uniform_random_affine", beta=1.0, gamma=1.0)

# name: (inshape, outshape, stride, key config or None for identity, strip cap)
STREAM_CASES = {
    "givens_capped_runs": ((8, 56, 56), (8, 56, 56), 1, GIVENS, 100_000),
    "givens_alpha1": ((8, 56, 56), (8, 56, 56), 1,
                      dict(local_geometric="givens_orthogonal", alpha=1, blocksize=14),
                      100_000),
    "nonperiodic_global_photometric": ((8, 56, 56), (8, 56, 56), 1,
                                       dict(GIVENS, global_photometric="uniform_random_affine"),
                                       100_000),
    "whole_image_block": ((8, 14, 14), (8, 14, 14), 1,
                          dict(local_geometric="givens_orthogonal", alpha=8, blocksize=14),
                          60_000),
    "stride2_identity": ((4, 28, 28), (6, 14, 14), 2, None, 50_000),
}


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(a).max()))
    assert float(np.abs(a - b).max()) <= tol * scale


def _links(op):
    return list(getattr(op, "ops", [op]))


def _assert_same_op(oj, ot):
    """Same links, array-equal packed arrays, same periods and layouts."""
    lj, lt = _links(oj), _links(ot)
    assert [type(o).__name__ for o in lj] == [type(o).__name__ for o in lt]
    aj, at = oj.arrays(), ot.arrays()
    assert sorted(aj) == sorted(at)
    for k in aj:
        assert np.array_equal(np.asarray(aj[k]), at[k].numpy()), k
    for a, b in zip(lj, lt):
        if isinstance(b, PermutedBlockSparseOp):
            assert b.inner.period == a.inner.period
            assert (b.layout_in, b.layout_out) == (a.layout_in, a.layout_out)
    assert ot.streaming_stats == oj.streaming_stats


def _conv(inshape, outshape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((outshape[0], inshape[0], 3, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(outshape[0]) * 0.1).astype(np.float32)
    x = rng.standard_normal((3, int(np.prod(inshape)) + 1)).astype(np.float32)
    x[:, -1] = 1.0
    return w, b, x


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_keyed_conv_streaming_matches_jax(name):
    inshape, outshape, stride, cfg, cap = STREAM_CASES[name]
    w, b, x = _conv(inshape, outshape, 0)
    if cfg is None:
        A = scipy.sparse.identity(int(np.prod(outshape)) + 1, format="csr")
        Ainv = scipy.sparse.identity(int(np.prod(inshape)) + 1, format="csr")
    else:
        A, Ainv = keys.keygen(inshape, seed=1, **cfg)
    oj = js.keyed_conv_streaming(inshape, outshape, w, b, stride, A, Ainv,
                                 strip_nnz_cap=cap)
    ot = ts.keyed_conv_streaming(inshape, outshape, w, b, stride, A, Ainv,
                                 strip_nnz_cap=cap)
    _assert_same_op(oj, ot)
    if name == "givens_capped_runs":
        assert ot.streaming_stats["extrapolated"] > 0 and ot.inner.period is not None
    if name == "nonperiodic_global_photometric":
        assert ot.streaming_stats["extrapolated"] == 0
    assert ot.nnz() == oj.nnz()
    _close(oj.apply(jnp.asarray(x)), ot.apply(torch.from_numpy(x)))


def test_masked_keyed_conv_streaming_matches_jax():
    """The stochastic recipe's structure (hierarchical global permutation,
    doubly-stochastic local keys) with the dense inverse split off: a
    masked chain with both sides masked, equal to keynet_tpu's from the same
    rng seed, and equal to the dense key sandwich."""
    shape = (8, 56, 56)
    w, b, x = _conv(shape, shape, 0)
    A, _ = keys.keygen(shape, seed=1, **STOCHASTIC)
    _, Ainv = keys.keygen(shape, seed=2, **STOCHASTIC)
    divs = [d for d in range(2, 3137) if (56 * 56) % d == 0]
    R, f3 = js.split_dense_inverse(scipy.sparse.csr_matrix(Ainv), divs,
                                   rng=np.random.default_rng(5))
    oj = js.masked_keyed_conv_streaming(shape, shape, w, b, 1, A, R,
                                        rng=np.random.default_rng(7))
    ot = ts.masked_keyed_conv_streaming(shape, shape, w, b, 1, A, R,
                                        rng=np.random.default_rng(7))
    assert ot.streaming_stats["masked_out"] and ot.streaming_stats["masked_in"]
    assert [type(o).__name__ for o in ot.ops] \
        == ["EllOp", "PermutedBlockSparseOp", "EllOp"]
    _assert_same_op(oj, ot)
    yj = oj.apply(jnp.asarray(x))
    yt = ot.apply(torch.from_numpy(x))
    _close(yj, yt)
    # the chain after the split-off factor is the keyed layer A·W·A⁻¹
    W = kt.toeplitz.toeplitz_conv2d(shape, w, bias=b, stride=1)
    ref = (scipy.sparse.csr_matrix(A, dtype=np.float32) @ W
           @ scipy.sparse.csr_matrix(Ainv, dtype=np.float32)) @ x.T
    got = ot.apply(torch.from_numpy(np.array(f3.apply(jnp.asarray(x)))))
    _close(ref.T, got)


def _pool_keys(case):
    if case == "givens_out_stochastic_in":
        inshape, outshape = (4, 16, 16), (4, 8, 8)
        A, _ = keys.keygen(outshape, seed=1, local_geometric="givens_orthogonal",
                           alpha=4, blocksize=8, local_photometric="uniform_random_affine",
                           beta=1.0, gamma=1.0)
        _, Ainv = keys.keygen(inshape, seed=2, local_geometric="doubly_stochastic",
                              alpha=2.0, blocksize=8,
                              local_photometric="uniform_random_gain", beta=1.0)
    elif case == "identity_out":
        inshape, outshape = (2, 8, 8), (2, 4, 4)
        A = None
        _, Ainv = keys.keygen(inshape, seed=3, local_geometric="permutation", blocksize=4)
    else:   # a spatial factor past the dense budget: Block-ELL or ELL inner
        inshape, outshape = (4, 64, 64), (4, 32, 32)
        A, _ = keys.keygen(outshape, seed=4, **dict(GIVENS, blocksize=8))
        _, Ainv = keys.keygen(inshape, seed=5, **dict(GIVENS, blocksize=8))
    return inshape, outshape, A, Ainv


@pytest.mark.parametrize("case", ["givens_out_stochastic_in", "identity_out",
                                  "sparse_inner"])
def test_channel_broadcast_keyed_pool_matches_jax(case):
    inshape, outshape, A, Ainv = _pool_keys(case)
    saved = [(G, G.get("DENSE_MAX_BYTES")) for G in (kj.globals.GLOBAL, kt.globals.GLOBAL)]
    if case == "sparse_inner":
        for G, _ in saved:
            G["DENSE_MAX_BYTES"] = 1 << 20
    try:
        oj = jk.channel_broadcast_keyed_pool(inshape, outshape, 2, 2, A, Ainv)
        ot = tk.channel_broadcast_keyed_pool(inshape, outshape, 2, 2, A, Ainv)
    finally:
        for G, v in saved:
            G["DENSE_MAX_BYTES"] = v
    assert isinstance(ot, ChannelBroadcastOp)
    assert type(ot.inner).__name__ == type(oj.inner).__name__
    if case == "sparse_inner":
        assert type(ot.inner).__name__ != "DenseOp"
    assert ot.shape == oj.shape and ot.nnz() == oj.nnz()
    aj, at = oj.arrays(), ot.arrays()
    assert sorted(aj) == sorted(at)
    for k in aj:
        assert np.array_equal(np.asarray(aj[k]), at[k].numpy()), k
    x = np.random.default_rng(0).standard_normal((3, int(np.prod(inshape)) + 1)) \
        .astype(np.float32)
    x[:, -1] = 1.0
    _close(oj.apply(jnp.asarray(x)), ot.apply(torch.from_numpy(x)))
