"""Each ported operator, built from the same numpy arrays, applies like its
keynet_tpu twin (CPU, f32: max|diff| <= 1e-5 * max(1, scale)); packing and
plan helpers return equal arrays."""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
from keynet_tpu.globals import GLOBAL as GJ
from keynet_tpu.ops import operators as oj

from keynet_tpu_torch.globals import GLOBAL as GT
from keynet_tpu_torch.ops import operators as ot


def _close(y_jax, y_port, tol=1e-5):
    y_jax = np.asarray(y_jax)
    y_port = y_port.numpy()
    assert y_jax.shape == y_port.shape
    scale = max(1.0, float(np.abs(y_jax).max()))
    err = float(np.abs(y_jax - y_port).max())
    assert err <= tol * scale, (err, scale)


def _x(n, B=3, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, n)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _sparse(shape, density=0.1, seed=1):
    rng = np.random.default_rng(seed)
    return scipy.sparse.random(*shape, density=density, random_state=seed,
                               data_rvs=lambda n: rng.standard_normal(n)).tocsr() \
        .astype(np.float32)


@pytest.mark.parametrize("B", [1, 2, 9, 130])
def test_dense_and_ell(B):
    A = _sparse((70, 90), seed=B)
    xj, xt = _x(90, B)
    _close(oj.DenseOp.from_scipy(A).apply(xj), ot.DenseOp.from_scipy(A).apply(xt))
    ej, et = oj.EllOp.from_scipy(A), ot.EllOp.from_scipy(A)
    assert np.array_equal(np.asarray(ej.cols), et.cols.numpy())
    _close(ej.apply(xj), et.apply(xt))


def test_ell_row_chunks():
    A = _sparse((300, 120), density=0.05)
    xj, xt = _x(120, 16)
    old = GT.get("ELL_GATHER_BYTES")
    GT["ELL_GATHER_BYTES"] = 4096            # force many row chunks
    try:
        y = ot.EllOp.from_scipy(A).apply(xt)
    finally:
        GT.pop("ELL_GATHER_BYTES") if old is None else GT.update(ELL_GATHER_BYTES=old)
    _close(oj.EllOp.from_scipy(A).apply(xj), y)


@pytest.mark.parametrize("tile", [(16, 16), (128, 128), (256, 128)])
def test_block_sparse_packing_and_apply(tile):
    A = _sparse((300, 260), density=0.05, seed=3)
    bj = oj.BlockSparseOp.from_scipy(A, tileshape=tile)
    bt = ot.BlockSparseOp.from_scipy(A, tileshape=tile)
    for k in ("tiles", "tile_ids", "col_blk"):
        assert np.array_equal(np.asarray(bj.arrays()[k]), bt.arrays()[k].numpy()), k
    assert bj.period == bt.period and bj.nnz() == bt.nnz()
    xj, xt = _x(260, 5)
    _close(bj.apply(xj), bt.apply(xt))


def _periodic(rng, s, P, R, tail, KB=3, T=8, n_cb=12, n_uniq=9):
    n_rb = s + P * R + tail
    ids = rng.integers(1, n_uniq, size=(n_rb, KB)).astype(np.int32)
    base = rng.integers(1, n_uniq, size=(P, KB)).astype(np.int32)
    for j in range(R):
        ids[s + j * P: s + (j + 1) * P] = base
    cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
    tiles = rng.standard_normal((n_uniq, T, T)).astype(np.float32)
    tiles[0] = 0.0
    return tiles, ids, cols, (n_rb * T - 3, n_cb * T - 5), (T, T)


@pytest.mark.parametrize("s,P,R,tail", [(0, 2, 5, 0), (3, 2, 5, 2)])
def test_block_sparse_periodic(s, P, R, tail):
    tiles, ids, cols, shape, tile = _periodic(np.random.default_rng(7), s, P, R, tail)
    assert oj.find_row_period(ids) == ot.find_row_period(ids)
    bj = oj.BlockSparseOp(jnp.asarray(tiles), jnp.asarray(ids), jnp.asarray(cols),
                          shape, tile, nnz=1, period=(s, P, R))
    bt = ot.BlockSparseOp(tiles, ids, cols, shape, tile, nnz=1, period=(s, P, R))
    xj, xt = _x(shape[1], 4)
    _close(bj.apply(xj), bt.apply(xt))


def test_block_sparse_grouped_rows():
    rng = np.random.default_rng(5)
    pats = rng.integers(1, 9, size=(6, 4)).astype(np.int32)
    ids = pats[rng.integers(0, 6, size=200)]
    cols = rng.integers(0, 10, size=(200, 4)).astype(np.int32)
    tiles = rng.standard_normal((9, 8, 8)).astype(np.float32)
    tiles[0] = 0.0
    pj, pt = oj.find_row_groups(ids), ot.find_row_groups(ids)
    assert np.array_equal(pj["inv_order"], pt["inv_order"])
    old = (GJ.get("ROWGROUP_MIN_SLOT_BYTES"), GT.get("ROWGROUP_MIN_SLOT_BYTES"))
    GJ["ROWGROUP_MIN_SLOT_BYTES"] = GT["ROWGROUP_MIN_SLOT_BYTES"] = 0
    try:
        bj = oj.BlockSparseOp(jnp.asarray(tiles), jnp.asarray(ids), jnp.asarray(cols),
                              (1600, 80), (8, 8), nnz=1)
        bt = ot.BlockSparseOp(tiles, ids, cols, (1600, 80), (8, 8), nnz=1)
    finally:
        GJ["ROWGROUP_MIN_SLOT_BYTES"], GT["ROWGROUP_MIN_SLOT_BYTES"] = old
    assert bt._rgroups is not None
    xj, xt = _x(80, 2)
    _close(bj.apply(xj), bt.apply(xt))


def test_block_sparse_bf16_tiles():
    A = _sparse((300, 260), density=0.1, seed=1)
    GJ["TILE_DTYPE"] = GT["TILE_DTYPE"] = "bfloat16"
    try:
        bj = oj.BlockSparseOp.from_scipy(A, tileshape=(16, 16))
        bt = ot.BlockSparseOp.from_scipy(A, tileshape=(16, 16))
    finally:
        GJ["TILE_DTYPE"] = GT["TILE_DTYPE"] = "float32"
    assert bt.tiles.dtype == torch.bfloat16
    xj, xt = _x(260, 4)
    _close(bj.apply(xj), bt.apply(xt), tol=1e-4)


@pytest.mark.parametrize("layout", ["blk", "run", "gather"])
def test_permuted_block_sparse(layout):
    C, H, W = 4, 8, 8
    n = C * H * W + 1
    A = scipy.sparse.random(n, n, density=0.02, random_state=1, format="csr",
                            dtype=np.float32)
    if layout == "run":
        perm = oj.run_layout_perm((C, H, W), 16, homogeneous=True)
        assert np.array_equal(perm, ot.run_layout_perm((C, H, W), 16, homogeneous=True))
        lay = ("run", C, H * W, 16)
    else:
        b = oj.conv_layout_blocks((C, H, W))
        assert b == ot.conv_layout_blocks((C, H, W))
        perm = oj.conv_layout_perm((C, H, W), homogeneous=True, blocks=b)
        assert np.array_equal(perm, ot.conv_layout_perm((C, H, W), homogeneous=True,
                                                        blocks=b))
        lay = ("blk", C, H, W, *b) if layout == "blk" else None
    pj = oj.PermutedBlockSparseOp.from_scipy(A, perm, perm, layout_in=lay, layout_out=lay)
    pt = ot.PermutedBlockSparseOp.from_scipy(A, perm, perm, layout_in=lay, layout_out=lay)
    assert np.array_equal(np.asarray(pj.inner.tile_ids), pt.inner.tile_ids.numpy())
    xj, xt = _x(n, 3)
    _close(pj.apply(xj), pt.apply(xt))


def test_repeated_block_diag():
    rng = np.random.default_rng(2)
    F = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    xj, xt = _x(65, 4)
    _close(oj.RepeatedBlockDiagOp(jnp.asarray(F), jnp.asarray(b), 64).apply(xj),
           ot.RepeatedBlockDiagOp(F, b, 64).apply(xt))


@pytest.mark.parametrize("perms", [False, True])
def test_kronecker(perms):
    rng = np.random.default_rng(4)
    Cm = rng.standard_normal((6, 5)).astype(np.float32)
    Sm = rng.standard_normal((9, 16)).astype(np.float32)
    b = rng.standard_normal(54).astype(np.float32)
    pi = rng.permutation(80).astype(np.int32) if perms else None
    po = rng.permutation(54).astype(np.int32) if perms else None
    kj = oj.KroneckerOp(jnp.asarray(Cm), jnp.asarray(Sm), jnp.asarray(b),
                        perm_in=None if pi is None else jnp.asarray(pi),
                        perm_out=None if po is None else jnp.asarray(po))
    kt = ot.KroneckerOp(Cm, Sm, b, perm_in=pi, perm_out=po)
    assert kj.nnz() == kt.nnz()
    xj, xt = _x(81, 4)
    _close(kj.apply(xj), kt.apply(xt))


def test_tapsum_and_chain():
    rng = np.random.default_rng(6)
    K = rng.standard_normal((9, 6, 5)).astype(np.float32)
    S = rng.standard_normal((9, 16, 16)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    F = rng.standard_normal((16, 16)).astype(np.float32)
    bf = rng.standard_normal(80).astype(np.float32)
    tj = oj.TapSumOp(jnp.asarray(K), jnp.asarray(S), jnp.asarray(b))
    tt = ot.TapSumOp(K, S, b)
    xj, xt = _x(81, 3)
    _close(tj.apply(xj), tt.apply(xt))
    cj = oj.ChainedOp([oj.RepeatedBlockDiagOp(jnp.asarray(F), jnp.asarray(bf), 80), tj])
    ct = ot.ChainedOp([ot.RepeatedBlockDiagOp(F, bf, 80), tt])
    assert cj.shape == ct.shape and cj.nnz() == ct.nnz()
    _close(cj.apply(xj), ct.apply(xt))


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (2, 4)])
def test_direct_conv(stride, groups):
    rng = np.random.default_rng(8)
    C1, H, W = 4, 9, 9
    C2 = 4 if groups > 1 else 6
    w = rng.standard_normal((C2, C1 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(C2).astype(np.float32) if groups == 1 else None
    outshape = (C2, H // stride, W // stride)
    dj = oj.DirectConvOp(jnp.asarray(w), None if b is None else jnp.asarray(b),
                         (C1, H, W), outshape, stride, groups=groups)
    dt = ot.DirectConvOp(w, b, (C1, H, W), outshape, stride, groups=groups)
    assert dj.nnz() == dt.nnz()
    xj, xt = _x(C1 * H * W + 1, 2)
    _close(dj.apply(xj), dt.apply(xt))


@pytest.mark.parametrize("fmt", [None, "dense", "block", "ell"])
def test_materialize_formats(fmt):
    A = _sparse((200, 180), density=0.05, seed=9)
    mj = oj.materialize(A, tileshape=(16, 16), dense_max_bytes=1 << 10, format=fmt)
    mt = ot.materialize(A, tileshape=(16, 16), dense_max_bytes=1 << 10, format=fmt)
    assert type(mj).__name__ == type(mt).__name__
    xj, xt = _x(180, 3)
    _close(mj.apply(xj), mt.apply(xt))


def test_block_diag_period_equal():
    from keynet_tpu_torch.keys import keygen
    A, _ = keygen((2, 8, 8), local_geometric="permutation", blocksize=4, seed=0)
    divs = [2, 4, 8, 16, 32, 64]
    assert oj.block_diag_period(A, divs) == ot.block_diag_period(A, divs)


def test_ops_move_between_devices():
    """``to`` moves every tensor of a nested op (here to the meta device)."""
    rng = np.random.default_rng(0)
    F = rng.standard_normal((8, 8)).astype(np.float32)
    A = _sparse((65, 65), density=0.1)
    pool = ot.ChannelBroadcastOp(ot.materialize(_sparse((16, 32), density=0.2),
                                                format="block", tileshape=(16, 16)),
                                 2, np.ones(16, np.float32))
    op = ot.ChainedOp([ot.RepeatedBlockDiagOp(F, np.zeros(64, np.float32), 64),
                       ot.materialize(A, format="block", tileshape=(16, 16)), pool])
    op.to("meta")
    assert op.device.type == "meta"
    assert all(t.device.type == "meta" for o in op.ops for t in o.arrays().values())
