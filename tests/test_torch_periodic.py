"""The port's periodic Block-ELL plain version against the JAX package's
Pallas periodic kernel run in interpret mode (as tests/test_operators.py
runs it), and the port's periodic BlockSparseOp apply against keynet_tpu's.
The CUDA kernel itself runs in chip_smoke.py and in the card-only test of
tests/test_torch_block_ell.py."""

import os
import re

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
from keynet_tpu.ops import pallas_kernels as pk
from keynet_tpu.ops.operators import BlockSparseOp as JBlockSparseOp

from keynet_tpu_torch.ops import block_ell
from keynet_tpu_torch.ops.operators import BlockSparseOp

TM = TN = 128

# (P, R, KB, n_uniq, s, tail row-blocks, n_cb, seed): the cases of
# tests/test_operators.py (P < PGROUP with s > 0 and a tail; P = 12 > PGROUP)
CASES = [(3, 4, 2, 7, 2, 1, 6, 3), (pk.PGROUP + 4, 3, 2, 11, 1, 0, 5, 9)]


def _operands(case, B=8):
    P, R, KB, n_uniq, s, tail, n_cb, seed = case
    rng = np.random.default_rng(seed)
    n_rb = s + P * R + tail
    tiles = rng.standard_normal((n_uniq, TM, TN)).astype(np.float32)
    tiles[0] = 0.0
    ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)
    for j in range(1, R):   # impose the periodicity contract on the mid rows
        ids[s + j * P:s + (j + 1) * P] = ids[s:s + P]
    cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
    x = rng.standard_normal((B, n_cb * TN)).astype(np.float32)
    return x, tiles, ids, cols


def _close(ref, got, tol):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.numpy() - ref).max()) <= tol * scale


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=["P3_s2", "P12_two_groups"])
def test_plain_matches_pallas(case, bf16):
    P, R, _, _, s, _, _, _ = case
    x, tiles, ids, cols = _operands(case)
    jt = jnp.asarray(tiles, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    y_jax = pk.periodic_block_ell_matvec(jnp.asarray(x), jt, jnp.asarray(ids),
                                         jnp.asarray(cols), s, P, R, interpret=True)
    tt = torch.from_numpy(tiles).to(torch.bfloat16 if bf16 else torch.float32)
    y = block_ell.periodic_block_ell_plain(torch.from_numpy(x), tt, torch.from_numpy(ids),
                                           torch.from_numpy(cols), s, P, R)
    # f32: both IEEE f32, only the sum order differs; bf16: both round the
    # same inputs to bf16 and accumulate in f32
    _close(y_jax, y, 1e-4 if bf16 else 1e-5)


def test_cpu_wrapper_uses_plain_version_and_does_not_count():
    P, R, _, _, s, _, _, _ = CASES[0]
    x, tiles, ids, cols = (torch.from_numpy(a) for a in _operands(CASES[0], B=5))
    block_ell.reset_launches()
    ref = block_ell.periodic_block_ell_plain(x, tiles, ids, cols, s, P, R)
    texp = tiles[ids[s:s + P].long()]
    assert torch.equal(block_ell.periodic_block_ell_plain(x, tiles, ids, cols, s, P, R,
                                                          texp=texp), ref)
    assert torch.equal(block_ell.periodic_block_ell_matvec(x, tiles, ids, cols, s, P, R),
                       ref)
    assert all(v == 0 for v in block_ell.LAUNCHES.values())
    with pytest.raises(ValueError):      # the period must fit the rows
        block_ell.periodic_block_ell_matvec(x, tiles, ids, cols, s, P, R + 1)


@pytest.mark.parametrize("R,B", [(1, 1), (8, 1), (3, 3), (31, 1), (11, 3), (8, 8), (13, 5),
                                 (31, 32)])
def test_periodic_launch_plan(R, B):
    """The periodic kernel's plan tiles the R·B (rep, image) pairs with the
    least instantiated row tile that holds them (capped at 128), one block
    column per 128 columns of a period row's P·TM.  bf16 adds the two slots
    of 8-byte row offsets to the slot walk's shared memory.  f32 (the IEEE
    FMA core) takes the slot walk's threads and its own TMA ring: 1024 bytes
    of slack, PERIODIC_STAGES[BT] stages of (BT + 128) rows of 128 bytes and
    two 8-byte mbarriers a stage, the k groups' fold inside the ring, and no
    more bytes than keep as many blocks an SM as before."""
    P, TM = 784, 128
    tiles = sorted(block_ell.TILE_THREADS)
    for dtype in (torch.float32, torch.bfloat16):
        plan = block_ell.launch_plan(R * B, P * TM, TM, 128, dtype, kernel="periodic")
        BT = plan["BT"]
        assert BT == min([t for t in tiles if t >= R * B] or [tiles[-1]])
        assert plan["grid"] == (-(-R * B // BT), P)
        walk = block_ell.launch_plan(R * B, P * TM, TM, 128, dtype)
        if dtype == torch.bfloat16:
            assert plan["smem"] == walk["smem"] + 16 * BT <= 232448
            continue
        S = block_ell.PERIODIC_STAGES[BT]
        assert plan["stages"] == S >= 3 and plan["threads"] == walk["threads"]
        assert plan["smem"] == 1024 + S * ((BT + 128) * 128 + 16) <= 232448
        group = 16 * (BT // 8)
        fold = (block_ell.TILE_THREADS[BT] // group - 1) * group * 64 * 4
        assert fold <= S * (BT + 128) * 128
        # blocks an SM (228 KB, 1 KB reserved a block): the parent's cp.async
        # ring held 1 at BT = 128, 2 at 16 to 64, 3 at 8
        blocks = {8: 3, 16: 2, 32: 2, 64: 2, 128: 1}[BT]
        assert blocks * (plan["smem"] + 1024) <= 233472


def test_periodic_stages_match_the_kernel():
    """PERIODIC_STAGES, which launch_plan sizes the f32 ring's shared memory
    from, is the table csrc/periodic_block_ell.cu's fma_stages compiles in."""
    src = open(os.path.join(block_ell._CSRC, "periodic_block_ell.cu")).read()
    body = src[src.index("constexpr int fma_stages()"):]
    body = body[:body.index(";")]
    pairs = dict((int(bt), int(n)) for bt, n in re.findall(r"BT == (\d+) \? (\d+)", body))
    last = int(re.findall(r": (\d+)$", body.strip())[0])
    table = {bt: pairs.get(bt, last) for bt in block_ell.TILE_THREADS}
    assert table == block_ell.PERIODIC_STAGES


def test_non_cpu_tensor_never_falls_back():
    x = torch.empty((2, 256), device="meta")
    tiles = torch.empty((3, 128, 128), device="meta")
    ids = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        block_ell.periodic_block_ell_matvec(x, tiles, ids, ids, 0, 2, 2)


def _block_diag_op(pkg_op, to_tensor):
    rng = np.random.default_rng(4)
    blk = rng.standard_normal((128, 128)).astype(np.float32)
    A = scipy.sparse.block_diag([blk] * 12, format="csr")
    x = rng.standard_normal((2, A.shape[1])).astype(np.float32)
    return pkg_op.from_scipy(A, tileshape=(128, 128)), to_tensor(x)


def test_block_sparse_periodic_apply_matches_jax():
    """BlockSparseOp on the periodic block_diag matrix of
    tests/test_operators.py: same period, same packed arrays, and apply
    equal to keynet_tpu's; the expanded period tiles live only beside CPU
    tiles, so the op's device bytes drop by their size off the CPU."""
    oj, xj = _block_diag_op(JBlockSparseOp, jnp.asarray)
    ot, xt = _block_diag_op(BlockSparseOp, torch.from_numpy)
    assert ot.period is not None and ot.period == oj.period
    for k in ("tiles", "tile_ids", "col_blk"):
        assert np.array_equal(np.asarray(oj.arrays()[k]), ot.arrays()[k].numpy()), k
    B = xt.shape[0]
    s, P, R = ot.period
    assert B <= (R - 1) * TM // R         # the periodic route is taken
    _close(oj.apply(xj), ot.apply(xt), 1e-5)
    assert ot._Texp is not None and ot.device_bytes() == oj.device_bytes()
    texp_bytes = ot._Texp.numel() * ot._Texp.element_size()
    cpu_bytes = ot.device_bytes()
    ot.to("meta")
    assert ot._Texp is None and ot.device_bytes() == cpu_bytes - texp_bytes
