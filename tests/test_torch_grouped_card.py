"""Card-only tests of the grouped kernel (csrc/grouped_block_ell.cu, entry
ops/block_ell.grouped_block_ell_matmul; marked ``cuda``, they skip without
a card).  Imports neither JAX nor keynet_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_grouped_card.py

The kernel is held within 1e-5·max(1, scale) of the grouped einsum and of
the slot-walk kernel, on a masked streamed core of the stochastic recipe
and on plans made by hand: a bucket of m = 1, m·B not a multiple of the row
tile, padding slots, tiles shared between patterns and an x block that only
padding slots name (filled with inf: a skipped slot adds nothing)."""

import numpy as np
import pytest
import torch

from keynet_tpu_torch import profiling
from keynet_tpu_torch.ops import block_ell
from test_torch_card import _close, _masked_core, _needs_card

TM = TN = 128
BATCHES = [1, 8, 32, 33]


@pytest.fixture(scope="module")
def masked():
    _needs_card()
    return _masked_core()


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_grouped_kernel_on_masked_core(masked, B):
    """BlockSparseOp.apply takes the grouped kernel on the card: one launch
    a row tile of its tables, counted in LAUNCHES and GROUPED_ROWS; equal to
    the grouped einsum and the slot walk, and bitwise equal run to run."""
    core = masked
    n_rb, KB = core.tile_ids.shape
    n_out, n_in = core.shape
    n_cb = -(-n_in // TN)
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.standard_normal((B, n_in)).astype(np.float32)).cuda()
    xp = torch.nn.functional.pad(x, (0, n_cb * TN - n_in))
    grouped, = core.schedule(B, x.device)
    assert grouped == ("grouped", 0, n_rb, "grouped_block_ell_matmul")
    block_ell.reset_launches()
    chunks = profiling.GROUPED_ROWS["chunks"]
    y = core.apply(x)
    n_launch = len(core._rgroup_tables[B]["launches"])
    tiles = {block_ell.launch_plan(m * B, TM, TM, TN, torch.float32, "grouped")["BT"]
             for m, _ in core._rgroup_meta}
    assert block_ell.LAUNCHES["grouped_block_ell_matmul"] == n_launch == len(tiles)
    assert profiling.GROUPED_ROWS["chunks"] == chunks + n_launch
    assert sum(v for k, v in block_ell.LAUNCHES.items()
               if k != "grouped_block_ell_matmul") == 0
    einsum = core.run_step(grouped._replace(entry=None), xp)
    walk = core.run_step(grouped._replace(kind="rows", entry=block_ell.route(KB).__name__), xp)
    torch.cuda.synchronize()
    _close(y, einsum[:, :n_out], 1e-5)
    _close(y, walk[:, :n_out], 1e-5)
    assert torch.equal(y, core.apply(x))


def _plan(seed=0):
    """A plan by hand: buckets (m, G) = (1, 3), (3, 2), (5, 1), (40, 2) over
    94 row-blocks in shuffled order, KB = 5; patterns with padding slots
    (one all padding), sharing tiles 1-4; column block 6 named only by
    padding slots."""
    buckets = [(1, 3), (3, 2), (5, 1), (40, 2)]
    patterns = np.array([[1, 0, 2, 0, 3], [2, 2, 0, 0, 0], [0, 0, 0, 0, 0],
                         [4, 1, 0, 3, 2], [1, 1, 1, 1, 1], [0, 4, 0, 0, 4],
                         [3, 0, 1, 2, 0], [2, 0, 0, 0, 4]], dtype=np.int32)
    n_rb, KB, n_cb = sum(m * G for m, G in buckets), 5, 7
    rng = np.random.default_rng(seed)
    rows = rng.permutation(n_rb).astype(np.int32)
    ids = np.zeros((n_rb, KB), np.int32)
    g = r = 0
    for m, G in buckets:
        for _ in range(G):
            ids[rows[r:r + m]] = patterns[g]
            g, r = g + 1, r + m
    cols = rng.integers(0, n_cb - 1, (n_rb, KB)).astype(np.int32)
    cols[ids == 0] = n_cb - 1
    tiles = rng.standard_normal((5, TM, TN)).astype(np.float32)
    tiles[0] = 0.0
    return buckets, patterns, rows, ids, cols, tiles, n_cb


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_grouped_kernel_on_a_plan_by_hand(B):
    """The entry against the plain grouped einsum and the slot walk, row by
    row against a float64 product at rows[...] itself, and run to run."""
    _needs_card()
    buckets, patterns, rows, ids, cols, tiles, n_cb = _plan()
    n_rb = ids.shape[0]
    rng = np.random.default_rng(100 + B)
    x = rng.standard_normal((B, n_cb * TN)).astype(np.float32)
    x_inf = x.copy()
    x_inf[:, (n_cb - 1) * TN:] = np.inf         # read by padding slots alone
    dev = [torch.from_numpy(a).cuda() for a in (x_inf, tiles, patterns, rows, cols)]
    block_ell.reset_launches()
    y = block_ell.grouped_block_ell_matmul(*dev, buckets, n_rb * TM)
    n_tiles = len({block_ell.launch_plan(m * B, TM, TM, TN, torch.float32,
                                         "grouped")["BT"] for m, _ in buckets})
    assert block_ell.LAUNCHES["grouped_block_ell_matmul"] == n_tiles
    cpu = [torch.from_numpy(a) for a in (x, tiles, patterns, rows, cols)]
    plain = block_ell.grouped_block_ell_plain(*cpu, buckets, n_rb * TM)
    walk = block_ell.block_ell_matmul_xresd(dev[0], dev[1], torch.from_numpy(ids).cuda(),
                                            dev[4], n_rb * TM)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    _close(y.cpu(), plain, 1e-5)
    _close(y, walk[:, :n_rb * TM], 1e-5)
    assert torch.equal(y, block_ell.grouped_block_ell_matmul(*dev, buckets, n_rb * TM))
    # each row-block's output lands at its own place: rows[g·m + i]
    yc = y.cpu().double().reshape(B, n_rb, TM)
    xd = torch.from_numpy(x).double().reshape(B, n_cb, TN)
    td = torch.from_numpy(tiles).double()
    for r in (rows[0], rows[3], rows[-1]):
        want = sum(xd[:, cols[r, k]] @ td[ids[r, k]].T for k in range(ids.shape[1])
                   if ids[r, k] > 0)
        want = want if torch.is_tensor(want) else torch.zeros(B, TM, dtype=torch.float64)
        assert float((yc[:, r] - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33])
def test_grouped_kernel_bf16_tiles(B):
    """bf16 tiles run the same walk on the FMA core: within 1e-4 of the plain
    version of the same bf16 operands."""
    _needs_card()
    buckets, patterns, rows, ids, cols, tiles, n_cb = _plan(seed=1)
    n_rb = ids.shape[0]
    x = np.random.default_rng(B).standard_normal((B, n_cb * TN)).astype(np.float32)
    t16 = torch.from_numpy(tiles).to(torch.bfloat16)
    args = [torch.from_numpy(x), t16, torch.from_numpy(patterns), torch.from_numpy(rows),
            torch.from_numpy(cols)]
    assert block_ell.product("grouped_block_ell_matmul", torch.bfloat16) == "bf16"
    y = block_ell.grouped_block_ell_matmul(*[a.cuda() for a in args], buckets, n_rb * TM)
    plain = block_ell.grouped_block_ell_plain(*args, buckets, n_rb * TM)
    torch.cuda.synchronize()
    _close(y.cpu(), plain, 1e-4)
