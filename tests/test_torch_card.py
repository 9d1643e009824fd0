"""Card-only tests of the port's CUDA kernels (marked ``cuda``; they skip
without a card).  This file imports neither JAX nor keynet_tpu, so it also
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Each kernel is held against its plain PyTorch version on the same seeded
operands.  Tolerances: 1e-5·max(1, scale) in f32, where only the sum order
differs, and 1e-4 in bf16, where both sides round the same inputs."""

import numpy as np
import pytest
import torch

from keynet_tpu_torch.ops import block_ell

TM = TN = 128

# (B, n_rb, KB, n_uniq, n_cb): B not a multiple of 8, KB not a multiple of
# the depth, n_rb not a multiple of 8
CASES = [(1, 11, 7, 9, 6), (5, 13, 9, 12, 7), (130, 5, 3, 6, 4)]

SLOT_WALK = [(block_ell.block_ell_matmul, {}), (block_ell.block_ell_matmul_xres2, {}),
             (block_ell.block_ell_matmul_xresd, {"depth": 3}),
             (block_ell.block_ell_matmul_xresd, {"depth": 4}),
             (block_ell.block_ell_matmul_xres, {}), (block_ell.block_ell_matmul_grid, {})]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python3 chip_smoke.py)")


def _operands(case, seed=0, tm=TM):
    """Seeded Block-ELL operands with tm x tm tiles: id-0 slots, tile 0 all
    zeros and an all-zero row."""
    B, n_rb, KB, n_uniq, n_cb = case
    rng = np.random.default_rng(seed)
    tiles = rng.standard_normal((n_uniq, tm, tm)).astype(np.float32)
    tiles[0] = 0.0                          # tile 0 is the zero tile
    ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)  # id-0 slots
    ids[n_rb // 2] = 0                      # an all-zero row
    cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
    x = rng.standard_normal((B, n_cb * tm)).astype(np.float32)
    return x, tiles, ids, cols


def _close(y, ref, tol):
    assert y.shape == ref.shape
    assert float((y - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 32, 33, 64, 65, 130])
def test_kernel_matches_plain_on_card(B):
    """The slot-walk kernels against their plain version at batches on both
    sides of every row tile of the slot walk (the same check chip_smoke.py's
    parity phase runs), f32 and bf16, TM = TN = 128 and 256, with id-0 slots
    and an all-zero row."""
    _needs_card()
    for tm in (128, 256):
        x, tiles, ids, cols = (torch.from_numpy(a).cuda()
                               for a in _operands((B, 5, 3, 6, 4), seed=B, tm=tm))
        n_out = ids.shape[0] * tm
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
            t = tiles.to(dtype)
            ref = block_ell.block_ell_plain(x, t, ids, cols, n_out)
            for fn, kw in SLOT_WALK:
                y = fn(x, t, ids, cols, n_out, **kw)
                torch.cuda.synchronize()
                _close(y, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 9, 20, 33, 130])
@pytest.mark.parametrize("name", ["block_ell_matmul_xres", "block_ell_matmul_grid"])
def test_staged_kernels_on_repeated_ids_and_wide_tiles(name, B):
    """The xres and grid kernels against the plain version in f32 and bf16
    at every row tile (B = 1, 9, 20, 33, 130: BT 8 to 128, the last over two
    batch tiles), TN = 128, 256 and 512 (TN = 512 in f32 is the grid case
    that was once refused; the grid kernel streams its panels there), TM =
    256, on rows whose consecutive non-zero slots repeat a tile id (a, a, 0,
    a: the grid kernel keeps its slice over the id-0 slot) and rows that
    start on the last id of the row before, over 601 row-blocks, so the grid
    kernel's blocks walk runs of G = 2 of them, n_rb not a multiple of G."""
    _needs_card()
    rng = np.random.default_rng(2 + B)
    fn = getattr(block_ell, name)
    for n_rb, KB, n_uniq, n_cb, TM_, TN_ in ((9, 6, 7, 5, 128, 512), (6, 5, 6, 4, 256, 256),
                                             (601, 5, 6, 7, 128, 128)):
        tiles = rng.standard_normal((n_uniq, TM_, TN_)).astype(np.float32)
        tiles[0] = 0.0
        ids = rng.integers(1, n_uniq, size=(n_rb, KB)).astype(np.int32)
        ids[::2, 1] = ids[::2, 0]
        ids[::2, 2] = 0
        ids[::2, 3] = ids[::2, 0]
        ids[1:, 0] = ids[:-1, -1]            # row r+1 starts on row r's last id
        cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
        x = torch.from_numpy(rng.standard_normal((B, n_cb * TN_)).astype(np.float32)).cuda()
        ids_d, cols_d = torch.from_numpy(ids).cuda(), torch.from_numpy(cols).cuda()
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
            t = torch.from_numpy(tiles).cuda().to(dtype)
            ref = block_ell.block_ell_plain(x, t, ids_d, cols_d, n_rb * TM_)
            y = fn(x, t, ids_d, cols_d, n_rb * TM_)
            torch.cuda.synchronize()
            _close(y, ref, tol)


@pytest.mark.cuda
def test_grid_keeps_a_tile_across_rows():
    """Where every non-zero slot of 600 row-blocks names tile 1 (a, 0, a
    runs and all-zero rows among them), the grid kernel copies the tile once
    for each block's run of G row-blocks (keep mode, f32 TN = 128), and once
    for every non-zero slot in stream mode (f32 TN = 256); both equal the
    plain version."""
    _needs_card()
    rng = np.random.default_rng(7)
    for tn in (128, 256):
        n_rb, KB = 600, 4
        tiles = rng.standard_normal((3, TM, tn)).astype(np.float32)
        tiles[0] = 0.0
        ids = np.ones((n_rb, KB), dtype=np.int32)
        ids[::3, 1] = 0                          # a, 0, a
        ids[5::7] = 0                            # all-zero rows
        cols = rng.integers(0, 6, size=(n_rb, KB)).astype(np.int32)
        x = torch.from_numpy(rng.standard_normal((1, 6 * tn)).astype(np.float32)).cuda()
        t, ids_d, cols_d = (torch.from_numpy(a).cuda() for a in (tiles, ids, cols))
        y, copies = block_ell.grid_tile_copies(x, t, ids_d, cols_d, n_rb * TM)
        _close(y, block_ell.block_ell_plain(x, t, ids_d, cols_d, n_rb * TM), 1e-5)
        plan = block_ell.launch_plan(1, n_rb * TM, TM, tn, torch.float32, kernel="grid")
        assert plan["G"] == 2 and plan["keep"] == (tn == 128)
        assert copies == (n_rb // plan["G"] if plan["keep"] else int((ids > 0).sum()))


@pytest.mark.cuda
def test_kernel_skips_zero_slots():
    """A slot with tile id 0 adds nothing, even when the x block it points
    at is not finite (the Pallas xres2/xresd kernels multiply the zero tile
    into the step; ROADMAP Queue 3): the slot-walk kernels and the periodic
    kernel give finite outputs equal to the plain version on x with that
    block zeroed."""
    _needs_card()
    x, tiles, ids, cols = (torch.from_numpy(a).cuda() for a in _operands(CASES[1]))
    cols[:, 0] = 6                       # every row's first slot reads block 6 ...
    ids[:, 0] = 0                        # ... through the zero tile
    cols[:, 1:] = torch.remainder(cols[:, 1:], 6)   # which no other slot reads
    x_zero = x.clone()
    x_zero[:, 6 * TN:] = 0.0
    x[:, 6 * TN:] = float("inf")
    n_out = 13 * TM
    for fn, kw in SLOT_WALK:
        y = fn(x, tiles, ids, cols, n_out, **kw)
        assert bool(torch.isfinite(y).all())
        _close(y, block_ell.block_ell_plain(x_zero, tiles, ids, cols, y.shape[1]), 1e-5)
    s, P, R = 1, 4, 3                    # rows [1, 13) repeat rows [1, 5)'s ids
    for j in range(1, R):
        ids[s + j * P:s + (j + 1) * P] = ids[s:s + P]
    y = block_ell.periodic_block_ell_matvec(x, tiles, ids, cols, s, P, R)
    assert bool(torch.isfinite(y).all())
    _close(y, block_ell.periodic_block_ell_plain(x_zero, tiles, ids, cols, s, P, R), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B", [(1, 1), (8, 1), (3, 3), (8, 2), (17, 1), (31, 1),
                                 (11, 3), (7, 5), (8, 8), (13, 5), (31, 5), (7, 20),
                                 (31, 24), (7, 33), (3, 100), (31, 32)])
def test_periodic_kernel_matches_plain_on_card(R, B):
    """The periodic CUDA kernel against its plain version in f32 and bf16,
    with s > 0, P not a multiple of anything, id-0 slots and an all-zero
    period row, at R·B on both sides of every row tile (1, 8 | 9, 16 | 17,
    31 | 33, 35, 64 | 65, 155, 140, 744, 231, 300, 992), with rep
    boundaries inside a row tile and inside an 8-row group of it (B = 24,
    33, 100), and two launches equal bit for bit."""
    _needs_card()
    rng = np.random.default_rng(R * 100 + B)
    s, P, KB, n_uniq, n_cb = 2, 5, 3, 9, 11
    n_rb = s + P * R + 1
    tiles = rng.standard_normal((n_uniq, TM, TN)).astype(np.float32)
    tiles[0] = 0.0
    ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)
    ids[s + 1] = 0                          # an all-zero period row
    for j in range(1, R):
        ids[s + j * P:s + (j + 1) * P] = ids[s:s + P]
    cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((B, n_cb * TN)).astype(np.float32)).cuda()
    ids, cols = torch.from_numpy(ids).cuda(), torch.from_numpy(cols).cuda()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        t = torch.from_numpy(tiles).cuda().to(dtype)
        ref = block_ell.periodic_block_ell_plain(x, t, ids, cols, s, P, R)
        y = block_ell.periodic_block_ell_matvec(x, t, ids, cols, s, P, R)
        torch.cuda.synchronize()
        _close(y, ref, tol)
        assert bool((y[:, TM:2 * TM] == 0).all())
        assert torch.equal(block_ell.periodic_block_ell_matvec(x, t, ids, cols, s, P, R), y)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 130])
def test_tensor_core_kernels_match_plain_on_card(B):
    """bf16 tiles run the slot walk and the periodic kernel on the tensor
    cores (csrc/block_ell_wgmma.cuh): both against their plain versions at
    the parity shapes (KB not a multiple of the depth, TM = 256 and TN =
    128 or 256, id-0 slots, an all-zero row or period row) within
    1e-4·max(1, scale), and id-0 slots that point at an all-inf x block add
    nothing (on tensor cores 0 x inf would be NaN)."""
    _needs_card()
    rng = np.random.default_rng(40 + B)
    s, P, R, KB, n_uniq, n_cb = 1, 3, 4, 7, 9, 8
    for tm, tn in ((256, 128), (256, 256), (128, 128)):
        n_rb = s + P * R + 2
        tiles = rng.standard_normal((n_uniq, tm, tn)).astype(np.float32)
        tiles[0] = 0.0
        ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)
        ids[s + 1] = 0                          # an all-zero period row
        ids[-1] = 0                             # an all-zero row
        for j in range(1, R):
            ids[s + j * P:s + (j + 1) * P] = ids[s:s + P]
        cols = rng.integers(0, n_cb - 1, size=(n_rb, KB)).astype(np.int32)
        x = rng.standard_normal((B, n_cb * tn)).astype(np.float32)
        t = torch.from_numpy(tiles).cuda().to(torch.bfloat16)
        ids_d, cols_d = torch.from_numpy(ids).cuda(), torch.from_numpy(cols).cuda()
        xd = torch.from_numpy(x).cuda()
        n_out = n_rb * tm
        for fn, kw in SLOT_WALK[:4]:
            y = fn(xd, t, ids_d, cols_d, n_out, **kw)
            torch.cuda.synchronize()
            _close(y, block_ell.block_ell_plain(xd, t, ids_d, cols_d, y.shape[1]), 1e-4)
        y = block_ell.periodic_block_ell_matvec(xd, t, ids_d, cols_d, s, P, R)
        torch.cuda.synchronize()
        _close(y, block_ell.periodic_block_ell_plain(xd, t, ids_d, cols_d, s, P, R), 1e-4)
        # every row's first slot: id 0 on the last, all-inf x block
        ids_d[:, 0], cols_d[:, 0] = 0, n_cb - 1
        x_zero = xd.clone()
        x_zero[:, (n_cb - 1) * tn:] = 0.0
        xd[:, (n_cb - 1) * tn:] = float("inf")
        for fn, kw in SLOT_WALK[:4]:
            y = fn(xd, t, ids_d, cols_d, n_out, **kw)
            assert bool(torch.isfinite(y).all())
            _close(y, block_ell.block_ell_plain(x_zero, t, ids_d, cols_d, y.shape[1]), 1e-4)
        y = block_ell.periodic_block_ell_matvec(xd, t, ids_d, cols_d, s, P, R)
        assert bool(torch.isfinite(y).all())
        _close(y, block_ell.periodic_block_ell_plain(x_zero, t, ids_d, cols_d, s, P, R), 1e-4)


class _Globals:
    """Set keynet_tpu_torch GLOBAL keys, restored on exit, and torch's TF32
    flags from PRECISION on entry and exit (globals.precision)."""

    def __init__(self, **keys):
        self.keys = keys

    def __enter__(self):
        from keynet_tpu_torch import globals as G
        self.saved = {k: G.GLOBAL.get(k) for k in self.keys}
        G.GLOBAL.update(self.keys)
        G.precision()

    def __exit__(self, *exc):
        from keynet_tpu_torch import globals as G
        for k, v in self.saved.items():
            if v is None:
                G.GLOBAL.pop(k, None)
            else:
                G.GLOBAL[k] = v
        G.precision()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 33, 130])
def test_tf32_kernels_match_plain_on_card(B):
    """f32 tiles under PRECISION='default' run the slot walk and the
    periodic kernel as tf32 products on the tensor cores: each against its
    plain version with tf32=True (the same rounding; only the sum order
    differs) within 1e-4*max(1, scale), at TM = 256 and TN = 128 or 256 and
    at 128 x 128, with output columns past the row-blocks (padding), id-0
    slots, an all-zero row and period row, every launch counted as tf32;
    then id-0 slots that point at an all-inf x block add nothing.  xres and
    grid stay on the IEEE FMA core (1e-5 against tf32=False).  The plain
    versions run under 'highest': under 'default' their einsum on the card
    would take cuBLAS's TF32 too."""
    _needs_card()
    rng = np.random.default_rng(70 + B)
    s, P, R, KB, n_uniq, n_cb = 1, 3, 4, 7, 9, 8
    for tm, tn in ((256, 128), (256, 256), (128, 128)):
        n_rb = s + P * R + 2
        tiles = rng.standard_normal((n_uniq, tm, tn)).astype(np.float32)
        tiles[0] = 0.0
        ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)
        ids[s + 1] = 0                          # an all-zero period row
        ids[-1] = 0                             # an all-zero row
        for j in range(1, R):
            ids[s + j * P:s + (j + 1) * P] = ids[s:s + P]
        cols = rng.integers(0, n_cb - 1, size=(n_rb, KB)).astype(np.int32)
        t, ids_d, cols_d, xd = (torch.from_numpy(a).cuda() for a in (
            tiles, ids, cols, rng.standard_normal((B, n_cb * tn)).astype(np.float32)))
        n_out = n_rb * tm + 128                 # columns past the row-blocks
        refs = {tf32: block_ell.block_ell_plain(xd, t, ids_d, cols_d, n_out, tf32=tf32)
                for tf32 in (False, True)}
        block_ell.reset_launches()
        for fn, kw in SLOT_WALK:
            with _Globals(PRECISION="default"):
                y = fn(xd, t, ids_d, cols_d, n_out, **kw)
            torch.cuda.synchronize()
            tf32 = fn.__name__ not in ("block_ell_matmul_xres", "block_ell_matmul_grid")
            _close(y, refs[tf32][:, :y.shape[1]], 1e-4 if tf32 else 1e-5)
        with _Globals(PRECISION="default"):
            y = block_ell.periodic_block_ell_matvec(xd, t, ids_d, cols_d, s, P, R)
        torch.cuda.synchronize()
        _close(y, block_ell.periodic_block_ell_plain(xd, t, ids_d, cols_d, s, P, R, tf32=True),
               1e-4)
        assert block_ell.TF32_LAUNCHES == dict(
            block_ell.LAUNCHES, block_ell_matmul_xres=0, block_ell_matmul_grid=0)
        assert block_ell.TF32_LAUNCHES["periodic_block_ell_matvec"] == 1
        # every row's first slot: id 0 on the last, all-inf x block
        ids_d[:, 0], cols_d[:, 0] = 0, n_cb - 1
        x_zero = xd.clone()
        x_zero[:, (n_cb - 1) * tn:] = 0.0
        xd[:, (n_cb - 1) * tn:] = float("inf")
        ref = block_ell.block_ell_plain(x_zero, t, ids_d, cols_d, n_out, tf32=True)
        for fn, kw in SLOT_WALK[:4]:
            with _Globals(PRECISION="default"):
                y = fn(xd, t, ids_d, cols_d, n_out, **kw)
            assert bool(torch.isfinite(y).all())
            _close(y, ref[:, :y.shape[1]], 1e-4)
        with _Globals(PRECISION="default"):
            y = block_ell.periodic_block_ell_matvec(xd, t, ids_d, cols_d, s, P, R)
        assert bool(torch.isfinite(y).all())
        _close(y, block_ell.periodic_block_ell_plain(x_zero, t, ids_d, cols_d, s, P, R,
                                                     tf32=True), 1e-4)


@pytest.mark.cuda
def test_tf32_rounding_pin_on_card():
    """The tensor cores truncate an f32 operand of a tf32 product (13 low
    mantissa bits dropped), as round_tf32 models it: on a diagonal tile, one
    non-zero product an output, the slot walk's and the periodic kernel's
    outputs equal round_tf32(x) * round_tf32(d) bit for bit, in x and in
    the tile, and round to nearest would give other bits."""
    _needs_card()
    low = np.array([0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x3000, 0x0001], np.uint32)
    bits = np.concatenate([0x3F800000 + low, 0xBF800000 + low, 0x41000000 + low])
    vals = bits.view(np.float32)
    n = len(vals)
    x = np.ones((1, 128), np.float32)
    d = np.ones(128, np.float32)
    x[0, :n] = vals                         # x carries the bits, then the tile
    d[64:64 + n] = vals
    r32 = lambda a: block_ell.round_tf32(torch.from_numpy(a)).numpy()
    want = (r32(x) * r32(d)[None, :]).view(np.uint32)
    nearest = ((bits + 0x1000) & ~np.uint32(0x1FFF)).view(np.float32)
    assert not np.array_equal(r32(vals), nearest)
    tiles = torch.zeros((2, 128, 128), dtype=torch.float32, device="cuda")
    tiles[1] = torch.from_numpy(np.diag(d))
    ids = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    cols = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    xd = torch.from_numpy(x).cuda()
    with _Globals(PRECISION="default"):
        ys = [block_ell.block_ell_matmul_xresd(xd, tiles, ids, cols, 128),
              block_ell.periodic_block_ell_matvec(xd, tiles, ids, cols, 0, 1, 1)]
    for y in ys:
        assert np.array_equal(y.cpu().numpy()[:, :128].view(np.uint32), want)


# --------------------------------------------------- keyed nets on the card

def _small_tile_keynet(kt, t, device):
    """Keynet(tileshape=(t, t)) on a 3x32x32 net whose conv2 (and at t = 4
    conv1) packs as Block-ELL with t x t tiles; t = 16 keys a narrow
    VGG-shaped 3x56x56 net into periodic cores of 16 x 16 tiles."""
    m = kt.models
    if t == 16:
        net = m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                       m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                       m.AvgPool2d("pool2", 3, 2),
                       m.Conv2d("conv3", 8, 8, 3), m.ReLU("relu3"),
                       m.Linear("fc4", 8 * 28 * 28, 10)], inshape=(3, 56, 56), seed=5)
        with _Globals(STREAM_NNZ=1000, KRON_FACTORED="never", POOL_FACTOR_MIN_N=1):
            s, k = kt.Keynet((3, 56, 56), net, tileshape=(16, 16), blocksize=16,
                             local_geometric="givens_orthogonal", alpha=2.0,
                             local_photometric="uniform_random_affine", beta=1.0,
                             gamma=1.0, seed=0, device=device)
        return net, s, k
    net = m.Model([m.Conv2d("conv1", 3, 4, 3), m.ReLU("relu1"),
                   m.Conv2d("conv2", 4, 4, 3), m.ReLU("relu2"),
                   m.AvgPool2d("pool2", 3, 2),
                   m.Linear("fc1", 4 * 16 * 16, 10)], inshape=(3, 32, 32), seed=1)
    with _Globals(DENSE_MAX_BYTES=1 << 16):
        s, k = kt.Keynet((3, 32, 32), net, tileshape=(t, t), blocksize=t,
                         local_photometric="uniform_random_affine", beta=1.0, gamma=1.0,
                         seed=0, device=device)
    return net, s, k


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 32, 16])
def test_sub128_tiles_on_card(t):
    """Block-ELL cores with t x t tiles take the einsum on the card (they
    raised in the kernel wrappers before routing by tile shape): keyed ==
    source within 1e-5·max(1, scale), and the keyed output of the card
    equals the CPU's (the plain path) within the same bound; t = 16 runs
    periodic mid-sections at B = 3."""
    _needs_card()
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.ops.operators import PermutedBlockSparseOp
    net, s, k = _small_tile_keynet(kt, t, "cuda")
    _, s_cpu, k_cpu = _small_tile_keynet(kt, t, "cpu")
    cores = [l.op().inner for l in k.layers().values()
             if l != "relu" and isinstance(l.op(), PermutedBlockSparseOp)]
    assert cores and all(c.tileshape == (t, t) for c in cores)
    if t == 16:
        assert any(c.period is not None for c in cores)
    B = 3 if t == 16 else 64
    assert not any(step.entry for c in cores for step in c.schedule(B, torch.device("cuda")))
    x = np.random.default_rng(t).standard_normal((B, *net.inshape)).astype(np.float32)
    y = k.forward(s.fromtensor(torch.from_numpy(x).cuda()).encrypt().tensor())
    ys = net.forward(torch.from_numpy(x).cuda())
    _close(y, ys, 1e-5)
    y_cpu = k_cpu.forward(s_cpu.fromtensor(x).encrypt().tensor())
    _close(y.cpu(), y_cpu, 1e-5)


RUN_FIRST = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import keynet_tpu_torch as kt
net = kt.models.LeNet_AvgPool(seed=0)
sensor, knet = kt.IdentityKeynet((1, 28, 28), net, seed=0, device="cuda")
x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 1, 28, 28))
                     .astype(np.float32)).cuda()
xc = torch.cat([x.reshape(64, -1), torch.ones(64, 1, device="cuda")], dim=1)
y = knet.run(xc)[:, :-1]           # the first computation of the process
ys = net.forward(x)
err = float((y - ys).abs().max())
print(err, float(ys.abs().max()))
assert err <= 1e-5 * max(1.0, float(ys.abs().max())), err
"""


@pytest.mark.cuda
def test_run_first_in_fresh_process():
    """KeyedModel.run on an identity-keyed net (DirectConvOp convs), called
    before anything else in a fresh process, where torch's cuDNN default is
    TF32: keyed == source within 1e-5·max(1, scale)."""
    _needs_card()
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", RUN_FIRST, root], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.cuda
def test_save_load_on_card_bitwise(tmp_path):
    """save_keynet, then load_keynet(device="cuda"): the forward is bitwise
    equal to the in-memory keyed net's (StochasticKeynet on a narrow spec:
    Block-ELL slot walk, Kronecker/TapSum chains, dense)."""
    _needs_card()
    import keynet_tpu_torch as kt
    m = kt.models
    net = m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                   m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                   m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)
    with _Globals(DENSE_MAX_BYTES=1 << 20, ELL_MAX_K=32):
        sensor, knet = kt.StochasticKeynet((3, 16, 16), net, alpha=2, blocksize=8, seed=0,
                                           device="cuda")
    x = np.random.default_rng(9).standard_normal((64, 3, 16, 16)).astype(np.float32)
    xc = sensor.fromtensor(torch.from_numpy(x).cuda()).encrypt().tensor()
    p = str(tmp_path / "k.npz")
    kt.save_keynet(p, knet, sensor=sensor, include_keys=True)
    s2, k2 = kt.load_keynet(p, device="cuda")
    assert torch.equal(knet.forward(xc), k2.forward(xc))


# The stochastic recipe's net of tests/test_torch_vgg_stochastic.py (VGG-16's
# first two blocks at 3x56x56, 16 and 32 channels, hierarchical levels (0, 1))
# and the gates that give it the 224 routes.
STOCH_GATES = {"STREAM_NNZ": 100_000, "POOL_FACTOR_MIN_N": 1,
               "ROWGROUP_MIN_SLOT_BYTES": 1 << 16, "KRON_NPIX_MAX": 512,
               "KRON_NPIX_WIDE": 1024, "MASK_DENSE_MAX_BYTES": 1 << 16}


def _masked_core():
    """conv1_1's masked streamed core (after the dense-inverse split and
    the F2 EllOp) of that net, keyed on the card; and the same arrays as a
    core without its period, so that it carries a grouped-row plan."""
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.ops.operators import BlockSparseOp
    m = kt.models
    net = m.Model([m.Conv2d("conv1_1", 3, 16, 3), m.ReLU("relu1_1"),
                   m.Conv2d("conv1_2", 16, 16, 3), m.ReLU("relu1_2"),
                   m.AvgPool2d("pool1_2", 3, 2)], inshape=(3, 56, 56), seed=5)
    with _Globals(**STOCH_GATES):
        _, knet = kt.Keynet((3, 56, 56), net, global_geometric="hierarchical_permutation",
                            hierarchical_blockshape=(2, 2),
                            hierarchical_permute_at_level=(0, 1),
                            local_geometric="doubly_stochastic", alpha=2.0, blocksize=14,
                            local_photometric="uniform_random_affine", beta=1.0, gamma=1.0,
                            memoryorder="channel", seed=0, device="cuda")
        knet._build()
        chain = knet.layers()["conv1_1"].op()
        assert [type(o).__name__ for o in chain.ops] \
            == ["RepeatedBlockDiagOp", "EllOp", "PermutedBlockSparseOp"]
        core = chain.ops[2].inner
        flat = BlockSparseOp(core.tiles, core.tile_ids, core.col_blk, core.shape,
                             core.tileshape, core.nnz())
    assert flat._rgroups is not None and flat.tiles.is_cuda
    return flat


@pytest.mark.cuda
@pytest.mark.parametrize("case,B", [("grouped_vs_slot_walk", 1), ("grouped_vs_slot_walk", 8),
                                    ("grouped_vs_slot_walk", 32), ("ell_k16", 1),
                                    ("ell_k16", 32)])
def test_stochastic_ops_on_card(case, B):
    """The stochastic recipe's device paths: on a masked streamed core of
    the net above the grouped-row apply (the grouped kernel with f32 tiles;
    tests/test_torch_grouped_card.py holds it against the einsum too) and
    the slot-walk kernel give the same output within 1e-5·max(1, scale); an
    EllOp of K=16 (the row length of keynet_tpu's F2 mask factor at VGG
    conv2_1, docs/SERVING.md:206-207) gives the same result on the card as
    on the CPU."""
    _needs_card()
    from keynet_tpu_torch.ops.operators import EllOp, Step
    rng = np.random.default_rng(B)
    if case == "ell_k16":
        n_in, n_out = 20_000, 30_000
        cols = rng.integers(0, n_in, size=(n_out, 16)).astype(np.int32)
        vals = rng.standard_normal((n_out, 16)).astype(np.float32)
        x = torch.from_numpy(rng.standard_normal((B, n_in)).astype(np.float32))
        op = EllOp(cols, vals, (n_out, n_in), n_out * 16)
        ref = op.apply(x)
        _close(op.to("cuda").apply(x.cuda()).cpu(), ref, 1e-5)
        return
    core = _masked_core()
    TN = core.tileshape[1]
    n_cb = -(-core.shape[1] // TN)
    n_rb = core.tile_ids.shape[0]
    x = torch.from_numpy(rng.standard_normal((B, n_cb * TN)).astype(np.float32)).cuda()
    grouped, = core.schedule(B, x.device)
    walk = Step("rows", 0, n_rb, block_ell.route(core.tile_ids.shape[1]).__name__)
    block_ell.reset_launches()
    y = core.run_step(walk, x)
    assert block_ell.LAUNCHES[walk.entry] == 1
    _close(core.run_step(grouped, x), y, 1e-5)


@pytest.mark.cuda
def test_tp_sharded_block_ell_on_card():
    """Two ranks on the card over gloo: the 8-block block-diagonal (every
    row-block full, so no shard holds an id-0 slot) tile-row tp-sharded and
    applied through the slot-walk kernel equals the single op, on every
    rank."""
    _needs_card()
    import scipy.sparse
    import torch_parallel_ranks as ranks
    from keynet_tpu_torch.parallel import launch
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((8, 128, 128)).astype(np.float32)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    want = (scipy.sparse.block_diag(list(blocks), format="csr") @ x.T).T
    for y, launches, _ in launch(ranks.card_block_ell, 2, args=(blocks, x), backend="gloo",
                                 deadline=300):
        assert launches["block_ell_matmul_xres2"] >= 1
        assert float(np.abs(y - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.cuda
def test_tp_sharded_block_ell_default_on_card():
    """The tp-sharded block-diagonal of the test above under
    PRECISION='default': every rank's slot walk runs tf32 products (each
    launch counted as tf32), and the result equals the product of the
    tf32-rounded blocks and x (round_tf32) within 1e-4*max(1, scale)."""
    _needs_card()
    import scipy.sparse
    import torch_parallel_ranks as ranks
    from keynet_tpu_torch.parallel import launch
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((8, 128, 128)).astype(np.float32)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    r32 = lambda a: block_ell.round_tf32(torch.from_numpy(a)).numpy()
    want = (scipy.sparse.block_diag(list(r32(blocks)), format="csr") @ r32(x).T).T
    for y, launches, tf32 in launch(ranks.card_block_ell, 2, args=(blocks, x, "default"),
                                    backend="gloo", deadline=300):
        assert tf32["block_ell_matmul_xres2"] == launches["block_ell_matmul_xres2"] >= 1
        assert float(np.abs(y - want).max()) <= 1e-4 * max(1.0, float(np.abs(want).max()))


@pytest.mark.cuda
def test_load_challenge_on_card(tmp_path):
    """load_challenge(..., device="cuda") on a legacy-format artifact of a
    PermutationKeynet LeNet_AvgPool: the public forward on the card equals
    the host scipy oracle within 1e-5·max(1, scale)."""
    _needs_card()
    import keynet_tpu_torch as kt
    import legacy_challenge
    net = kt.models.LeNet_AvgPool(seed=0)
    sensor, knet = kt.PermutationKeynet((1, 28, 28), net, seed=0, device="cpu")
    layers = legacy_challenge.layers_of(knet)
    path = str(tmp_path / "challenge.pkl")
    legacy_challenge.write(path, (1, 28, 28), layers)
    _, served = kt.challenge.load_challenge(path, device="cuda")
    x = np.random.default_rng(0).standard_normal((4, 1, 28, 28)).astype(np.float32)
    xc = sensor.fromtensor(x).encrypt().tensor().numpy()
    y = served.forward(xc)
    assert y.device.type == "cuda"
    _close(y.cpu(), torch.from_numpy(legacy_challenge.oracle(layers, xc)), 1e-5)


@pytest.mark.cuda
def test_entry_on_card():
    """entry("cuda")'s fn(x) against entry("cpu")'s within 1e-5·max(1, scale)."""
    _needs_card()
    from keynet_tpu_torch.entry import entry
    fn, (x,) = entry("cuda")
    fn_cpu, (x_cpu,) = entry("cpu")
    assert torch.equal(x.cpu(), x_cpu)
    y = fn(x)
    assert y.device.type == "cuda" and fn.knet.num_parameters() == 323491
    _close(y.cpu(), fn_cpu(x_cpu), 1e-5)


@pytest.mark.cuda
def test_serve_cold_process_on_card(tmp_path):
    """StochasticKeynet AllConvNet(seed=1) (3x32x32, alpha 2, blocksize 8)
    saved with its sensor and served by ``python -m
    keynet_tpu_torch.scripts.serve`` in a fresh process on the card: its
    outputs are bitwise equal to serve() in this process on the same
    bundle, its check holds, and conv1's core launched xresd there."""
    _needs_card()
    import json
    import os
    import subprocess
    import sys
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.scripts import serve
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sensor, knet = kt.StochasticKeynet((3, 32, 32), kt.models.AllConvNet(seed=1), alpha=2,
                                       blocksize=8, seed=0, device="cuda")
    snap, out = str(tmp_path / "allconv.npz"), str(tmp_path / "y.npz")
    kt.save_keynet(snap, knet, sensor=sensor, include_keys=True)
    r = subprocess.run([sys.executable, "-m", "keynet_tpu_torch.scripts.serve", "--snapshot",
                        snap, "--batches", "64", "--reps", "2", "--check", "allconv:1",
                        "--out", out], cwd=root, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0, r.stdout + r.stderr
    line = [l for l in r.stdout.splitlines() if l.startswith("[serve] launches ")][-1]
    assert json.loads(line[len("[serve] launches "):])["block_ell_matmul_xresd"] >= 1
    here = serve.serve(snap, [64], reps=1, device="cuda", verbose=False)
    with np.load(out) as z:
        assert np.array_equal(z["B64"], here["outputs"][64])
