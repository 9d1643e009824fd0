"""The port's Block-ELL entries on CPU tensors (their plain version) against
the JAX package's Pallas entries run in interpret mode (as
tests/test_operators.py runs them), values and output width, the port's
routing, and the rule that without a card every entry point raises unless
device='cpu' is given.  The CUDA kernels themselves run in chip_smoke.py
and in the card-only tests, tests/test_torch_card.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from keynet_tpu.ops import pallas_kernels as pk

import keynet_tpu_torch as kt
from keynet_tpu_torch.ops import block_ell

TM = TN = 128

# (B, n_rb, KB, n_uniq, n_cb): B not a multiple of 8, KB not a multiple of
# the depth, n_rb not a multiple of 8
CASES = [(1, 11, 7, 9, 6), (5, 13, 9, 12, 7), (130, 5, 3, 6, 4)]

ENTRIES = [("block_ell_matmul", pk.block_ell_matmul, {}),
           ("block_ell_matmul_xres2", pk.block_ell_matmul_xres2, {}),
           ("block_ell_matmul_xresd", pk.block_ell_matmul_xresd, {"depth": 2}),
           ("block_ell_matmul_xresd", pk.block_ell_matmul_xresd, {"depth": 3}),
           ("block_ell_matmul_xresd", pk.block_ell_matmul_xresd, {"depth": 4}),
           ("block_ell_matmul_xres", pk.block_ell_matmul_xres, {}),
           ("block_ell_matmul_grid", pk.block_ell_matmul_grid, {})]
ENTRY_IDS = [e[0] + str(e[2].get("depth", "")) for e in ENTRIES]


def _operands(case, seed=0):
    B, n_rb, KB, n_uniq, n_cb = case
    rng = np.random.default_rng(seed)
    tiles = rng.standard_normal((n_uniq, TM, TN)).astype(np.float32)
    tiles[0] = 0.0                          # tile 0 is the zero tile
    ids = rng.integers(0, n_uniq, size=(n_rb, KB)).astype(np.int32)  # id-0 slots
    ids[n_rb // 2] = 0                      # an all-zero row
    cols = rng.integers(0, n_cb, size=(n_rb, KB)).astype(np.int32)
    x = rng.standard_normal((B, n_cb * TN)).astype(np.float32)
    return x, tiles, ids, cols


def _compare(name, fn, kw, case, bf16, n_out=None):
    """The port's entry on CPU tensors (its plain version) against the JAX
    entry in interpret mode: same shape, values within the tolerance."""
    x, tiles, ids, cols = _operands(case)
    n_out = ids.shape[0] * TM if n_out is None else n_out
    jt = jnp.asarray(tiles, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    y_jax = np.asarray(fn(jnp.asarray(x), jt, jnp.asarray(ids), jnp.asarray(cols),
                          n_out, interpret=True, **kw))
    tt = torch.from_numpy(tiles).to(torch.bfloat16 if bf16 else torch.float32)
    y = getattr(block_ell, name)(torch.from_numpy(x), tt, torch.from_numpy(ids),
                                 torch.from_numpy(cols), n_out, **kw)
    assert y.dtype == torch.float32 and tuple(y.shape) == y_jax.shape
    scale = max(1.0, float(np.abs(y_jax).max()))
    # f32: both IEEE f32, only the sum order differs; bf16: both round the
    # same inputs to bf16 and accumulate in f32
    tol = 1e-4 if bf16 else 1e-5
    assert np.abs(y.numpy() - y_jax).max() <= tol * scale


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", range(len(ENTRIES)), ids=ENTRY_IDS)
def test_plain_matches_pallas_f32(entry, case):
    _compare(*ENTRIES[entry], case, bf16=False)


@pytest.mark.parametrize("entry", range(len(ENTRIES)), ids=ENTRY_IDS)
def test_plain_matches_pallas_bf16(entry):
    _compare(*ENTRIES[entry], CASES[1], bf16=True)


@pytest.mark.parametrize("width", ["n_rb", "group", "group+1"])
@pytest.mark.parametrize("entry", [0, 1, 4, 5, 6], ids=[ENTRY_IDS[i] for i in (0, 1, 4, 5, 6)])
def test_entry_width_matches_pallas(entry, width):
    """Every entry returns the JAX entry's width: the row-padded ones
    min(n_out_padded, ⌈n_rb/8⌉·8·TM), the grid one min(n_out_padded,
    n_rb·TM), with zeros past n_rb·TM; n_rb = 11 pads to 16."""
    n_rb = CASES[0][1]
    group = -(-n_rb // 8) * 8 * TM
    n_out = {"n_rb": n_rb * TM, "group": group, "group+1": group + TM}[width]
    _compare(*ENTRIES[entry], CASES[0], bf16=False, n_out=n_out)
    assert block_ell.out_width(n_rb, TM, n_out) == min(n_out, group)
    assert block_ell.out_width(n_rb, TM, n_out, grid=True) == n_rb * TM


def test_cpu_entries_use_plain_version_and_do_not_count():
    x, tiles, ids, cols = (torch.from_numpy(a) for a in _operands(CASES[0]))
    block_ell.reset_launches()
    ref = block_ell.block_ell_plain(x, tiles, ids, cols, 11 * TM + 128)
    for fn, kw in [(block_ell.block_ell_matmul, {}), (block_ell.block_ell_matmul_xres2, {}),
                   (block_ell.block_ell_matmul_xresd, {"depth": 3})]:
        y = fn(x, tiles, ids, cols, 11 * TM + 128, **kw)
        assert torch.equal(y, ref)
    assert (ref[:, 11 * TM:] == 0).all()     # columns past n_rb*TM are zero
    assert all(v == 0 for v in block_ell.LAUNCHES.values())


@pytest.mark.parametrize("name", ["block_ell_matmul_xres", "block_ell_matmul_grid"])
def test_new_entries_never_fall_back(name):
    """The xres and grid entries launch their kernel or raise as well."""
    x = torch.empty((2, 256), device="meta")
    tiles = torch.empty((3, 128, 128), device="meta")
    ids = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        getattr(block_ell, name)(x, tiles, ids, ids, 128)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU launches the kernel or raises: on a device the
    kernel does not take it raises instead of computing the plain version."""
    x = torch.empty((2, 256), device="meta")
    tiles = torch.empty((3, 128, 128), device="meta")
    ids = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        block_ell.block_ell_matmul(x, tiles, ids, ids, 128)


def test_route_by_batch_and_row_length():
    """The entry depends on the row length alone: the batch is no argument."""
    import inspect
    assert list(inspect.signature(block_ell.route).parameters) == ["KB"]
    assert block_ell.route(16) is block_ell.block_ell_matmul_xresd
    assert block_ell.route(8) is block_ell.block_ell_matmul_xresd
    assert block_ell.route(7) is block_ell.block_ell_matmul_xres2
    assert block_ell.route(1) is block_ell.block_ell_matmul_xres2


@pytest.mark.parametrize("depth", [0, -1, 2.5])
def test_xresd_rejects_bad_depth(depth):
    x, tiles, ids, cols = (torch.from_numpy(a) for a in _operands(CASES[0]))
    with pytest.raises(ValueError):
        block_ell.block_ell_matmul_xresd(x, tiles, ids, cols, 11 * TM, depth=depth)


PLAN_ROWS = [1, 7, 8, 9, 31, 32, 33, 64, 65, 130, 992, 1024]


@pytest.mark.parametrize("tm", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_launch_plan(rows, dtype, tm):
    """launch_plan's row tile is the least instantiated tile that holds the
    rows (capped at 128), its shared memory fits a block, its grid covers
    every row and output column, and a plan that cannot fit raises."""
    tiles = sorted(block_ell.TILE_THREADS)
    n_out = 5 * tm
    plan = block_ell.launch_plan(rows, n_out, tm, tm, dtype)
    BT = plan["BT"]
    assert BT in tiles
    assert BT == (min(t for t in tiles if t >= rows) if rows <= tiles[-1] else tiles[-1])
    assert plan["stages"] == block_ell.STAGES
    assert 0 < plan["smem"] <= 232448
    assert plan["grid"][0] * BT >= rows > (plan["grid"][0] - 1) * BT
    assert plan["grid"][1] * 128 >= n_out > (plan["grid"][1] - 1) * 128
    # the periodic kernel's plan: bf16 adds its two slots of row offsets, f32
    # takes its TMA ring
    per = block_ell.launch_plan(rows, n_out, tm, tm, dtype, kernel="periodic")
    S = block_ell.PERIODIC_STAGES[BT]
    assert per["BT"] == BT and per["smem"] == (
        plan["smem"] + 16 * BT if dtype == torch.bfloat16
        else 1024 + S * ((BT + 128) * 128 + 16))
    with pytest.raises(ValueError):        # more 128-column chunks than grid.y holds
        block_ell.launch_plan(rows, 65536 * 128, tm, tm, dtype)
    with pytest.raises(ValueError):        # more row tiles than grid.x holds
        block_ell.launch_plan(2 ** 31 * 128, n_out, tm, tm, dtype)
    with pytest.raises(ValueError):        # TM not a multiple of the 128-column chunk
        block_ell.launch_plan(rows, n_out, tm + 64, tm, dtype)


def test_launch_plan_smem_is_the_ring():
    """Shared memory is the ring: with f32 tiles STAGES x (BT + 128) panel
    rows of 128 + 16 bytes (the k groups' fold fits inside it); with bf16
    tiles, which run on the tensor cores, STAGES x (BT + 128) swizzled rows
    of 128 bytes after 1024 bytes of alignment slack.  It grows with the row
    tile; TN does not change it."""
    tiles = sorted(block_ell.TILE_THREADS)
    smem = [block_ell.launch_plan(BT, 128, 128, 128, torch.float32)["smem"] for BT in tiles]
    assert smem == [block_ell.STAGES * (BT + 128) * 144 for BT in tiles]
    assert smem == sorted(smem)
    for BT in tiles:
        assert block_ell.launch_plan(BT, 128, 128, 512, torch.bfloat16)["smem"] \
            == 1024 + block_ell.STAGES * (BT + 128) * 128


def _fold_bytes(BT, threads=None):
    """The k groups' fold of a row tile run by ``threads`` (default: the
    slot walk's) threads: (k groups - 1) x 64 floats a thread of a group."""
    group = 16 * (BT // 8)
    threads = block_ell.TILE_THREADS[BT] if threads is None else threads
    return (threads // group - 1) * group * 64 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_xres_launch_plan(rows, dtype):
    """The xres plan: the slot walk's row tile, threads and grid; shared
    memory = 1024 bytes of alignment slack + STAGES swizzled stages of
    (BT + 128) rows of 128 bytes, each a multiple of 1024 bytes (TMA's
    swizzled destinations stay aligned), + an mbarrier a stage, with room for
    the k groups' fold in the ring; raises where the grid cannot launch."""
    walk = block_ell.launch_plan(rows, 5 * 128, 128, 128, dtype)
    plan = block_ell.launch_plan(rows, 5 * 128, 128, 128, dtype, kernel="xres")
    BT = plan["BT"]
    assert (BT, plan["grid"], plan["stages"]) == (walk["BT"], walk["grid"], walk["stages"])
    assert plan["threads"] == block_ell.TILE_THREADS[BT]
    stage = (BT + 128) * 128
    assert stage % 1024 == 0
    assert plan["smem"] == 1024 + block_ell.STAGES * stage + block_ell.STAGES * 8
    assert _fold_bytes(BT) <= block_ell.STAGES * stage
    # the same bytes in either dtype and at any TN: a stage is 128-byte panels
    assert block_ell.launch_plan(rows, 640, 128, 512, torch.bfloat16, kernel="xres")[
        "smem"] == plan["smem"]
    with pytest.raises(ValueError):        # more 128-column chunks than grid.y holds
        block_ell.launch_plan(rows, 65536 * 128, 128, 128, dtype, kernel="xres")


@pytest.mark.parametrize("tn", [128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_grid_launch_plan(rows, dtype, tn):
    """The grid plan: the slot walk's row tile, 256 consumer threads (k
    groups added; 128 at BT = 8, one 16-byte chunk a group) and a producer
    warp beside 128 of them, a warpgroup beside 256 (it hands its registers
    over); keep
    mode exactly where two 128 x TN tile slices, the x ring, the fold and
    the 2·STAGES + 4 mbarriers fit a block (f32 TN = 128, bf16 TN <= 256),
    else the streamed stages, so every TN is taken (TN = 512 in f32, which
    the kernel once refused, included); G the largest run of row-blocks that
    keeps >= 2 blocks for each of 132 multiprocessors; a grid over every
    row-block with output columns."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_rb, TM = 300, 256
    plan = block_ell.launch_plan(rows, n_rb * TM, TM, tn, dtype, kernel="grid")
    BT, G = plan["BT"], plan["G"]
    assert BT == block_ell.launch_plan(rows, n_rb * TM, TM, tn, dtype)["BT"]
    consumers = 128 if BT == 8 else 256
    assert plan["threads"] == consumers + (32 if BT == 8 else 128)
    tail = _fold_bytes(BT, consumers) + (2 * block_ell.STAGES + 4) * 8
    keep = 1024 + 2 * 128 * tn * itemsize + block_ell.STAGES * BT * 128 + tail
    assert plan["keep"] == (keep <= 232448) == (tn * itemsize <= 512)
    stream = 1024 + block_ell.STAGES * (BT + 128) * 128 + tail
    assert plan["smem"] == (keep if plan["keep"] else stream) <= 232448
    bt = -(-rows // BT)

    def blocks(g):
        return bt * -(-n_rb // g) * (TM // 128)
    assert plan["grid"] == (bt, blocks(G) // bt)
    assert 1 <= G <= n_rb
    assert G == 1 or blocks(G) >= 2 * 132
    assert G == n_rb or blocks(G + 1) < 2 * 132
    # output columns stop at n_out: row-blocks past them get no block
    part = block_ell.launch_plan(rows, 7 * TM - 5, TM, tn, dtype, kernel="grid")
    assert part["grid"][1] == -(-7 // part["G"]) * 2


def test_grid_launch_plan_at_the_bench_shapes():
    """G at the depth-bench operand (784 row-blocks: G = 2 at B = 1 and 8,
    392 blocks) and at 189 row-blocks (the VGG conv1_2 head rows, B = 1:
    fewer than 264 blocks even at G = 1); AllConvNet conv1 at B = 1024 (8
    batch tiles of 128, 769 row-blocks) runs 24 row-blocks a block."""
    f32 = torch.float32
    for B in (1, 8):
        plan = block_ell.launch_plan(B, 784 * 128, 128, 128, f32, kernel="grid")
        assert (plan["G"], plan["grid"], plan["keep"]) == (2, (1, 392), True)
    assert block_ell.launch_plan(1, 189 * 128, 128, 128, f32, kernel="grid")["G"] == 1
    plan = block_ell.launch_plan(1024, 769 * 128, 128, 128, f32, kernel="grid")
    assert (plan["BT"], plan["G"], plan["grid"]) == (128, 24, (8, 33))
    assert not block_ell.launch_plan(8, 128, 128, 512, f32, kernel="grid")["keep"]


def test_launch_plan_names_its_kernel():
    with pytest.raises(ValueError):
        block_ell.launch_plan(8, 128, 128, 128, torch.float32, kernel="hbm")


def test_grid_tile_copies_needs_the_card():
    """The copy count is the CUDA kernel's: a CPU tensor is refused, not
    answered by the plain version."""
    x, tiles, ids, cols = (torch.from_numpy(a) for a in _operands(CASES[0]))
    with pytest.raises(ValueError):
        block_ell.grid_tile_copies(x, tiles, ids, cols, 11 * TM)


def _tiny_net():
    m = kt.models
    return m.Model([m.Conv2d("conv1", 1, 2, 3), m.ReLU("relu1"),
                    m.Linear("fc", 2 * 8 * 8, 4)], inshape=(1, 8, 8), seed=0)


@pytest.mark.parametrize("entry", ["Keynet", "StochasticKeynet", "PermutationKeynet",
                                   "IdentityKeynet", "KeyedModel", "KeyedSensor",
                                   "load_keynet"])
def test_entry_points_raise_without_card_unless_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry points run on it")
    net = _tiny_net()
    n = 65
    I = kt.keys.identity_matrix(n)

    def call(**dev):
        if entry == "Keynet":
            return kt.Keynet((1, 8, 8), net, seed=0, **dev)
        if entry == "StochasticKeynet":
            return kt.StochasticKeynet((1, 8, 8), net, alpha=2, blocksize=4, seed=0, **dev)
        if entry == "PermutationKeynet":
            return kt.PermutationKeynet((1, 8, 8), net, seed=0, **dev)
        if entry == "IdentityKeynet":
            return kt.IdentityKeynet((1, 8, 8), net, seed=0, **dev)
        if entry == "KeyedModel":
            f_kp = lambda name, shape: kt.keygen(shape, seed=1)
            return kt.KeyedModel(net, (1, 8, 8), I, f_kp, kt.layergen, **dev)
        if entry == "KeyedSensor":
            return kt.KeyedSensor((1, 8, 8), (I, I), **dev)
        import keynet_tpu as kj
        jnet = kj.models.Model([kj.models.Conv2d("conv1", 1, 2, 3),
                                kj.models.ReLU("relu1"),
                                kj.models.Linear("fc", 2 * 8 * 8, 4)],
                               inshape=(1, 8, 8), seed=0)
        s, k = kj.PermutationKeynet((1, 8, 8), jnet, seed=0)
        p = str(tmp_path / "k.npz")
        kj.serialize.save_keynet(p, k, sensor=s, include_keys=True)
        return kt.load_keynet(p, **dev)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError):
        call(device="cuda")
    assert call(device="cpu") is not None
