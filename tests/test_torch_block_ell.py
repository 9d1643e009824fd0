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
    # the periodic kernel's plan adds its two slots of row offsets
    per = block_ell.launch_plan(rows, n_out, tm, tm, dtype, periodic=True)
    assert per["BT"] == BT and per["smem"] == plan["smem"] + 16 * BT
    with pytest.raises(ValueError):        # more 128-column chunks than grid.y holds
        block_ell.launch_plan(rows, 65536 * 128, tm, tm, dtype)
    with pytest.raises(ValueError):        # more row tiles than grid.x holds
        block_ell.launch_plan(2 ** 31 * 128, n_out, tm, tm, dtype)
    with pytest.raises(ValueError):        # TM not a multiple of the 128-column chunk
        block_ell.launch_plan(rows, n_out, tm + 64, tm, dtype)


def test_launch_plan_smem_is_the_ring():
    """Shared memory is the ring, STAGES x (BT + 128) panel rows of 128 + 16
    bytes in either dtype (the k groups' fold fits inside it), and grows
    with the row tile; TN does not change it."""
    smem = [block_ell.launch_plan(BT, 128, 128, 128, torch.float32)["smem"]
            for BT in sorted(block_ell.TILE_THREADS)]
    assert smem == [block_ell.STAGES * (BT + 128) * 144 for BT in sorted(block_ell.TILE_THREADS)]
    assert smem == sorted(smem)
    for BT in block_ell.TILE_THREADS:
        assert block_ell.launch_plan(BT, 128, 128, 512, torch.bfloat16)["smem"] == smem[
            sorted(block_ell.TILE_THREADS).index(BT)]


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
