"""The port's Block-ELL entries on CPU tensors (their plain version) against
the JAX package's Pallas entries run in interpret mode (as
tests/test_operators.py runs them), values and output width, the port's
routing, and the rule that without a card every entry point raises unless
device='cpu' is given.  The CUDA kernels themselves run in chip_smoke.py
and in the card-only tests at the end."""

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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs the card: the CUDA kernel against its plain version (the same
    check chip_smoke.py's parity phase runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python3 chip_smoke.py)")
    x, tiles, ids, cols = (torch.from_numpy(a).cuda() for a in _operands(CASES[2]))
    ref = block_ell.block_ell_plain(x, tiles, ids, cols, 5 * TM)
    for fn, kw in [(block_ell.block_ell_matmul, {}), (block_ell.block_ell_matmul_xres2, {}),
                   (block_ell.block_ell_matmul_xresd, {"depth": 3}),
                   (block_ell.block_ell_matmul_xresd, {"depth": 4}),
                   (block_ell.block_ell_matmul_xres, {}), (block_ell.block_ell_matmul_grid, {})]:
        y = fn(x, tiles, ids, cols, 5 * TM, **kw)
        assert float((y - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["block_ell_matmul_xres", "block_ell_matmul_grid"])
def test_staged_kernels_on_repeated_ids_and_wide_tiles(name):
    """Needs the card: the xres and grid kernels against the plain version
    in f32 and bf16 at TN = 256 and TM = 256, on rows whose consecutive
    non-zero slots repeat a tile id (a, a, 0, a: the grid kernel keeps its
    staged slice over the id-0 slot) and rows that end and start on one id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python3 chip_smoke.py)")
    rng = np.random.default_rng(2)
    fn = getattr(block_ell, name)
    for B, n_rb, KB, n_uniq, n_cb, TM_, TN_ in ((5, 9, 6, 7, 5, 128, 256),
                                               (130, 6, 5, 6, 4, 256, 128)):
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
            assert y.shape == ref.shape
            assert float((y - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_kernel_skips_zero_slots():
    """Needs the card: a slot with tile id 0 adds nothing, even when the x
    block it points at is not finite (the Pallas xres2/xresd kernels multiply
    the zero tile into the step; ROADMAP Queue 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python3 chip_smoke.py)")
    x, tiles, ids, cols = (torch.from_numpy(a).cuda() for a in _operands(CASES[1]))
    cols[:, 0] = 6                       # every row's first slot reads block 6 ...
    ids[:, 0] = 0                        # ... through the zero tile
    x[:, 6 * TN:] = float("inf")         # which no other slot reads
    cols[:, 1:] = torch.remainder(cols[:, 1:], 6)
    for fn, kw in ((block_ell.block_ell_matmul_xresd, {"depth": 4}),
                   (block_ell.block_ell_matmul_xres, {}), (block_ell.block_ell_matmul_grid, {})):
        y = fn(x, tiles, ids, cols, 13 * TM, **kw)
        assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_periodic_kernel_matches_plain_on_card():
    """Needs the card: the periodic CUDA kernel against its plain version
    in f32 and bf16, with s > 0, P not a multiple of anything, B = 5, id-0
    slots and an all-zero period row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python3 chip_smoke.py)")
    rng = np.random.default_rng(1)
    s, P, R, KB, n_uniq, n_cb, B = 2, 5, 7, 3, 9, 11, 5
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
        assert float((y - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
        assert bool((y[:, TM:2 * TM] == 0).all())
