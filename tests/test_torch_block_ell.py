"""The port's plain Block-ELL function against the JAX package's Pallas
entries run in interpret mode (as tests/test_operators.py runs them), the
port's routing, and the rule that without a card every entry point raises
unless device='cpu' is given.  The CUDA kernel itself runs in chip_smoke.py
and in the card-only test at the end."""

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
           ("block_ell_matmul_xresd", pk.block_ell_matmul_xresd, {"depth": 4})]


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


def _compare(fn, kw, case, bf16):
    x, tiles, ids, cols = _operands(case)
    n_out = ids.shape[0] * TM
    jt = jnp.asarray(tiles, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    y_jax = np.asarray(fn(jnp.asarray(x), jt, jnp.asarray(ids), jnp.asarray(cols),
                          n_out, interpret=True, **kw))
    tt = torch.from_numpy(tiles).to(torch.bfloat16 if bf16 else torch.float32)
    y = block_ell.block_ell_plain(torch.from_numpy(x), tt, torch.from_numpy(ids),
                                  torch.from_numpy(cols), n_out)
    assert y.dtype == torch.float32 and tuple(y.shape) == y_jax.shape
    scale = max(1.0, float(np.abs(y_jax).max()))
    # f32: both IEEE f32, only the sum order differs; bf16: both round the
    # same inputs to bf16 and accumulate in f32
    tol = 1e-4 if bf16 else 1e-5
    assert np.abs(y.numpy() - y_jax).max() <= tol * scale


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", range(len(ENTRIES)),
                         ids=[e[0] + str(e[2].get("depth", "")) for e in ENTRIES])
def test_plain_matches_pallas_f32(entry, case):
    _, fn, kw = ENTRIES[entry]
    _compare(fn, kw, case, bf16=False)


@pytest.mark.parametrize("entry", range(len(ENTRIES)),
                         ids=[e[0] + str(e[2].get("depth", "")) for e in ENTRIES])
def test_plain_matches_pallas_bf16(entry):
    _, fn, kw = ENTRIES[entry]
    _compare(fn, kw, CASES[1], bf16=True)


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
                   (block_ell.block_ell_matmul_xresd, {"depth": 4})]:
        y = fn(x, tiles, ids, cols, 5 * TM, **kw)
        assert float((y - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


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
    y = block_ell.block_ell_matmul_xresd(x, tiles, ids, cols, 13 * TM, depth=4)
    assert bool(torch.isfinite(y).all())
