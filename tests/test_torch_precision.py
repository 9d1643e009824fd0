"""PRECISION='default' (keynet_tpu's relaxed mode, keynet_tpu/globals.py:19-22),
the port against keynet_tpu on the CPU, with the key set in both packages
and restored after.

(a) ``kernel_precision`` maps each mode and tile dtype to the product the
Block-ELL kernels run as keynet_tpu's kernel_precision() and
BlockSparseOp._precision map them to a Pallas dot precision: 'ieee' where
keynet_tpu's kernels run HIGHEST (f32 tiles under 'highest' and 'high'),
'tf32' and 'bf16' where they run DEFAULT.

(b) launch_plan's tf32 plans (f32 tiles on the tensor cores under
'default'): two warpgroups, the bf16 plan's 128-byte swizzled ring, two
blocks an SM, a wgmma N at every batch from 1 to 1024; the mode is read at
the call.

(c) round_tf32 on fixed bit patterns: the tensor cores' truncation of an
f32 operand to tf32 (13 low mantissa bits dropped).

(d) The plain versions with tf32=True on the f32 cores of the Givens-
orthogonal recipe on the narrow VGG-shaped net at 3x56x56 of
test_torch_bf16.py: within 1e-3*max(1, scale) of keynet_tpu's core apply
under 'default' (on the CPU, f32 products: the gap is the tf32 rounding),
and more than 1e-7 from tf32=False (the rounding is applied).

(e) The keyed forward under 'default' on the CPU, where every product stays
f32 in both packages: within 1e-5*max(1, scale) of keynet_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import keynet_tpu as kj
import keynet_tpu_torch as kt
from keynet_tpu_torch.ops import block_ell
from test_torch_bf16 import ORTH, ORTH_GATES, _close, _cores, _Globals, _jax_cores, _vgg_narrow

MODES = ("highest", "high", "default")
TOL_CORE, TOL_FWD = 1e-3, 1e-5
# the port's product -> the Pallas dot precision keynet_tpu's kernels run
PALLAS = {"ieee": jax.lax.Precision.HIGHEST, "tf32": jax.lax.Precision.DEFAULT,
          "bf16": jax.lax.Precision.DEFAULT}


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_precision_matches_jax(mode, dtype):
    """The product for each mode and tile dtype is the one keynet_tpu's
    Pallas wrappers pick: kernel_precision() (HIGH rounded up to HIGHEST)
    for f32 tiles, DEFAULT for bf16 tiles whatever the mode, as
    BlockSparseOp._precision gives bf16 tiles DEFAULT."""
    tiles = np.zeros((2, 128, 128), np.float32)
    ids = np.zeros((1, 1), np.int32)
    op = kj.ops.operators.BlockSparseOp(jnp.asarray(tiles).astype(getattr(jnp, dtype)),
                                        jnp.asarray(ids), jnp.asarray(ids),
                                        (128, 128), (128, 128), 0)
    with _Globals(PRECISION=mode):
        jax_mode, jax_op = kj.globals.precision(), op._precision()
        jax_kernel = kj.globals.kernel_precision() if dtype == "float32" \
            else jax.lax.Precision.DEFAULT
        product = kt.globals.kernel_precision(getattr(torch, dtype))
    assert PALLAS[product] == jax_kernel
    # BlockSparseOp._precision: the mode itself for f32 tiles, DEFAULT for bf16
    assert jax_op == (jax_mode if dtype == "float32" else jax.lax.Precision.DEFAULT)
    assert product == {"bfloat16": "bf16"}.get(dtype, "tf32" if mode == "default" else "ieee")


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("TN", [128, 256])
@pytest.mark.parametrize("kernel", ["slot_walk", "periodic"])
def test_launch_plan_tf32(kernel, TN):
    """tf32 plans at every batch from 1 to 1024: WGMMA_THREADS threads, a
    row tile that is a wgmma N (a multiple of 8 from 8 to 256) and holds the
    rows up to 128, shared memory 1024 + STAGES x (BT + 128) x 128 bytes (+
    the periodic kernel's row offsets) as in the bf16 plan, within the 227
    KB a block may have and two blocks an SM (228 KB); the mode read at the
    call ('default': tf32, 'highest' and 'high': the FMA core's plan)."""
    per = 16 if kernel == "periodic" else 0
    with _Globals(PRECISION="default"):
        for B in range(1, 1025):
            plan = block_ell.launch_plan(B, 5 * 128, 128, TN, torch.float32, kernel)
            BT = plan["BT"]
            assert plan["kind"] == block_ell.KIND["tf32"] == 2
            assert plan["threads"] == block_ell.WGMMA_THREADS == 256
            assert BT % 8 == 0 and 8 <= BT <= 256 and BT >= min(B, 128)
            assert plan["smem"] == 1024 + block_ell.STAGES * (BT + 128) * 128 + per * BT
            assert plan["smem"] <= 232448 and 2 * plan["smem"] <= 228 * 1024
            bf16 = block_ell.launch_plan(B, 5 * 128, 128, TN, torch.bfloat16, kernel)
            assert bf16["kind"] == 1
            assert {k: v for k, v in plan.items() if k != "kind"} == \
                {k: v for k, v in bf16.items() if k != "kind"}
    for mode in ("highest", "high"):
        with _Globals(PRECISION=mode):
            plan = block_ell.launch_plan(33, 5 * 128, 128, TN, torch.float32, kernel)
            assert plan["kind"] == 0 and plan["threads"] == block_ell.TILE_THREADS[64]
            assert block_ell.launch_plan(33, 5 * 128, 128, TN, torch.bfloat16, kernel)[
                "kind"] == 1


@pytest.mark.parametrize("kernel", ["xres", "grid"])
def test_launch_plan_staged_kernels_ignore_the_mode(kernel):
    """xres and grid run the FMA core in every mode: their plans under
    'default' are those under 'highest'."""
    plans = []
    for mode in MODES:
        with _Globals(PRECISION=mode):
            plans.append([block_ell.launch_plan(B, 7 * 128, 128, 128, dt, kernel)
                          for B in (1, 9, 33, 130) for dt in (torch.float32, torch.bfloat16)])
    assert plans[0] == plans[1] == plans[2]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("entry", block_ell.ENTRIES)
def test_product_is_what_the_launch_runs(entry, mode):
    """block_ell.product(entry, dtype) is the product the entry's launch
    runs, in one place: the kind launch_plan hands the kernel, the slot walk
    and periodic kernel on kernel_precision, xres and grid on the FMA core."""
    kernel = block_ell.KERNEL_OF[entry]
    with _Globals(PRECISION=mode):
        for dt in (torch.float32, torch.bfloat16):
            product = block_ell.product(entry, dt)
            assert product == block_ell.product(kernel, dt)
            assert block_ell.KIND[product] == \
                block_ell.launch_plan(9, 3 * 128, 128, 128, dt, kernel)["kind"]
            if kernel in ("slot_walk", "periodic"):
                assert product == kt.globals.kernel_precision(dt)
            else:
                assert product == ("bf16" if dt == torch.bfloat16 else "ieee")


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("bits,want", [
    (0x3F801FFF, 0x3F800000),   # 1 + all 13 low bits: down to 1
    (0x3F801000, 0x3F800000),   # a tie: down (truncation, not round to nearest)
    (0x3F803000, 0x3F802000),   # a tie above an odd tf32 mantissa: down
    (0xBF801FFF, 0xBF800000),   # negative: toward zero
    (0x3F802000, 0x3F802000),   # already tf32
    (0x7F7FFFFF, 0x7F7FE000),   # the largest f32 stays finite
    (0x7F800000, 0x7F800000),   # inf
    (0x00001FFF, 0x00000000),   # a subnormal below the tf32 unit: zero
    (0x80000000, 0x80000000),   # -0
])
def test_round_tf32_bits(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    y = block_ell.round_tf32(x)
    assert y.dtype == torch.float32
    assert int(y.view(torch.int32).item()) & 0xFFFFFFFF == want


def test_round_tf32_keeps_shape_and_drops_13_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))[:, ::2]
    y = block_ell.round_tf32(x)
    assert y.shape == x.shape and block_ell.TF32_DROPPED_BITS == 13
    bx = x.contiguous().view(torch.int32)
    by = y.view(torch.int32)
    assert bool((by == (bx & ~0x1FFF)).all())
    assert bool((y.abs() <= x.abs()).all()) and float((x - y).abs().max()) > 0
    assert torch.equal(block_ell.round_tf32(y), y)


# ------------------------------------------------------------------ (d), (e)

@pytest.fixture(scope="module")
def orth():
    with _Globals(**ORTH_GATES):
        nj, nt = _vgg_narrow(kj.models), _vgg_narrow(kt.models)
        sj, knj = kj.Keynet((3, 56, 56), nj, **ORTH)
        st, knt = kt.Keynet((3, 56, 56), nt, device="cpu", **ORTH)
    return dict(sj=sj, st=st, knj=knj, knt=knt)


def _apply_tf32(core, x, tf32):
    """BlockSparseOp.apply through the plain versions with tf32 rounding:
    the head and tail rows on block_ell_plain, the period on
    periodic_block_ell_plain, as the card's routes run them."""
    TM, TN = core.tileshape
    n_out, n_in = core.shape
    n_cb = -(-n_in // TN)
    x = F.pad(x, (0, n_cb * TN - n_in)).contiguous()
    n_rb = core.tile_ids.shape[0]
    args = (core.tiles, core.tile_ids, core.col_blk)
    if core.period is None:
        return block_ell.block_ell_plain(x, *args, n_rb * TM, tf32=tf32)[:, :n_out]
    s, P, R = core.period
    parts = []
    for a, b in ((0, s), (s + P * R, n_rb)):
        if b > a:
            parts.append((a, block_ell.block_ell_plain(x, core.tiles, core.tile_ids[a:b],
                                                        core.col_blk[a:b], (b - a) * TM,
                                                        tf32=tf32)))
    parts.append((s, block_ell.periodic_block_ell_plain(x, *args, s, P, R, tf32=tf32)))
    y = torch.cat([p for _, p in sorted(parts, key=lambda ap: ap[0])], dim=1)
    return y[:, :n_out]


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv3"])
def test_plain_tf32_against_jax_default(orth, layer, B):
    """Each f32 core's plain versions with tf32=True, fed the same input,
    within 1e-3*max(1, scale) of keynet_tpu's core apply under 'default',
    and more than 1e-7 from the same plain versions with tf32=False, which
    equal the port's own apply (f32 products on the CPU in every mode)."""
    (_, cj), = _jax_cores(orth["knj"].layers()[layer].op())
    (_, ct), = _cores(orth["knt"].layers()[layer].op())
    assert ct.tiles.dtype == torch.float32 and ct.tileshape == (128, 128)
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.standard_normal((B, ct.shape[1])).astype(np.float32))
    with _Globals(PRECISION="default"):
        yj = cj.apply(jnp.asarray(x.numpy()))
        y32 = _apply_tf32(ct, x, tf32=True)
        yf = _apply_tf32(ct, x, tf32=False)
        _close(ct.apply(x), yf, TOL_FWD)
    _close(yj, y32, TOL_CORE)
    assert float((y32 - yf).abs().max()) > 1e-7


@pytest.mark.parametrize("B", [1, 8, 32])
def test_cpu_forward_default_matches_jax(orth, B):
    """The keyed forward under 'default' on the CPU within 1e-5*max(1,
    scale) of keynet_tpu's under 'default', and equal to the port's own
    forward under 'highest' (the CPU keeps f32 products)."""
    x = np.random.default_rng(100 + B).standard_normal((B, 3, 56, 56)).astype(np.float32)
    yh = orth["knt"].forward(orth["st"].fromtensor(torch.from_numpy(x)).encrypt().tensor())
    with _Globals(PRECISION="default"):
        xcj = orth["sj"].fromtensor(x).encrypt().tensor()
        xct = orth["st"].fromtensor(torch.from_numpy(x)).encrypt().tensor()
        _close(xcj, xct, TOL_FWD)
        yt = orth["knt"].forward(xct)
        yj = orth["knj"].forward(xcj)
    _close(yj, yt, TOL_FWD)
    assert torch.equal(yt, yh)


def test_cpu_wrappers_keep_f32_products_under_default():
    """On a CPU tensor every entry computes its plain version with f32
    products whatever the mode: under 'default' the results equal those
    under 'highest' bit for bit and differ from tf32=True."""
    rng = np.random.default_rng(3)
    tiles = torch.from_numpy(rng.standard_normal((6, 128, 128)).astype(np.float32))
    tiles[0] = 0
    ids = torch.from_numpy(rng.integers(0, 6, (9, 4)).astype(np.int32))
    ids[3:9] = ids[1:3].repeat(3, 1)
    cols = torch.from_numpy(rng.integers(0, 5, (9, 4)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((3, 5 * 128)).astype(np.float32))
    calls = [lambda: block_ell.block_ell_matmul_xresd(x, tiles, ids, cols, 9 * 128),
             lambda: block_ell.block_ell_matmul_xres2(x, tiles, ids, cols, 9 * 128),
             lambda: block_ell.periodic_block_ell_matvec(x, tiles, ids, cols, 1, 2, 4)]
    highest = [f() for f in calls]
    with _Globals(PRECISION="default"):
        default = [f() for f in calls]
    for h, d in zip(highest, default):
        assert torch.equal(h, d)
    t32 = block_ell.block_ell_plain(x, tiles, ids, cols, 9 * 128, tf32=True)
    assert float((t32 - highest[0]).abs().max()) > 1e-7
