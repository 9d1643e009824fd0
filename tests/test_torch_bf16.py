"""bf16 tiles (GLOBAL['TILE_DTYPE'] = 'bfloat16', keynet_tpu's serving
mode, keynet_tpu/globals.py:29-32), the port against keynet_tpu on the CPU,
with the key set in both packages and restored after.

(a) The Givens-orthogonal VGG recipe of scripts/run_vgg_orth_224.py on a
narrow VGG-shaped net at 3x56x56 (periodic streamed cores, a
channel-broadcast pool, a non-periodic core): equal routes, equal tile_ids
and col_blk, tiles equal as bf16, each Block-ELL core fed the same
bf16-rounded input within 1e-4*max(1, scale) of keynet_tpu's, and the
keyed forward within 1e-3*max(1, scale) of keynet_tpu's at B = 1, 8, 32
(the bf16 tier: one rounding flip of an activation between layers is 2^-8
relative) and within the JAX script's 3e-2*max(1, scale) of the source.

(b) The stochastic recipe at 3x56x56 with the size gates of
test_torch_vgg_stochastic.py: the same routes as keynet_tpu's, and the gates
that read the tile itemsize (the grouped-row plan's slot bytes,
the schedule's grouped step, the periodic expansion) decide as keynet_tpu's do; chip_smoke's
STOCH_ROUTES_BF16 rests on them.  The forward within 1e-3*max(1, scale).

(c) launch_plan for bf16 tiles, which run the slot walk and the periodic
kernel on the tensor cores (csrc/block_ell_wgmma.cuh): two warpgroups at
every row tile, a ring of 1024-byte-aligned swizzled stages after 1024
bytes of slack, no k-group fold; the f32 plans as they were."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import keynet_tpu as kj
import keynet_tpu_torch as kt
from keynet_tpu_torch.ops import block_ell
from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChannelBroadcastOp,
                                            PermutedBlockSparseOp)
from test_torch_vgg_stochastic import GATES, RECIPE, ROUTES, SHAPE, _prefix, route_kinds

TOL_CORE, TOL_FWD, TOL_SRC = 1e-4, 1e-3, 3e-2
ORTH = dict(global_geometric="identity", local_geometric="givens_orthogonal",
            alpha=2.0, blocksize=14, local_photometric="uniform_random_affine",
            beta=1.0, gamma=1.0, memoryorder="channel", seed=0)
# every conv streams into a periodic core (STREAM_NNZ), no Kronecker chain,
# the pool takes the channel-broadcast route, as in test_torch_system.py
ORTH_GATES = {"DENSE_MAX_BYTES": 1 << 20, "ELL_MAX_K": 32, "STREAM_NNZ": 1000,
              "KRON_FACTORED": "never", "POOL_FACTOR_MIN_N": 1}


class _Globals:
    """``keys`` in both packages' GLOBAL, restored on exit, and the port's
    torch TF32 flags from PRECISION on entry and exit."""

    def __init__(self, keys=(), **more):
        self.keys = dict(keys, **more)

    def __enter__(self):
        self.saved = [(G, {k: G.get(k) for k in self.keys})
                      for G in (kj.globals.GLOBAL, kt.globals.GLOBAL)]
        for G, _ in self.saved:
            G.update(self.keys)
        kt.globals.precision()

    def __exit__(self, *exc):
        for G, old in self.saved:
            for k, v in old.items():
                if v is None:
                    G.pop(k, None)
                else:
                    G[k] = v
        kt.globals.precision()


def _close(a, b, tol):
    a = np.asarray(a, dtype=np.float32)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(a).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, tol * scale)


def _cores(op):
    """(link index, Block-ELL core) of each core of an op."""
    out = []
    for i, link in enumerate(getattr(op, "ops", [op])):
        if isinstance(link, ChannelBroadcastOp):
            link = link.inner
        if isinstance(link, PermutedBlockSparseOp):
            link = link.inner
        if isinstance(link, BlockSparseOp):
            out.append((i, link))
    return out


def _jax_cores(op):
    out = []
    for i, link in enumerate(getattr(op, "ops", [op])):
        link = getattr(link, "inner", link)
        link = getattr(link, "inner", link)
        if type(link).__name__ == "BlockSparseOp":
            out.append((i, link))
    return out


def _bf16_bits(t):
    """The uint16 bit patterns of a bf16 tensor or array."""
    if torch.is_tensor(t):
        assert t.dtype == torch.bfloat16
        return t.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(t)
    assert str(a.dtype) == "bfloat16"
    return a.view(np.uint16)


def _vgg_narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.AvgPool2d("pool2", 3, 2),
                    m.Conv2d("conv3", 8, 8, 3), m.ReLU("relu3"),
                    m.Linear("fc4", 8 * 28 * 28, 10)], inshape=(3, 56, 56), seed=5)


@pytest.fixture(scope="module")
def orth():
    with _Globals(ORTH_GATES, TILE_DTYPE="bfloat16"):
        nj, nt = _vgg_narrow(kj.models), _vgg_narrow(kt.models)
        sj, knj = kj.Keynet((3, 56, 56), nj, **ORTH)
        st, knt = kt.Keynet((3, 56, 56), nt, device="cpu", **ORTH)
    return dict(nt=nt, sj=sj, st=st, knj=knj, knt=knt)


def _layer_ops(net, sensor):
    ops = {k: l.op() for k, l in net.layers().items() if l != "relu"}
    ops["sensor"] = sensor.op()
    return ops


def test_orth_routes_equal(orth):
    """Both packages route every layer alike in bf16; the convs are
    Block-ELL cores with bf16 tiles, periodic where keynet_tpu's are."""
    oj, ot = _layer_ops(orth["knj"], orth["sj"]), _layer_ops(orth["knt"], orth["st"])
    assert {k: route_kinds(o) for k, o in ot.items()} == {k: route_kinds(o) for k, o in oj.items()}
    cores = {k: _cores(o) for k, o in ot.items()}
    assert all(cores[c] for c in ("conv1", "conv2", "conv3"))
    assert any(c.period is not None for cs in cores.values() for _, c in cs)
    for k, o in oj.items():
        for (_, cj), (_, ct) in zip(_jax_cores(o), cores[k]):
            assert ct.tiles.dtype == torch.bfloat16 and ct.period == cj.period, k


@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv3"])
def test_orth_packed_arrays_equal(orth, layer):
    """tile_ids and col_blk equal, tiles equal bit for bit as bf16."""
    cj = _jax_cores(orth["knj"].layers()[layer].op())
    ct = _cores(orth["knt"].layers()[layer].op())
    assert len(cj) == len(ct) == 1
    cj, ct = cj[0][1], ct[0][1]
    assert np.array_equal(np.asarray(cj.tile_ids), ct.tile_ids.numpy())
    assert np.array_equal(np.asarray(cj.col_blk), ct.col_blk.numpy())
    assert np.array_equal(_bf16_bits(cj.tiles), _bf16_bits(ct.tiles))


@pytest.mark.parametrize("B", [1, 8, 32, 130])
def test_orth_cores_match_jax(orth, B):
    """Each Block-ELL core fed the same bf16-rounded input in both packages
    (B = 1, 8, 32 take the periodic apply, 130 the slot walk of every row),
    within 1e-4*max(1, scale): bf16 products are exact in f32, so only the
    sum order differs."""
    rng = np.random.default_rng(B)
    n = 0
    for layer in ("conv1", "conv2", "conv3"):
        (_, cj), = _jax_cores(orth["knj"].layers()[layer].op())
        (_, ct), = _cores(orth["knt"].layers()[layer].op())
        x = torch.from_numpy(rng.standard_normal((B, ct.shape[1])).astype(np.float32))
        x = x.to(torch.bfloat16).float()
        yj = cj.apply(jnp.asarray(x.numpy()))
        yt = ct.apply(x)
        assert yt.dtype == torch.float32
        _close(yj, yt, TOL_CORE)
        n += 1
    assert n == 3


@pytest.mark.parametrize("B", [1, 8, 32])
def test_orth_forward_matches_jax(orth, B):
    """The keyed forward in bf16: within 1e-3*max(1, scale) of keynet_tpu's
    and within 3e-2*max(1, scale) of the source forward."""
    x = np.random.default_rng(100 + B).standard_normal((B, 3, 56, 56)).astype(np.float32)
    xcj = orth["sj"].fromtensor(x).encrypt().tensor()
    xct = orth["st"].fromtensor(torch.from_numpy(x)).encrypt().tensor()
    _close(xcj, xct, TOL_FWD)
    yt = orth["knt"].forward(xct)
    _close(orth["knj"].forward(xcj), yt, TOL_FWD)
    _close(orth["nt"].forward(torch.from_numpy(x)), yt, TOL_SRC)


# ------------------------------------------------------------------ (b)

@pytest.fixture(scope="module")
def stoch():
    with _Globals(GATES, TILE_DTYPE="bfloat16"):
        nj, nt = _prefix(kj.models), _prefix(kt.models)
        sj, knj = kj.Keynet(SHAPE, nj, seed=0, **RECIPE)
        st, knt = kt.Keynet(SHAPE, nt, seed=0, device="cpu", **RECIPE)
    return dict(nt=nt, sj=sj, st=st, knj=knj, knt=knt)


def test_stochastic_routes_and_gates_equal(stoch):
    """The stochastic recipe in bf16 routes as in f32 (ROUTES) in both
    packages, and each core's itemsize gates decide alike: a grouped-row plan
    or none (ROWGROUP_MIN_SLOT_BYTES), the grouped step of the schedule on
    the CPU against keynet_tpu's _grouped_wins at B = 1, 8, 32, 1024,
    and the periodic expansion (_Texp within PERIODIC_EXPAND_BYTES)."""
    oj, ot = _layer_ops(stoch["knj"], stoch["sj"]), _layer_ops(stoch["knt"], stoch["st"])
    assert {k: route_kinds(o) for k, o in oj.items()} == ROUTES
    assert {k: route_kinds(o) for k, o in ot.items()} == ROUTES
    grouped = 0
    for k, o in oj.items():
        cjs, cts = _jax_cores(o), _cores(ot[k])
        assert [i for i, _ in cjs] == [i for i, _ in cts], k
        for (_, cj), (_, ct) in zip(cjs, cts):
            assert ct.tiles.dtype == torch.bfloat16, k
            assert (ct._rgroups is None) == (cj._rgroups is None), k
            assert (ct._Texp is None) == (cj._Texp is None), k
            if ct._rgroups is not None:
                grouped += 1
                assert ct._rgroup_meta == cj._rgroup_meta
                for B in (1, 8, 32, 1024):
                    steps = ct.schedule(B, torch.device("cpu"))
                    assert (steps[0].kind == "grouped") == cj._grouped_wins(B), (k, B)
    assert grouped


@pytest.mark.parametrize("B", [1, 8, 32])
def test_stochastic_forward_matches_jax(stoch, B):
    x = np.random.default_rng(400 + B).standard_normal((B, *SHAPE)).astype(np.float32)
    xcj = stoch["sj"].fromtensor(x).encrypt().tensor()
    xct = stoch["st"].fromtensor(torch.from_numpy(x)).encrypt().tensor()
    yt = stoch["knt"].forward(xct)
    _close(stoch["knj"].forward(xcj), yt, TOL_FWD)
    _close(stoch["nt"].forward(torch.from_numpy(x)), yt, TOL_SRC)


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("kernel", ["slot_walk", "periodic"])
@pytest.mark.parametrize("BT", sorted(block_ell.TILE_THREADS))
def test_launch_plan_bf16_tensor_cores(BT, kernel):
    """bf16: WGMMA_THREADS threads at every row tile; shared memory 1024
    bytes of slack + STAGES stages of (BT + 128) swizzled rows of 128 bytes,
    each stage a multiple of 1024 bytes (wgmma's swizzled panels stay
    aligned), + the periodic kernel's 16·BT bytes of row offsets; no fold.
    f32 plans keep their threads and their FMA-core rings (the periodic
    kernel's on TMA)."""
    per = 16 * BT if kernel == "periodic" else 0
    for TN in (128, 256):
        plan = block_ell.launch_plan(BT, 5 * 128, 128, TN, torch.bfloat16, kernel)
        assert plan["BT"] == BT and plan["threads"] == block_ell.WGMMA_THREADS == 256
        assert (BT + 128) * 128 % 1024 == 0
        assert plan["smem"] == 1024 + block_ell.STAGES * (BT + 128) * 128 + per <= 232448
        f32 = block_ell.launch_plan(BT, 5 * 128, 128, TN, torch.float32, kernel)
        group = 16 * (BT // 8)
        fold = (block_ell.TILE_THREADS[BT] // group - 1) * group * 64 * 4
        assert f32["threads"] == block_ell.TILE_THREADS[BT]
        if kernel == "periodic":    # its f32 TMA ring (test_torch_periodic.py)
            S = block_ell.PERIODIC_STAGES[BT]
            assert f32["smem"] == 1024 + S * ((BT + 128) * 128 + 16)
        else:
            assert f32["smem"] == max(block_ell.STAGES * (BT + 128) * 144, fold)
        assert f32["grid"] == plan["grid"]
