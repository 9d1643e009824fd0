"""The stochastic recipe of scripts/run_vgg_stochastic_224.py (hierarchical
global permutation, doubly-stochastic local keys, local affine, blocksize
14, memoryorder 'channel') on a VGG-shaped prefix, the port against
keynet_tpu on the CPU.

The net is conv-conv-pool-conv-conv-pool at 3x56x56 with 16 and 32
channels, keyed at hierarchical levels (0, 1).  The size gates are lowered
identically in both packages (GATES, restored afterwards) so that the routes
the full VGG-16 takes at 224 are taken here: the dense-inverse split, masked
strip streaming with an F2 EllOp mask factor, periodic streamed cores,
channel-broadcast pools (one with an ELL spatial factor) and a core with a
grouped-row plan.  A single conv keyed on both sides with the full recipe
(as scripts/inspect_stoch_factors.py keys conv2_1) adds the F1 EllOp
factor, which no layer of the net has: every conv there is followed by a
ReLU, whose key is block-identical.

Both packages give the same route per layer, array-equal packed arrays
(tiles, tile_ids, col_blk, cols/vals, the factors, layouts, period), and
forwards within 1e-5*max(1, scale) of each other; the port's keyed forward
equals the source forward within the same tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import keynet_tpu as kj
import keynet_tpu_torch as kt
from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChannelBroadcastOp,
                                            PermutedBlockSparseOp)

TOL = 1e-5
SHAPE = (3, 56, 56)
RECIPE = dict(global_geometric="hierarchical_permutation", hierarchical_blockshape=(2, 2),
              hierarchical_permute_at_level=(0, 1), local_geometric="doubly_stochastic",
              alpha=2.0, blocksize=14, local_photometric="uniform_random_affine", beta=1.0,
              gamma=1.0, memoryorder="channel")
# the gates that decide the 224 routes, lowered to this net's size: every conv
# streams (STREAM_NNZ), conv2_x at 28x28 is past the Kron ranges so it
# streams as VGG's conv1_x/conv2_x do (KRON_NPIX_MAX, KRON_NPIX_WIDE), both
# pools take the channel-broadcast factor (POOL_FACTOR_MIN_N), pool1_2's
# spatial factor is past the dense budget and packs as ELL, as VGG's pool1_2
# and pool2_2 do at 224 (DENSE_MAX_BYTES; the sensor's key then packs as ELL
# too, where VGG's packs as Block-ELL), a non-periodic core of 197
# row-blocks gets its grouped-row plan (ROWGROUP_MIN_SLOT_BYTES)
GATES = {"STREAM_NNZ": 100_000, "POOL_FACTOR_MIN_N": 1, "ROWGROUP_MIN_SLOT_BYTES": 1 << 16,
         "KRON_NPIX_MAX": 512, "KRON_NPIX_WIDE": 1024, "MASK_DENSE_MAX_BYTES": 1 << 16,
         "DENSE_MAX_BYTES": 4 << 20}
ROUTES = {
    "sensor": "EllOp",
    "conv1_1": "Chain[RepeatedBlockDiagOp, EllOp, PermutedBlockSparseOp]",
    "conv1_2": "PermutedBlockSparseOp",
    "pool1_2": "ChannelBroadcastOp[EllOp]",
    "conv2_1": "Chain[RepeatedBlockDiagOp, PermutedBlockSparseOp]",
    "conv2_2": "PermutedBlockSparseOp",
    "pool2_2": "ChannelBroadcastOp[DenseOp]",
}


class _Gates:
    """GATES in both packages' GLOBAL, restored on exit."""

    def __enter__(self):
        self.saved = [(G, {k: G.get(k) for k in GATES})
                      for G in (kj.globals.GLOBAL, kt.globals.GLOBAL)]
        for G, _ in self.saved:
            G.update(GATES)

    def __exit__(self, *exc):
        for G, old in self.saved:
            for k, v in old.items():
                if v is None:
                    G.pop(k, None)
                else:
                    G[k] = v


def _prefix(m):
    """VGG-16's first two blocks at 3x56x56, channels cut 64 -> 16."""
    return m.Model([m.Conv2d("conv1_1", 3, 16, 3), m.ReLU("relu1_1"),
                    m.Conv2d("conv1_2", 16, 16, 3), m.ReLU("relu1_2"),
                    m.AvgPool2d("pool1_2", 3, 2),
                    m.Conv2d("conv2_1", 16, 32, 3), m.ReLU("relu2_1"),
                    m.Conv2d("conv2_2", 32, 32, 3), m.ReLU("relu2_2"),
                    m.AvgPool2d("pool2_2", 3, 2)], inshape=SHAPE, seed=5)


def route_kinds(op):
    """An op's link kinds, e.g. 'Chain[RepeatedBlockDiagOp, EllOp, ...]'."""
    if hasattr(op, "ops"):
        return "Chain[%s]" % ", ".join(route_kinds(o) for o in op.ops)
    if type(op).__name__ == "ChannelBroadcastOp":
        return "ChannelBroadcastOp[%s]" % route_kinds(op.inner)
    return type(op).__name__


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(a).max()))
    assert float(np.abs(a - b).max()) <= tol * scale


def _assert_same_op(oj, ot):
    """Same links, array-equal packed arrays, same periods and layouts."""
    assert route_kinds(oj) == route_kinds(ot)
    assert ot.shape == tuple(oj.shape) and ot.nnz() == oj.nnz()
    aj, at = oj.arrays(), ot.arrays()
    assert sorted(aj) == sorted(at)
    for k in aj:
        assert np.array_equal(np.asarray(aj[k]), at[k].numpy()), k
    for a, b in zip(getattr(oj, "ops", [oj]), getattr(ot, "ops", [ot])):
        if isinstance(b, PermutedBlockSparseOp):
            assert b.inner.period == a.inner.period
            assert (b.layout_in, b.layout_out) == (a.layout_in, a.layout_out)


def _cores(op):
    """The Block-ELL cores of an op."""
    out = []
    for link in getattr(op, "ops", [op]):
        if isinstance(link, ChannelBroadcastOp):
            link = link.inner
        if isinstance(link, PermutedBlockSparseOp):
            link = link.inner
        if isinstance(link, BlockSparseOp):
            out.append(link)
    return out


@pytest.fixture(scope="module")
def nets():
    with _Gates():
        nj, nt = _prefix(kj.models), _prefix(kt.models)
        sj, knj = kj.Keynet(SHAPE, nj, seed=0, **RECIPE)
        st, knt = kt.Keynet(SHAPE, nt, seed=0, device="cpu", **RECIPE)
    return dict(nj=nj, nt=nt, sj=sj, st=st, knj=knj, knt=knt)


def test_routes_equal(nets):
    """Both packages take the 224 routes, layer by layer."""
    for pkg, sensor in (("knj", "sj"), ("knt", "st")):
        got = {k: route_kinds(l.op()) for k, l in nets[pkg].layers().items() if l != "relu"}
        got["sensor"] = route_kinds(nets[sensor].op())
        assert got == ROUTES, pkg
    cores = {k: _cores(l.op()) for k, l in nets["knt"].layers().items() if l != "relu"}
    assert cores["conv1_1"][0].period is not None and cores["conv1_2"][0].period is not None
    assert any(c._rgroups is not None for cs in cores.values() for c in cs)


@pytest.mark.parametrize("layer", list(ROUTES))
def test_packed_arrays_equal(nets, layer):
    if layer == "sensor":
        oj, ot = nets["sj"].op(), nets["st"].op()
    else:
        oj, ot = nets["knj"].layers()[layer].op(), nets["knt"].layers()[layer].op()
    _assert_same_op(oj, ot)
    for cj, ct in zip(_cores(oj), _cores(ot)):
        assert ct.period == cj.period
        assert (ct._rgroups is None) == (cj._rgroups is None)
        if ct._rgroups is not None:
            assert ct._rgroup_meta == cj._rgroup_meta
            # the port's patterns are keynet_tpu's, bucket by bucket, and its
            # rows keynet_tpu's order inverted, their column blocks keynet_tpu's
            patterns, rows = (t.numpy() for t in ct._rgroups)
            assert np.array_equal(np.concatenate([np.asarray(p) for p, _ in cj._rgroups]),
                                  patterns)
            assert np.array_equal(np.asarray(cj._rgroup_inv)[rows], np.arange(len(rows)))
            assert np.array_equal(np.concatenate([np.asarray(c).reshape(-1, c.shape[-1])
                                                  for _, c in cj._rgroups]),
                                  ct.col_blk.numpy()[rows])


@pytest.mark.parametrize("B", [1, 8, 32])
def test_forward_matches_jax(nets, B):
    """The same image batch through both keyed nets: equal ciphers, the
    port's output within 1e-5*max(1, scale) of keynet_tpu's, and keyed ==
    source in the port (the grouped-row apply at every B on the CPU)."""
    x = np.random.default_rng(B).standard_normal((B, *SHAPE)).astype(np.float32)
    xcj = nets["sj"].fromtensor(x).encrypt().tensor()
    xct = nets["st"].fromtensor(torch.from_numpy(x)).encrypt().tensor()
    _close(xcj, xct)
    yj = nets["knj"].forward(xcj)
    yt = nets["knt"].forward(xct)
    _close(yj, yt)
    _close(nets["nt"].forward(torch.from_numpy(x)), yt)
    # the grouped-row core against its slot walk (the plain version here)
    core = next(c for l in nets["knt"].layers().values() if l != "relu"
                for c in _cores(l.op()) if c._rgroups is not None)
    TN = core.tileshape[1]
    xb = torch.from_numpy(np.random.default_rng(B + 1).standard_normal(
        (B, -(-core.shape[1] // TN) * TN)).astype(np.float32))
    grouped, = core.schedule(B, xb.device)
    assert grouped.kind == "grouped"
    _close(core.run_step(grouped._replace(kind="rows"), xb), core.run_step(grouped, xb))


@pytest.mark.parametrize("B", [1, 8, 32])
def test_f1_f2_layer_matches_jax(B):
    """A conv2_1-shaped layer keyed on both sides with the full recipe (the
    structure scripts/inspect_stoch_factors.py inspects): the chain
    RepeatedBlockDiag -> F2 EllOp -> masked streamed core -> F1 EllOp, equal
    in both packages, and the keyed sandwich A·W·A⁻¹ on the CPU."""
    inshape, outshape = (8, 28, 28), (16, 28, 28)
    rng = np.random.default_rng(0)
    params = {"weight": (rng.standard_normal((16, 8, 3, 3)) * 0.1).astype(np.float32),
              "bias": (rng.standard_normal(16) * 0.1).astype(np.float32)}
    _, Ainv = kt.keys.keygen(inshape, seed=1, **RECIPE)
    A, _ = kt.keys.keygen(outshape, seed=2, **RECIPE)
    with _Gates():
        lj = kj.layer.KeyedLayer(kj.models.specs.Conv2d("conv2_1", 8, 16, 3), inshape, outshape,
                                 A=A, Ainv=Ainv, params=params, rng=np.random.default_rng(7))
        lt = kt.layer.KeyedLayer(kt.models.specs.Conv2d("conv2_1", 8, 16, 3), inshape, outshape,
                                 A=A, Ainv=Ainv, params=params, rng=np.random.default_rng(7))
    assert route_kinds(lt.op()) \
        == "Chain[RepeatedBlockDiagOp, EllOp, PermutedBlockSparseOp, EllOp]"
    _assert_same_op(lj.op(), lt.op())
    x = np.random.default_rng(B).standard_normal((B, 8 * 28 * 28 + 1)).astype(np.float32)
    x[:, -1] = 1.0
    yt = lt.forward(torch.from_numpy(x))
    _close(lj.forward(jnp.asarray(x)), yt)
    W = kt.toeplitz.toeplitz_conv2d(inshape, params["weight"], bias=params["bias"])
    ref = (A.astype(np.float32) @ (W @ (Ainv.astype(np.float32) @ x.T))).T
    _close(ref, yt)
