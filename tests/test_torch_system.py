"""The port end to end against keynet_tpu on the CPU: same routes, equal
packed arrays, the JAX package's forward within 1e-5 * max(1, scale), and
keyed == source, for a narrow StochasticKeynet spec, a JAX-saved bundle,
PermutationKeynet LeNet_AvgPool and the full-width AllConvNet."""

import numpy as np
import pytest
import torch

import keynet_tpu as kj
import keynet_tpu_torch as kt

TOL = 1e-5


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(a).max()))
    assert float(np.abs(a - b).max()) <= tol * scale


def _narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)


class _SmallGlobals:
    """DENSE_MAX_BYTES=1 MiB and ELL_MAX_K=32 in both packages, restored on exit."""
    KEYS = {"DENSE_MAX_BYTES": 1 << 20, "ELL_MAX_K": 32}

    def __enter__(self):
        self.saved = [(G, {k: G.get(k) for k in self.KEYS})
                      for G in (kj.globals.GLOBAL, kt.globals.GLOBAL)]
        for G, _ in self.saved:
            G.update(self.KEYS)

    def __exit__(self, *exc):
        for G, old in self.saved:
            for k, v in old.items():
                if v is None:
                    G.pop(k, None)
                else:
                    G[k] = v


def _keyed(sensor, knet, x):
    return knet.forward(sensor.fromtensor(x).encrypt().tensor())


@pytest.fixture(scope="module")
def narrow():
    with _SmallGlobals():
        nj, nt = _narrow(kj.models), _narrow(kt.models)
        sj, knj = kj.StochasticKeynet((3, 16, 16), nj, alpha=2, blocksize=8, seed=0)
        st, knt = kt.StochasticKeynet((3, 16, 16), nt, alpha=2, blocksize=8, seed=0,
                                      device="cpu")
    x = np.random.default_rng(0).standard_normal((4, 3, 16, 16)).astype(np.float32)
    return dict(nj=nj, nt=nt, sj=sj, st=st, knj=knj, knt=knt, x=x)


def _route(op):
    names = [type(o).__name__ for o in getattr(op, "ops", [op])]
    return names


def test_narrow_routes(narrow):
    want = {"conv1": ["RepeatedBlockDiagOp", "PermutedBlockSparseOp"],
            "conv2": ["KroneckerOp", "TapSumOp", "KroneckerOp"], "fc1": ["DenseOp"]}
    for pkg in ("knj", "knt"):
        layers = narrow[pkg].layers()
        got = {k: _route(l.op()) for k, l in layers.items() if l != "relu"}
        assert got == want, pkg
    core = narrow["knt"].layers()["conv1"].op().ops[1].inner
    assert tuple(core.tile_ids.shape) == (17, 7)
    from keynet_tpu_torch.ops import block_ell
    assert block_ell.route(core.tile_ids.shape[1]) is block_ell.block_ell_matmul_xres2


def test_narrow_packed_arrays_equal(narrow):
    for name in ("conv1", "conv2", "fc1"):
        aj = narrow["knj"].layers()[name].op().arrays()
        at = narrow["knt"].layers()[name].op().arrays()
        assert sorted(aj) == sorted(at), name
        for k in aj:
            assert np.array_equal(np.asarray(aj[k]), at[k].numpy()), (name, k)


def test_narrow_sensor_cipher_equal(narrow):
    x = narrow["x"]
    cj = narrow["sj"].fromtensor(x).encrypt().tensor()
    ct = narrow["st"].fromtensor(x).encrypt().tensor()
    _close(cj, ct)


def test_narrow_forward_matches_jax(narrow):
    x = narrow["x"]
    _close(_keyed(narrow["sj"], narrow["knj"], x), _keyed(narrow["st"], narrow["knt"], x))


def test_narrow_keyed_equals_source(narrow):
    x = narrow["x"]
    _close(narrow["nt"].forward(x), _keyed(narrow["st"], narrow["knt"], x))


def test_narrow_decrypt_roundtrip(narrow):
    x = narrow["x"]
    back = narrow["st"].fromtensor(x).encrypt().decrypt().tensor()
    _close(x, back)


@pytest.mark.parametrize("which", ["narrow", "lenet_bf16", "vgg_narrow"])
def test_load_jax_bundle(which, narrow, vgg_narrow, tmp_path):
    """A bundle that keynet_tpu converted and saved serves in the port with
    the JAX package's forward (periodic Block-ELL cores and a
    channel-broadcast pool in the VGG-shaped one)."""
    p = str(tmp_path / "k.npz")
    if which == "vgg_narrow":
        sj, knj, x = vgg_narrow["sj"], vgg_narrow["knj"], vgg_narrow["x"]
        tol = TOL
        kj.serialize.save_keynet(p, knj, sensor=sj, include_keys=True)
    elif which == "narrow":
        sj, knj, x = narrow["sj"], narrow["knj"], narrow["x"]
        tol = TOL
        kj.serialize.save_keynet(p, knj, sensor=sj, include_keys=True)
    else:
        net = kj.models.LeNet_AvgPool(seed=0)
        kj.globals.GLOBAL["TILE_DTYPE"] = "bfloat16"
        try:
            sj, knj = kj.PermutationKeynet((1, 28, 28), net, seed=0)
        finally:
            kj.globals.GLOBAL["TILE_DTYPE"] = "float32"
        x = np.random.default_rng(1).standard_normal((3, 1, 28, 28)).astype(np.float32)
        tol = 1e-4
        kj.serialize.save_keynet(p, knj, sensor=sj, include_keys=True)
    st, knt = kt.load_keynet(p, device="cpu")
    assert list(knt.layers()) == list(knj.layers())
    if which == "vgg_narrow":
        assert type(knt.layers()["pool2"].op()).__name__ == "ChannelBroadcastOp"
        assert knt.layers()["conv1"].op().inner.period \
            == knj.layers()["conv1"].op().inner.period
    _close(_keyed(sj, knj, x), _keyed(st, knt, x), tol=tol)


@pytest.fixture(scope="module")
def lenet():
    nj, nt = kj.models.LeNet_AvgPool(seed=0), kt.models.LeNet_AvgPool(seed=0)
    sj, knj = kj.PermutationKeynet((1, 28, 28), nj, seed=0)
    st, knt = kt.PermutationKeynet((1, 28, 28), nt, seed=0, device="cpu")
    x = np.random.default_rng(2).standard_normal((5, 1, 28, 28)).astype(np.float32)
    return dict(nt=nt, sj=sj, st=st, knj=knj, knt=knt, x=x)


def test_lenet_permutation_nnz(lenet):
    assert lenet["knt"].num_parameters() == 323491 == lenet["knj"].num_parameters()
    assert [type(l.op()).__name__ for l in lenet["knt"].layers().values() if l != "relu"] \
        == ["DenseOp", "EllOp", "DenseOp", "EllOp", "DenseOp", "DenseOp", "DenseOp"]


def test_lenet_permutation_forward(lenet):
    x = lenet["x"]
    y = _keyed(lenet["st"], lenet["knt"], x)
    _close(_keyed(lenet["sj"], lenet["knj"], x), y)
    _close(lenet["nt"].forward(x), y)


def test_batchnorm_keyed_relu_path():
    """conv + conv_bn + relu: batchnorm fusion and the explicitly keyed ReLU."""
    def spec(m):
        return m.Model([m.Conv2d("conv1", 2, 4, 3), m.BatchNorm2d("conv1_bn", 4),
                        m.ReLU("relu1"), m.Dropout("drop", 0.5),
                        m.Linear("fc", 4 * 8 * 8, 5)], inshape=(2, 8, 8), seed=3)
    nj, nt = spec(kj.models), spec(kt.models)
    sj, knj = kj.PermutationKeynet((2, 8, 8), nj, seed=1)
    st, knt = kt.PermutationKeynet((2, 8, 8), nt, seed=1, device="cpu")
    x = np.random.default_rng(4).standard_normal((3, 2, 8, 8)).astype(np.float32)
    y = _keyed(st, knt, x)
    _close(_keyed(sj, knj, x), y)
    _close(nt.forward(x), y)


@pytest.mark.parametrize("name", ["LeNet", "LeNet_AvgPool", "AllConvNet_bn", "VGG16"])
def test_source_forward_matches_jax(name):
    if name == "AllConvNet_bn":
        nj, nt = (kj.models.AllConvNet(batchnorm=True, seed=2),
                  kt.models.AllConvNet(batchnorm=True, seed=2))
    else:
        nj, nt = getattr(kj.models, name)(seed=2), getattr(kt.models, name)(seed=2)
    B = 1 if name == "VGG16" else 2       # VGG16: one 3x224x224 image
    x = np.random.default_rng(5).standard_normal((B, *nj.inshape)).astype(np.float32)
    _close(nj.forward(x), nt.forward(x))


def test_allconvnet_full_width_parity():
    """bench.py's second configuration at full width, B=2: same routes, same
    conv1 Block-ELL arrays, the JAX forward, and keyed == source."""
    nj, nt = kj.models.AllConvNet(seed=1), kt.models.AllConvNet(seed=1)
    sj, knj = kj.StochasticKeynet((3, 32, 32), nj, alpha=2, blocksize=8, seed=0)
    st, knt = kt.StochasticKeynet((3, 32, 32), nt, alpha=2, blocksize=8, seed=0,
                                  device="cpu")
    assert [_route(l.op()) for l in knt.layers().values() if l != "relu"] \
        == [_route(l.op()) for l in knj.layers().values() if l != "relu"]
    cj = knj.layers()["conv1"].op().ops[1].inner
    ct = knt.layers()["conv1"].op().ops[1].inner
    assert tuple(ct.tile_ids.shape) == (769, 16) and ct.tiles.shape[0] == 2981
    assert ct.period is None and ct._rgroups is None
    for k in ("tiles", "tile_ids", "col_blk"):
        assert np.array_equal(np.asarray(cj.arrays()[k]), ct.arrays()[k].numpy()), k
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    y = _keyed(st, knt, x)
    _close(_keyed(sj, knj, x), y)
    _close(nt.forward(x), y)


class _VggGlobals(_SmallGlobals):
    """Strip streaming for every conv (STREAM_NNZ), no Kronecker chains and
    channel-broadcast pools at any size, in both packages."""
    KEYS = {"STREAM_NNZ": 1000, "KRON_FACTORED": "never", "POOL_FACTOR_MIN_N": 1}


def _vgg_narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.AvgPool2d("pool2", 3, 2),
                    m.Conv2d("conv3", 8, 8, 3), m.ReLU("relu3"),
                    m.Linear("fc4", 8 * 28 * 28, 10)], inshape=(3, 56, 56), seed=5)


ORTH = dict(global_geometric="identity", local_geometric="givens_orthogonal",
            alpha=2.0, blocksize=14, local_photometric="uniform_random_affine",
            beta=1.0, gamma=1.0, memoryorder="channel", seed=0)


@pytest.fixture(scope="module")
def vgg_narrow():
    """The Givens-orthogonal VGG recipe on a narrow VGG-shaped net at
    3x56x56: its convs stream into periodic Block-ELL cores and its pool
    takes the channel-broadcast route."""
    with _VggGlobals():
        nj, nt = _vgg_narrow(kj.models), _vgg_narrow(kt.models)
        sj, knj = kj.Keynet((3, 56, 56), nj, **ORTH)
        st, knt = kt.Keynet((3, 56, 56), nt, device="cpu", **ORTH)
    x = np.random.default_rng(3).standard_normal((3, 3, 56, 56)).astype(np.float32)
    return dict(nj=nj, nt=nt, sj=sj, st=st, knj=knj, knt=knt, x=x)


def test_vgg_narrow_routes_and_arrays(vgg_narrow):
    from keynet_tpu_torch.ops.operators import PermutedBlockSparseOp
    lj, lt = vgg_narrow["knj"].layers(), vgg_narrow["knt"].layers()
    assert list(lj) == list(lt)
    routes = {k: _route(l.op()) for k, l in lt.items() if l != "relu"}
    assert routes == {k: _route(l.op()) for k, l in lj.items() if l != "relu"}
    assert routes["pool2"] == ["ChannelBroadcastOp"]
    assert all(routes[c] == ["PermutedBlockSparseOp"] for c in ("conv1", "conv2", "conv3"))
    assert vgg_narrow["knt"].num_parameters() == vgg_narrow["knj"].num_parameters()
    for k, l in lt.items():
        if l == "relu":
            continue
        assert l.nnz() == lj[k].nnz(), k
        aj, at = lj[k].op().arrays(), l.op().arrays()
        assert sorted(aj) == sorted(at), k
        for a in aj:
            assert np.array_equal(np.asarray(aj[a]), at[a].numpy()), (k, a)
        if isinstance(l.op(), PermutedBlockSparseOp):
            assert l.op().inner.period == lj[k].op().inner.period, k
    B = vgg_narrow["x"].shape[0]
    periodic = [lt[c].op().inner.period for c in ("conv1", "conv2", "conv3")]
    assert any(p is not None and B <= (p[2] - 1) * 128 // p[2] for p in periodic)


def test_vgg_narrow_forward_matches_jax_and_source(vgg_narrow):
    x = vgg_narrow["x"]
    y = _keyed(vgg_narrow["st"], vgg_narrow["knt"], x)
    _close(_keyed(vgg_narrow["sj"], vgg_narrow["knj"], x), y)
    _close(vgg_narrow["nt"].forward(x), y)
