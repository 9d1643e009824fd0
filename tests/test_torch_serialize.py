"""The port's save_keynet against keynet_tpu's on the CPU: for the same
seeded keyed net both packages write the same array names and dtypes,
bitwise-equal arrays and the same manifest; the port's bundle serves in
keynet_tpu.load_keynet and the JAX bundle in the port, forwards within
1e-5·max(1, scale) (1e-4 with bf16 tiles); and the port's own round trip is
bitwise.  Cases: PermutationKeynet LeNet_AvgPool (dense and ELL, with the
embedding key), a narrow StochasticKeynet AllConvNet-style spec (chain,
repblockdiag, permuted_block, kron, tapsum), bf16 tiles, a channel-broadcast
pool (tests/test_serialize.py:113-140), periodic Block-ELL cores, and
DirectConvOp."""

import json

import numpy as np
import pytest
import torch

import keynet_tpu as kj
import keynet_tpu_torch as kt

CASES = ["lenet_permutation", "stochastic_narrow", "bf16_tiles", "channel_broadcast",
         "periodic", "directconv"]


class _Globals:
    """Set GLOBAL keys in both packages, restored on exit."""

    def __init__(self, **keys):
        self.keys = keys

    def __enter__(self):
        self.saved = [(G, {k: G.get(k) for k in self.keys})
                      for G in (kj.globals.GLOBAL, kt.globals.GLOBAL)]
        for G, _ in self.saved:
            G.update(self.keys)

    def __exit__(self, *exc):
        for G, old in self.saved:
            for k, v in old.items():
                if v is None:
                    G.pop(k, None)
                else:
                    G[k] = v


GIVENS_BLOCK = dict(global_geometric="hierarchical_permutation",
                    hierarchical_blockshape=(2, 2), hierarchical_permute_at_level=(0,),
                    local_geometric="givens_orthogonal", alpha=2.0, blocksize=4,
                    local_photometric="uniform_random_affine", beta=1.0, gamma=1.0,
                    memoryorder="block", seed=0)
ORTH = dict(global_geometric="identity", local_geometric="givens_orthogonal",
            alpha=2.0, blocksize=14, local_photometric="uniform_random_affine",
            beta=1.0, gamma=1.0, memoryorder="channel", seed=0)


def _narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)


def _vgg_narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.AvgPool2d("pool2", 3, 2),
                    m.Conv2d("conv3", 8, 8, 3), m.ReLU("relu3"),
                    m.Linear("fc4", 8 * 28 * 28, 10)], inshape=(3, 56, 56), seed=5)


def _build(case, pkg):
    """(sensor, knet) of ``case`` in package ``pkg`` (kj or kt), with the
    op kinds the case is for."""
    dev = {} if pkg is kj else {"device": "cpu"}
    m = pkg.models
    if case == "lenet_permutation":
        return pkg.PermutationKeynet((1, 28, 28), m.LeNet_AvgPool(seed=1), seed=0,
                                     do_output_encryption=True, **dev)
    if case == "stochastic_narrow":
        with _Globals(DENSE_MAX_BYTES=1 << 20, ELL_MAX_K=32):
            return pkg.StochasticKeynet((3, 16, 16), _narrow(m), alpha=2, blocksize=8,
                                        seed=0, **dev)
    if case == "bf16_tiles":
        with _Globals(DENSE_MAX_BYTES=1 << 20, TILE_DTYPE="bfloat16"):
            return pkg.Keynet((1, 28, 28), m.LeNet_AvgPool(seed=1), **GIVENS_BLOCK, **dev)
    if case == "channel_broadcast":
        with _Globals(POOL_FACTOR_MIN_N=1):
            return pkg.TiledOrthogonalKeynet((1, 28, 28), m.LeNet_AvgPool(seed=1),
                                             tilesize=14, seed=0, **dev)
    if case == "periodic":
        with _Globals(STREAM_NNZ=1000, KRON_FACTORED="never", POOL_FACTOR_MIN_N=1):
            return pkg.Keynet((3, 56, 56), _vgg_narrow(m), **ORTH, **dev)
    return pkg.IdentityKeynet((1, 28, 28), m.LeNet_AvgPool(seed=1), seed=0, **dev)


def _kinds(op):
    if hasattr(op, "ops"):
        return set().union(*(_kinds(o) for o in op.ops))
    return {type(op).__name__} | (_kinds(op.inner) if hasattr(op, "inner") else set())


WANT = {"lenet_permutation": {"DenseOp", "EllOp"},
        "stochastic_narrow": {"ChainedOp", "RepeatedBlockDiagOp", "PermutedBlockSparseOp",
                              "KroneckerOp", "TapSumOp"},
        "bf16_tiles": {"PermutedBlockSparseOp"},
        "channel_broadcast": {"ChannelBroadcastOp"},
        "periodic": {"PermutedBlockSparseOp", "ChannelBroadcastOp"},
        "directconv": {"DirectConvOp"}}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """case -> dict: both packages' keyed nets, their bundles (saved with
    the sensor and keys), a seeded batch and the tolerance; built once per
    case."""
    cache = {}

    def get(case):
        if case not in cache:
            d = tmp_path_factory.mktemp(case)
            sj, knj = _build(case, kj)
            st, knt = _build(case, kt)
            kinds = set().union(*(_kinds(l.op()) | {type(l.op()).__name__}
                                  for l in knt.layers().values() if l != "relu"))
            assert WANT[case] <= kinds, (case, kinds)
            if case == "periodic":
                assert any(l != "relu" and hasattr(l.op(), "inner")
                           and getattr(l.op().inner, "period", None)
                           for l in knt.layers().values())
            pj, pt = str(d / "jax.npz"), str(d / "port.npz")
            kj.serialize.save_keynet(pj, knj, sensor=sj, include_keys=True)
            assert kt.save_keynet(pt, knt, sensor=st, include_keys=True) == pt
            inshape = {"stochastic_narrow": (3, 16, 16), "periodic": (3, 56, 56)}.get(
                case, (1, 28, 28))
            x = np.random.default_rng(2).standard_normal((3, *inshape)).astype(np.float32)
            cache[case] = dict(sj=sj, knj=knj, st=st, knt=knt, pj=pj, pt=pt, x=x,
                               tol=1e-4 if case == "bf16_tiles" else 1e-5)
        return cache[case]
    return get


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(1.0, float(np.abs(a).max()))


def _keyed(sensor, knet, x):
    return knet.forward(sensor.fromtensor(x).encrypt().tensor())


@pytest.mark.parametrize("case", CASES)
def test_save_matches_jax(case, bundles):
    """Same array names, dtypes and bits, and the same manifest."""
    b = bundles(case)
    with np.load(b["pj"]) as zj, np.load(b["pt"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            if k != "__manifest__":
                assert np.array_equal(zj[k], zt[k]), k
        mj = json.loads(bytes(zj["__manifest__"]).decode())
        mt = json.loads(bytes(zt["__manifest__"]).decode())
    assert mj == mt
    if case == "bf16_tiles":
        assert any(e.get("meta", {}).get("tile_dtype") == "bfloat16" for e in mt["layers"])


@pytest.mark.parametrize("case", CASES)
def test_port_bundle_serves_in_jax(case, bundles):
    b = bundles(case)
    sj2, knj2 = kj.serialize.load_keynet(b["pt"])
    _close(_keyed(sj2, knj2, b["x"]), _keyed(b["st"], b["knt"], b["x"]), b["tol"])


@pytest.mark.parametrize("case", CASES)
def test_jax_bundle_serves_in_port(case, bundles):
    b = bundles(case)
    st2, knt2 = kt.load_keynet(b["pj"], device="cpu")
    _close(_keyed(b["sj"], b["knj"], b["x"]), _keyed(st2, knt2, b["x"]), b["tol"])


@pytest.mark.parametrize("case", CASES)
def test_port_roundtrip_bitwise(case, bundles):
    """save_keynet then load_keynet in the port: the same cipher gives the
    same output, bit for bit, and the restored sensor keypair the same
    cipher (as tests/test_serialize.py:25-27 holds it); a public save holds
    no key."""
    b = bundles(case)
    xc = b["st"].fromtensor(b["x"]).encrypt().tensor()
    st2, knt2 = kt.load_keynet(b["pt"], device="cpu")
    assert torch.equal(b["knt"].forward(xc), knt2.forward(xc))
    _close(xc, st2.fromtensor(b["x"]).encrypt().tensor(), 1e-5)
    p = b["pt"].replace("port.npz", "public.npz")
    kt.save_keynet(p, b["knt"], include_keys=False)
    s3, knt3 = kt.load_keynet(p, device="cpu")
    assert s3 is None and knt3.imagekey() is None and knt3.embeddingkey() is None
    assert torch.equal(knt3.run(xc), b["knt"].run(xc))


@pytest.mark.parametrize("T,C2,C1", [(9, 3, 2), (4, 3, 1)])
def test_tapsum_chain_roundtrip(tmp_path, T, C2, C1):
    """save_keynet/load_keynet of a Kronecker-TapSum-Kronecker chain: the
    snapshot holds K as the (T, C2, C1) C-order array it was built from
    (also where the op's view of it is Fortran-ordered, C1 = 1), and the
    restored op gives back the same arrays and the same output, bitwise."""
    import zipfile
    from keynet_tpu_torch.layer import KeyedLayer
    from keynet_tpu_torch.ops import operators as O
    from keynet_tpu_torch.system import KeyedModel
    rng = np.random.default_rng(T * 10 + C1)
    p = 9
    K = rng.standard_normal((T, C2, C1)).astype(np.float32)
    S = rng.standard_normal((T, p, p)).astype(np.float32)
    b = rng.standard_normal(C2 * p).astype(np.float32)
    kron = [(rng.standard_normal((c, c)).astype(np.float32),
             rng.standard_normal((p, p)).astype(np.float32),
             rng.standard_normal(c * p).astype(np.float32)) for c in (C1, C2)]
    op = O.ChainedOp([O.KroneckerOp(*kron[0]), O.TapSumOp(K, S, b), O.KroneckerOp(*kron[1])])
    kl = KeyedLayer.__new__(KeyedLayer)
    kl._op, kl._relu, kl._repr, kl._layertype = op, False, "chain", "conv2d"
    kl._inshape = kl._outshape = kl._tileshape = kl.W = None
    kl.shape, kl._nnz = op.shape, op.nnz()
    path = str(tmp_path / "tapsum.npz")
    kt.save_keynet(path, KeyedModel.from_layers({"conv": kl}, (C2, 3, 3), device="cpu"))
    with zipfile.ZipFile(path) as zf, zf.open("layer_conv__c1_K.npy") as f:
        assert np.lib.format.read_magic(f) == (1, 0)
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        assert (shape, fortran, dtype) == ((T, C2, C1), False, np.float32)
        assert f.read() == K.tobytes()
    _, kn2 = kt.load_keynet(path, device="cpu")
    op2 = kn2.layers()["conv"].op()
    ts = op2.ops[1]
    assert isinstance(ts, O.TapSumOp)
    for got, want in ((ts.K, K), (ts.S, S), (ts.bias, b)):
        assert torch.equal(got, torch.from_numpy(want))
    x = torch.from_numpy(rng.standard_normal((3, op.shape[1])).astype(np.float32))
    assert torch.equal(op2.apply(x), op.apply(x))
