"""The port's smaller modules against keynet_tpu on the CPU: visualize.spy
and KeyedLayer.spy, the fiber-bundle simulation and its keynet factory, the
three Tiled* factories, Block-ELL routing by tile shape (sub-128 tiles take
an einsum on the card), precision() on every keyed entry point, and the
version."""

import numpy as np
import pytest
import scipy.sparse
import torch

import keynet_tpu as kj
import keynet_tpu_torch as kt

TOL = 1e-5


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(1.0, float(np.abs(a).max()))


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


def _route(op):
    """Op kinds down the chain, with each Block-ELL core's tile shape."""
    if hasattr(op, "ops"):
        return [_route(o) for o in op.ops]
    if hasattr(op, "inner"):
        return [type(op).__name__, _route(op.inner)]
    if type(op).__name__ == "BlockSparseOp":
        return ["BlockSparseOp", list(op.tileshape), list(op.tile_ids.shape), op.period]
    return type(op).__name__


def _routes(sensor, knet):
    return [_route(sensor.op())] + [[k, _route(l.op())] for k, l in knet.layers().items()
                                    if l != "relu"]


# ------------------------------------------------------------------ spy

@pytest.mark.parametrize("case", ["dense", "downsampled", "window", "eps"])
def test_spy_equals_jax(case):
    A = scipy.sparse.random(600 if case != "dense" else 90, 700 if case != "dense" else 80,
                            density=0.02, random_state=3, format="csr", dtype=np.float32)
    kw = {"window": dict(rng=(10, 400)), "eps": dict(eps=0.5)}.get(case, {})
    a, b = kj.visualize.spy(A, **kw), kt.visualize.spy(A, **kw)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_keyed_layer_spy_equals_jax():
    """KeyedLayer.spy imports the port's visualize module (it raised
    ModuleNotFoundError before the module was ported)."""
    sj, knj = kj.PermutationKeynet((1, 28, 28), kj.models.LeNet_AvgPool(seed=0), seed=0)
    st, knt = kt.PermutationKeynet((1, 28, 28), kt.models.LeNet_AvgPool(seed=0), seed=0,
                                   device="cpu")
    for name in ("conv1", "pool1"):
        a, b = knj.layers()[name].spy(), knt.layers()[name].spy()
        assert b.dtype == np.uint8 and np.array_equal(a, b), name


# ------------------------------------------------------------ fiber bundle

@pytest.mark.parametrize("seed", [None, 1])
def test_fiberbundle_transform_equals_jax(seed):
    img = np.uint8(np.random.default_rng(0).random((28, 28, 3)) * 255)
    a = kj.fiberbundle.transform(img, outshape=(28, 28), seed=seed)
    b = kt.fiberbundle.transform(img, outshape=(28, 28), seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_fiberbundle_simulation_with_noise_equals_jax():
    img = np.uint8(np.random.default_rng(1).random((64, 48, 3)) * 255)
    a = kj.fiberbundle.simulation(img, do_camera_noise=True, seed=4)
    b = kt.fiberbundle.simulation(img, do_camera_noise=True, seed=4)
    assert np.array_equal(a, b)


def _scene(tmp_path):
    from PIL import Image
    img = Image.fromarray(np.uint8(np.random.default_rng(2).random((64, 64, 3)) * 255))
    p = str(tmp_path / "scene.png")
    img.save(p)
    return p


def test_optical_fiberbundle_keynet_cipher_equals_jax(tmp_path):
    """The factory as tests/test_fiberbundle_keynet.py:30-46 builds it: the
    same keys, simulated image and cipher in both packages."""
    p = _scene(tmp_path)
    sj, _ = kj.OpticalFiberBundleKeynet((3, 64, 64), None, seed=0,
                                        global_geometric="permutation")
    st, knt = kt.OpticalFiberBundleKeynet((3, 64, 64), None, seed=0, device="cpu",
                                          global_geometric="permutation")
    assert knt is None and isinstance(st, kt.OpticalFiberBundle)
    for a, b in zip(sj.keypair(), st.keypair()):
        assert (scipy.sparse.csr_matrix(a) != scipy.sparse.csr_matrix(b)).nnz == 0
    sj.load(p)
    st.load(p)
    assert st.image().shape == (64, 64, 3) and np.array_equal(sj.image(), st.image())
    cj = np.asarray(sj.encrypt().tensor())
    ct = st.encrypt().tensor()
    assert tuple(ct.shape) == (1, 3 * 64 * 64 + 1)
    _close(cj, ct)
    st.decrypt()
    _close(st.image().transpose(2, 0, 1)[None].astype(np.float32), st.tensor())


def test_optical_fiberbundle_keynet_with_net():
    """A keyed net behind the fiber-bundle sensor: the JAX package's forward
    and keyed == source."""
    def spec(m):
        return m.Model([m.Conv2d("conv1", 3, 4, 3), m.ReLU("relu1"),
                        m.Linear("fc1", 4 * 8 * 8, 5)], inshape=(3, 8, 8), seed=2)
    nj, nt = spec(kj.models), spec(kt.models)
    sj, knj = kj.OpticalFiberBundleKeynet((3, 8, 8), nj, seed=1,
                                          global_geometric="permutation")
    st, knt = kt.OpticalFiberBundleKeynet((3, 8, 8), nt, seed=1, device="cpu",
                                          global_geometric="permutation")
    x = np.random.default_rng(3).standard_normal((2, 3, 8, 8)).astype(np.float32)
    y = knt.forward(st.fromtensor(x).encrypt().tensor())
    _close(knj.forward(sj.fromtensor(x).encrypt().tensor()), y)
    _close(nt.forward(x), y)


# ------------------------------------------------------------ Tiled* factories

@pytest.mark.parametrize("factory", ["TiledIdentityKeynet", "TiledPermutationKeynet",
                                     "TiledOrthogonalKeynet"])
@pytest.mark.parametrize("dense_max", [None, 1 << 20])
def test_tiled_factories_match_jax(factory, dense_max):
    """LeNet_AvgPool at (1, 28, 28), tilesize 14 (snapped to 16): the routes
    of keynet_tpu, its forward, and keyed == source; with DENSE_MAX_BYTES at
    1 MiB conv2 packs as Block-ELL with 16x16 tiles."""
    keys = {} if dense_max is None else {"DENSE_MAX_BYTES": dense_max}
    with _Globals(**keys):
        nj, nt = kj.models.LeNet_AvgPool(seed=0), kt.models.LeNet_AvgPool(seed=0)
        sj, knj = getattr(kj, factory)((1, 28, 28), nj, tilesize=14, seed=0)
        st, knt = getattr(kt, factory)((1, 28, 28), nt, tilesize=14, seed=0, device="cpu")
    assert _routes(st, knt) == _routes(sj, knj)
    if dense_max and factory != "TiledIdentityKeynet":
        assert _route(knt.layers()["conv2"].op())[1][1] == [16, 16]
    x = np.random.default_rng(4).standard_normal((3, 1, 28, 28)).astype(np.float32)
    y = knt.forward(st.fromtensor(x).encrypt().tensor())
    _close(knj.forward(sj.fromtensor(x).encrypt().tensor()), y)
    _close(nt.forward(x), y)


# ------------------------------------------------------- routing by tile shape

@pytest.mark.parametrize("device,TM,TN,want", [
    ("cuda", 4, 4, "einsum"), ("cuda", 32, 32, "einsum"), ("cuda", 16, 16, "einsum"),
    ("cuda", 128, 64, "einsum"), ("cuda", 64, 128, "einsum"),
    ("cuda", 128, 128, "kernel"), ("cuda", 256, 128, "kernel"), ("cuda", 128, 512, "kernel"),
    ("cpu", 4, 4, "plain"), ("cpu", 128, 128, "plain"), ("meta", 128, 128, "kernel"),
    ("meta", 32, 32, "einsum")])
def test_block_ell_route(device, TM, TN, want):
    """Sub-128 tiles take the einsum on a CUDA device and never reach a
    kernel (whose wrappers refuse them), as keynet_tpu keeps them off its
    Pallas kernels: a core's schedule names an entry for its periodic step
    (B under the period's gate) and its slot walk only on the kernel side
    ("kernel"), and the plain versions elsewhere."""
    from keynet_tpu_torch.ops.operators import BlockSparseOp, Step
    tiles = torch.zeros((2, TM, TN))
    tiles[1] = 1.0
    op = BlockSparseOp(tiles, [[1], [1]], [[0], [1]], (2 * TM, 2 * TN), (TM, TN),
                       2 * TM * TN, period=(0, 1, 2))
    kernel = want == "kernel"
    assert op.schedule(1, device) == (
        Step("periodic", 0, 2, "periodic_block_ell_matvec" if kernel else None),)
    assert op.schedule(TM, device) == (
        Step("rows", 0, 2, "block_ell_matmul_xres2" if kernel else None),)


def _small_tile_spec(m):
    return m.Model([m.Conv2d("conv1", 3, 4, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 4, 4, 3), m.ReLU("relu2"),
                    m.AvgPool2d("pool2", 3, 2),
                    m.Linear("fc1", 4 * 16 * 16, 10)], inshape=(3, 32, 32), seed=1)


@pytest.mark.parametrize("t", [4, 32])
def test_keynet_sub128_tiles_match_jax(t):
    """Keynet(tileshape=(t, t)) keeps t x t Block-ELL tiles (conv2 at t = 32,
    conv1 and conv2 at t = 4): the JAX package's arrays and forward, and
    keyed == source."""
    with _Globals(DENSE_MAX_BYTES=1 << 16):
        nj, nt = _small_tile_spec(kj.models), _small_tile_spec(kt.models)
        kw = dict(tileshape=(t, t), blocksize=t, local_photometric="uniform_random_affine",
                  beta=1.0, gamma=1.0, seed=0)
        sj, knj = kj.Keynet((3, 32, 32), nj, **kw)
        st, knt = kt.Keynet((3, 32, 32), nt, device="cpu", **kw)
    assert _routes(st, knt) == _routes(sj, knj)
    core = knt.layers()["conv2"].op().inner
    assert core.tileshape == (t, t)
    for k in ("tiles", "tile_ids", "col_blk"):
        assert np.array_equal(np.asarray(knj.layers()["conv2"].op().inner.arrays()[k]),
                              core.arrays()[k].numpy())
    x = np.random.default_rng(5).standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = knt.forward(st.fromtensor(x).encrypt().tensor())
    _close(knj.forward(sj.fromtensor(x).encrypt().tensor()), y)
    _close(nt.forward(x), y)


# ------------------------------------------------------------- precision

@pytest.fixture(scope="module")
def identity_lenet():
    net = kt.models.LeNet_AvgPool(seed=0)
    sensor, knet = kt.IdentityKeynet((1, 28, 28), net, seed=0, device="cpu")
    return net, sensor, knet


@pytest.mark.parametrize("entry", ["run", "decrypt", "public_tensor", "layer_forward"])
def test_entry_point_sets_ieee_precision(entry, identity_lenet):
    """Each keyed entry point sets IEEE f32 itself: a process that calls it
    first must not run cuDNN convs in TF32 (torch's default)."""
    net, sensor, knet = identity_lenet
    x = np.random.default_rng(6).standard_normal((2, 1, 28, 28)).astype(np.float32)
    xc = torch.cat([torch.from_numpy(x).reshape(2, -1), torch.ones(2, 1)], dim=1)
    y = knet.run(xc)
    public = kt.PublicKeyedSensor((1, 28, 28), device="cpu").fromtensor(x)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    try:
        if entry == "run":
            knet.run(xc)
        elif entry == "decrypt":
            knet.decrypt(y, scipy.sparse.identity(y.shape[1], format="csr"))
        elif entry == "public_tensor":
            public.tensor()
        else:
            knet.layers()["conv1"].forward(xc)
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
        assert not torch.backends.cudnn.allow_tf32
    finally:
        kt.globals.precision()


def test_show_displays_the_image(monkeypatch, identity_lenet):
    from PIL import Image
    shown = []
    monkeypatch.setattr(Image.Image, "show", lambda im, *a, **k: shown.append(np.asarray(im)))
    _, sensor, _ = identity_lenet
    x = np.random.default_rng(7).standard_normal((1, 1, 28, 28)).astype(np.float32)
    assert sensor.fromtensor(x).show() is sensor
    assert len(shown) == 1 and np.array_equal(shown[0], sensor.asimage())


def test_version_equals_jax():
    assert kt.__version__ == kj.__version__
