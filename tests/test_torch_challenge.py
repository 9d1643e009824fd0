"""keynet_tpu_torch.challenge against keynet_tpu.challenge on an artifact
in the 2020 release's pickle format (tests/legacy_challenge.py), built
from a PermutationKeynet LeNet_AvgPool: both loaders give the same layers
and nnz, and public forwards equal to each other and to the host scipy
oracle of tests/test_challenge.py within 1e-5·max(1, scale)."""

import numpy as np
import pytest

import keynet_tpu as kj
import keynet_tpu_torch as kt
import legacy_challenge


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(1.0, float(np.abs(a).max()))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(path, layers, cipher batch): the legacy pickle of a public
    PermutationKeynet LeNet_AvgPool(seed=0) and a seeded cipher batch."""
    net = kt.models.LeNet_AvgPool(seed=0)
    sensor, knet = kt.PermutationKeynet((1, 28, 28), net, seed=0, device="cpu")
    layers = legacy_challenge.layers_of(knet)
    path = str(tmp_path_factory.mktemp("challenge") / "keynet_challenge_lenet.pkl")
    legacy_challenge.write(path, (1, 28, 28), layers)
    x = np.random.default_rng(0).standard_normal((4, 1, 28, 28)).astype(np.float32)
    xc = sensor.fromtensor(x).encrypt().tensor().numpy()
    return path, layers, xc


@pytest.fixture(scope="module")
def loaded(artifact):
    path = artifact[0]
    return kj.challenge.load_challenge(path), kt.challenge.load_challenge(path, device="cpu")


def test_legacy_class_map_equals_jax():
    assert set(kt.challenge._LEGACY) == set(kj.challenge._LEGACY)
    for key, cls in kj.challenge._LEGACY.items():
        assert kt.challenge._LEGACY[key].__name__ == cls.__name__


def test_layers_and_nnz_equal_jax(artifact, loaded):
    _, layers, _ = artifact
    (_, kjnet), (_, ktnet) = loaded
    assert list(ktnet.layers()) == list(kjnet.layers()) == [n for n, _, _ in layers]
    for (name, W, relu), lt, lj in zip(layers, ktnet.layers().values(),
                                       kjnet.layers().values()):
        if W is None:
            assert lt == lj == "relu"
            continue
        assert lt.nnz() == lj.nnz() == W.nnz
        assert lt._relu == lj._relu == relu
    assert ktnet.num_parameters() == kjnet.num_parameters() == 323491
    assert ktnet.imagekey() is None and ktnet.embeddingkey() is None


def test_sensor_inshape(loaded):
    (sj, _), (st, _) = loaded
    assert st._inshape == sj._inshape == (1, 1, 28, 28)


def test_public_forward_equals_jax_and_oracle(artifact, loaded):
    _, layers, xc = artifact
    (_, kjnet), (_, ktnet) = loaded
    want = legacy_challenge.oracle(layers, xc)
    y_t = ktnet.forward(xc).numpy()
    _close(want, y_t)
    _close(want, np.asarray(kjnet.forward(xc)))
    _close(np.asarray(kjnet.forward(xc)), y_t)


def test_extract_csr_equals_jax(artifact):
    """_extract_csr on a shim and on a bare scipy matrix, as keynet_tpu's."""
    path, layers, _ = artifact
    with open(path, "rb") as f:
        _, model = kt.challenge._LegacyUnpickler(f).load()
    for name, child in model.__dict__["_keynet"]._modules.items():
        if isinstance(child, kt.challenge._ShimKeyedLayer):
            W = kt.challenge._extract_csr(child.__dict__["W"])
            Wj = kj.challenge._extract_csr(child.__dict__["W"])
            assert W.dtype == Wj.dtype == np.float32
            assert (W != Wj).nnz == 0
            assert (kt.challenge._extract_csr(W) != W).nnz == 0
