"""The port's trainer and datasets against keynet_tpu on the CPU: bitwise
equal synthetic datasets and batch order, the optax learning-rate sequence
(tests/test_train.py:73-91), SGD steps of LeNet_AvgPool from the same init
(losses within 1e-5 relative, params within 1e-5·max(1, |p|)), gradients
through Model.forward(params=...), a falling loss over 8 epochs, and keyed
validation equal to plain validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import keynet_tpu as kj
import keynet_tpu_torch as kt
from keynet_tpu import datasets as dj, train as tj
from keynet_tpu_torch import datasets as dt, train as tt

TOL = 1e-5


@pytest.mark.parametrize("loader,train,root", [
    ("load_mnist", True, None), ("load_mnist", False, None),
    ("load_mnist", True, "/nonexistent"), ("load_cifar10", True, None),
    ("load_cifar10", False, None)])
def test_datasets_equal(loader, train, root):
    a = getattr(dj, loader)(root=root, train=train, synthetic_n=64, seed=3)
    b = getattr(dt, loader)(root=root, train=train, synthetic_n=64, seed=3)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_equal(shuffle):
    x, y = dt.load_mnist(synthetic_n=100)
    a = list(dj.batches(x, y, batch_size=16, shuffle=shuffle, seed=2)(3))
    b = list(dt.batches(x, y, batch_size=16, shuffle=shuffle, seed=2)(3))
    assert len(a) == len(b) == 6
    for (xa, ya), (xb, yb) in zip(a, b):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


def test_mnist_idx_reader_matches_jax(tmp_path):
    """The IDX reader on files already on disk (nothing is downloaded)."""
    import gzip
    import struct
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, 5, dtype=np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 0x803, 5, 28, 28) + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 0x801, 5) + lbls.tobytes())
    a = dj.load_mnist(root=str(tmp_path), train=False)
    b = dt.load_mnist(root=str(tmp_path), train=False)
    assert b[0].shape == (5, 1, 28, 28)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and np.array_equal(u, v)


def _torch_lrs(**kw):
    """The lr each of 25 steps runs at (the update of a unit gradient)."""
    w = torch.zeros((), dtype=torch.float64, requires_grad=True)
    opt, sched = tt.make_optimizer({"w": {"w": w}}, **kw)
    lrs = []
    for _ in range(25):
        before = float(w.detach())
        w.grad = torch.ones((), dtype=torch.float64)
        opt.step()
        sched.step()
        lrs.append(before - float(w.detach()))
    return lrs


def _optax_lrs(**kw):
    tx = tj.make_optimizer(**kw)
    params, grads = {"w": jnp.zeros(())}, {"w": jnp.ones(())}
    state = tx.init(params)
    lrs = []
    for _ in range(25):
        updates, state = tx.update(grads, state, params)
        lrs.append(-float(updates["w"]))
    return lrs


@pytest.mark.parametrize("milestones", [[2], [1, 2]])
def test_lr_sequence_matches_optax(milestones):
    """Epoch milestones decay at milestone·steps_per_epoch, as optax's
    piecewise_constant_schedule: base lr through step 19, decayed at 20."""
    kw = dict(lr=1.0, momentum=0.0, milestones=milestones, gamma=0.1, steps_per_epoch=10)
    lrs = _torch_lrs(**kw)
    assert lrs == pytest.approx(_optax_lrs(**kw), rel=1e-6)
    if milestones == [2]:
        assert lrs[5] == pytest.approx(1.0) and lrs[19] == pytest.approx(1.0)
        assert lrs[20] == pytest.approx(0.1)
    with pytest.raises(ValueError):
        tt.train(None, None, milestones=[2])


def _close_params(pj, pt):
    for k, d in pj.items():
        for kk, v in d.items():
            a = np.asarray(v)
            b = pt[k][kk].detach().numpy() if torch.is_tensor(pt[k][kk]) else pt[k][kk]
            assert a.shape == b.shape
            assert np.all(np.abs(a - b) <= TOL * np.maximum(1.0, np.abs(a))), (k, kk)


@pytest.mark.parametrize("recipe", [
    dict(lr=0.05, momentum=0.9),
    dict(lr=0.05, momentum=0.9, weight_decay=1e-3, milestones=[1], steps_per_epoch=2)])
def test_sgd_steps_match_optax(recipe):
    """Three SGD steps of LeNet_AvgPool from the same init: losses within
    1e-5 relative and params within 1e-5·max(1, |p|) after every step (the
    second recipe decays the lr before step 3)."""
    nj, nt = kj.models.LeNet_AvgPool(seed=0), kt.models.LeNet_AvgPool(seed=0)
    x, y = dt.load_mnist(synthetic_n=48)
    tx = tj.make_optimizer(**recipe)
    pj = tj._params_pytree(nj)
    sj = tx.init(pj)
    step_j = tj.make_train_step(nj, tx)
    pt = tt.params_tree(nt, torch.device("cpu"))
    step_t = tt.make_train_step(nt, *tt.make_optimizer(pt, **recipe))
    for i in range(3):
        xb, yb = x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)]
        pj, sj, lj = step_j(pj, sj, jnp.asarray(xb), jnp.asarray(yb))
        lt = step_t(pt, torch.from_numpy(xb), torch.from_numpy(yb))
        assert float(lt) == pytest.approx(float(lj), rel=TOL)
        _close_params(pj, pt)


@pytest.mark.parametrize("name", ["LeNet_AvgPool", "AllConvNet_bn"])
def test_gradient_through_forward_params(name):
    """Model.forward(params=tensors) keeps autograd: the same output as with
    the numpy params, a gradient on every tensor, and for LeNet_AvgPool the
    gradient of jax.grad within 1e-5·max(1, |g|)."""
    if name == "LeNet_AvgPool":
        nj, nt = kj.models.LeNet_AvgPool(seed=1), kt.models.LeNet_AvgPool(seed=1)
    else:
        nj, nt = None, kt.models.AllConvNet(batchnorm=True, seed=2)
    x = np.random.default_rng(8).standard_normal((3, *nt.inshape)).astype(np.float32)
    pt = tt.params_tree(nt, torch.device("cpu"))
    out = nt.forward(x, params=pt)
    assert torch.equal(out, nt.forward(x))
    (out ** 2).sum().backward()
    for k, d in pt.items():
        for kk, v in d.items():
            assert v.grad is not None and bool(torch.isfinite(v.grad).all()), (k, kk)
    if nj is not None:
        gj = jax.grad(lambda p: (nj.forward(x, params=p) ** 2).sum())(tj._params_pytree(nj))
        _close_params(gj, {k: {kk: v.grad for kk, v in d.items()} for k, d in pt.items()})


def test_train_writes_numpy_params_like_jax():
    """train() for one epoch of synthetic MNIST (8 steps): numpy float32
    params written back, within 1e-5·max(1, |p|) of keynet_tpu.train.train."""
    x, y = dt.load_mnist(synthetic_n=128)
    nj, nt = kj.models.LeNet_AvgPool(seed=0), kt.models.LeNet_AvgPool(seed=0)
    kw = dict(epochs=1, lr=0.05, momentum=0.9, weight_decay=1e-3, verbose=False)
    tj.train(nj, dj.batches(x, y, batch_size=16), **kw)
    tt.train(nt, dt.batches(x, y, batch_size=16), device="cpu", **kw)
    for d in nt.params.values():
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float32 for v in d.values())
    _close_params(nj.params, nt.params)


def test_train_reduces_loss():
    """As tests/test_train.py:14-30: 8 epochs of synthetic MNIST."""
    net = kt.models.LeNet_AvgPool(seed=0)
    x, y = dt.load_mnist(root=None, synthetic_n=512)
    it = dt.batches(x, y, batch_size=32)
    params = tt.params_tree(net, torch.device("cpu"))
    step = tt.make_train_step(net, *tt.make_optimizer(params, lr=0.05, momentum=0.9))
    losses = []
    for e in range(8):
        tot, nb = 0.0, 0
        for xb, yb in it(e):
            tot += float(step(params, torch.from_numpy(xb), torch.from_numpy(yb)))
            nb += 1
        losses.append(tot / nb)
    assert losses[-1] < losses[0] * 0.8, losses


def test_validate_keyed_equals_plain():
    """validate() through the encrypted sensor and keyed net equals plain
    validation, and the JAX package's accuracy."""
    nt, nj = kt.models.LeNet_AvgPool(seed=0), kj.models.LeNet_AvgPool(seed=0)
    x, y = dt.load_mnist(root=None, synthetic_n=96)
    it = list(dt.batches(x, y, batch_size=32, shuffle=False)(0))
    acc_plain = tt.validate(nt, it, verbose=False, device="cpu")
    sensor, knet = kt.PermutationKeynet((1, 28, 28), nt, seed=0, device="cpu")
    acc_keyed = tt.validate(nt, it, secret_sensor=sensor, secret_knet=knet, verbose=False)
    assert acc_plain == acc_keyed == tj.validate(nj, it, verbose=False)
