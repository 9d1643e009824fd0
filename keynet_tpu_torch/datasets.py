"""Dataset loaders for the reference training/validation recipes.

The port's own copy of keynet_tpu/datasets.py.  The reference uses
torchvision's MNIST/CIFAR-10 downloads (keynet/mnist.py:67,
keynet/cifar10.py:86).  Nothing is downloaded here: the loaders read the
standard on-disk formats if present (IDX files for MNIST, python-pickle
batches for CIFAR-10) and otherwise fall back to a deterministic synthetic
set with the same shapes, drawn from the same numpy generator as the JAX
package's, so both give the same arrays for the same seed.
"""

import gzip
import os
import pickle
import struct

import numpy as np

from .models.zoo import MNIST_MEAN, MNIST_STD, CIFAR10_MEAN, CIFAR10_STD


def _read_idx(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(root=None, train=True, normalize=True, synthetic_n=2048, seed=0):
    """(images NxCxHxW float32, labels N int32).  Reads IDX files from
    ``root`` when available, else synthesizes a deterministic stand-in."""
    split = "train" if train else "t10k"
    if root is not None:
        for sub in ("", "MNIST/raw"):
            d = os.path.join(root, sub)
            img_f = next((os.path.join(d, f"{split}-images-idx3-ubyte{ext}")
                          for ext in ("", ".gz")
                          if os.path.exists(os.path.join(d, f"{split}-images-idx3-ubyte{ext}"))), None)
            lbl_f = next((os.path.join(d, f"{split}-labels-idx1-ubyte{ext}")
                          for ext in ("", ".gz")
                          if os.path.exists(os.path.join(d, f"{split}-labels-idx1-ubyte{ext}"))), None)
            if img_f and lbl_f:
                x = _read_idx(img_f).astype(np.float32) / 255.0
                y = _read_idx(lbl_f).astype(np.int32)
                x = x[:, None]
                if normalize:
                    x = (x - MNIST_MEAN) / MNIST_STD
                return x.astype(np.float32), y
    rng = np.random.default_rng(seed + (0 if train else 1))
    y = rng.integers(0, 10, synthetic_n).astype(np.int32)
    # class-conditional blobs so training actually reduces loss
    protos = rng.normal(size=(10, 1, 28, 28)).astype(np.float32)
    x = protos[y] + 0.5 * rng.normal(size=(synthetic_n, 1, 28, 28)).astype(np.float32)
    return x, y


def load_cifar10(root=None, train=True, normalize=True, synthetic_n=2048, seed=0):
    """(images Nx3x32x32 float32, labels N int32) from the python-version
    CIFAR-10 batches when present, else a synthetic stand-in."""
    if root is not None:
        d = os.path.join(root, "cifar-10-batches-py")
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        if os.path.isdir(d) and all(os.path.exists(os.path.join(d, n)) for n in names):
            xs, ys = [], []
            for n in names:
                with open(os.path.join(d, n), "rb") as f:
                    b = pickle.load(f, encoding="bytes")
                xs.append(np.asarray(b[b"data"], dtype=np.float32).reshape(-1, 3, 32, 32) / 255.0)
                ys.append(np.asarray(b[b"labels"], dtype=np.int32))
            x, y = np.concatenate(xs), np.concatenate(ys)
            if normalize:
                mean = np.asarray(CIFAR10_MEAN, dtype=np.float32).reshape(1, 3, 1, 1)
                std = np.asarray(CIFAR10_STD, dtype=np.float32).reshape(1, 3, 1, 1)
                x = (x - mean) / std
            return x.astype(np.float32), y
    rng = np.random.default_rng(seed + (0 if train else 1))
    y = rng.integers(0, 10, synthetic_n).astype(np.int32)
    protos = rng.normal(size=(10, 3, 32, 32)).astype(np.float32)
    x = protos[y] + 0.5 * rng.normal(size=(synthetic_n, 3, 32, 32)).astype(np.float32)
    return x, y


def batches(x, y, batch_size=64, shuffle=True, seed=0):
    """Epoch iterator factory: data_iter_fn(epoch) for keynet_tpu_torch.train.train."""
    n = len(y)

    def data_iter_fn(epoch):
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield x[sel], y[sel]

    return data_iter_fn
