"""Figure-6 fiber-bundle protocol, end to end (reference demo/figures.py:121-179
`train_mnist_lenet_avgpool_fiberbundle`; the port of
scripts/run_fiberbundle_fig6.py):

  1. simulate the MNIST set through the fiber-bundle optics
     (keynet_tpu_torch.fiberbundle.transform, on the host), estimating the
     normalization constants from the simulated train set,
  2. validate a raw-trained checkpoint on simulated imagery (when one is given),
  3. re-train LeNet_AvgPool on simulated imagery on the device (lr 0.004,
     40 epochs in the paper protocol),
  4. validate the re-trained net, and a fiber-bundle checkpoint as the oracle
     (when one is given),
  5. keyed-validate the re-trained net through a PermutationKeynet — the
     Fig.-6 "keynet" column: keyed accuracy == source accuracy.

With no MNIST IDX files under ``--mnist-root`` the loader falls back to a
deterministic synthetic set; nothing is downloaded.  Steps 2 and 4's oracle
run only when ``--raw-ckpt`` / ``--fb-ckpt`` name files that exist.

    python -m keynet_tpu_torch.scripts.run_fiberbundle_fig6 [--mnist-root DIR]
        [--epochs N] [--n-train N] [--n-test N] [--device cpu]
"""

import argparse
import os
import time

import numpy as np
import torch

from .. import fiberbundle
from ..datasets import batches, load_mnist
from ..globals import resolve_device
from ..models.zoo import LeNet_AvgPool, MNIST_FIBERBUNDLE_MEAN, MNIST_FIBERBUNDLE_STD
from ..system import PermutationKeynet
from ..train import train, validate


def simulate_set(x, seed=0, verbose=True):
    """Push (N,1,28,28) float images in [0,1] through the fiber-bundle optics;
    returns (N,1,28,28) float32 in [0,1] (reference figures.py:131-136
    transform chain: RGB -> fiberbundle.transform -> grayscale -> 28x28)."""
    out = np.empty_like(x, dtype=np.float32)
    t0 = time.time()
    for i in range(len(x)):
        img = np.uint8(np.clip(x[i, 0] * 255.0, 0, 255))
        rgb = np.repeat(img[:, :, None], 3, axis=2)
        sim = fiberbundle.transform(rgb, outshape=(28, 28), seed=seed + i)
        out[i, 0] = np.asarray(sim, dtype=np.float32).mean(axis=2) / 255.0
        if verbose and i and i % 2000 == 0:
            print("  simulated %d/%d (%.1f img/s)" % (i, len(x), i / (time.time() - t0)))
    return out


def test_logits(net, sensor, knet, data_iter, device):
    """(source, keyed) logits of the test set, numpy (N, 10): the numbers
    behind the two accuracies, so a keyed forward that drifts from the
    source shows even where both nets give the same argmax."""
    ys, yks = [], []
    with torch.no_grad():
        for images, _ in data_iter:
            ys.append(net.forward(images, device=device).cpu().numpy())
            xc = sensor.fromtensor(images).encrypt().tensor()
            yks.append(knet.forward(xc).reshape(len(images), -1).cpu().numpy())
    return np.concatenate(ys), np.concatenate(yks)


def _ckpt(path):
    return path if path and os.path.exists(path) else None


def run(mnist_root=None, epochs=40, n_train=None, n_test=None, lr=0.004,
        batch_size=32, seed=0, raw_ckpt=None, fb_ckpt=None, device="cuda", verbose=True):
    """The protocol's results: mu, std, the accuracies of each step, the
    retrained net's source and keyed logits on the test set
    ("logits_source", "logits_keyed"), the seconds of each step ("seconds")
    and the retrained params ("params")."""
    device = resolve_device(device)
    secs = {}
    t = time.perf_counter()
    # raw sets are normalized for step 2; simulation wants raw [0,1] pixels
    xtr_raw, ytr = load_mnist(root=mnist_root, train=True, normalize=False, seed=seed)
    xte_raw, yte = load_mnist(root=mnist_root, train=False, normalize=False, seed=seed)
    if n_train:
        xtr_raw, ytr = xtr_raw[:n_train], ytr[:n_train]
    if n_test:
        xte_raw, yte = xte_raw[:n_test], yte[:n_test]

    print("simulating %d train + %d test images through the fiber bundle..."
          % (len(ytr), len(yte)))
    str_ = simulate_set(xtr_raw, seed=seed, verbose=verbose)
    ste = simulate_set(xte_raw, seed=seed + 10 ** 6, verbose=verbose)

    # 1. normalization constants from the simulated train set
    #    (reference figures.py:138-147; published pair figures.py:153)
    mu, std = float(str_.mean()), float(str_.std())
    print("estimated sim constants: mu=%.8f std=%.8f (published %.8f %.8f)"
          % (mu, std, MNIST_FIBERBUNDLE_MEAN, MNIST_FIBERBUNDLE_STD))
    xtr = (str_ - mu) / std
    xte = (ste - mu) / std
    secs["simulate"] = time.perf_counter() - t

    results = {"mu": mu, "std": std}

    def test_batches():
        return batches(xte, yte, batch_size, shuffle=False)(0)

    # 2. raw-trained checkpoint on simulated imagery
    if _ckpt(raw_ckpt):
        raw = LeNet_AvgPool().load_torch_state_dict(raw_ckpt)
        acc = validate(raw, test_batches(), verbose=False, device=device)
        results["raw_ckpt_on_sim"] = acc
        print("raw-trained checkpoint on sim imagery: %.4f" % acc)

    # 3. retrain on simulated imagery (paper: lr 0.004, 40 epochs,
    #    reference figures.py:175 via keynet.cifar10.train)
    t = time.perf_counter()
    net = LeNet_AvgPool(seed=seed)
    steps = max(1, (len(ytr) - batch_size + 1 + batch_size - 1) // batch_size)
    train(net, batches(xtr, ytr, batch_size, seed=seed), epochs=epochs, lr=lr,
          steps_per_epoch=steps, verbose=verbose, device=device)
    secs["train"] = time.perf_counter() - t

    # 4. validate the retrained net + the fiber-bundle oracle
    t = time.perf_counter()
    acc = validate(net, test_batches(), verbose=False, device=device)
    results["retrained_on_sim"] = acc
    print("retrained net on sim imagery: %.4f" % acc)
    if _ckpt(fb_ckpt):
        oracle = LeNet_AvgPool().load_torch_state_dict(fb_ckpt)
        acc_o = validate(oracle, test_batches(), verbose=False, device=device)
        results["reference_fb_ckpt_on_sim"] = acc_o
        print("fiber-bundle checkpoint on sim imagery: %.4f" % acc_o)
    secs["validate"] = time.perf_counter() - t

    # 5. keyed-validate the retrained net (Fig.-6 "keynet" column)
    t = time.perf_counter()
    sensor, knet = PermutationKeynet((1, 28, 28), net, seed=seed, device=device)
    acc_k = validate(None, test_batches(), secret_sensor=sensor, secret_knet=knet,
                     verbose=False)
    results["retrained_keyed"] = acc_k
    secs["keyed_validate"] = time.perf_counter() - t
    print("retrained net, keyed forward: %.4f (source %.4f)"
          % (acc_k, results["retrained_on_sim"]))
    results["logits_source"], results["logits_keyed"] = test_logits(
        net, sensor, knet, test_batches(), device)
    results["seconds"] = secs
    results["params"] = net.params
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="Figure-6 fiber-bundle protocol")
    ap.add_argument("--mnist-root", default=None,
                    help="directory with MNIST IDX files (synthetic fallback if absent)")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--n-test", type=int, default=None)
    ap.add_argument("--raw-ckpt", default=None, help="raw-trained LeNet_AvgPool .pth")
    ap.add_argument("--fb-ckpt", default=None, help="fiber-bundle-trained LeNet_AvgPool .pth")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(mnist_root=a.mnist_root, epochs=a.epochs, n_train=a.n_train,
               n_test=a.n_test, raw_ckpt=a.raw_ckpt,
               fb_ckpt=a.fb_ckpt, device=a.device)


if __name__ == "__main__":
    main()
