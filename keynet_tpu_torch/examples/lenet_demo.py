"""Quickstart demo (reference demo/lenet.ipynb; the port of
examples/lenet_demo.py): build a PermutationKeynet on LeNet_AvgPool, encrypt
an image, run keyed inference, inspect per-layer nnz, and show the
cross-keynet rejection property.

    python -m keynet_tpu_torch.examples.lenet_demo [--image IMG] [--device cpu]

The weights are LeNet_AvgPool's seeded ones (seed 0, the fallback keynet_tpu
takes without its checkpoint); without ``--image`` the image is the seeded
synthetic one, written to build/programs/lenet_demo/image.png.
"""

import argparse
import os

import numpy as np

from .. import models
from ..globals import resolve_device
from ..profiling import Stopwatch, print_layer_report
from ..system import PermutationKeynet
from . import outdir, write_secret_image

SEED, OTHER_SEED = 42, 7   # the keynet's seed and the rejecting keynet's


def run(image=None, device="cuda", verbose=True):
    """Keyed against source logits of one image, and the same cipher through
    a keynet of another seed; returns a dict of the logits, their errors,
    the conversion seconds and the layer report."""
    device = resolve_device(device)
    if image is None:
        image = write_secret_image(os.path.join(outdir("lenet_demo"), "image.png"))
    net = models.LeNet_AvgPool(seed=0)
    with Stopwatch() as sw:
        sensor, knet = PermutationKeynet((1, 28, 28), net, seed=SEED, device=device)
    if verbose:
        print("keygen + conversion: %.2fs" % sw.elapsed)
        report = print_layer_report(knet)
    else:
        from ..profiling import layer_report
        report = layer_report(knet)

    cipher = sensor.load(image).encrypt().tensor()
    y_keyed = knet.forward(cipher).cpu().numpy().ravel()
    y_source = net.forward(sensor.decrypt().tensor()).cpu().numpy().ravel()

    # an image encrypted for THIS keynet is garbage through another keynet
    sensor.encrypt()
    _, other_knet = PermutationKeynet((1, 28, 28), net, seed=OTHER_SEED, device=device)
    y_cross = other_knet.forward(sensor.tensor()).cpu().numpy().ravel()
    r = {"image": image, "cipher_shape": tuple(cipher.shape), "seconds": sw.elapsed,
         "layers": report, "y_keyed": y_keyed, "y_source": y_source, "y_cross": y_cross,
         "max_err": float(np.abs(y_keyed - y_source).max()),
         "cross_deviation": float(np.abs(y_cross - y_source).max())}
    if verbose:
        print("\ncipher shape:", r["cipher_shape"])
        print("keyed logits :", y_keyed.round(3))
        print("source logits:", y_source.round(3))
        print("max |keyed - source| = %.3g" % r["max_err"])
        print("cross-keynet max deviation = %.3g (should be large)" % r["cross_deviation"])
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description="Keyed LeNet_AvgPool quickstart")
    ap.add_argument("--image", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.image, device=args.device)


if __name__ == "__main__":
    main()
