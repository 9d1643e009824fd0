"""The port of ``__graft_entry__.entry()`` (``__graft_entry__.py:40-64``):
the keyed forward of the quickstart configuration as a function and its
example input.

    fn, (x,) = entry("cuda")
    y = fn(x)          # the cipher output, (8, 785) -> (8, 11)

PermutationKeynet((1, 28, 28), LeNet_AvgPool(seed=1), seed=0), built; ``fn``
is ``KeyedModel.run`` over the built ops (keynet_tpu's ``_forward_fn(ops,
x)``: the keyed layers with ReLU between them, no decryption); ``x`` is
``default_rng(0).normal(size=(8, 785))`` as float32 on the device.  The
weights are the seeded fallback keynet_tpu takes when no checkpoint is
present; nothing is read from disk.
"""

import argparse

import numpy as np
import torch

from .globals import resolve_device
from .models.zoo import LeNet_AvgPool
from .system import PermutationKeynet


def entry(device="cuda"):
    """(fn, (x,)): the keyed forward step on the flagship model and its
    example cipher batch; ``fn.knet`` is the keyed net."""
    device = resolve_device(device)
    _, knet = PermutationKeynet((1, 28, 28), LeNet_AvgPool(seed=1), seed=0, device=device)
    knet._build()

    def fn(x_cipher):
        return knet.run(x_cipher)

    fn.knet = knet
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 785)),
                        dtype=torch.float32, device=device)
    return fn, (x,)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, (x,) = entry(args.device)
    y = fn(x)
    print("entry: keyed LeNet_AvgPool on %s, nnz %d, fn(x) %s, max|y| %.6g"
          % (y.device, fn.knet.num_parameters(), tuple(y.shape), float(y.abs().max())))


if __name__ == "__main__":
    main()
