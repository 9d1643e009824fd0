"""Worked 2x2 example of the Key-Nets construction (reference
demo/figures.py:29-88; the port of examples/worked_example.py): a single 2x2
image, one keyed linear layer, showing the homogeneous algebra
Ŵ = A1·[W b;0 1]·A0⁻¹ producing identical outputs on the cipher.

    python -m keynet_tpu_torch.examples.worked_example [--device cpu]

The algebra runs on the host in float64 and prints the JAX script's lines;
the last line runs the same keyed layer and its decryption as float32 ops on
``--device`` and gives their error against the plaintext layer.
"""

import argparse

import numpy as np
import scipy.sparse
import torch

from ..globals import resolve_device
from ..homogeneous import affine_to_linear_matrix, numpy_homogenize
from ..keys import keygen
from ..ops.operators import materialize


def run(device="cuda"):
    """The worked example's arrays as a dict: x, cipher, y_plain, y_cipher,
    y_decrypted, max_err (host, float64) and device, y_device, max_err_device
    (the keyed layer and its decryption applied on ``device`` in float32)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = rng.random((2, 2)).astype(np.float32)        # the "image"
    W = rng.normal(size=(4, 4)).astype(np.float32)   # a linear layer
    b = rng.normal(size=4).astype(np.float32)

    A0, A0inv = keygen((1, 2, 2), global_geometric="permutation",
                       global_photometric="uniform_random_gain", beta=1.0, seed=1)
    A1, A1inv = keygen((4, 1, 1), global_geometric="permutation", seed=2)

    xh = numpy_homogenize(x)                         # [x; 1]
    cipher = A0 @ xh                                 # keyed sensor output
    Wh = affine_to_linear_matrix(W, b)               # [W b; 0 1]
    What = scipy.sparse.csr_matrix(A1) @ Wh @ scipy.sparse.csr_matrix(A0inv)
    y_cipher = What @ cipher                         # keyed layer on cipher
    y_plain = W @ x.ravel() + b                      # source layer on plaintext
    y_decrypted = (A1inv @ y_cipher)[:-1]

    xc = torch.as_tensor(np.asarray(cipher, dtype=np.float32)[None], device=device)
    y_dev = materialize(scipy.sparse.csr_matrix(What)).to(device).apply(xc)
    y_dev = materialize(scipy.sparse.csr_matrix(A1inv)).to(device).apply(y_dev)
    y_dev = y_dev[0, :-1].cpu().numpy()
    return {"x": x, "cipher": cipher, "y_plain": y_plain,
            "y_cipher": np.asarray(y_cipher).ravel(),
            "y_decrypted": np.asarray(y_decrypted).ravel(),
            "max_err": float(np.abs(y_decrypted - y_plain).max()),
            "device": str(device), "y_device": y_dev,
            "max_err_device": float(np.abs(y_dev - y_plain).max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Worked 2x2 Key-Nets example")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    with np.printoptions(precision=3, suppress=True):
        print("image x           :", r["x"].ravel())
        print("cipher A0·[x;1]   :", r["cipher"])
        print("source  W·x + b   :", r["y_plain"])
        print("keyed   Ŵ·cipher  :", r["y_cipher"])
        print("decrypted         :", r["y_decrypted"])
        print("max err           : %.2e" % r["max_err"])
        print("on %-15s: max err %.2e (f32 keyed layer and decrypt)"
              % (r["device"], r["max_err_device"]))
    return r


if __name__ == "__main__":
    main()
