"""Produce a self-published cryptanalysis challenge bundle (the port of
examples/release_challenge.py; reference demo/challenge.ipynb artifact
flow: public = (encrypted PNG, public embedding, public keynet); private =
the keygen seed, layer keys, and image key).

Bundle layout (written to OUTDIR, default build/programs/release_challenge/bundle):
  challenge_keynet.npz     public keynet (save_keynet include_keys=False)
  challenge_cipher.png     the encrypted secret image (mat2gray-rescaled)
  challenge_embedding.npy  public embedding = keynet.forward(marshal(png))
  MANIFEST.json            shapes + instructions

A cold process holding ONLY the bundle must reproduce the embedding bit for
bit on the same device:

    python -m keynet_tpu_torch.examples.release_challenge [--outdir DIR] [--seed N]
    python -m keynet_tpu_torch.examples.release_challenge --verify DIR

The source net is LeNet_AvgPool(seed=0), keynet_tpu's fallback without its
checkpoint.  Without ``secret_image`` the secret is the seeded synthetic
28x28 image, written beside the bundle (``<OUTDIR>_private/secret.png``),
never into it.
"""

import argparse
import json
import os
import sys

import numpy as np

from .. import models, serialize
from ..globals import resolve_device
from ..system import Keynet, PermutationKeynet, PublicKeyedSensor
from . import outdir as _outdir
from . import write_secret_image

FILES = {"keynet": "challenge_keynet.npz", "cipher": "challenge_cipher.png",
         "embedding": "challenge_embedding.npy"}


def build_bundle(outdir=None, seed=2020, secret_image=None, net=None, device="cuda",
                 verbose=True):
    """Write the public bundle; returns a dict of its paths, the secret
    image's path, the embedding and the keynet's nnz."""
    device = resolve_device(device)
    outdir = outdir or os.path.join(_outdir("release_challenge"), "bundle")
    os.makedirs(outdir, exist_ok=True)
    if secret_image is None:
        secret_image = write_secret_image(
            os.path.join(outdir.rstrip(os.sep) + "_private", "secret.png"))
    net = models.LeNet_AvgPool(seed=0) if net is None else net

    # private: seed, keys, masks — all derived from `seed` and discarded here
    # (output encryption on: the published embedding is itself keyed)
    sensor, knet = PermutationKeynet((1, 28, 28), net, seed=seed,
                                     do_output_encryption=True, device=device)

    # encrypt the secret image and publish it as a PNG (mat2gray-as-key: the
    # [min,max]->[0,1] rescale is composed into the PRIVATE decrypt key,
    # reference keynet/system.py:173-181)
    sensor.load(secret_image).encrypt()
    png = os.path.join(outdir, FILES["cipher"])
    _, composed_decrypt_key = sensor.save(png)

    # holder-side sanity: the composed private key still decrypts the PNG
    check, _ = Keynet((1, 28, 28), net=None, device=device)
    dec = check.load(png, imagekey=composed_decrypt_key).decrypt().tensor().cpu().numpy()
    src = sensor.decrypt().tensor().cpu().numpy()
    assert np.abs(dec - src).max() < 2.0, "composed decrypt key failed"  # 8-bit PNG

    # public keynet: no keys stored
    npz = os.path.join(outdir, FILES["keynet"])
    serialize.save_keynet(npz, knet, include_keys=False)

    # public embedding: forward of the MARSHALED png cipher on the device
    # (what any bundle holder computes, PNG quantization and all)
    marshal = PublicKeyedSensor((1, 28, 28), device=device)
    y = knet.forward(marshal.load(png).tensor(), outkey=None).cpu().numpy()
    emb = os.path.join(outdir, FILES["embedding"])
    np.save(emb, y)

    manifest = {
        "inshape": [1, 28, 28],
        "model": "LeNet_AvgPool (topology public, weights private)",
        "files": FILES,
        "task": "recover the secret image given only these public artifacts",
        "reproduce": "PublicKeyedSensor((1,28,28)).load(cipher).tensor() -> "
                     "load_keynet(keynet).forward -> embedding",
    }
    with open(os.path.join(outdir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if verbose:
        print("bundle written to %s (on %s)" % (outdir, device))
        print("  keynet nnz: %d   embedding shape: %s" % (knet.num_parameters(), y.shape))
    return {"outdir": outdir, "keynet": npz, "cipher": png, "embedding": emb,
            "secret_image": secret_image, "y": y, "nnz": knet.num_parameters()}


def verify(bundle_dir, device="cuda"):
    """What a bundle holder runs: load the public keynet on ``device``,
    marshal the cipher PNG, forward without a key, and compare with the
    published embedding.  Returns {"equal": bitwise, "max_abs_diff", "shape"}."""
    device = resolve_device(device)
    _, knet = serialize.load_keynet(os.path.join(bundle_dir, FILES["keynet"]), device=device)
    x = PublicKeyedSensor((1, 28, 28), device=device).load(
        os.path.join(bundle_dir, FILES["cipher"])).tensor()
    y = knet.forward(x, outkey=None).cpu().numpy()
    y_pub = np.load(os.path.join(bundle_dir, FILES["embedding"]))
    same_shape = y.shape == y_pub.shape
    return {"equal": bool(same_shape and np.array_equal(y, y_pub)),
            "max_abs_diff": float(np.abs(y - y_pub).max()) if same_shape else None,
            "shape": y.shape}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Self-published challenge bundle")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--seed", type=int, default=2020)
    ap.add_argument("--secret-image", default=None)
    ap.add_argument("--verify", metavar="DIR", default=None,
                    help="reproduce DIR's embedding from its public files and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.verify:
        r = verify(args.verify, args.device)
        print("VERIFY %s" % json.dumps({"equal": r["equal"], "max_abs_diff": r["max_abs_diff"],
                                        "shape": list(r["shape"]),
                                        "jax_loaded": "jax" in sys.modules}))
        if not r["equal"]:
            raise SystemExit("the embedding is not reproduced bit for bit")
        return r
    return build_bundle(args.outdir, seed=args.seed, secret_image=args.secret_image,
                        device=args.device)


if __name__ == "__main__":
    main()
