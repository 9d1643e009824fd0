"""vgg16.ipynb sensor recipe (reference demo/vgg16.ipynb; the port of
examples/vgg16_sensor_demo.py): build the published stochastic sensor
configuration, encrypt an image, save the cipher as a PNG, load it back
with the composed decrypt key and decrypt it.

    python -m keynet_tpu_torch.examples.vgg16_sensor_demo [--image IMG] [--device cpu]

The recipe (examples/vgg16_sensor_demo.py:21-30) sets blocksize and alpha
to H // 16 of the input shape (14 at 3x224x224), hierarchical permutation
at levels (0, 1, 2, 3), blockwise constant bias, Givens-orthogonal local
keys and a uniform random affine (beta 10, gamma 1000), block memory order.
At 3x224x224 the 150,529 x 150,529 sensor key materializes as an EllOp, so
this program launches no Block-ELL kernel.  Without ``--image`` the image
is keynet_tpu's synthetic one.
"""

import argparse
import os

import numpy as np

from ..globals import resolve_device
from ..profiling import Stopwatch, timed_ms
from ..system import Keynet
from . import outdir


def recipe_image(inshape):
    """keynet_tpu's synthetic test image at (C, H, W) = inshape, (H, W, 3) f32."""
    _, H, W = inshape
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    return np.stack([128 + 100 * np.sin(xx / 12.0),
                     128 + 100 * np.cos(yy / 9.0),
                     rng.integers(0, 256, (H, W))], axis=-1).astype(np.float32)


def sensor_recipe(inshape=(3, 224, 224), device="cuda"):
    """The recipe's keyed sensor at ``inshape`` (net=None), seed 42 as the
    JAX script's."""
    k = inshape[1] // 16
    sensor, _ = Keynet(
        inshape=tuple(inshape), net=None, blocksize=k,
        global_geometric="hierarchical_permutation",
        hierarchical_blockshape=(2, 2),
        hierarchical_permute_at_level=(0, 1, 2, 3),
        global_photometric="blockwise_constant_bias",
        local_geometric="givens_orthogonal", alpha=k,
        local_photometric="uniform_random_affine", beta=10.0, gamma=1000.0,
        memoryorder="block", seed=42, device=device)
    return sensor


def run(imgfile=None, inshape=(3, 224, 224), out=None, device="cuda", verbose=True):
    """Encrypt → save PNG → load(imagekey=...) → decrypt.  Returns a dict:
    keygen seconds, the sensor key's route, encrypt/decrypt ms, the cipher,
    the PNG paths, the correlation of the PNG round trip with the image
    (> 0.95 wanted) and the in-memory decrypt's max error (< 1e-2 wanted)."""
    device = resolve_device(device)
    out = out or outdir("vgg16_sensor_demo")
    os.makedirs(out, exist_ok=True)
    with Stopwatch() as sw:
        sensor = sensor_recipe(inshape, device)
    route = type(sensor.op()).__name__
    if verbose:
        print("keygen: %.1f s  %r, sensor key %s %s" % (sw.elapsed, sensor, route,
                                                       tuple(sensor.shape)))
    if imgfile:
        # VGGFace eval preprocessing (reference keynet/vgg.py:23-35)
        from PIL import Image
        from ..models import vgg16_preprocess
        sensor.fromtensor(vgg16_preprocess()(Image.open(imgfile))[None])
        im = None
    else:
        im = recipe_image(inshape)
        sensor.fromimage(im)

    _, encrypt_ms = timed_ms(device, sensor.encrypt)
    cipher = sensor.tensor().cpu().numpy()
    if verbose:
        print("encrypt: %.3f ms (first)  cipher shape %s" % (encrypt_ms, cipher.shape))

    from PIL import Image
    keyed_png = os.path.join(out, "keyed.png")
    keyed_img = sensor.asimage()
    Image.fromarray(keyed_img).save(keyed_png)
    cipher_png, imagekey = sensor.save(os.path.join(out, "cipher.png"))

    # the composed key is the full decrypt: load into an identity sensor
    loader, _ = Keynet(inshape=tuple(inshape), net=None, device=device)
    dec_png = loader.load(cipher_png, imagekey=imagekey).decrypt().tensor()
    dec_png = dec_png.cpu().numpy().reshape(inshape)

    # the first decrypt also materializes the decrypt key on the device
    _, decrypt_first_ms = timed_ms(device, sensor.decrypt)
    dec = sensor.tensor().cpu().numpy().reshape(inshape)
    decrypted_png = os.path.join(out, "decrypted.png")
    Image.fromarray(sensor.asimage()).save(decrypted_png)
    _, encrypt_warm_ms = timed_ms(device, sensor.encrypt)
    _, decrypt_warm_ms = timed_ms(device, sensor.decrypt)
    r = {"inshape": tuple(inshape), "keygen_s": sw.elapsed, "route": route,
         "key_shape": tuple(sensor.shape), "encrypt_ms": encrypt_ms,
         "decrypt_first_ms": decrypt_first_ms, "encrypt_warm_ms": encrypt_warm_ms,
         "decrypt_warm_ms": decrypt_warm_ms, "cipher": cipher, "keyed_image": keyed_img,
         "keyed_png": keyed_png, "cipher_png": cipher_png, "decrypted_png": decrypted_png}
    if im is not None:
        r["png_corr"] = float(np.corrcoef(dec_png.transpose(1, 2, 0).ravel(),
                                          im.ravel() / 255.0)[0, 1])
        r["decrypt_max_err"] = float(np.abs(dec.transpose(1, 2, 0) - im).max())
    if verbose:
        print("decrypt: %.3f ms (first, with the key's materialization); warm encrypt "
              "%.3f ms, decrypt %.3f ms" % (decrypt_first_ms, encrypt_warm_ms,
                                             decrypt_warm_ms))
        print("cipher PNG %s, keyed %s, decrypted %s" % (cipher_png, keyed_png,
                                                        decrypted_png))
        if im is not None:
            print("PNG round trip corr %.6f (> 0.95), in-memory decrypt max err %.3g (< 1e-2)"
                  % (r["png_corr"], r["decrypt_max_err"]))
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description="vgg16.ipynb sensor recipe")
    ap.add_argument("--image", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.image, device=args.device)


if __name__ == "__main__":
    main()
