"""The port of ``examples/``: the programs users run, one module each, on
the card by default (``--device cpu`` runs them on the host).

    python -m keynet_tpu_torch.examples.worked_example
    python -m keynet_tpu_torch.examples.optical_montage
    python -m keynet_tpu_torch.examples.param_tables [--allconv]
    python -m keynet_tpu_torch.examples.lenet_demo
    python -m keynet_tpu_torch.examples.vgg16_sensor_demo
    python -m keynet_tpu_torch.examples.release_challenge [--verify DIR]

Each module has a function that returns its results as a dict and a
``main()``.  No program reads a checkpoint or a downloaded image: weights
come from the seed that keynet_tpu falls back to, and the secret image is
the seeded synthetic one below, which the program writes as a PNG itself.
Outputs go to ``build/programs/`` in the checkout unless a path is given.
"""

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def outdir(name):
    """The default output directory of program ``name``: build/programs/<name>."""
    return os.path.join(ROOT, "build", "programs", name)


def synthetic_image(seed=0, shape=(28, 28)):
    """A seeded grayscale test image, uint8 (H, W): four Gaussian blobs of
    random sign and width and a little noise, so it has structure for a
    correlation to find and no symmetry of the square."""
    H, W = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / float(max(H, W))
    img = np.zeros((H, W))
    for _ in range(4):
        cy, cx = rng.random(2)
        s = 0.08 + 0.15 * rng.random()
        img += rng.uniform(-1.0, 1.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                               / (2 * s * s))
    img += 0.05 * rng.standard_normal((H, W))
    img = (img - img.min()) / (img.max() - img.min())
    return np.uint8(np.round(255 * img))


def write_secret_image(path, seed=0, shape=(28, 28)):
    """Write synthetic_image(seed, shape) to ``path`` as a PNG; returns the path."""
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(synthetic_image(seed, shape)).save(path)
    return path

