"""Optical-transformation montage (reference demo/figures.py:91-118
`optical_transformation_montage`; the port of examples/optical_montage.py):
a 3x7 grid sweeping photometric severity (rows: gain/bias scales 0.1, 1.0,
10000) against geometric severity (columns: hierarchical block permutation
at increasingly coarse levels) — the paper's visual argument for what each
key family hides.  It is image arithmetic on the host: no device is used.

    python -m keynet_tpu_torch.examples.optical_montage [--image IMG] [--out PNG]
"""

import argparse
import os

import numpy as np

from ..blockpermute import hierarchical_block_permute
from . import outdir


def montage(img=None, seed=0):
    """img: (256,256,3) uint8 (synthetic if None).  Returns (3*256, 7*256, 3)
    uint8 montage array."""
    rng = np.random.default_rng(seed)
    if img is None:
        yy, xx = np.mgrid[0:256, 0:256]
        img = np.stack([128 + 100 * np.sin(xx / 14.0),
                        128 + 100 * np.cos(yy / 10.0),
                        64 + (xx + yy) / 4.0], axis=-1).astype(np.uint8)
    assert img.shape == (256, 256, 3)

    # photometric severities (reference figures.py:96-97)
    D = [np.maximum(1e-6, 1.0 + (s * rng.random((256, 256, 3)) - s / 2.0))
         for s in (0.1, 1.0, 10000.0)]
    B = [255 * np.maximum(1e-6, s * rng.random((256, 256, 3)))
         for s in (0.1, 1.0, 10000.0)]

    # geometric severities: permute at finer -> coarser levels (figures.py:98-105)
    prng = np.random.default_rng(seed + 1)
    P = [img] + [hierarchical_block_permute(img, (2, 2), permute_at_level=levels,
                                            min_blocksize=1, seed=int(prng.integers(1 << 30)))
                 for levels in (range(6, 8), range(5, 6), range(4, 5),
                                range(3, 5), range(2, 6), range(0, 8))]

    rows = []
    for d, b in zip(D, B):
        row = []
        for p in P:
            scaled = np.multiply(d, p.astype(np.float64)) + b
            lo, hi = scaled.min(), scaled.max()
            row.append(np.uint8(255 * (scaled - lo) / max(hi - lo, 1e-12)))
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def run(imgfile=None, outfile=None):
    """Write the montage of ``imgfile`` (synthetic if None) to ``outfile``
    (build/programs/optical_montage/montage.png by default); returns
    {"montage": array, "outfile": path}."""
    from PIL import Image
    img = None
    if imgfile:
        img = np.asarray(Image.open(imgfile).convert("RGB").resize((256, 256)))
    m = montage(img)
    outfile = outfile or os.path.join(outdir("optical_montage"), "montage.png")
    os.makedirs(os.path.dirname(os.path.abspath(outfile)), exist_ok=True)
    Image.fromarray(m).save(outfile)
    return {"montage": m, "outfile": outfile}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Optical-transformation montage")
    ap.add_argument("--image", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    r = run(args.image, args.out)
    print("montage (3 photometric x 7 geometric severities) -> %s  %s"
          % (r["outfile"], r["montage"].shape))
    return r


if __name__ == "__main__":
    main()
