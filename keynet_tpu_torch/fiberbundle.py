"""Fiber-bundle optical camera simulation (vectorized numpy).

The port's own copy of keynet_tpu/fiberbundle.py.  Physics spec from
reference keynet/fiberbundle.py:7-163: an image is viewed through a coherent
fiber bundle — light is integrated per fiber core laid out on a sheared
(hex-like) grid, the interstitial cladding blocks light, adjacent cores leak
a fraction of intensity into each other (6-neighbor crosstalk with separate
horizontal/vertical coefficients), total energy is renormalized, and a CMOS
sensor adds Poisson shot noise, Gaussian dark noise and ADU
quantization/saturation.

The core-average, mask and crosstalk steps are computed for all cores at
once with reshaped block views, so a 512x512x3 frame simulates in
milliseconds.
"""

import numpy as np


def camera_noise(irrad_photons, q_e=0.5, sensitivity=0.0, s_pixel=0.0,
                 dark_noise=2.0, bit_depth=12, baseline=90, rng=None):
    """CMOS FPA noise model: Poisson shot noise -> quantum efficiency ->
    Gaussian dark noise -> ADU conversion with baseline and saturation
    (spec: keynet/fiberbundle.py:7-28)."""
    rng = rng or np.random.RandomState(seed=3)
    photons = rng.poisson(np.maximum(irrad_photons, 0.0))
    electrons = q_e * photons
    electrons_out = rng.normal(scale=dark_noise, size=electrons.shape) + electrons
    max_adu = int(2 ** bit_depth - 1)
    adu = (electrons_out * (sensitivity + s_pixel)).astype(np.int64) + baseline
    return np.minimum(adu, max_adu)


def simulation(img_color, fiber_core_x=16, fiber_core_y=16, clad_factor=1.25,
               shear=1, h_xtalk=0.05, v_xtalk=0.05, pad_val=3,
               image_pixel_size=4, do_camera_noise=True, seed=None):
    """Simulate viewing an (H,W,3) uint8 image through a fiber bundle.

    Returns an (H,W,3) float array in [0,255].  Parameters mirror the
    reference API (keynet/fiberbundle.py:31); sizes are in physical microns
    with image_pixel_size microns per pixel.
    """
    img_color = np.asarray(img_color)
    assert img_color.ndim == 3 and img_color.shape[2] == 3
    rng = np.random.default_rng(seed)
    noise_rng = np.random.RandomState(seed=3 if seed is None else seed)
    H, W = img_color.shape[:2]

    # fiber pitch in pixels (core + cladding border)
    pitch_x = max(2, int(round(fiber_core_x * clad_factor / image_pixel_size)))
    pitch_y = max(2, int(round(fiber_core_y * clad_factor / image_pixel_size)))
    core_x = max(1, int(round(fiber_core_x / image_pixel_size)))
    core_y = max(1, int(round(fiber_core_y / image_pixel_size)))

    nby, nbx = H // pitch_y, W // pitch_x
    Hc, Wc = nby * pitch_y, nbx * pitch_x

    # per-cell core aperture mask with alternating-row half-pitch shear (hex packing)
    # plus a small random jitter of up to `shear` pixels per row of cells.
    cell = np.zeros((pitch_y, pitch_x), dtype=bool)
    oy, ox = (pitch_y - core_y) // 2, (pitch_x - core_x) // 2
    cell[oy:oy + core_y, ox:ox + core_x] = True
    mask = np.tile(cell, (nby, nbx))
    row_shift = ((np.arange(nby) % 2) * (pitch_x // 2)
                 + rng.integers(0, max(1, shear), size=nby))
    mask = mask.reshape(nby, pitch_y, Wc)
    mask = np.stack([np.roll(mask[i], int(row_shift[i]), axis=1) for i in range(nby)])
    mask = mask.reshape(Hc, Wc)

    gray_level = 127.0  # interstitial cladding gray (keynet/fiberbundle.py:82)
    out = np.empty_like(img_color, dtype=np.float64)

    for ch in range(3):
        img = img_color[:Hc, :Wc, ch].astype(np.float64)

        # per-core average intensity: block-mean over each (pitch_y, pitch_x)
        # cell of the masked image (all cores at once)
        masked = np.where(mask, img, 0.0)
        blocks = masked.reshape(nby, pitch_y, nbx, pitch_x)
        core_sum = blocks.sum(axis=(1, 3))
        core_area = float(cell.sum())
        core_val = core_sum / max(core_area, 1.0)           # (nby, nbx)

        # 6-neighbor crosstalk: diagonal neighbors couple with v_xtalk,
        # lateral neighbors with h_xtalk (keynet/fiberbundle.py:101-133)
        pre_mean = core_val.mean()
        p = np.pad(core_val, 1, mode="edge")
        diag = p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]
        lat = p[1:-1, :-2] + p[1:-1, 2:]
        leak = np.minimum(v_xtalk * diag + h_xtalk * lat, 255.0)
        keep = max(1.0 - 4.0 * v_xtalk - 2.0 * h_xtalk, 0.0)
        core_val = keep * core_val + leak
        post_mean = core_val.mean()
        if post_mean > 0:
            core_val *= pre_mean / post_mean                 # energy renormalization

        # paint cores back, cladding stays gray
        painted = np.repeat(np.repeat(core_val, pitch_y, axis=0), pitch_x, axis=1)
        fiber_out = np.where(mask, painted, gray_level)

        if do_camera_noise:
            s_pixel = 30.0  # uniform per-pixel sensitivity (keynet/fiberbundle.py:84)
            fiber_out = camera_noise(fiber_out, s_pixel=s_pixel, rng=noise_rng) \
                * 255.0 / 2 ** 12 - 1

        full = np.full((H, W), gray_level, dtype=np.float64)
        full[:Hc, :Wc] = fiber_out
        out[:, :, ch] = full

    return np.clip(out, 0, 255)


def transform(img_color, outshape=(32, 32), seed=None):
    """Dataset transform: upsample to 512, simulate without sensor noise,
    downsample to outshape (spec: keynet/fiberbundle.py:158-163).  Used for
    fiber-bundle retraining (reference demo/figures.py:121-233)."""
    from PIL import Image
    img = np.asarray(img_color)
    assert img.ndim == 3 and img.dtype == np.uint8
    big = np.array(Image.fromarray(img).resize((512, 512), Image.NEAREST))
    sim = simulation(big, h_xtalk=0.05, v_xtalk=0.05, fiber_core_x=16,
                     fiber_core_y=16, do_camera_noise=False, seed=seed)
    return np.array(Image.fromarray(np.uint8(sim)).resize(outshape, Image.BICUBIC))
