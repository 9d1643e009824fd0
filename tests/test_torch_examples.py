"""The port's examples against keynet_tpu's on the CPU, on the same seeds.

- worked_example: the JAX script's printed lines, equal (the port adds one
  line, the keyed layer run on the device as f32 ops);
- optical_montage: montage() bitwise equal (host numpy in both);
- param_tables: the LeNet rows' nnz and device_bytes() equal;
- lenet_demo: keyed logits within 1e-5·max(1, scale) of keynet_tpu's on the
  same PNG (f32, only the sum order differs), keyed vs source within the
  same bound, and the cross-keynet deviation above 1e4 times that error;
- the vgg16.ipynb sensor recipe at 3x64x64 (blocksize 4, alpha 4, levels
  (0, 1, 2, 3)): the cipher within 1e-5·max(1, scale) of keynet_tpu's, the
  cipher PNG's pixels equal, and tests/test_sensor_recipe.py's round-trip
  checks (PNG decrypt correlation > 0.95, in-memory decrypt max error <
  1e-2, the keyed image scrambled)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import keynet_tpu as kj  # noqa: E402


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(1.0, float(np.abs(b).max()))


def test_worked_example_prints_jax_lines(capsys):
    import worked_example as jax_worked
    from keynet_tpu_torch.examples import worked_example
    jax_worked.main()
    want = capsys.readouterr().out.splitlines()
    r = worked_example.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 6 and got[:6] == want
    assert len(got) == 7 and got[6].startswith("on cpu")
    assert r["max_err_device"] < 1e-5


def test_montage_bitwise():
    import optical_montage as jax_montage
    from keynet_tpu_torch.examples.optical_montage import montage
    assert np.array_equal(montage(), jax_montage.montage())


def test_param_tables_lenet_rows():
    from keynet_tpu_torch.examples import param_tables
    r = param_tables.run(device="cpu", verbose=False)
    net = kj.models.LeNet_AvgPool(seed=0)
    assert r["source_parameters"] == net.num_parameters()
    facs = {"IdentityKeynet": (kj.IdentityKeynet, {}),
            "PermutationKeynet": (kj.PermutationKeynet, {}),
            "TiledIdentityKeynet-14": (kj.TiledIdentityKeynet, {"tilesize": 14}),
            "TiledPermutationKeynet-14": (kj.TiledPermutationKeynet, {"tilesize": 14}),
            "TiledOrthogonalKeynet-14": (kj.TiledOrthogonalKeynet, {"tilesize": 14}),
            "StochasticKeynet-a2": (kj.StochasticKeynet, {"alpha": 2, "blocksize": 14})}
    assert [row["name"] for row in r["rows"]] == list(facs)
    for row in r["rows"]:
        fac, kw = facs[row["name"]]
        _, knet = fac((1, 28, 28), net, seed=0, **kw)
        assert (row["nnz"], row["device_bytes"]) == (knet.num_parameters(),
                                                    knet.device_bytes()), row["name"]
        assert row["memory_allocated"] is None


def test_lenet_demo_against_jax(tmp_path):
    from keynet_tpu_torch.examples import lenet_demo, write_secret_image
    png = write_secret_image(str(tmp_path / "image.png"))
    r = lenet_demo.run(png, device="cpu", verbose=False)
    net = kj.models.LeNet_AvgPool()
    sensor, knet = kj.PermutationKeynet((1, 28, 28), net, seed=42)
    y = np.asarray(knet.forward(sensor.load(png).encrypt().tensor())).ravel()
    _close(r["y_keyed"], y)
    _close(r["y_keyed"], r["y_source"])
    assert r["cross_deviation"] > 1e4 * max(r["max_err"], 1e-9)
    assert r["cipher_shape"] == (1, 785)
    assert sum(row["nnz"] for row in r["layers"]) == 323491


def test_sensor_recipe_against_jax(tmp_path):
    from PIL import Image
    from keynet_tpu_torch.examples import vgg16_sensor_demo as demo
    inshape = (3, 64, 64)
    r = demo.run(inshape=inshape, out=str(tmp_path / "port"), device="cpu", verbose=False)
    assert r["route"] == "BlockSparseOp" and r["key_shape"] == (12289, 12289)
    im = demo.recipe_image(inshape)
    sensor, model = kj.Keynet(
        inshape=inshape, net=None, blocksize=4,
        global_geometric="hierarchical_permutation", hierarchical_blockshape=(2, 2),
        hierarchical_permute_at_level=(0, 1, 2, 3),
        global_photometric="blockwise_constant_bias", local_geometric="givens_orthogonal",
        alpha=4, local_photometric="uniform_random_affine", beta=10.0, gamma=1000.0,
        memoryorder="block", seed=42)
    assert model is None
    cipher = np.asarray(sensor.fromimage(im).encrypt().tensor())
    _close(r["cipher"], cipher)
    jax_png, _ = sensor.save(str(tmp_path / "jax.png"))
    assert np.array_equal(np.asarray(Image.open(r["cipher_png"])),
                          np.asarray(Image.open(jax_png)))
    # tests/test_sensor_recipe.py's checks
    plain = ((im - im.min()) / (im.max() - im.min()) * 255).astype(np.uint8)
    assert r["keyed_image"].shape == (64, 64, 3)
    assert np.mean(np.abs(r["keyed_image"].astype(int) - plain.astype(int))) > 20
    assert r["png_corr"] > 0.95
    assert r["decrypt_max_err"] < 1e-2


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["--device", "cpu", "--allconv"]])
def test_param_tables_main(argv, capsys):
    """Both tables print six rows and the note on periodic cores."""
    from keynet_tpu_torch.examples import param_tables
    r = param_tables.main(argv)
    out = capsys.readouterr().out
    assert len(r["rows"]) == 6 and "_Texp" in out
    assert all(row["name"] in out for row in r["rows"])
