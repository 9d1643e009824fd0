"""The port's challenge bundle against examples/release_challenge.py's on
the CPU, with the same seed (2020), the same seeded synthetic secret PNG and
the same weights (LeNet_AvgPool(seed=0): keynet_tpu's checkpoint load is
made to fail, as it does when no checkpoint is present).

- the npz holds the same array names and np.array_equal arrays, the cipher
  PNG the same pixels, and the embeddings agree within 1e-5·max(1, scale)
  (f32, only the sum order differs);
- the bundle is public only, and the cipher is not the plaintext;
- a cold process with the port only (no JAX in its sys.modules) reproduces
  the port bundle's embedding bit for bit;
- the JAX bundle, served by the port, gives its embedding within
  1e-5·max(1, scale)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["challenge_keynet.npz", "challenge_cipher.png", "challenge_embedding.npy",
         "MANIFEST.json"]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    from keynet_tpu.models import specs
    from keynet_tpu_torch.examples import write_secret_image
    from keynet_tpu_torch.examples.release_challenge import build_bundle
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import release_challenge as jax_release
    root = tmp_path_factory.mktemp("release")
    secret = write_secret_image(str(root / "private" / "secret.png"))
    port = build_bundle(str(root / "port"), seed=2020, secret_image=secret, device="cpu",
                        verbose=False)

    def absent(self, path_or_dict):
        raise FileNotFoundError(path_or_dict)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(specs.Model, "load_torch_state_dict", absent)
        jax_dir = jax_release.build_bundle(str(root / "jax"), seed=2020,
                                           secret_image=secret, verbose=False)
    return port, jax_dir, secret


def _close(a, b, tol=1e-5):
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(1.0, float(np.abs(b).max()))


def test_bundle_matches_jax(bundles):
    port, jax_dir, _ = bundles
    assert sorted(os.listdir(port["outdir"])) == sorted(os.listdir(jax_dir)) == sorted(FILES)
    with np.load(port["keynet"]) as zt, \
            np.load(os.path.join(jax_dir, "challenge_keynet.npz")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k]), k
    assert np.array_equal(np.asarray(Image.open(port["cipher"])),
                          np.asarray(Image.open(os.path.join(jax_dir, FILES[1]))))
    _close(np.load(port["embedding"]), np.load(os.path.join(jax_dir, FILES[2])))
    with open(os.path.join(port["outdir"], FILES[3])) as f, \
            open(os.path.join(jax_dir, FILES[3])) as g:
        assert json.load(f) == json.load(g)
    assert port["nnz"] == 323491


def test_bundle_contents_are_public_only(bundles):
    port, _, secret = bundles
    assert sorted(os.listdir(port["outdir"])) == sorted(FILES)
    assert not os.path.dirname(secret).startswith(port["outdir"] + os.sep)
    with np.load(port["keynet"]) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        assert manifest["include_keys"] is False
        assert not any(k.startswith(("imagekey", "embeddingkey", "sensor_"))
                       for k in z.files)


def test_cipher_png_is_not_plaintext(bundles):
    port, _, secret = bundles
    cipher = np.asarray(Image.open(port["cipher"]).convert("L"), dtype=float)
    plain = np.asarray(Image.open(secret).convert("L"), dtype=float)
    c = (cipher - cipher.mean()) / (cipher.std() + 1e-9)
    s = (plain - plain.mean()) / (plain.std() + 1e-9)
    assert abs(float((c * s).mean())) < 0.5, "cipher correlates with plaintext"


def test_cold_process_reproduces_embedding(bundles):
    """A fresh process holding only the bundle, with the port alone, gives
    the published embedding bit for bit."""
    port, _, _ = bundles
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "keynet_tpu_torch.examples.release_challenge",
                        "--verify", port["outdir"], "--device", "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(l for l in r.stdout.splitlines() if l.startswith("VERIFY "))
    got = json.loads(line[len("VERIFY "):])
    assert got == {"equal": True, "max_abs_diff": 0.0, "shape": [1, 10], "jax_loaded": False}


def test_jax_bundle_served_by_port(bundles):
    _, jax_dir, _ = bundles
    from keynet_tpu_torch import load_keynet
    from keynet_tpu_torch.system import PublicKeyedSensor
    _, knet = load_keynet(os.path.join(jax_dir, FILES[0]), device="cpu")
    x = PublicKeyedSensor((1, 28, 28), device="cpu").load(
        os.path.join(jax_dir, FILES[1])).tensor()
    _close(knet.forward(x, outkey=None).numpy(), np.load(os.path.join(jax_dir, FILES[2])))
