"""The port's structure attack against scripts/attack_bundle.py on the CPU.

- the port's own copy of the attack math gives what scripts/attack_bundle's
  gives on tests/test_attack.py's synthetic permutation-conjugated conv
  Toeplitz (value sets and row labels, tap labels, every one of the 24
  direction assignments' grid, the dihedral correlation, the histogram
  EMD) and on its dense mixture, exactly;
- attack() on a port-built permutation bundle recovers the same conv1
  weights (exact) and the same image (np.array_equal) as keynet_tpu's
  attack() on that bundle, the image correlating > 0.999 with the secret up
  to the dihedral group;
- the stochastic bundle (alpha 2, blocksize 7) shows no permutation
  structure."""

import itertools
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import attack_bundle as jax_attack  # noqa: E402
from keynet_tpu.toeplitz import toeplitz_conv2d  # noqa: E402
from keynet_tpu_torch.scripts import attack_bundle as port_attack  # noqa: E402

DIRS4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]


def _toeplitz(seed, H=10, W=10, n_ch=3):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n_ch, 1, 3, 3)).astype(np.float32)
    W1 = toeplitz_conv2d((1, H, W), f, bias=None, stride=1, format="csr").toarray()
    p_out = rng.permutation(n_ch * H * W)
    p_in = rng.permutation(H * W)
    return W1[p_out][:, p_in], rng


def _trace(mod, Wc, rng, H=10, W=10):
    """Everything the attack math computes on Wc, as comparable values."""
    cl = mod.cluster_rows_by_valueset(Wc)
    if cl is None:
        return None
    protos, row2ch = cl
    out = {"protos": sorted((sorted(map(float, p)), c) for p, c in protos.items()),
           "row2ch": row2ch.tolist(), "taps": [], "grids": []}
    for ch in range(len(protos)):
        tl = mod.label_taps(Wc, row2ch, ch, H, W)
        out["taps"].append(None if tl is None else (tl[0], tl[1], sorted(tl[2])))
        if tl is None:
            continue
        for perm in itertools.permutations(tl[1]):
            lab = {tl[0]: (0, 0)}
            lab.update(zip(perm, DIRS4))
            p = mod.recover_grid(Wc, row2ch, ch, lab, H, W)
            out["grids"].append(None if p is None else p.tolist())
    img = rng.normal(size=(H, W))
    out["dihedral"] = [d.tolist() for d in mod.dihedral_images(img)]
    out["corr"] = mod.best_dihedral_corr(img[::-1].copy(), img)
    out["emd"] = mod.hist_emd(img.ravel(), rng.normal(size=H * W))
    return out


@pytest.mark.parametrize("case", ["toeplitz_seed0", "toeplitz_seed7", "mixture"])
def test_attack_math_matches_jax(case):
    if case == "mixture":
        rng = np.random.default_rng(1)
        Wc = rng.normal(size=(300, 100))
        assert port_attack.cluster_rows_by_valueset(Wc) is None
        assert jax_attack.cluster_rows_by_valueset(Wc) is None
        return
    Wc, _ = _toeplitz(int(case[-1]))
    t = _trace(port_attack, Wc, np.random.default_rng(3))
    j = _trace(jax_attack, Wc, np.random.default_rng(3))
    assert t == j
    assert len(t["protos"]) == 3
    assert sum(g is not None for g in t["grids"]) % 8 == 0 and any(t["grids"])


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    from keynet_tpu_torch.examples import write_secret_image
    from keynet_tpu_torch.examples.release_challenge import build_bundle
    root = tmp_path_factory.mktemp("attack")
    secret = write_secret_image(str(root / "private" / "secret.png"))
    perm = build_bundle(str(root / "perm"), seed=2020, secret_image=secret, device="cpu",
                        verbose=False)["outdir"]
    rep = port_attack.run(str(root / "out"), seed=2020, secret_image=secret, perm_dir=perm,
                          device="cpu", verbose=False)
    return perm, str(root / "out" / "stoch"), rep


def test_attack_on_port_bundle_matches_jax(report):
    perm, _, rep = report
    t = port_attack.attack(perm, device="cpu")
    j = jax_attack.attack(perm)
    assert t["status"] == j["status"] == "image recovered up to dihedral + global affine"
    assert t["channels_found"] == j["channels_found"] == 6
    assert t["weights_recovered"] == j["weights_recovered"]
    assert np.array_equal(t["recovered_image"], j["recovered_image"])
    assert rep["permutation"]["conv1_valuesets_exact"] == "6/6"
    assert rep["permutation"]["image_corr_best_dihedral"] > 0.999


def test_stochastic_bundle_shows_no_structure(report):
    _, stoch, rep = report
    assert rep["stochastic"]["channels_found"] == 0
    assert rep["stochastic"]["status"].startswith("no permutation structure")
    j = jax_attack.attack(stoch)
    assert j["channels_found"] == 0 and j["status"] == rep["stochastic"]["status"]
