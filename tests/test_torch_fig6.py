"""The port's Fig.-6 fiber-bundle protocol against
scripts/run_fiberbundle_fig6.py on the CPU, at tests/test_fig6_protocol.py's
micro size (1 epoch, 96 train and 64 test images, batches of 32, synthetic
MNIST, no checkpoint):

- keyed accuracy == source accuracy (exactly: the Fig.-6 invariant), and
  the keyed logits of the test set within 1e-5·max(1, scale) of the
  source's, which shows a keyed error even where both nets predict alike;
- mu and std of the simulated train set within 1e-7 of keynet_tpu's (the
  same host simulation on the same seeds);
- the retrained params within 1e-5·max(1, |p|) of keynet_tpu's, the bound of
  tests/test_torch_train.py (torch.optim SGD against optax)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

ARGS = dict(epochs=1, n_train=96, n_test=64, batch_size=32, verbose=False)


@pytest.fixture(scope="module")
def runs():
    import run_fiberbundle_fig6 as jax_fig6
    from keynet_tpu_torch.scripts.run_fiberbundle_fig6 import run
    trained = []
    orig = jax_fig6.train

    def keep(model, *a, **kw):
        trained.append(model)
        return orig(model, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fig6, "train", keep)
        j = jax_fig6.run(**ARGS)
    t = run(device="cpu", **ARGS)
    return t, j, trained[0]


def test_keyed_accuracy_equals_source(runs):
    t, _, _ = runs
    assert t["retrained_keyed"] == t["retrained_on_sim"]
    assert "raw_ckpt_on_sim" not in t and "reference_fb_ckpt_on_sim" not in t
    assert set(t["seconds"]) == {"simulate", "train", "validate", "keyed_validate"}


def test_keyed_logits_match_source(runs):
    t, _, _ = runs
    y, yk = t["logits_source"], t["logits_keyed"]
    assert y.shape == yk.shape == (ARGS["n_test"], 10)
    assert np.isfinite(y).all()
    scale = float(np.abs(y).max())
    assert float(np.abs(yk - y).max()) <= 1e-5 * max(1.0, scale)


def test_simulation_constants_match_jax(runs):
    t, j, _ = runs
    assert 0.0 < t["mu"] < 1.0 and t["std"] > 0.0
    assert abs(t["mu"] - j["mu"]) <= 1e-7 and abs(t["std"] - j["std"]) <= 1e-7


def test_retrained_params_match_jax(runs):
    t, _, jnet = runs
    for layer, d in jnet.params.items():
        for name, pj in d.items():
            pj = np.asarray(pj)
            pt = np.asarray(t["params"][layer][name])
            assert pt.shape == pj.shape
            assert np.all(np.abs(pt - pj) <= 1e-5 * np.maximum(1.0, np.abs(pj))), \
                (layer, name, float(np.abs(pt - pj).max()))
