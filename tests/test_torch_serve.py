"""The port's serve() on the CPU, on bundles that keynet_tpu saved: the
narrow spec (3x16x16, StochasticKeynet alpha 2, blocksize 8: a Block-ELL
slot walk, Kronecker/TapSum chains, dense) with its sensor and as a public
bundle.  Its outputs agree with keynet_tpu's forward on the same cipher
batches within 1e-5·max(1, scale) (f32, only the sum order differs), and
``check`` holds keyed == source within 1e-5·max(1, scale).  The CLI writes
the outputs and prints the launch counts."""

import json

import numpy as np
import pytest

import keynet_tpu as kj
from keynet_tpu_torch.scripts import serve as port_serve

GATES = {"DENSE_MAX_BYTES": 1 << 20, "ELL_MAX_K": 32}


def _narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    G = kj.globals.GLOBAL
    saved = {k: G.get(k) for k in GATES}
    G.update(GATES)
    try:
        sensor, knet = kj.StochasticKeynet((3, 16, 16), _narrow(kj.models), alpha=2,
                                           blocksize=8, seed=0)
    finally:
        for k, v in saved.items():
            if v is None:
                G.pop(k, None)
            else:
                G[k] = v
    d = tmp_path_factory.mktemp("serve")
    paths = {"with_sensor": str(d / "narrow_keys.npz"), "public": str(d / "narrow_pub.npz")}
    kj.serialize.save_keynet(paths["with_sensor"], knet, sensor=sensor, include_keys=True)
    kj.serialize.save_keynet(paths["public"], knet)
    return paths, knet


@pytest.mark.parametrize("kind", ["with_sensor", "public"])
def test_serve_matches_jax_forward(bundle, kind):
    import keynet_tpu_torch as kt
    paths, knet = bundle
    check = _narrow(kt.models) if kind == "with_sensor" else None
    r = port_serve.serve(paths[kind], [1, 8], reps=1, check=check, device="cpu",
                         verbose=False)
    sensor, _ = kt.load_keynet(paths[kind], device="cpu")
    for B in (1, 8):
        xc = port_serve.inputs(sensor, 769, B, (3, 16, 16), "cpu").numpy()
        if kind == "public":
            assert np.all(xc[:, -1] == 1.0)
        want = np.asarray(knet.forward(xc))
        got = r["outputs"][B]
        assert got.shape == want.shape == (B, 10)
        assert float(np.abs(got - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))
        assert r["batches"][B]["imgs_per_s"] > 0 and len(r["batches"][B]["sha1"]) == 40
    if kind == "with_sensor":
        c = r["check"]
        assert c["max_abs_err"] <= 1e-5 * max(1.0, c["scale"])
    else:
        assert r["check"] is None
        with pytest.raises(ValueError, match="sensor"):
            port_serve.serve(paths[kind], [1], check="allconv:1", device="cpu",
                             verbose=False)


def test_serve_main_writes_outputs_and_launches(bundle, tmp_path, capsys):
    paths, _ = bundle
    out = str(tmp_path / "y.npz")
    r = port_serve.main(["--snapshot", paths["public"], "--batches", "2,3", "--reps", "1",
                         "--device", "cpu", "--out", out])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("[serve] launches ")
    assert json.loads(lines[-1][len("[serve] launches "):]) == {
        n: 0 for n in port_serve.block_ell.ENTRIES}   # no kernel on the CPU
    with np.load(out) as z:
        assert sorted(z.files) == ["B2", "B3"]
        assert np.array_equal(z["B3"], r["outputs"][3])
