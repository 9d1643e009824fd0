"""The port's entry() against __graft_entry__.entry() on the CPU, and the
port's program modules import no JAX.

entry("cpu")'s fn(x) is held against keynet_tpu's within 1e-5·max(1, scale)
(f32, only the sum order differs); the keyed net's nnz is 323,491.  Both
sides use LeNet_AvgPool(seed=1): keynet_tpu's checkpoint load is made to
fail, as it does when no checkpoint is present."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAMS = ["keynet_tpu_torch.entry",
            "keynet_tpu_torch.examples.worked_example",
            "keynet_tpu_torch.examples.optical_montage",
            "keynet_tpu_torch.examples.param_tables",
            "keynet_tpu_torch.examples.lenet_demo",
            "keynet_tpu_torch.examples.vgg16_sensor_demo",
            "keynet_tpu_torch.examples.release_challenge",
            "keynet_tpu_torch.scripts.attack_bundle",
            "keynet_tpu_torch.scripts.run_fiberbundle_fig6",
            "keynet_tpu_torch.scripts.serve"]


@pytest.fixture
def no_checkpoint(monkeypatch):
    """keynet_tpu's checkpoint loads raise, so its programs take their
    seeded fallback weights."""
    from keynet_tpu.models import specs

    def absent(self, path_or_dict):
        raise FileNotFoundError(path_or_dict)
    monkeypatch.setattr(specs.Model, "load_torch_state_dict", absent)


def test_entry_matches_graft_entry(no_checkpoint):
    sys.path.insert(0, REPO)
    import __graft_entry__
    from keynet_tpu_torch.entry import entry
    fn_j, (x_j,) = __graft_entry__.entry()
    fn_t, (x_t,) = entry("cpu")
    assert np.array_equal(np.asarray(x_j), x_t.numpy())
    y_j = np.asarray(fn_j(x_j))
    y_t = fn_t(x_t).numpy()
    assert y_t.shape == y_j.shape == (8, 11)
    scale = float(np.abs(y_j).max())
    assert float(np.abs(y_t - y_j).max()) <= 1e-5 * max(1.0, scale)
    assert fn_t.knet.num_parameters() == 323491


def test_entry_main_runs_on_cpu(capsys):
    from keynet_tpu_torch.entry import main
    main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "nnz 323491" in out and "(8, 11)" in out


def test_programs_import_no_jax():
    """Every program module, imported in a fresh process, leaves jax and
    keynet_tpu out of sys.modules."""
    code = ("import sys, importlib\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'keynet_tpu' or k.startswith('keynet_tpu.'))\n"
            "assert not bad, bad\n"
            "print('NO_JAX_OK')\n" % PROGRAMS)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout


@pytest.mark.parametrize("module", PROGRAMS)
def test_program_defaults_to_cuda(module):
    """Each program's entry function takes device= and defaults to cuda
    (resolve_device raises without a card; it never falls back to the CPU)."""
    import importlib
    import inspect
    mod = importlib.import_module(module)
    fn = {"keynet_tpu_torch.entry": "entry",
          "keynet_tpu_torch.examples.optical_montage": None,
          "keynet_tpu_torch.examples.release_challenge": "build_bundle",
          "keynet_tpu_torch.scripts.serve": "serve"}.get(module, "run")
    if fn is None:   # image arithmetic on the host: no device argument
        assert "device" not in inspect.signature(mod.run).parameters
        return
    assert inspect.signature(getattr(mod, fn)).parameters["device"].default == "cuda"
