"""The stochastic recipe of the vgg16-stoch-224 configuration
(scripts/run_vgg_stochastic_224.py:39-46) served from a snapshot, as the
benchmark serves it: converted, saved with its sensor and keys
(``save_keynet``), restored (``load_keynet``) and run by
``KeyedModel.forward``, against the plain reference of the benchmark
(kbench/reference/cnn.py) with the benchmark's seeded He-normal weights
(kbench/weights.py).  Imports no JAX.

The net is tests/test_torch_vgg_stochastic.py's VGG-shaped prefix at 3x56x56
(16 and 32 channels, hierarchical levels (0, 1)) with its size gates lowered
(restored afterwards), so that it takes the routes of the full net at 224:
masked split chains, periodic cores, channel-broadcast pools, and a core
with a grouped-row plan (conv2_2's here), which the restore must rebuild.

The card test (marked ``cuda``; it skips without a card) serves the same
snapshot on the H100:

    python -m pytest --noconftest -m cuda tests/test_torch_vgg_stochastic_serve.py
"""

import importlib.util
import os

import pytest
import torch

import keynet_tpu_torch as kt
from keynet_tpu_torch import profiling
from keynet_tpu_torch.ops.operators import (BlockSparseOp, ChannelBroadcastOp,
                                            PermutedBlockSparseOp)
from kbench import harness
from kbench import weights as kweights

SHAPE = (3, 56, 56)
B = 8
RECIPE = dict(global_geometric="hierarchical_permutation", hierarchical_blockshape=(2, 2),
              hierarchical_permute_at_level=(0, 1), local_geometric="doubly_stochastic",
              alpha=2.0, blocksize=14, local_photometric="uniform_random_affine", beta=1.0,
              gamma=1.0, memoryorder="channel", seed=0)
# tests/test_torch_vgg_stochastic.py's gates: the 224 routes at this size
GATES = {"STREAM_NNZ": 100_000, "POOL_FACTOR_MIN_N": 1, "ROWGROUP_MIN_SLOT_BYTES": 1 << 16,
         "KRON_NPIX_MAX": 512, "KRON_NPIX_WIDE": 1024, "MASK_DENSE_MAX_BYTES": 1 << 16,
         "DENSE_MAX_BYTES": 4 << 20}
# and its routes, which the restored model keeps
ROUTES = {
    "sensor": "EllOp",
    "conv1_1": "Chain[RepeatedBlockDiagOp, EllOp, PermutedBlockSparseOp]",
    "conv1_2": "PermutedBlockSparseOp",
    "pool1_2": "ChannelBroadcastOp[EllOp]",
    "conv2_1": "Chain[RepeatedBlockDiagOp, PermutedBlockSparseOp]",
    "conv2_2": "PermutedBlockSparseOp",
    "pool2_2": "ChannelBroadcastOp[DenseOp]",
}
# The configuration's layer list, cut to the prefix; input and weights as
# kbench/configs/vgg16-stoch-224.json gives them.
CFG = {
    "inshape": list(SHAPE),
    "layers": [{"kind": "conv", "name": "conv1_1", "in": 3, "out": 16, "k": 3, "stride": 1},
               {"kind": "relu", "name": "relu1_1"},
               {"kind": "conv", "name": "conv1_2", "in": 16, "out": 16, "k": 3, "stride": 1},
               {"kind": "relu", "name": "relu1_2"},
               {"kind": "avgpool", "name": "pool1_2", "k": 3, "stride": 2},
               {"kind": "conv", "name": "conv2_1", "in": 16, "out": 32, "k": 3, "stride": 1},
               {"kind": "relu", "name": "relu2_1"},
               {"kind": "conv", "name": "conv2_2", "in": 32, "out": 32, "k": 3, "stride": 1},
               {"kind": "relu", "name": "relu2_2"},
               {"kind": "avgpool", "name": "pool2_2", "k": 3, "stride": 2}],
    "input": {"low": 0.0, "high": 255.0, "mean": [93.594, 104.7624, 129.1863],
              "std": [1.0, 1.0, 1.0]},
    "weights": {"seed": 5, "init": "he_normal", "bias_std": 0.01},
}
# max|y - ref| / max|ref|, the benchmark's comparison.  The port computes in
# IEEE f32 through keys whose 14x14 doubly-stochastic blocks are inverted
# dense; three seeds read 3.4e-7 to 4.0e-7 here.  1e-5 leaves 25x room over
# that, and TF32 products (the next precision below) read ~1e-2 at 224.
TOL = 1e-5


class _Gates:
    """GATES in the port's GLOBAL, restored on exit."""

    def __enter__(self):
        G = kt.globals.GLOBAL
        self.saved = {k: G.get(k) for k in GATES}
        G.update(GATES)

    def __exit__(self, *exc):
        G = kt.globals.GLOBAL
        for k, v in self.saved.items():
            if v is None:
                G.pop(k, None)
            else:
                G[k] = v


def route_kinds(op):
    if hasattr(op, "ops"):
        return "Chain[%s]" % ", ".join(route_kinds(o) for o in op.ops)
    if isinstance(op, ChannelBroadcastOp):
        return "ChannelBroadcastOp[%s]" % route_kinds(op.inner)
    return type(op).__name__


def routes(sensor, knet):
    got = {k: route_kinds(l.op()) for k, l in knet.layers().items() if l != "relu"}
    got["sensor"] = route_kinds(sensor.op())
    return got


def grouped_cores(knet):
    """{layer: its Block-ELL cores that hold a grouped-row plan}."""
    out = {}
    for name, l in knet.layers().items():
        if l == "relu":
            continue
        for link in getattr(l.op(), "ops", [l.op()]):
            core = link.inner if isinstance(link, (PermutedBlockSparseOp,
                                                   ChannelBroadcastOp)) else link
            core = core.inner if isinstance(core, PermutedBlockSparseOp) else core
            if isinstance(core, BlockSparseOp) and core._rgroups is not None:
                out.setdefault(name, []).append(core)
    return out


def _prefix():
    m = kt.models
    net = m.Model([m.Conv2d("conv1_1", 3, 16, 3), m.ReLU("relu1_1"),
                   m.Conv2d("conv1_2", 16, 16, 3), m.ReLU("relu1_2"),
                   m.AvgPool2d("pool1_2", 3, 2),
                   m.Conv2d("conv2_1", 16, 32, 3), m.ReLU("relu2_1"),
                   m.Conv2d("conv2_2", 32, 32, 3), m.ReLU("relu2_2"),
                   m.AvgPool2d("pool2_2", 3, 2)], inshape=SHAPE)
    return net.load_torch_state_dict(kweights.state_dict(kweights.he_normal(CFG)))


def _reference():
    path = os.path.join(harness.ROOT, "kbench", "reference", "cnn.py")
    spec = importlib.util.spec_from_file_location("kbench_reference_cnn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_err(y, ref):
    return float((y.cpu() - ref).abs().max()) / float(ref.abs().max())


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The prefix converted on the CPU and saved with its sensor and keys:
    (path, the converted sensor and net, images, their reference outputs)."""
    with _Gates():
        sensor, knet = kt.Keynet(SHAPE, _prefix(), device="cpu", **RECIPE)
    path = str(tmp_path_factory.mktemp("snap") / "vgg16-stoch-prefix.npz")
    kt.save_keynet(path, knet, sensor=sensor, include_keys=True)
    x = harness.make_images(CFG, B, 2 ** 31 + 17, "cpu")
    ref = _reference().run(CFG["layers"], kweights.he_normal(CFG), x, "cpu")
    return dict(path=path, sensor=sensor, knet=knet, x=x, ref=ref)


def _load(path, device):
    with _Gates():
        return kt.load_keynet(path, device=device)


def test_restored_routes_and_grouped_plans(snapshot):
    """The restored model keeps every route, and rebuilds each grouped-row
    plan equal to the converted one."""
    sensor, knet = _load(snapshot["path"], "cpu")
    assert routes(snapshot["sensor"], snapshot["knet"]) == ROUTES
    assert routes(sensor, knet) == ROUTES
    before, after = grouped_cores(snapshot["knet"]), grouped_cores(knet)
    assert list(after) == list(before) == ["conv2_2"]
    for a, b in zip(before["conv2_2"], after["conv2_2"]):
        assert b._rgroup_meta == a._rgroup_meta
        for ta, tb in zip(a._rgroups, b._rgroups):    # patterns, rows
            assert torch.equal(ta, tb)


def test_served_snapshot_matches_reference(snapshot):
    """load_keynet -> encrypt with the restored sensor -> KeyedModel.forward:
    the same cipher and bitwise the same output as the converted model, one
    grouped-row apply a request on the counter, and the reference's output
    within TOL."""
    sensor, knet = _load(snapshot["path"], "cpu")
    xc = sensor.fromtensor(snapshot["x"]).encrypt().tensor()
    assert torch.equal(xc, snapshot["sensor"].fromtensor(snapshot["x"]).encrypt().tensor())
    y0 = snapshot["knet"].forward(xc)
    before = profiling.GROUPED_ROWS["applies"]
    y = knet.forward(xc)
    assert profiling.GROUPED_ROWS["applies"] == before + 1
    core = grouped_cores(knet)["conv2_2"][0]
    rec = profiling.GROUPED_ROWS["cores"]["%dx%d" % core.shape]
    assert rec["last"] == profiling.GROUPED_ROWS["applies"]
    assert rec["B"] == B and [b[:2] for b in rec["buckets"]] == \
        [list(mg) for mg in core._rgroup_meta]
    assert torch.equal(y, y0)
    assert y.shape == snapshot["ref"].shape
    assert rel_err(y, snapshot["ref"]) <= TOL


@pytest.mark.cuda
def test_served_snapshot_on_card(snapshot):
    """The same snapshot restored on the card: the grouped-row apply taken
    (B=8 is under conv2_2's gate, its schedule, on the card), the output
    within TOL of the reference computed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    sensor, knet = _load(snapshot["path"], "cuda")
    assert routes(sensor, knet) == ROUTES
    core = grouped_cores(knet)["conv2_2"][0]
    assert [step.kind for step in core.schedule(B, torch.device("cuda"))] == ["grouped"]
    xc = sensor.fromtensor(snapshot["x"].cuda()).encrypt().tensor()
    before = profiling.GROUPED_ROWS["applies"]
    y = knet.forward(xc)
    torch.cuda.synchronize()
    assert profiling.GROUPED_ROWS["applies"] == before + 1
    assert profiling.GROUPED_ROWS["cores"]["%dx%d" % core.shape]["B"] == B
    ref = _reference().run(CFG["layers"], kweights.he_normal(CFG), snapshot["x"], "cuda")
    assert rel_err(y, ref) <= TOL
