"""The plain reference and the configurations it is written from, on the CPU:
the reference against keynet_tpu_torch's source ``Model.forward`` with the
benchmark's weights, each configuration's layer list against the zoo spec
its recipe uses, and the source FLOP counts."""

import json
import os

import numpy as np
import pytest
import torch

import keynet_tpu_torch as kt
from keynet_tpu_torch.models import specs
from kbench import harness, weights, yardstick
from kbench.reference import cnn

KBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(KBENCH, "configs")
DATA = os.path.join(KBENCH, "tests", "data")


def _cfg(path):
    with open(path) as f:
        return json.load(f)


def _layer(l):
    """A zoo spec layer as a configuration's layer entry."""
    if isinstance(l, specs.Conv2d):
        assert l.padding is None
        return {"kind": "conv", "name": l.name, "in": l.in_channels, "out": l.out_channels,
                "k": l.kernel_size, "stride": l.stride}
    if isinstance(l, specs.AvgPool2d):
        return {"kind": "avgpool", "name": l.name, "k": l.kernel_size, "stride": l.stride}
    if isinstance(l, specs.Linear):
        return {"kind": "linear", "name": l.name, "in": l.in_features, "out": l.out_features}
    for cls, kind in ((specs.ReLU, "relu"), (specs.Dropout, "dropout")):
        if isinstance(l, cls):
            return {"kind": kind, "name": l.name}
    raise TypeError(l)


def _recipe(name, where=CONFIGS):
    return harness.load_module(os.path.join(where, name + ".py"), "test_recipe_" + name)


@pytest.mark.parametrize("name", ["vgg16-orth-224", "allconv-stoch-32"])
def test_config_layers_are_the_zoo_spec(name):
    cfg = _cfg(os.path.join(CONFIGS, name + ".json"))
    net = _recipe(name).source_model(kt, cfg)
    assert [_layer(l) for l in net.layers] == cfg["layers"]
    assert list(net.inshape) == cfg["inshape"]


@pytest.mark.parametrize("name", ["vgg16-orth-224", "allconv-stoch-32"])
def test_weights_fill_every_zoo_parameter(name):
    cfg = _cfg(os.path.join(CONFIGS, name + ".json"))
    net = _recipe(name).source_model(kt, cfg)
    w = weights.he_normal(cfg)
    sd = weights.state_dict(w)
    assert {"%s.%s" % (n, k) for n, p in net.params.items() for k in p} == set(sd)
    for l in cfg["layers"]:
        if l["kind"] == "conv":
            fan_in = l["in"] * l["k"] ** 2
        elif l["kind"] == "linear":
            fan_in = l["in"]
        else:
            continue
        W = w[l["name"]]["weight"]
        assert W.dtype == np.float32
        assert abs(W.std() / np.sqrt(2.0 / fan_in) - 1) < 0.2, l["name"]


def test_weights_repeat_from_the_seed():
    cfg = _cfg(os.path.join(CONFIGS, "allconv-stoch-32.json"))
    a, b = weights.he_normal(cfg), weights.he_normal(cfg)
    assert all(np.array_equal(a[n][k], b[n][k]) for n in a for k in a[n])


@pytest.mark.parametrize("name,gflop", [("vgg16-orth-224", 30.95), ("allconv-stoch-32", 0.562)])
def test_source_flops(name, gflop):
    cfg = _cfg(os.path.join(CONFIGS, name + ".json"))
    flops = yardstick.source_flops(cfg["layers"], cfg["inshape"])
    assert round(flops / 1e9, 2 if gflop > 1 else 3) == gflop


def test_source_flops_by_hand():
    layers = [{"kind": "conv", "name": "c", "in": 3, "out": 4, "k": 3, "stride": 2},
              {"kind": "relu", "name": "r"},
              {"kind": "avgpool", "name": "p", "k": 3, "stride": 2},
              {"kind": "linear", "name": "f", "in": 4 * 4 * 4, "out": 5}]
    # conv: 8x8 outputs of 4 channels, 3*9 MACs each; pool to 4x4; linear 64*5
    assert yardstick.source_flops(layers, (3, 16, 16)) == 2 * (3 * 9 * 4 * 64 + 64 * 5)


def _against_model(cfg, net, B, seed=0):
    w = weights.he_normal(cfg)
    net.load_torch_state_dict(weights.state_dict(w))
    x = harness.make_images(cfg, B, seed, "cpu")
    want = net.forward(x)
    got = cnn.run(cfg["layers"], w, x, "cpu", block=3)
    assert got.shape == want.shape
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err < 1e-5, err
    return got


def test_reference_is_allconvnet():
    cfg = _cfg(os.path.join(CONFIGS, "allconv-stoch-32.json"))
    y = _against_model(cfg, _recipe("allconv-stoch-32").source_model(kt, cfg), B=5)
    assert y.shape == (5, 10)


def test_reference_is_the_narrow_spec():
    cfg = _cfg(os.path.join(DATA, "tiny-stoch-16.json"))
    _against_model(cfg, _recipe("tiny-stoch-16", DATA).source_model(kt, cfg), B=7)


def test_reference_is_a_vgg_block():
    """VGG-16's layer kinds (3x3 convs, the Key-Net 3x3/2 average pool with
    count-include-pad padding, linear on the CHW flattening) at a size the
    CPU holds, odd sizes included."""
    layers = [{"kind": "conv", "name": "conv1_1", "in": 3, "out": 8, "k": 3, "stride": 1},
              {"kind": "relu", "name": "relu1_1"},
              {"kind": "avgpool", "name": "pool1", "k": 3, "stride": 2},
              {"kind": "conv", "name": "conv2_1", "in": 8, "out": 16, "k": 3, "stride": 1},
              {"kind": "relu", "name": "relu2_1"},
              {"kind": "avgpool", "name": "pool2", "k": 3, "stride": 2},
              {"kind": "linear", "name": "fc6", "in": 16 * 5 * 5, "out": 12},
              {"kind": "relu", "name": "relu6"},
              {"kind": "dropout", "name": "dropout7"},
              {"kind": "linear", "name": "fc7", "in": 12, "out": 6}]
    cfg = {"inshape": [3, 22, 22], "layers": layers,
           "input": {"low": 0.0, "high": 255.0, "mean": [93.594, 104.7624, 129.1863],
                     "std": [1.0, 1.0, 1.0]},
           "weights": {"seed": 9, "init": "he_normal", "bias_std": 0.01}}
    m = specs
    net = m.Model([m.Conv2d("conv1_1", 3, 8, 3), m.ReLU("relu1_1"), m.AvgPool2d("pool1", 3, 2),
                   m.Conv2d("conv2_1", 8, 16, 3), m.ReLU("relu2_1"), m.AvgPool2d("pool2", 3, 2),
                   m.Linear("fc6", 400, 12), m.ReLU("relu6"), m.Dropout("dropout7"),
                   m.Linear("fc7", 12, 6)], inshape=(3, 22, 22))
    _against_model(cfg, net, B=4)


def test_images_follow_the_seed_and_the_range():
    cfg = _cfg(os.path.join(CONFIGS, "vgg16-orth-224.json"))
    cfg = dict(cfg, inshape=[3, 8, 8])
    a = harness.make_images(cfg, 4, 2 ** 31 + 5, "cpu")
    assert torch.equal(a, harness.make_images(cfg, 4, 2 ** 31 + 5, "cpu"))
    assert not torch.equal(a, harness.make_images(cfg, 4, 2 ** 31 + 6, "cpu"))
    mean = torch.tensor(cfg["input"]["mean"])[None, :, None, None]
    assert float((a + mean).min()) >= 0.0 and float((a + mean).max()) < 255.0


def test_reference_turns_tf32_off_and_back():
    before = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with cnn.ieee_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        # the legacy flag alone leaves torch (2.13 here) reading the precision
        # as mixed, and get_float32_matmul_precision raises in later tests
        torch.set_float32_matmul_precision(precision)
