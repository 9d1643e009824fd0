"""Side branches in a configuration's layer list, on the CPU: a ``conv``
entry with ``"input"`` reads an earlier layer's output off the chain (the
option-B projection shortcut of ResNet-50, He et al., arXiv:1512.03385
§3.3) and a ``relu`` entry's ``"residual"`` adds it.  ``source_flops``
counts it and rejects a malformed one, ``he_normal`` draws it,
``reference/resnet.py`` runs it as a hand-written block does, and the four
configurations keep their frozen FLOP counts."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kbench import weights, yardstick
from kbench.reference import resnet

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


def conv(name, cin, cout, k, stride=1, **kw):
    return dict({"kind": "conv", "name": name, "in": cin, "out": cout, "k": k,
                 "stride": stride}, **kw)


def relu(name, **kw):
    return dict({"kind": "relu", "name": name}, **kw)


def bottleneck(prefix, src, cin, width, stride, stride_on="conv1"):
    """A bottleneck block (1x1, 3x3, 1x1 to 4·width) on the output of
    ``src``, with a 1x1 projection where the shape changes, written as the
    schema asks: the side conv after the block's last conv."""
    p = prefix + "."
    layers = [conv(p + "conv1", cin, width, 1, stride if stride_on == "conv1" else 1),
              relu(p + "relu1"),
              conv(p + "conv2", width, width, 3, stride if stride_on == "conv2" else 1),
              relu(p + "relu2"),
              conv(p + "conv3", width, 4 * width, 1)]
    res = src
    if stride != 1 or cin != 4 * width:
        layers.append(conv(p + "downsample", cin, 4 * width, 1, stride, input=src))
        res = p + "downsample"
    return layers + [relu(p + "relu3", residual=res)]


def resnet50(stride_on="conv1"):
    """ResNet-50's layer list (Table 1's 50-layer column) at 3x224x224 with
    the Key-Net stem pool, as a configuration would give it."""
    layers = [conv("conv1", 3, 64, 7, 2), relu("relu1"),
              {"kind": "avgpool", "name": "pool1", "k": 3, "stride": 2}]
    src, cin = "pool1", 64
    for i, (width, n, stride) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3),
                                               (1, 2, 2, 2)), 1):
        for b in range(n):
            prefix = "layer%d.%d" % (i, b)
            layers += bottleneck(prefix, src, cin, width, stride if b == 0 else 1, stride_on)
            src, cin = prefix + ".relu3", 4 * width
    return layers + [{"kind": "avgpool", "name": "avgpool", "k": 7, "stride": 7,
                      "global": True},
                     {"kind": "linear", "name": "fc", "in": 2048, "out": 1000}]


def _cfg(layers, inshape, seed=7):
    return {"inshape": list(inshape), "layers": layers,
            "weights": {"seed": seed, "init": "he_normal", "bias_std": 0.01}}


# ------------------------------------------------------------ source_flops

def test_source_flops_of_a_projection_block_by_hand():
    """8x8x8 in; conv1 1x1/2 8->4 on 4x4; conv2 3x3 4->4 on 4x4; conv3 1x1
    4->16 on 4x4; the projection 1x1/2 8->16 on 4x4 from the block's input;
    then fc 256->10."""
    layers = [conv("stem", 3, 8, 3), relu("r0")] + bottleneck("b", "r0", 8, 4, 2) + \
        [{"kind": "linear", "name": "fc", "in": 16 * 4 * 4, "out": 10}]
    macs = (3 * 9 * 8 * 64          # the stem on 8x8
            + 8 * 4 * 16            # conv1
            + 4 * 9 * 4 * 16        # conv2
            + 4 * 16 * 16           # conv3
            + 8 * 16 * 16           # the projection
            + 256 * 10)
    assert yardstick.source_flops(layers, (3, 8, 8)) == 2 * macs
    # without the projection's term the count is the chain's alone
    chain = [l for l in layers if not l.get("input")]
    chain[-2] = relu("b.relu3")
    assert yardstick.source_flops(chain, (3, 8, 8)) == 2 * (macs - 8 * 16 * 16)


@pytest.mark.parametrize("stride_on,macs", [("conv1", 3_857_973_248),
                                            ("conv2", 4_089_184_256)])
def test_resnet50_source_macs(stride_on, macs):
    """The paper's design (the stride on the first 1x1; Table 1: 3.8e9) and
    torchvision's v1.5 (the stride on the 3x3)."""
    assert yardstick.source_macs(resnet50(stride_on), (3, 224, 224)) == macs


@pytest.mark.parametrize("name,flops", [("vgg16-orth-224", 30_953_816_064),
                                        ("vgg16-stoch-224", 30_953_816_064),
                                        ("allconv-stoch-32", 562_478_032),
                                        ("resnet34a-orth-224", 7_288_987_648)])
def test_configurations_keep_their_frozen_flops(name, flops):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        cfg = json.load(f)
    assert yardstick.source_flops(cfg["layers"], cfg["inshape"]) == flops


def _malformed():
    """(what is wrong, layer list) at 3x8x8: each a one-edit break of a
    well-formed projection block."""
    good = [conv("stem", 3, 8, 3), relu("r0")] + bottleneck("b", "r0", 8, 4, 2)
    ds = next(i for i, l in enumerate(good) if l.get("input"))

    def edit(i, **kw):
        out = [dict(l) for l in good]
        out[i].update(kw)
        return out
    moved = [dict(l) for l in good]
    moved.insert(ds + 2, moved.pop(ds))          # the side conv after its ReLU
    return [("unknown input", edit(ds, input="nowhere")),
            ("input of a later layer", edit(ds, input="b.relu3")),
            ("wrong in", edit(ds, **{"in": 3})),
            ("wrong out", edit(ds, out=8)),
            ("wrong stride", edit(ds, stride=1)),
            ("added before it is computed", moved),
            ("input on a relu", edit(1, input="stem"))]


@pytest.mark.parametrize("what,layers", _malformed(), ids=[w for w, _ in _malformed()])
def test_malformed_side_branch_raises(what, layers):
    with pytest.raises(ValueError):
        yardstick.source_flops(layers, (3, 8, 8))


# ------------------------------------------------------------------ weights

def test_he_normal_draws_resnet50():
    cfg = _cfg(resnet50(), (3, 224, 224))
    w = weights.he_normal(cfg)
    kinds = [l["kind"] for l in cfg["layers"] if l["name"] in w]
    assert kinds.count("conv") == 53 and kinds.count("linear") == 1
    assert sum(a.size for p in w.values() for a in p.values()) == 25_530_472
    ds = w["layer3.0.downsample"]["weight"]
    assert ds.shape == (1024, 512, 1, 1) and ds.dtype == np.float32
    assert abs(ds.std() / np.sqrt(2.0 / 512) - 1) < 0.05


# ---------------------------------------------------------------- reference

def _hand_block(x, p, name, stride, proj, stride_on="conv1"):
    """A bottleneck block written out in plain torch, torchvision's order
    (BN folded into the biases): x is the block's input."""
    def c(t, layer, s, pad):
        return F.conv2d(t, p[layer]["weight"], p[layer]["bias"], stride=s, padding=pad)
    s1, s2 = (stride, 1) if stride_on == "conv1" else (1, stride)
    y = torch.relu(c(x, name + ".conv1", s1, 0))
    y = torch.relu(c(y, name + ".conv2", s2, 1))
    y = c(y, name + ".conv3", 1, 0)
    return torch.relu(y + (c(x, name + ".downsample", stride, 0) if proj else x))


def _params(cfg):
    return {n: {k: torch.from_numpy(v) for k, v in p.items()}
            for n, p in weights.he_normal(cfg).items()}


@pytest.mark.parametrize("stride_on", ["conv1", "conv2"])
def test_reference_is_a_hand_written_bottleneck(stride_on):
    """3x16x16: a stem, a block with a 1x1/2 projection, a block with the
    identity (the option-A path at equal shapes), the global pool and fc."""
    layers = ([conv("stem", 3, 8, 3), relu("r0")]
              + bottleneck("a", "r0", 8, 4, 2, stride_on)
              + bottleneck("b", "a.relu3", 16, 4, 1, stride_on)
              + [{"kind": "avgpool", "name": "gap", "k": 8, "stride": 8, "global": True},
                 {"kind": "linear", "name": "fc", "in": 16, "out": 10}])
    assert [l["name"] for l in layers if l.get("input")] == ["a.downsample"]
    cfg = _cfg(layers, (3, 16, 16))
    p = _params(cfg)
    x = torch.randn(5, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    got = resnet.run(layers, weights.he_normal(cfg), x, "cpu", block=2)
    y = torch.relu(F.conv2d(x, p["stem"]["weight"], p["stem"]["bias"], padding=1))
    y = _hand_block(y, p, "a", 2, True, stride_on)
    y = _hand_block(y, p, "b", 1, False, stride_on)
    want = y.mean((2, 3)) @ p["fc"]["weight"].T + p["fc"]["bias"]
    assert got.shape == want.shape == (5, 10)
    assert float((got - want).abs().max()) / float(want.abs().max()) < 1e-6


def test_reference_runs_resnet50():
    """The whole ResNet-50 list on one 3x224x224 image against the blocks
    written out by hand."""
    layers = resnet50()
    cfg = _cfg(layers, (3, 224, 224))
    p = _params(cfg)
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(2))
    got = resnet.run(layers, weights.he_normal(cfg), x, "cpu")
    y = torch.relu(F.conv2d(x, p["conv1"]["weight"], p["conv1"]["bias"], stride=2,
                            padding=3)[:, :, :112, :112])
    y = F.avg_pool2d(F.pad(y, (1, 1, 1, 1)), 3, 2)[:, :, :56, :56]
    for i, n in enumerate((3, 4, 6, 3), 1):
        for b in range(n):
            stride = 2 if b == 0 and i > 1 else 1
            y = _hand_block(y, p, "layer%d.%d" % (i, b), stride, b == 0)
    want = y.mean((2, 3)) @ p["fc"]["weight"].T + p["fc"]["bias"]
    assert got.shape == want.shape == (1, 1000) and torch.isfinite(got).all()
    # 53 f32 convs in another order of rounding: 2.2e-7 on one CPU
    assert float((got - want).abs().max()) / float(want.abs().max()) < 1e-5


def test_reference_rejects_a_mismatched_add():
    layers = [conv("stem", 3, 8, 3), relu("r0")] + bottleneck("b", "r0", 8, 4, 2)
    layers[-2] = dict(layers[-2], stride=1)      # the projection keeps 8x8
    cfg = _cfg(layers, (3, 8, 8))
    with pytest.raises(ValueError):
        resnet.run(layers, weights.he_normal(cfg), torch.zeros(1, 3, 8, 8), "cpu")
