"""Residual nets on the port's normal path: a narrow ResNet with option-A
shortcuts (the 7x7/2 stem, the pool, a stage of two identity blocks and a
stage of an option-A block and an identity block, the global pool and fc,
at 3x32x32; tests/data/tiny-resnet-32.json) keyed with IdentityKeynet,
PermutationKeynet and the orth recipe of the resnet34a-orth-224
configuration, against the benchmark's plain reference
(kbench/reference/resnet.py) and the port's own Model.forward, with the
benchmark's He-normal weights; the keyed shortcut against A_out·S·A_src⁻¹;
the snapshot round trip; the span keynet.residual and the counter
profiling.RESIDUAL with the benchmark's reading of them
(kbench/residual.py); the frozen harness on resnet34a-orth-224's
configuration; dp and tp over gloo ranks; and chain nets' plans, which
stay as they were.  Imports no JAX.

The card test (marked ``cuda``; it skips without a card) serves the orth
net with its size gates lowered, so that its convs take factored chains
and its pool a channel broadcast, on the H100:

    python -m pytest --noconftest -m cuda tests/test_torch_resnet.py
"""

import importlib.util
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import keynet_tpu_torch as kt
from keynet_tpu_torch import profiling
from keynet_tpu_torch.keys import keygen
from keynet_tpu_torch.layer import KeyedLayer
from keynet_tpu_torch.models import specs
from keynet_tpu_torch.ops.operators import EllOp
from keynet_tpu_torch.toeplitz import toeplitz_shortcut
from kbench import harness, residual, spans, yardstick
from kbench import weights as kweights

ROOT = harness.ROOT
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TINY = "tiny-resnet-32"
with open(os.path.join(DATA, TINY + ".json")) as _f:
    CFG = json.load(_f)
SHAPE = tuple(CFG["inshape"])
BIG = os.path.join(ROOT, "kbench", "configs", "resnet34a-orth-224.json")
B = 4
TOL = 1e-5
ORTH = {k: v for k, v in CFG["keys"].items() if k != "factory"}
FACTORIES = {"identity": lambda net, **kw: kt.IdentityKeynet(SHAPE, net, **kw),
             "permutation": lambda net, **kw: kt.PermutationKeynet(SHAPE, net, **kw),
             "orth": lambda net, **kw: kt.Keynet(SHAPE, net, **dict(ORTH, **kw))}
BLOCKS = ["layer1.0.relu2", "layer1.1.relu2", "layer2.0.relu2", "layer2.1.relu2"]
# size gates lowered so that the narrow net's convs leave the dense route
GATES = {"STREAM_NNZ": 20_000, "DENSE_MAX_BYTES": 1 << 16, "POOL_FACTOR_MIN_N": 1}


def _reference():
    spec = importlib.util.spec_from_file_location(
        "test_resnet_reference", os.path.join(ROOT, "kbench", "reference", "resnet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def narrow():
    net = kt.models.ResNetA((2, 2), (8, 16), stem=8, num_classes=CFG["num_classes"],
                            inshape=SHAPE)
    net.load_torch_state_dict(kweights.state_dict(kweights.he_normal(CFG)))
    return net


def close(y, ref, tol=TOL):
    y, ref = torch.as_tensor(y), torch.as_tensor(ref)
    assert y.shape == ref.shape
    return float((y - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))


class gates:
    """GLOBAL keys set for the block, restored after."""

    def __init__(self, **keys):
        self.keys = keys

    def __enter__(self):
        G = kt.globals.GLOBAL
        self.saved = {k: G.get(k) for k in self.keys}
        G.update(self.keys)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                kt.globals.GLOBAL.pop(k, None)
            else:
                kt.globals.GLOBAL[k] = v


@pytest.fixture(scope="module")
def images():
    return harness.make_images(CFG, B, 2 ** 33 + 7, "cpu")


@pytest.fixture(scope="module")
def keyed():
    """name -> (sensor, knet) of the narrow net, converted once."""
    net = narrow()
    return {name: f(net, seed=0, device="cpu") for name, f in FACTORIES.items()}


# ------------------------------------------------------------ the model spec

def test_spec_edges_and_shapes():
    net = narrow()
    shapes = net.netshape()
    assert [shapes[r].get("residual") for r in BLOCKS] == \
        ["pool1", "layer1.0.relu2", "layer1.1.relu2", "layer2.0.relu2"]
    assert shapes["avgpool"]["outshape"] == (16, 1, 1)
    assert net.residual_sources() == {"pool1", "layer1.0.relu2", "layer1.1.relu2",
                                      "layer2.0.relu2"}
    x = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    y = specs.shortcut_apply(x, (5, 2, 2))
    assert torch.equal(y[:, :3], x[:, :, ::2, ::2]) and not y[:, 3:].any()
    with pytest.raises(ValueError):
        specs.shortcut_shape((8, 4, 4), (4, 4, 4))      # fewer channels
    with pytest.raises(ValueError):
        specs.shortcut_shape((8, 7, 7), (8, 4, 4))      # no stride gives 4 from 7
    bad = specs.Model([specs.Conv2d("c", 3, 4, 3), specs.ReLU("r", residual="later")],
                      inshape=(3, 4, 4))
    with pytest.raises(AssertionError):
        bad.netshape()


def test_reference_and_spec_agree(images):
    """The port's Model.forward and the benchmark's plain reference: the same
    residual net."""
    ref = _reference().run(CFG["layers"], kweights.he_normal(CFG), images, "cpu")
    assert close(narrow().forward(images), ref, 1e-6)


# ------------------------------------------------------------ keyed == source

@pytest.mark.parametrize("name", list(FACTORIES))
def test_keyed_equals_reference(keyed, images, name):
    sensor, knet = keyed[name]
    assert list(knet.residuals()) == BLOCKS
    y = knet.forward(sensor.fromtensor(images).encrypt().tensor())
    ref = _reference().run(CFG["layers"], kweights.he_normal(CFG), images, "cpu")
    assert close(y, ref)
    assert close(y, narrow().forward(images))


@pytest.mark.parametrize("name", list(FACTORIES))
def test_shortcut_routes(keyed, name):
    """Between ReLU-restricted keys a shortcut is one gain a row, an ELL
    gather of K = 1; from the orth-keyed pool it reads that key's fill."""
    _, knet = keyed[name]
    for relu, (src, sc) in knet.residuals().items():
        assert isinstance(sc.op(), EllOp) and sc._layertype == "shortcut"
        if src != "pool1" or name != "orth":
            assert sc.op().cols.shape[1] == 1
    assert knet.residuals()["layer2.0.relu2"][1].shape == (16 * 4 * 4 + 1, 8 * 8 * 8 + 1)


def _dense(op, n_in):
    return op.apply(torch.eye(n_in)).T.numpy()


@pytest.mark.parametrize("src", ["orth", "relu"])
@pytest.mark.parametrize("inshape,outshape", [((8, 8, 8), (8, 8, 8)),
                                              ((8, 8, 8), (16, 4, 4))])
def test_keyed_shortcut_is_the_sandwich(src, inshape, outshape):
    """Ŝ = A_out·S·A_src⁻¹ with a zero homogeneous row, A_out a ReLU's key
    (a local permutation with positive gains), A_src an orth or a ReLU key."""
    rng = np.random.default_rng(4)
    relu_keys = dict(local_geometric="permutation", local_photometric="uniform_random_gain",
                     beta=1.0, blocksize=4, rng=rng)
    orth_keys = dict(local_geometric="givens_orthogonal", alpha=2, blocksize=4,
                     local_photometric="uniform_random_affine", beta=1.0, gamma=1.0, rng=rng)
    A_src, A_src_inv = keygen(inshape, **(orth_keys if src == "orth" else relu_keys))
    A_out, _ = keygen(outshape, **relu_keys)
    sc = KeyedLayer(specs.Shortcut("r"), inshape, outshape, A_out, A_src_inv)
    S = toeplitz_shortcut(inshape, outshape).toarray()
    assert S[-1].sum() == 0 and S[:, -1].sum() == 0
    want = A_out.toarray() @ S @ A_src_inv.toarray()
    want[-1] = 0
    got = _dense(sc.op(), want.shape[1])
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got[-1].any()
    assert isinstance(sc.op(), EllOp)
    if src == "relu":
        assert sc.op().cols.shape[1] == 1
    # the keyed shortcut carries the plaintext's shortcut: Ŝ·(A_src·x) = A_out·S·x
    x = np.append(rng.normal(size=int(np.prod(inshape))), 1.0)
    y = got @ (A_src.toarray() @ x)
    np.testing.assert_allclose(y, A_out.toarray() @ (S @ x), atol=1e-5)


# ------------------------------------------------------------ the residual add

def _ell(K, n_out=300, n_in=500, seed=0):
    """cols, vals (n_out, K) of a keyed-shortcut-like ELL: rows of K
    distinct columns (a random start, then steps of 17), every fifth row
    all padding (value 0)."""
    g = torch.Generator().manual_seed(seed)
    start = torch.randint(0, n_in, (n_out, 1), generator=g)
    cols = (start + 17 * torch.arange(K)) % n_in
    vals = torch.randn(n_out, K, generator=g)
    vals[::5] = 0
    return cols.to(torch.int32), vals


@pytest.mark.parametrize("K", [1, 3, 6])
def test_shortcut_ell(K):
    """An EllOp of a keyed shortcut's form (K distinct columns a row, some
    rows all padding): its product, and the input coordinates its non-zero
    entries read (read_cols, which profiling.RESIDUAL records)."""
    cols, vals = _ell(K)
    op = EllOp(cols, vals, (300, 500), int((vals != 0).sum()))
    x = torch.randn(5, 500)
    dense = torch.zeros(300, 500)
    dense[torch.arange(300)[:, None].expand(-1, K), cols.long()] = vals
    assert torch.allclose(op.apply(x), x @ dense.T, atol=1e-5)
    assert op.read_cols() == int(torch.unique(cols[vals != 0]).numel())


# ------------------------------------------------------------ snapshots

def test_snapshot_round_trip_is_bitwise(keyed, images, tmp_path):
    sensor, knet = keyed["orth"]
    path = str(tmp_path / "resnet.npz")
    kt.save_keynet(path, knet, sensor=sensor, include_keys=True)
    sensor2, knet2 = kt.load_keynet(path, device="cpu")
    assert {r: s for r, (s, _) in knet2.residuals().items()} == \
        {r: s for r, (s, _) in knet.residuals().items()}
    assert list(knet2.layers()) == list(knet.layers())
    for r, (_, sc) in knet2.residuals().items():
        sc0 = knet.residuals()[r][1]
        assert repr(sc) == repr(sc0)
        for k, v in sc.op().arrays().items():
            assert torch.equal(v, sc0.op().arrays()[k])
    xc = sensor.fromtensor(images).encrypt().tensor()
    assert torch.equal(sensor2.fromtensor(images).encrypt().tensor(), xc)
    assert torch.equal(knet2.forward(xc), knet.forward(xc))
    assert knet2.num_parameters() == knet.num_parameters()


def test_chain_snapshot_has_no_residual_entry(tmp_path):
    sensor, knet = kt.PermutationKeynet((1, 28, 28), kt.models.LeNet_AvgPool(seed=1),
                                        seed=2, device="cpu")
    path = str(tmp_path / "lenet.npz")
    kt.save_keynet(path, knet, sensor=sensor, include_keys=True)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
    assert {e["kind"] for e in manifest["layers"]} & {"residual_relu"} == set()
    _, knet2 = kt.load_keynet(path, device="cpu")
    assert knet2.residuals() == {}


# ------------------------------------------------------------ the plan, span and counter

def _names(prof):
    return [e.name for e in prof.events() if e.name.startswith("keynet.")]


def test_plan_keeps_block_inputs_until_their_add(keyed):
    _, knet = keyed["orth"]
    knet._build()
    at = {name: j for j, (name, _) in enumerate(knet._stages)}
    assert knet._keep == {at[s]: at[r] for r, (s, _) in knet.residuals().items()}
    assert sorted(knet._adds) == sorted(at[r] for r in BLOCKS)
    n_stage_ops = sum(relu is not None for _, relu in knet._stages)
    assert len(knet._ops) == n_stage_ops + len(BLOCKS)
    assert [k for _, k, _ in knet._adds.values()] == list(range(n_stage_ops, len(knet._ops)))


def test_residual_span_and_counter(keyed, images):
    sensor, knet = keyed["orth"]
    xc = sensor.fromtensor(images).encrypt().tensor()
    before = profiling.RESIDUAL["applies"]
    y0 = knet.run(xc)
    assert profiling.RESIDUAL["applies"] == before + len(BLOCKS)
    recs = [profiling.RESIDUAL["shortcuts"][r] for r in BLOCKS]
    assert [r["last"] for r in recs] == list(range(before + 1, before + len(BLOCKS) + 1))
    for r, (_, sc) in zip(recs, knet.residuals().values()):
        assert r["B"] == B and r["x_itemsize"] == 4
        assert (r["rows_out"], r["rows_in"]) == sc.shape and r["nnz"] == sc.nnz()
        assert r["op_bytes"] == sc.device_bytes()
    # the option-A shortcut reads a quarter of its source's pixels, the
    # identity ones every coordinate but the homogeneous one
    assert recs[2]["x_cols"] == 8 * 4 * 4 and recs[3]["x_cols"] == 16 * 4 * 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = knet.run(xc)
    assert torch.equal(y, y0)
    names = _names(prof)
    assert names.count(residual.SPAN) == len(BLOCKS)
    ev = {e.name: e for e in prof.events() if e.name.startswith("keynet.layer/")}
    for r in BLOCKS:
        stage = ev["keynet.layer/%s/relu" % r].time_range
        inner = [e.time_range for e in prof.events() if e.name == residual.SPAN
                 and stage.start <= e.time_range.start and e.time_range.end <= stage.end]
        assert len(inner) == 1


def test_counter_gives_the_request_bytes(keyed, images):
    sensor, knet = keyed["orth"]
    knet.run(sensor.fromtensor(images).encrypt().tensor())
    w = residual.request_work(profiling.RESIDUAL, B, yardstick.PEAKS["f32"], len(BLOCKS))
    want = 0
    for relu in BLOCKS:
        sc = knet.residuals()[relu][1]
        op = sc.op()
        x_cols = int(torch.unique(op.cols[op.vals != 0]).numel())
        want += B * x_cols * 4 + 2 * B * sc.shape[0] * 4 + op.cols.numel() * 8
    assert w["bytes"] == want
    assert residual.request_work(profiling.RESIDUAL, B + 1, 67e12, len(BLOCKS)) is None


# ------------------------------------------------------------ the benchmark's readers

MAIN = (1, 1)
SC = {"name": "r", "last": 7, "B": 2, "x_itemsize": 4, "rows_out": 65, "rows_in": 129,
      "nnz": 64, "x_cols": 32, "op_bytes": 65 * 8}


def _x(name, cat, ts, dur, thread=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _request(t, c, with_span=True):
    """One request at ``t`` (µs): forward holding run holding the stage
    conv2/EllOp [t+20, t+100) and the stage relu2/relu [t+100, t+300);
    with ``with_span`` the ReLU stage holds keynet.residual [t+110, t+250).
    Kernels: the conv's (40 µs), a gather (20) and a multiply-add (30)
    launched in the span, the clamp (10) launched after it."""
    ev = [_x("keynet.forward", "user_annotation", t, 400),
          _x("keynet.run", "user_annotation", t + 10, 380),
          _x("keynet.layer/conv2/EllOp", "user_annotation", t + 20, 80),
          _x("keynet.layer/relu2/relu", "user_annotation", t + 100, 200)]
    if with_span:
        ev.append(_x(residual.SPAN, "user_annotation", t + 110, 140))
    for k, (ts, name, dur) in enumerate([(25, "conv", 40), (120, "index_select", 20),
                                         (150, "addcmul", 30), (260, "clamp", 10)]):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + ts, 3, corr=c + k))
        ev.append(_x(name, "kernel", t + ts + 5, dur, thread=(0, 7), corr=c + k))
    return ev


def _write(tmp_path, cell, with_span=True):
    ev = [_x("kbench.window", "user_annotation", 0, 1000)]
    ev += _request(100, 10, with_span) + _request(600, 20, with_span)
    with open(tmp_path / (cell + ".json"), "w") as f:
        json.dump({"traceEvents": ev}, f)
    return {"cell": cell, "batch": 2, "step_peak": yardstick.PEAKS["f32"],
            "trace": {"span_us": 1000.0}}


def _reader(name):
    return harness.load_module(os.path.join(ROOT, "kbench", "metrics", name + ".py"),
                               "test_residual_reader_" + name.replace(".", "_"))


def _counter(monkeypatch, shortcuts, applies=7):
    prof = types.SimpleNamespace(RESIDUAL={"applies": applies, "shortcuts": shortcuts})
    monkeypatch.setitem(sys.modules, "keynet_tpu_torch.profiling", prof)


def test_reduce_by_hand(tmp_path):
    rec = _write(tmp_path, "res.b2")
    with open(tmp_path / "res.b2.json") as f:
        trace = json.load(f)
    assert residual.reduce(trace) == {"requests": 2, "spans": 2, "kernel_us": 2 * 50.0}
    # spans.py charges the same kernels, and the clamp, to the ReLU's stage
    s = spans.reduce(trace)
    assert s["coverage"] == 1.0 and s["kind_us"]["other"] == 2 * 100.0
    assert residual.for_record(rec, traces=str(tmp_path))["kernel_us"] == 100.0


def test_readers(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "TRACES", str(tmp_path))
    rec = _write(tmp_path, "rr.b2")
    ms, roof = _reader("residual_ms.batch"), _reader("residual_roofline.batch")
    assert ms.read(rec) == pytest.approx(0.05, rel=1e-12)
    # SC by hand: 32 input coordinates, the 65-row branch read and the sum
    # written at B = 2, the ELL's 65 values and indices
    nbytes = 2 * 32 * 4 + 2 * 2 * 65 * 4 + 65 * 8
    assert residual.apply_work(SC) == {"flops": 2.0 * 2 * 64, "bytes": nbytes}
    want = 100.0 * (nbytes / 3.35e12) * 2 / 100e-6
    _counter(monkeypatch, {"r": SC})
    assert roof.read(rec) == pytest.approx(want, rel=1e-12)
    # an earlier apply of another shortcut is left out
    _counter(monkeypatch, {"q": dict(SC, name="q", last=3, B=5), "r": SC})
    assert roof.read(rec) == pytest.approx(want, rel=1e-12)
    # the counter's last apply is not the request's
    _counter(monkeypatch, {"r": dict(SC, last=6)})
    assert roof.read(rec) is None
    # a shortcut last applied at another batch
    _counter(monkeypatch, {"r": dict(SC, B=4)})
    assert roof.read(rec) is None
    # a program without the counter
    monkeypatch.setitem(sys.modules, "keynet_tpu_torch.profiling", types.SimpleNamespace())
    assert roof.read(rec) is None


def test_readers_read_nothing_without_a_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "TRACES", str(tmp_path))
    _counter(monkeypatch, {"r": SC})
    for rec in ({"cell": "none.b2", "batch": 2, "step_peak": 67e12, "trace": None},
                {"cell": "none.b2", "batch": 2, "step_peak": 67e12,
                 "trace": {"span_us": 1000.0}}):
        assert _reader("residual_ms.batch").read(rec) is None
        assert _reader("residual_roofline.batch").read(rec) is None
    # a program without the span: a chain net's trace, or the parent's
    rec = _write(tmp_path, "bare.b2", with_span=False)
    assert spans.for_record(rec) is not None
    assert _reader("residual_ms.batch").read(rec) is None
    assert _reader("residual_roofline.batch").read(rec) is None


# ------------------------------------------------------------ errors

def test_unservable_residuals_raise():
    # a ReLU follows the named conv: its output is not a keyed stage of its own
    net = specs.Model([specs.Conv2d("c1", 3, 4, 3), specs.ReLU("relu1"),
                       specs.Conv2d("c2", 4, 4, 3), specs.ReLU("relu2", residual="c1")],
                      inshape=(3, 8, 8))
    with pytest.raises(ValueError, match="not a keyed stage"):
        kt.IdentityKeynet((3, 8, 8), net, seed=0, device="cpu")
    # a residual ReLU after a fused batchnorm would clamp inside the op
    net = specs.Model([specs.Conv2d("c1", 3, 4, 3), specs.ReLU("relu1"),
                       specs.Conv2d("c2", 4, 4, 3), specs.BatchNorm2d("c2_bn", 4),
                       specs.ReLU("relu2", residual="relu1")], inshape=(3, 8, 8))
    with pytest.raises(ValueError, match="batchnorm"):
        kt.IdentityKeynet((3, 8, 8), net, seed=0, device="cpu")


def test_run_refuses_a_plan_without_its_shortcuts(keyed, images):
    """A sharded plan made for the stages alone cannot serve a residual net:
    run says so instead of adding nothing."""
    sensor, knet = keyed["orth"]
    knet._build()
    n = sum(relu is not None for _, relu in knet._stages)
    xc = sensor.fromtensor(images).encrypt().tensor()
    with pytest.raises(ValueError, match="shortcuts"):
        knet.run(xc, knet._ops[:n])


# ------------------------------------------------------------ chain nets

def _chain_run(knet, x):
    """KeyedModel.run as it was before residual nets: each stage's op, a
    ReLU between."""
    i = 0
    for _, relu in knet._stages:
        if relu is None:
            x = torch.clamp_min(x, 0.0)
            continue
        x = knet._ops[i].apply(x)
        if relu:
            x = torch.clamp_min(x, 0.0)
        i += 1
    return x


@pytest.mark.parametrize("name", ["AllConvNet", "LeNet_AvgPool"])
def test_chain_nets_keep_their_plan(name):
    net = getattr(kt.models, name)(seed=1)
    shape = (3, 32, 32) if name == "AllConvNet" else (1, 28, 28)
    sensor, knet = kt.PermutationKeynet(shape, net, seed=2, device="cpu")
    knet._build()
    stages = [(n, None) if l == "relu" else (n, bool(l._relu))
              for n, l in knet.layers().items()]
    assert knet._stages == stages and knet._keep == {} and knet._adds == {}
    assert len(knet._ops) == sum(relu is not None for _, relu in stages)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, *shape)), dtype=torch.float32)
    xc = sensor.fromtensor(x).encrypt().tensor()
    before = profiling.RESIDUAL["applies"]
    assert torch.equal(knet.run(xc), _chain_run(knet, xc))
    assert profiling.RESIDUAL["applies"] == before


# ------------------------------------------------------------ the frozen harness

def test_frozen_harness_takes_the_configuration(monkeypatch, tmp_path):
    """resnet34a-orth-224's layer list through the benchmark's frozen code:
    yardstick's source FLOPs, the He-normal draws, ensure_snapshot's check
    of the zoo spec's parameters (the conversion itself is left to the card)."""
    with open(BIG) as f:
        cfg = json.load(f)
    assert yardstick.source_flops(cfg["layers"], cfg["inshape"]) == 7_288_987_648
    net = kt.models.ResNet34A(num_classes=cfg["num_classes"])
    w = kweights.he_normal(cfg)
    assert {n: {k: v.shape for k, v in p.items()} for n, p in net.params.items()} == \
        {n: {k: v.shape for k, v in p.items()} for n, p in w.items()}
    cell = harness.Cell(ROOT, "resnet34a-orth-224.b32")
    assert cell.cfg == cfg and cell.cfg["reference"] == "resnet"

    class Stop(Exception):
        pass

    real = cell.recipe()

    def convert(kt_, cfg_, net_, device):
        for n, p in net_.params.items():          # the configuration's weights loaded
            for k, v in p.items():
                assert np.array_equal(v, w[n][k])
        raise Stop

    monkeypatch.setattr(cell, "recipe", lambda: types.SimpleNamespace(
        source_model=real.source_model, convert=convert))
    with pytest.raises(Stop):
        harness.ensure_snapshot(kt, cell, str(tmp_path / "cache"))
    assert os.listdir(tmp_path / "cache") == []


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """A checkout root with this kbench and BENCHMARK.json plus the narrow
    residual configuration and its cell on the b32 mix."""
    import shutil
    d = tmp_path_factory.mktemp("root")
    shutil.copytree(os.path.join(ROOT, "kbench"), d / "kbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    for ext in (".json", ".py"):
        shutil.copy(os.path.join(DATA, TINY + ext), d / "kbench" / "configs")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": TINY, "source": "tests", "reduced": [],
                             "file": "kbench/configs/%s.json" % TINY, "why": "tests"})
    bench["workloads"].append({"name": "tinyres.b32", "config": TINY, "traffic": "b32",
                               "chips": 1, "why": "tests"})
    with open(d / "kbench" / "workloads" / "tinyres.b32.json", "w") as f:
        json.dump({"correct": {"max_rel_err": 1e-4}}, f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "resnet34a-orth-224.b32" in m.get("workloads", ()):
            m["workloads"].append("tinyres.b32")
    with open(d / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(d)


@pytest.mark.parametrize("trace", [False, True])
def test_cpu_cell_run(bench_root, trace):
    """The harness runs a residual cell end to end on the CPU: set-up from a
    snapshot it converts, the window, the comparison with the resnet
    reference; the device readers find nothing here."""
    result, compared = harness.run_cell("tinyres.b32", 2 ** 35 + 3, 0.3, trace,
                                        time.perf_counter(), root=bench_root, device="cpu")
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert 0 < compared[0][1] < 1e-4
    assert set(result["metrics"]) == ({"load_read_s", "load_restore_s"} if trace
                                      else {"imgs_per_s", "setup_s"})
    if trace:
        with open(os.path.join(bench_root, "kbench", "cache", "traces",
                               "tinyres.b32.json")) as f:
            r = residual.reduce(json.load(f))
        assert r["requests"] > 0 and r["spans"] == len(BLOCKS) * r["requests"]


# ------------------------------------------------------------ dp and tp

def test_dp_and_tp_match_the_single_forward(images):
    from keynet_tpu_torch.parallel import launch
    import torch_resnet_ranks
    res = launch(torch_resnet_ranks.resnet_rank, 2, args=(CFG, images.numpy()),
                 backend="gloo", deadline=240)
    for r in res:
        for key in ("dp", "dp_tp"):
            assert close(r[key], r["single"], 1e-4)
        np.testing.assert_array_equal(r["dp"], res[0]["dp"])
    # the shortcuts' ELL ops follow the stages' ops, and tp splits them
    classes = res[0]["tp_classes"][res[0]["n_stage_ops"]:]
    assert classes == ["TpShardedEllOp"] * len(BLOCKS)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_card_equals_cpu(images):
    """The orth net with its gates lowered (chain routes) on the card: its
    output equals the CPU's within TOL, and the reference's within the
    narrow cell's limit (the chains' masks cost a few f32 roundings: the
    CPU's own output is 1.2e-5 of the scale off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    from keynet_tpu_torch.ops import block_ell
    block_ell.build()
    with gates(**GATES):
        sensor, knet = FACTORIES["orth"](narrow(), seed=0, device="cpu")
    xc = sensor.fromtensor(images).encrypt().tensor()
    y_cpu = knet.forward(xc)
    with gates(**GATES):
        sensor, knet = FACTORIES["orth"](narrow(), seed=0, device="cuda")
    y = knet.forward(xc.cuda())
    torch.cuda.synchronize()
    assert close(y.cpu(), y_cpu)
    ref = _reference().run(CFG["layers"], kweights.he_normal(CFG), images, "cuda")
    assert close(y.cpu(), ref, 1e-4)
