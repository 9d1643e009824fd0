"""The program's spans on the CPU (keynet_tpu_torch.profiling.annotate), on
the narrow net of test_torch_profiling.py, which takes the Block-ELL and
Kronecker routes: under torch.profiler each forward holds keynet.h2d,
keynet.run (one span a stage, named after the op the run plan applies
there: a folded Kronecker chain's TapSumOp, a chained layer's links in
order, a channel-broadcast pool's inner op) and keynet.decrypt; with no
profiler no record_function is made and the outputs are bitwise the same;
load_keynet records its two phases."""

import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import keynet_tpu_torch as kt
from keynet_tpu_torch.ops.operators import ChainedOp, LinearOp

OVERRIDES = {"DENSE_MAX_BYTES": 1 << 20, "ELL_MAX_K": 32}


def _narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)


@pytest.fixture(scope="module")
def keyed():
    G = kt.globals.GLOBAL
    old = {k: G.get(k) for k in OVERRIDES}
    try:
        G.update(OVERRIDES)
        sensor, knet = kt.StochasticKeynet((3, 16, 16), _narrow(kt.models), alpha=2,
                                           blocksize=8, seed=0, device="cpu")
    finally:
        for k, v in old.items():
            if v is None:
                G.pop(k, None)
            else:
                G[k] = v
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3, 16, 16))
                         .astype(np.float32))
    return sensor, knet, sensor.fromtensor(x).encrypt().tensor()


def _tree(prof):
    """The keynet.* spans of a finished trace as (name, [children]) trees,
    children in the order they opened."""
    evs = sorted((e for e in prof.events() if e.name.startswith("keynet.")),
                 key=lambda e: e.time_range.start)
    nodes = {id(e): (e.name, []) for e in evs}
    roots = []
    for e in evs:
        p = e.cpu_parent
        while p is not None and id(p) not in nodes:
            p = p.cpu_parent
        (nodes[id(p)][1] if p is not None else roots).append(nodes[id(e)])
    return roots


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _tree(prof)


def _stage_spans(knet):
    """The span of each stage, named after the op the run plan
    (``knet._ops``) applies there."""
    knet._build()
    ops, names = iter(knet._ops), []
    for layer, l in knet.layers().items():
        names.append("keynet.layer/%s/%s" % (layer, "relu" if l == "relu"
                                             else type(next(ops)).__name__))
    return names


def _kept_chain(rng):
    """A one-layer net whose chain keeps its Kronecker links: its first
    KroneckerOp gathers its input (perm_in), so the run does not fold."""
    from keynet_tpu_torch.layer import KeyedLayer
    from keynet_tpu_torch.ops.operators import KroneckerOp, TapSumOp
    C, p, T = 2, 4, 3

    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    chain = ChainedOp([KroneckerOp(mk(C, C), mk(p, p), mk(C * p),
                                   perm_in=rng.permutation(C * p)),
                       TapSumOp(mk(T, C, C), mk(T, p, p), mk(C * p)),
                       KroneckerOp(mk(C, C), mk(p, p), mk(C * p))])
    kl = KeyedLayer.__new__(KeyedLayer)
    kl._op, kl._relu = chain, True
    return kt.KeyedModel.from_layers({"kept": kl}, (C * p, 1, 1), device="cpu"), chain


def test_each_forward_holds_h2d_run_decrypt(keyed):
    _, knet, xc = keyed
    _, roots = _traced(lambda: (knet.forward(xc), knet.forward(xc)))
    assert [n for n, _ in roots] == ["keynet.forward", "keynet.forward"]
    for _, children in roots:
        assert [n for n, _ in children] == ["keynet.h2d", "keynet.run", "keynet.decrypt"]


def test_run_holds_one_span_a_stage_in_order(keyed):
    _, knet, xc = keyed
    _, roots = _traced(lambda: knet.forward(xc))
    run = roots[0][1][1]
    assert run[0] == "keynet.run"
    assert [n for n, _ in run[1]] == _stage_spans(knet)
    classes = {n.rsplit("/", 1)[1] for n, _ in run[1]}
    assert "ChainedOp" in classes and "DenseOp" in classes
    # conv2 publishes a Kronecker-TapSum-Kronecker chain: the plan runs it folded
    assert [type(op).__name__ for op in knet.layers()["conv2"].op().ops] == \
        ["KroneckerOp", "TapSumOp", "KroneckerOp"]
    assert ("keynet.layer/conv2/TapSumOp", []) in run[1]


def test_chained_layers_hold_their_links_in_order(keyed):
    _, knet, xc = keyed
    _, roots = _traced(lambda: knet.forward(xc))
    stages = dict(roots[0][1][1][1])
    knet._build()
    plan = iter(knet._ops)
    seen = set()
    for layer, l in knet.layers().items():
        op = None if l == "relu" else next(plan)
        if not isinstance(op, ChainedOp):
            continue
        links = ["keynet.link/%d/%s" % (j, type(link).__name__) for j, link in enumerate(op.ops)]
        got = stages["keynet.layer/%s/ChainedOp" % layer]
        assert [n for n, _ in got] == links
        assert all(not children for _, children in got)
        seen |= {n.rsplit("/", 1)[1] for n in links}
    # the narrow net's chain that does not fold takes the Block-ELL route
    assert "PermutedBlockSparseOp" in seen
    # a chain whose Kronecker link gathers keeps its three links, in order
    rng = np.random.default_rng(7)
    kept, chain = _kept_chain(rng)
    x = torch.cat([torch.from_numpy(rng.standard_normal((2, chain.shape[1] - 1))
                                    .astype(np.float32)), torch.ones(2, 1)], dim=1)
    _, roots = _traced(lambda: kept.run(x))
    links = ["keynet.link/%d/%s" % (j, type(link).__name__) for j, link in enumerate(chain.ops)]
    assert roots == [("keynet.run", [("keynet.layer/kept/ChainedOp",
                                      [(n, []) for n in links])])]
    seen |= {n.rsplit("/", 1)[1] for n in links}
    assert {"PermutedBlockSparseOp", "KroneckerOp", "TapSumOp"} <= seen


def test_run_names_the_ops_it_is_given(keyed):
    """The sharded plans pass their own ops through run: the spans name
    those ops' classes."""
    _, knet, xc = keyed

    class Relabelled(LinearOp):
        def __init__(self, op):
            self.op, self.shape = op, op.shape

        def apply(self, x):
            return self.op.apply(x)

    knet._build()
    ops = [Relabelled(op) for op in knet._ops]
    x = torch.as_tensor(xc, dtype=torch.float32)
    y, roots = _traced(lambda: knet.run(x, ops))
    assert roots[0][0] == "keynet.run"
    assert [n for n, _ in roots[0][1]] == [
        n if n.endswith("/relu") else n.rsplit("/", 1)[0] + "/Relabelled"
        for n in _stage_spans(knet)]
    assert torch.equal(y, knet.run(x))


def test_channel_broadcast_layer_holds_its_inner_op():
    """A keyed pool stored as a ChannelBroadcastOp runs its inner op (here
    a DenseOp) inside keynet.link/0/<OpClass>."""
    from keynet_tpu_torch.layer import KeyedLayer
    from keynet_tpu_torch.ops.operators import ChannelBroadcastOp, DenseOp
    rng = np.random.default_rng(5)
    C, p1, p2 = 3, 16, 4
    op = ChannelBroadcastOp(DenseOp(rng.standard_normal((p2, p1)).astype(np.float32)), C,
                            rng.standard_normal(p2).astype(np.float32))
    kl = KeyedLayer.__new__(KeyedLayer)
    kl._op, kl._relu = op, True
    knet = kt.KeyedModel.from_layers({"pool": kl}, (C * p2, 1, 1), device="cpu")
    x = torch.cat([torch.from_numpy(rng.standard_normal((2, C * p1)).astype(np.float32)),
                   torch.ones(2, 1)], dim=1)
    y, roots = _traced(lambda: knet.run(x))
    assert roots == [("keynet.run", [("keynet.layer/pool/ChannelBroadcastOp",
                                      [("keynet.link/0/DenseOp", [])])])]
    assert torch.equal(y, knet.run(x))


@pytest.mark.parametrize("traced", [False, True])
def test_forward_frees_its_input_after_the_first_op(traced):
    """The device copy of the request is freed once the first op has read
    it, with and without a profiler: it does not stay alive through the
    forward (it would add a batch to the device's peak)."""
    import weakref

    from keynet_tpu_torch.layer import KeyedLayer
    seen = []

    class Probe(LinearOp):
        def __init__(self, n, first):
            self.shape, self.first = (n, n), first

        def apply(self, x):
            if self.first:
                seen.append(weakref.ref(x))
            else:
                seen.append(seen[0]() is None)
            return x + 0.0

    layers = {}
    for name, first in (("a", True), ("b", False)):
        kl = KeyedLayer.__new__(KeyedLayer)
        kl._op, kl._relu = Probe(5, first), False
        layers[name] = kl
    knet = kt.KeyedModel.from_layers(layers, (4, 1, 1), device="cpu")
    xc = torch.ones(2, 5)
    if traced:
        _traced(lambda: knet.forward(xc.numpy()))
    else:
        knet.forward(xc.numpy())
    assert seen[1] is True


def test_no_profiler_no_record_function(keyed, monkeypatch):
    _, knet, xc = keyed
    calls = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __init__(self, *a, **k):
            calls.append(a[0] if a else k.get("name"))
            super().__init__(*a, **k)

    for mod in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(mod, "record_function", Counting)
    assert not kt.profiling.active()
    knet.forward(xc)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        knet.forward(xc)
    assert calls[0] == "keynet.forward" and len(calls) > len(_stage_spans(knet))


def test_annotate_is_a_shared_null_context_when_off():
    P = kt.profiling
    assert P.annotate("a") is P.annotate("b")
    assert P.annotate("a", on=False) is P.annotate("b", on=False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert P.active()
        span = P.annotate("a")
        assert isinstance(span, torch.autograd.profiler.record_function)
        with span:
            pass


def test_outputs_bitwise_with_and_without_a_profiler(keyed):
    _, knet, xc = keyed
    plain = knet.forward(xc)
    traced, _ = _traced(lambda: knet.forward(xc))
    assert torch.equal(plain, traced)


def test_load_keynet_records_its_two_phases(keyed):
    sensor, knet, xc = keyed
    f = io.BytesIO()
    kt.save_keynet(f, knet, sensor=sensor, include_keys=True)
    rec = kt.profiling.LOAD_SECONDS
    rec["stale"] = 1.0
    f.seek(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sensor2, knet2 = kt.load_keynet(f, device="cpu")
    assert set(rec) == {"read", "restore"} and rec["read"] > 0 and rec["restore"] > 0
    names = {e.name for e in prof.events()}
    assert {"keynet.load.read", "keynet.load.restore"} <= names
    assert torch.equal(knet2.forward(xc), knet.forward(xc))
    assert sensor2 is not None
