"""The run plan's fold of Kronecker–TapSum–Kronecker runs into one TapSum
link (keynet_tpu_torch.ops.kronfactor.plan_op, made by KeyedModel._build):
the folded op against a float64 evaluation of the published chain and
against the source conv, which runs fold and which keep their links, the
plan of a converted net, the published ops and snapshot left as they were,
and the ``profiling.KRON_FOLDS`` counter.  Imports neither JAX nor
keynet_tpu; the ``cuda`` case skips without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_kron_fold.py
"""

import io

import numpy as np
import pytest
import scipy.sparse
import torch
import torch.nn.functional as F

import keynet_tpu_torch as kt
from keynet_tpu_torch import profiling
from keynet_tpu_torch.ops.kronfactor import (fold_kron_run, kron_factored_keyed_conv,
                                             kron_runs, plan_op)
from keynet_tpu_torch.ops.operators import (ChainedOp, DenseOp, KroneckerOp,
                                            RepeatedBlockDiagOp, TapSumOp)

# keys with identical per-channel spatial blocks and a bias column (the
# local affine photometric key): the structure kron_factored_keyed_conv takes
KEYS = dict(local_geometric="givens_orthogonal", alpha=2, blocksize=4,
            local_photometric="uniform_random_affine", beta=1.0, gamma=1.0)
# the narrow net of test_torch_spans.py: conv1 a Block-ELL chain, conv2 a
# Kronecker-TapSum-Kronecker chain
OVERRIDES = {"DENSE_MAX_BYTES": 1 << 20, "ELL_MAX_K": 32}


def _narrow(m):
    return m.Model([m.Conv2d("conv1", 3, 8, 3), m.ReLU("relu1"),
                    m.Conv2d("conv2", 8, 8, 3), m.ReLU("relu2"),
                    m.Linear("fc1", 8 * 16 * 16, 10)], inshape=(3, 16, 16), seed=1)


def _convert(device="cpu"):
    G = kt.globals.GLOBAL
    old = {k: G.get(k) for k in OVERRIDES}
    try:
        G.update(OVERRIDES)
        return kt.StochasticKeynet((3, 16, 16), _narrow(kt.models), alpha=2, blocksize=8,
                                   seed=0, device=device)
    finally:
        for k, v in old.items():
            if v is None:
                G.pop(k, None)
            else:
                G[k] = v


def _homogeneous(rng, B, n):
    x = rng.standard_normal((B, n)).astype(np.float32)
    x[:, -1] = 1.0
    return torch.from_numpy(x)


def _link64(link, x):
    """One Kronecker or TapSum link applied in float64."""
    xh = x[:, -1:]
    if isinstance(link, KroneckerOp):
        C2, C1 = link.Cm.shape
        p2, p1 = link.Sm.shape
        xc = x[:, :C1 * p1]
        if link.perm_in is not None:
            xc = xc[:, link.perm_in]
        y = (link.Cm.double() @ (xc.reshape(-1, C1, p1) @ link.Sm.double().T))
        y = y.reshape(x.shape[0], -1)
        if link.perm_out is not None:
            y = y[:, link.perm_out]
    else:
        K, S = link.K.double(), link.S.double()
        C1, p1 = K.shape[2], S.shape[2]
        y = torch.einsum("tdc,bcq,tpq->bdp", K, x[:, :C1 * p1].reshape(-1, C1, p1), S)
        y = y.reshape(x.shape[0], -1)
    return torch.cat([y + xh * link.bias.double(), xh], dim=1)


def _chain64(links, x):
    x = x.double()
    for link in links:
        x = _link64(link, x)
    return x


def _err(y, ref):
    return float((y.double() - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("stride", [1, 2])
def test_fold_against_float64_and_the_source_conv(stride):
    """A keyed conv's published chain and its fold on the same cipher batch:
    the fold is no further from a float64 evaluation of the chain than the
    float32 chain is, plus 1e-6 of the scale, and within 1e-5 of the scale
    of the source conv keyed in float64 (with bias, both strides)."""
    rng = np.random.default_rng(stride)
    inshape, outshape = (4, 8, 8), (6, 8 // stride, 8 // stride)
    _, Ainv = kt.keygen(inshape, seed=10 + stride, **KEYS)
    A, _ = kt.keygen(outshape, seed=20 + stride, **KEYS)
    w = rng.standard_normal((outshape[0], inshape[0], 3, 3)).astype(np.float32) / 6
    b = rng.standard_normal(outshape[0]).astype(np.float32)
    chain = kron_factored_keyed_conv(inshape, outshape, w, b, stride, A, Ainv, rng=rng)
    assert [type(link).__name__ for link in chain.ops] == \
        ["KroneckerOp", "TapSumOp", "KroneckerOp"]
    assert kron_runs(chain.ops) == [0]
    assert float(chain.ops[0].bias.abs().max()) > 0 and float(chain.ops[2].bias.abs().max()) > 0
    folded = fold_kron_run(*chain.ops, torch.device("cpu"))
    assert isinstance(folded, TapSumOp) and folded.shape == chain.shape
    assert folded.S.shape == chain.ops[1].S.shape
    assert folded.K_st.shape == chain.ops[1].K_st.shape

    x = _homogeneous(rng, 5, chain.shape[1])
    want = _chain64(chain.ops, x)
    y_chain, y_fold = chain.apply(x), folded.apply(x)
    scale = max(1.0, float(want.abs().max()))
    assert _err(y_fold, want) <= _err(y_chain, want) + 1e-6

    # the source conv, keyed in float64: A·[conv(A⁻¹·x); 1]
    z = np.asarray(scipy.sparse.csr_matrix(Ainv, dtype=np.float64) @ x.double().numpy().T).T
    y = F.conv2d(torch.from_numpy(z[:, :-1]).reshape(-1, *inshape), torch.from_numpy(w).double(),
                 torch.from_numpy(b).double(), stride=stride, padding=1)
    y = y[:, :, :outshape[1], :outshape[2]].reshape(x.shape[0], -1)
    yh = np.concatenate([y.numpy(), z[:, -1:]], axis=1)
    src = torch.from_numpy(np.asarray(scipy.sparse.csr_matrix(A, dtype=np.float64) @ yh.T).T)
    assert float((y_fold.double() - src).abs().max()) <= 1e-5 * scale
    assert float((y_chain.double() - src).abs().max()) <= 1e-5 * scale


def _kron_chain(rng, C=3, p=5, T=4, perm_in=None, perm_out=None):
    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return [KroneckerOp(mk(C, C), mk(p, p), mk(C * p), perm_in=perm_in),
            TapSumOp(mk(T, C, C), mk(T, p, p), mk(C * p)),
            KroneckerOp(mk(C, C), mk(p, p), mk(C * p), perm_out=perm_out)]


@pytest.mark.parametrize("where", ["perm_in", "perm_out"])
def test_a_chain_with_a_gather_keeps_its_links(where):
    rng = np.random.default_rng(3)
    links = _kron_chain(rng, **{where: rng.permutation(15)})
    chain = ChainedOp(links)
    assert kron_runs(chain.ops) == []
    before = dict(profiling.KRON_FOLDS)
    got = plan_op(chain, torch.device("cpu"), "gathered")
    assert got is chain and got.ops == tuple(links)
    assert profiling.KRON_FOLDS["runs"] == before["runs"]
    assert profiling.KRON_FOLDS["kept"] == before["kept"] + 2


def test_a_masked_split_chain_folds_only_its_inner_run():
    """[mask, Kronecker, TapSum, Kronecker] (stoch VGG's split chains) plans
    as [mask, TapSum]: the mask link is the published one, and the plan
    applies the chain's map."""
    rng = np.random.default_rng(4)
    links = _kron_chain(rng)
    mask = RepeatedBlockDiagOp(rng.standard_normal((5, 5)).astype(np.float32),
                               rng.standard_normal(15).astype(np.float32), 15)
    chain = ChainedOp([mask] + links)
    assert kron_runs(chain.ops) == [1]
    plan = plan_op(chain, torch.device("cpu"), "split")
    assert isinstance(plan, ChainedOp) and len(plan.ops) == 2
    assert plan.ops[0] is mask and isinstance(plan.ops[1], TapSumOp)
    assert profiling.KRON_FOLDS["layers"]["split"] == [
        {"at": 1, "T": 4, "C1": 3, "C2": 3, "p1": 5, "p2": 5, "removed": 2}]
    x = _homogeneous(rng, 3, 16)
    want = _chain64(links, mask.apply(x).double())
    assert _err(plan.apply(x), want) <= _err(chain.apply(x), want) + 1e-6
    # two runs in a row fold each; a lone Kronecker link between them stays
    lone = _kron_chain(rng)[0]
    more = ChainedOp(_kron_chain(rng) + [lone] + _kron_chain(rng))
    assert kron_runs(more.ops) == [0, 4]
    plan = plan_op(more, torch.device("cpu"), "two")
    assert [type(op).__name__ for op in plan.ops] == ["TapSumOp", "KroneckerOp", "TapSumOp"]
    assert plan.ops[1] is lone and len(profiling.KRON_FOLDS["layers"]["two"]) == 2


def test_other_ops_are_their_own_plan():
    rng = np.random.default_rng(5)
    dense = DenseOp(rng.standard_normal((4, 4)).astype(np.float32))
    assert plan_op(dense, torch.device("cpu"), "dense") is dense
    chain = ChainedOp([dense, DenseOp(rng.standard_normal((4, 4)).astype(np.float32))])
    assert plan_op(chain, torch.device("cpu"), "chain") is chain


@pytest.fixture(scope="module")
def narrow():
    sensor, knet = _convert()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 3, 16, 16))
                         .astype(np.float32))
    return sensor, knet, sensor.fromtensor(x).encrypt().tensor()


def _members(knet, sensor):
    f = io.BytesIO()
    kt.save_keynet(f, knet, sensor=sensor, include_keys=True)
    f.seek(0)
    with np.load(f) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}


def test_the_plan_holds_a_tapsum_where_a_layer_publishes_a_run(narrow):
    sensor, knet, xc = narrow
    G = kt.globals.GLOBAL
    published = {name: l.op() for name, l in knet.layers().items() if l != "relu"}
    arrays = {name: {k: v.clone() for k, v in op.arrays().items()}
              for name, op in published.items()}
    counts = (knet.num_parameters(), knet.device_bytes(),
              {name: op.nnz() for name, op in published.items()})
    members = _members(knet, sensor)
    before = dict(profiling.KRON_FOLDS)
    saved = {k: G.get(k) for k in OVERRIDES}
    y = knet.forward(xc)

    assert profiling.KRON_FOLDS["runs"] == before["runs"] + 1
    assert profiling.KRON_FOLDS["kept"] == before["kept"]
    assert profiling.KRON_FOLDS["layers"]["conv2"] == [
        {"at": 0, "T": 9, "C1": 8, "C2": 8, "p1": 256, "p2": 256, "removed": 2}]
    plan = dict(zip([n for n, l in knet.layers().items() if l != "relu"], knet._ops))
    for name, op in published.items():
        kinds = [type(link).__name__ for link in getattr(op, "ops", [op])]
        if kinds == ["KroneckerOp", "TapSumOp", "KroneckerOp"]:
            assert isinstance(plan[name], TapSumOp), name
        else:
            assert plan[name] is op, name
    assert isinstance(plan["conv2"], TapSumOp) and isinstance(plan["conv1"], ChainedOp)
    assert knet.published_ops() == list(published.values())
    assert profiling.folded_layers(knet) == {"conv2": 1}

    # the published ops and the snapshot are what the conversion made
    assert {k: G.get(k) for k in OVERRIDES} == saved
    assert (knet.num_parameters(), knet.device_bytes(),
            {name: op.nnz() for name, op in published.items()}) == counts
    for name, op in published.items():
        got = op.arrays()
        assert got.keys() == arrays[name].keys()
        for k, v in got.items():
            assert torch.equal(v, arrays[name][k]), (name, k)
    assert _members(knet, sensor) == members

    # the plan's forward: the published chains' forward within 1e-5 of the scale
    x = torch.as_tensor(xc, dtype=torch.float32)
    ref = knet.run(x, knet.published_ops())
    assert float((knet.run(x) - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert y.shape == (3, 10)


def test_a_loaded_snapshot_folds_the_same(narrow):
    sensor, knet, xc = narrow
    f = io.BytesIO()
    kt.save_keynet(f, knet, sensor=sensor, include_keys=True)
    f.seek(0)
    _, loaded = kt.load_keynet(f, device="cpu")
    assert torch.equal(loaded.forward(xc), knet.forward(xc))
    assert isinstance(loaded._ops[1], TapSumOp)
    assert isinstance(loaded.layers()["conv2"].op(), ChainedOp)


@pytest.mark.cuda
def test_card_fold_equals_the_cpu():
    """The narrow net's snapshot served on the card and on the CPU: the
    forwards agree within 1e-5 of the scale; the card holds the folded
    layer's TapSum link, no larger than the published chain, which stays
    on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    sensor, knet = _convert()
    f = io.BytesIO()
    kt.save_keynet(f, knet, sensor=sensor, include_keys=True)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 3, 16, 16))
                         .astype(np.float32))
    xc = sensor.fromtensor(x).encrypt().tensor()
    f.seek(0)
    _, on_cpu = kt.load_keynet(f, device="cpu")
    f.seek(0)
    _, on_card = kt.load_keynet(f, device="cuda")
    want = on_cpu.forward(xc)
    got = on_card.forward(xc).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    chain = on_card.layers()["conv2"].op()
    fold = on_card._ops[1]
    assert isinstance(fold, TapSumOp) and fold.device.type == "cuda"
    assert all(link.device.type == "cpu" for link in chain.ops)
    assert fold.device_bytes() <= chain.device_bytes()
