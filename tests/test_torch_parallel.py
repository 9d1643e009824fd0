"""keynet_tpu_torch.parallel and the sharded train step against keynet_tpu.

The port's ranks are spawned processes (parallel.launch, gloo on the CPU,
each launch with a deadline); they run tests/torch_parallel_ranks.py,
which imports no JAX.  keynet_tpu runs here, on conftest's 8-device
virtual CPU mesh, on a (dp, tp) sub-mesh of the same shape.  Tolerances:
the port's dp x tp forward equals its single forward within
1e-4·max(1, scale) (__graft_entry__.py:221: collectives change the sum
order) and keynet_tpu's dp x tp forward within 1e-5·max(1, scale), as
the train step's loss and params do."""

import multiprocessing
import time

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import keynet_tpu as kj
import keynet_tpu_torch as kt
import torch_parallel_ranks as ranks
from keynet_tpu.parallel import sharding as JS
from keynet_tpu_torch.parallel import launch

SHAPES = [(1, 2), (2, 2), (1, 4)]
DEADLINE = 240  # seconds for one launch: 4 ranks import, convert and check


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * max(1.0, float(np.abs(a).max()))


def _mesh(shape):
    dp, tp = shape
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))


def _inputs():
    rng = np.random.default_rng(0)
    mk = lambda *s: (rng.normal(size=s) / np.sqrt(s[-1])).astype(np.float32)
    C, p, T = 8, 16, 9
    return {
        "lenet_x": rng.normal(size=(8, 1, 28, 28)).astype(np.float32),
        "train_x": rng.normal(size=(8, 1, 28, 28)).astype(np.float32),
        "train_y": rng.integers(0, 10, 8),
        # every row-block full (one tile each): no shard holds an id-0 slot
        "blocks": rng.normal(size=(8, 128, 128)).astype(np.float32),
        "blockell_x": rng.normal(size=(4, 1024)).astype(np.float32),
        "kron": [(mk(C, C), mk(p, p), mk(C * p)), (mk(T, C, C), mk(T, p, p), mk(C * p)),
                 (mk(C, C), mk(p, p), mk(C * p))],
        "kron_x": rng.normal(size=(4, C * p + 1)).astype(np.float32),
        "ell": scipy.sparse.random(600, 512, density=0.02, random_state=1,
                                   dtype=np.float32, format="csr"),
        "ell_x": rng.normal(size=(4, 512)).astype(np.float32),
        "rbd": (rng.normal(size=(4, 4)).astype(np.float32),
                rng.normal(size=64).astype(np.float32)),
        "rbd_x": rng.normal(size=(4, 65)).astype(np.float32),
        "stream_wb": (rng.normal(size=(8, 8, 3, 3)).astype(np.float32),
                      rng.normal(size=8).astype(np.float32)),
        "stream_x": rng.normal(size=(4, 8 * 16 * 16 + 1)).astype(np.float32),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "dp%d_tp%d" % s)
def port(request):
    """The port's ranks on a (dp, tp) mesh: shape and rank 0's results,
    with every rank's output equal to rank 0's."""
    shape = request.param
    res = launch(ranks.rank_checks, shape[0] * shape[1], args=(shape, INPUTS),
                 backend="gloo", deadline=DEADLINE)
    for r in res[1:]:
        for key in ("y_dp_tp", "y_dp", "loss", "blockell", "kron", "ell", "rbd", "stream"):
            np.testing.assert_array_equal(r[key], res[0][key])
    return shape, res[0]


@pytest.fixture(scope="module")
def jax_lenet():
    """keynet_tpu's stochastic LeNet_AvgPool (the dryrun's real_stochastic)."""
    sensor, knet = ranks.stochastic_lenet(kj)
    knet._build()
    return knet


def _jax_tp_dense(op):
    return "tp" in tuple(op.W.sharding.spec)


# ------------------------------------------------------------ row_shard_plan

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["block_diag", "scattered", "ragged"])
def test_row_shard_plan_equals_jax(tp, kind):
    """BlockSparseOp.row_shard_plan: the same arrays as keynet_tpu's, element
    for element (row padding, compaction, local ids)."""
    rng = np.random.default_rng(3)
    TM = TN = 16
    if kind == "block_diag":
        A = scipy.sparse.block_diag([rng.normal(size=(TM, TN)) for _ in range(8)])
    elif kind == "scattered":
        A = scipy.sparse.random(7 * TM, 9 * TN, density=0.05, random_state=4)
    else:  # n_rb not a multiple of tp, rows of unequal slot counts
        A = scipy.sparse.random(11 * TM - 5, 6 * TN, density=0.02, random_state=5)
    A = scipy.sparse.csr_matrix(A, dtype=np.float32)
    pj = kj.ops.operators.BlockSparseOp.from_scipy(A, tileshape=(TM, TN)).row_shard_plan(tp)
    pt = kt.ops.operators.BlockSparseOp.from_scipy(A, tileshape=(TM, TN)).row_shard_plan(tp)
    assert pt["rb_per"] == pj["rb_per"]
    for key in ("tile_ids", "col_blk"):
        assert pt[key].dtype == np.asarray(pj[key]).dtype
        np.testing.assert_array_equal(pt[key], np.asarray(pj[key]))
    np.testing.assert_array_equal(pt["tiles"].numpy(), np.asarray(pj["tiles"]))


# ------------------------------------------------------------ the real conversion

def test_every_rank_converts_the_same(port):
    assert port[1]["same_conversion"]


def test_shard_keynet_ops_decisions_equal_jax(port, jax_lenet):
    """Per-link decisions of shard_keynet_ops on the converted stochastic
    LeNet (STREAM_NNZ lowered as __graft_entry__.py:200-203 lowers it)."""
    shape, res = port
    plan = JS.shard_keynet_ops(jax_lenet, _mesh(shape), "tp", min_tp_bytes=1 << 14)
    want = [ranks.decision(op, _jax_tp_dense) for op in plan]
    assert res["decisions"] == want
    assert any("TpSharded" in d for d in want)


def test_replication_report_equals_jax(port, jax_lenet):
    shape, res = port
    plan = JS.shard_keynet_ops(jax_lenet, _mesh(shape), "tp", min_tp_bytes=1 << 14)
    want = [tuple(r) for r in JS.replication_report(plan, min_bytes=1 << 14)]
    assert [tuple(r) for r in res["report"]] == want
    if shape[1] == 2:  # the dryrun's mesh: nothing replicated without a reason
        assert not [r for r in want if r[3] is None]


def test_dp_tp_forward(port, jax_lenet):
    """dp x tp forward == the port's single forward (1e-4) and keynet_tpu's
    dp x tp forward (1e-5); the dp-only forward on the mesh and on
    batch_mesh too."""
    shape, res = port
    _close(res["y_single"], res["y_dp_tp"], 1e-4)
    _close(res["y_single"], res["y_dp"], 1e-4)
    _close(res["y_single"], res["y_batch"], 1e-4)
    f = JS.keyed_forward_dp_tp(jax_lenet, _mesh(shape), min_tp_bytes=1 << 14)
    _close(np.asarray(f(res["xc"])), res["y_dp_tp"], 1e-5)


def test_sharded_train_step_equals_jax(port):
    """One make_sharded_train_step step on LeNet_AvgPool (fc1 tp-split):
    param shardings, loss and every updated param equal keynet_tpu's."""
    shape, res = port
    mesh = _mesh(shape)
    net = kj.models.LeNet_AvgPool(seed=1)
    tx = kj.train.make_optimizer(lr=0.003, momentum=0.9)
    step, p_shard, bsh, lsh = kj.train.make_sharded_train_step(net, tx, mesh)
    assert res["p_shard"] == {k: {kk: tuple(s.spec) for kk, s in d.items()}
                              for k, d in p_shard.items()}
    assert res["p_shard"]["fc1"]["weight"] == (None, "tp")
    params = jax.device_put(kj.train._params_pytree(net), p_shard)
    params, _, loss = step(params, tx.init(params),
                           jax.device_put(jnp.asarray(INPUTS["train_x"]), bsh),
                           jax.device_put(jnp.asarray(INPUTS["train_y"]), lsh))
    _close(float(loss), res["loss"], 1e-5)
    for k, d in params.items():
        for kk, v in d.items():
            _close(np.asarray(v), res["params"][k][kk], 1e-5)


def _single_step():
    return ranks.single_step(kt, kt.models.LeNet_AvgPool(seed=1), "cpu", INPUTS["train_x"],
                             INPUTS["train_y"], lr=0.003, momentum=0.9)


def test_sharded_train_step_equals_single_step(port):
    """The sharded step equals the port's single-process make_train_step
    from the same params: every leaf's gradient flows through _TpSplit and
    _TpReduce and is averaged over dp.  The gradients themselves are held
    within 1e-5·max(1, |g|): through the params an lr-scaled gradient
    fault could hide under the limit."""
    shape, res = port
    loss, params, grads = _single_step()
    _close(res["loss"], loss, 1e-5)
    for k, d in params.items():
        for kk, v in d.items():
            _close(v, res["params"][k][kk], 1e-5)
            _close(grads[k][kk], res["grads"][k][kk], 1e-5)
    leaf, err, bound = ranks.worst_leaf(res["grads"], grads)
    assert err <= bound, (leaf, err, bound)


@pytest.mark.parametrize("fault", ranks.FAULTS)
def test_gradient_check_fails_a_planted_fault(port, fault):
    """The gradient check above fails each fault planted in the sharded step
    (an all_reduce in the tp reduce's backward; gradients summed, not
    averaged, over dp) on a mesh where its axis has more than one rank, and
    the fault changes nothing where that axis has one."""
    shape, res = port
    grads = _single_step()[2]
    leaf, err, bound = ranks.worst_leaf(res["fault_grads"][fault], grads)
    n = shape[1] if fault == "tp_times" else shape[0]
    if n > 1:
        assert err > bound, (leaf, err, bound)
        # every gradient upstream of the fault is n times the true one
        g = grads[leaf.split(".")[0]][leaf.split(".")[1]]
        _close(res["fault_grads"][fault][leaf.split(".")[0]][leaf.split(".")[1]], n * g, 1e-5)
    else:
        assert err <= bound, (leaf, err, bound)


# ------------------------------------------------------------ the dryrun's toy sections

def _toy_single(name):
    """(the port's single-device output, keynet_tpu's op and input) of a
    toy section."""
    O, J = kt.ops.operators, kj.ops.operators
    if name in ("blockell", "zero_tile"):
        A = scipy.sparse.block_diag(list(INPUTS["blocks"]), format="csr")
        x = INPUTS["blockell_x"]
        return A @ x.T.astype(np.float64), J.BlockSparseOp.from_scipy(A, (128, 128)), x
    if name == "kron":
        k = INPUTS["kron"]
        mk = lambda M, a: M(*[jnp.asarray(v) for v in a])
        jop = J.ChainedOp([mk(J.KroneckerOp, k[0]), mk(J.TapSumOp, k[1]),
                           mk(J.KroneckerOp, k[2])])
        op = O.ChainedOp([O.KroneckerOp(*k[0]), O.TapSumOp(*k[1]), O.KroneckerOp(*k[2])])
        x = INPUTS["kron_x"]
    elif name == "ell":
        jop, op, x = J.EllOp.from_scipy(INPUTS["ell"]), O.EllOp.from_scipy(INPUTS["ell"]), \
            INPUTS["ell_x"]
    elif name == "rbd":
        F, b = INPUTS["rbd"]
        jop = J.RepeatedBlockDiagOp(jnp.asarray(F), jnp.asarray(b), 64)
        op, x = O.RepeatedBlockDiagOp(F, b, 64), INPUTS["rbd_x"]
    return op.apply(torch.from_numpy(x)).numpy().T, jop, x


def _jax_sharded(name, jop, mesh):
    if name in ("blockell", "zero_tile"):
        return JS.tp_shard_block_op(jop, mesh, "tp")
    if name == "kron":
        return JS.tp_shard_chain_op(jop, mesh, "tp")
    if name == "ell":
        return JS.TpShardedEllOp.from_ell_op(jop, mesh, "tp")
    return JS.TpShardedRepeatedBlockDiagOp.from_op(jop, mesh, "tp")


@pytest.mark.parametrize("name", ["blockell", "zero_tile", "kron", "ell", "rbd"])
def test_toy_section(port, name):
    """Each toy section of the dryrun (__graft_entry__.py:125-192): the
    port's tp-sharded apply == its single apply (1e-4) and keynet_tpu's
    sharded apply (1e-5).  zero_tile is the 8-block block-diagonal applied
    with the kernels' id-0 skip."""
    shape, res = port
    want, jop, x = _toy_single(name)
    _close(want.T, res[name], 1e-4)
    y = _jax_sharded(name, jop, _mesh(shape)).apply(jnp.asarray(x))
    _close(np.asarray(y), res[name], 1e-5)


def test_zero_tile_shift_is_needed(port):
    """Trouble 1: every row-block of the block-diagonal is full, so no shard
    holds an id-0 slot and compaction leaves a real tile at local id 0; a
    kernel that skips id-0 slots drops it unless the shard puts the zero
    tile first."""
    shape, res = port
    want = _toy_single("zero_tile")[0].T
    _close(want, res["zero_tile"], 1e-4)
    err = float(np.abs(res["zero_tile_unshifted"] - want).max())
    assert err > 1e-2 * float(np.abs(want).max())


def test_streamed_masked_chain(port):
    """The dryrun's streamed masked-chain conv 8x16x16 tp-sharded with
    max_replication=1.01: same links shard as in keynet_tpu, output == the
    single apply (1e-4) and keynet_tpu's sharded apply (1e-5)."""
    shape, res = port
    jop = ranks.streamed_layer(kj, *INPUTS["stream_wb"])
    jtp = JS.tp_shard_chain_op(jop, _mesh(shape), "tp", max_replication=1.01)
    assert res["stream_decision"] == ranks.decision(jtp)
    assert "TpShardedBlockEllOp" in res["stream_decision"]
    _close(res["stream_single"], res["stream"], 1e-4)
    _close(np.asarray(jtp.apply(jnp.asarray(INPUTS["stream_x"]))), res["stream"], 1e-5)
    _close(np.asarray(jop.apply(jnp.asarray(INPUTS["stream_x"]))), res["stream_single"],
           1e-5)


def test_kron_chain_links_shard(port):
    assert port[1]["kron_decision"] == \
        "ChainedOp[TpShardedKroneckerOp, TpShardedTapSumOp, TpShardedKroneckerOp]"


# ------------------------------------------------------------ the launcher

def test_launch_reraises_a_rank_exception():
    """A rank's exception fails the launch with its traceback, and no rank
    is left running (the others were waiting on it in a collective)."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        launch(ranks.fail_on_last, 2, backend="gloo", deadline=DEADLINE)
    assert not multiprocessing.active_children()


def test_launch_deadline():
    """A rank that never returns fails the launch at its deadline, and every
    rank is stopped."""
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        launch(ranks.hang_on_last, 2, backend="gloo", deadline=10)
    assert time.monotonic() - t < 60
    assert not multiprocessing.active_children()
