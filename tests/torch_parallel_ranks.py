"""Rank functions and toy-net constructors for tests/test_torch_parallel.py,
the card tests and chip_smoke.py's [parallel] phase.

Each runs on one rank of a torch.distributed world started by
keynet_tpu_torch.parallel.launch and returns numpy results.  This module
imports neither JAX nor keynet_tpu: the ranks are fresh processes, and
keynet_tpu's side is computed in the pytest process.
"""

import numpy as np

# the dryrun's toy sections (__graft_entry__.py:125-302) and real-conversion
# settings, shared with the test so both packages see the same inputs
LENET_STREAM_NNZ = 60_000
STREAM_KEYS = dict(STREAM_NNZ=100_000, KRON_FACTORED="never", DENSE_MAX_BYTES=1 << 20)
STREAM_CFG = dict(global_geometric="hierarchical_permutation",
                  hierarchical_blockshape=(2, 2), hierarchical_permute_at_level=(0, 1),
                  local_geometric="doubly_stochastic", alpha=2, blocksize=8,
                  local_photometric="uniform_random_affine", beta=1.0, gamma=1.0)


class global_keys:
    """Set GLOBAL keys of a package's globals, restored on exit."""

    def __init__(self, G, **keys):
        self.G, self.keys = G, keys

    def __enter__(self):
        self.saved = {k: self.G.get(k) for k in self.keys}
        self.G.update(self.keys)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                self.G.pop(k, None)
            else:
                self.G[k] = v


def decision(op, tp_dense=lambda op: False):
    """An op's sharding decision as type names down its chain: wrapped
    inners in parentheses, a tp-split dense as TpShardedDenseOp."""
    name = type(op).__name__
    if hasattr(op, "ops"):
        return "ChainedOp[%s]" % ", ".join(decision(o, tp_dense) for o in op.ops)
    if name in ("PermutedBlockSparseOp", "ChannelBroadcastOp"):
        return "%s(%s)" % (name, decision(op.inner, tp_dense))
    if name == "DenseOp" and tp_dense(op):
        return "TpShardedDenseOp"
    return name


def stochastic_lenet(kt, device="cpu"):
    """The dryrun's real_stochastic net (__graft_entry__.py:196-206) built
    with package ``kt`` (keynet_tpu_torch's on ``device``)."""
    with global_keys(kt.globals.GLOBAL, STREAM_NNZ=LENET_STREAM_NNZ):
        net = kt.models.LeNet_AvgPool(seed=3)
        return kt.StochasticKeynet((1, 28, 28), net, alpha=2, blocksize=14, seed=5,
                                   **({} if kt.__name__ == "keynet_tpu" else
                                      {"device": device}))


def streamed_layer(kt, w, b):
    """The dryrun's streamed masked-chain conv 8x16x16 (__graft_entry__.py
    :252-283) built with package ``kt``; returns the layer's op."""
    with global_keys(kt.globals.GLOBAL, **STREAM_KEYS):
        A, _ = kt.keys.keygen((8, 16, 16), seed=3, **STREAM_CFG)
        _, Ai = kt.keys.keygen((8, 16, 16), seed=4, **STREAM_CFG)
        lay = kt.layer.KeyedLayer(kt.models.specs.Conv2d("conv", 8, 8, 3, 1, 1),
                                  (8, 16, 16), (8, 16, 16), A=A, Ainv=Ai,
                                  params={"weight": w, "bias": b},
                                  rng=np.random.default_rng(6))
        return lay.op()


def kernel_style_plain(x_padded, tiles, tile_ids, col_blk, n_out_padded):
    """block_ell_plain with the CUDA kernels' id-0 skip: slots of tile id 0
    add nothing, whatever tile 0 holds."""
    import torch
    from keynet_tpu_torch.ops import block_ell
    keep = (tile_ids != 0).to(torch.float32)[..., None, None]
    n_rb, KB = tile_ids.shape
    TM, TN = tiles.shape[1:]
    B = x_padded.shape[0]
    xg = x_padded.reshape(B, -1, TN)[:, col_blk.long()].float()
    tg = tiles[tile_ids.long()].float() * keep
    y = torch.einsum("brkn,rkmn->brm", xg, tg).reshape(B, -1)
    return y[:, :block_ell.out_width(n_rb, TM, n_out_padded)]


def zero_tile_apply(kt, mesh, A, x, shift=True):
    """The tile-row tp-sharded Block-ELL of the scipy matrix ``A`` applied
    to ``x`` with the kernels' id-0 skip; ``shift=False`` builds the shards
    without putting the zero tile first."""
    import torch
    from keynet_tpu_torch.ops import block_ell
    from keynet_tpu_torch.parallel import sharding
    plain, first = block_ell.block_ell_plain, sharding._zero_tile_first
    block_ell.block_ell_plain = kernel_style_plain
    if not shift:
        sharding._zero_tile_first = lambda tiles, ids: (tiles, ids)
    try:
        op = kt.ops.operators.BlockSparseOp.from_scipy(A, tileshape=(128, 128))
        tpop = sharding.tp_shard_block_op(op, mesh, "tp")
        return tpop.apply(torch.from_numpy(x)).numpy()
    finally:
        block_ell.block_ell_plain, sharding._zero_tile_first = plain, first


FAULTS = ("tp_times", "dp_sum")


class planted_fault:
    """A fault planted in make_sharded_train_step, for the gradient checks
    that must fail on it.  "tp_times": the tp linear's reduce all-reduces
    its gradient too, as torch.distributed.nn.functional.all_reduce does,
    so every gradient upstream of it is tp times too large.  "dp_sum": the
    gradients are summed over dp, not averaged.  None plants nothing."""

    def __init__(self, kt, mesh, fault):
        self.kt, self.mesh, self.fault = kt, mesh, fault

    def __enter__(self):
        from keynet_tpu_torch.parallel import sharding as S
        reduce_cls = self.kt.train._TpReduce
        self.saved = reduce_cls.backward, S.all_reduce_sum
        mesh, plain = self.mesh, S.all_reduce_sum
        if self.fault == "tp_times":
            reduce_cls.backward = staticmethod(
                lambda ctx, g: (plain(g.contiguous(), mesh, "tp"), None, None))
        elif self.fault == "dp_sum":
            S.all_reduce_sum = lambda x, mesh, axis: \
                plain(x, mesh, axis) * (mesh.size(axis) if axis == "dp" else 1)
        elif self.fault is not None:
            raise ValueError("no fault %r" % (self.fault,))

    def __exit__(self, *exc):
        from keynet_tpu_torch.parallel import sharding as S
        self.kt.train._TpReduce.backward, S.all_reduce_sum = self.saved


def sharded_step(kt, net, mesh, images, labels, fault=None, **opt):
    """One make_sharded_train_step step from ``net``'s params (optimizer
    make_optimizer(**opt)) with ``fault`` planted: (loss, p_shard, the
    updated params, the gradients the step applied), the trees as numpy
    arrays, whole on every rank."""
    p_shard = kt.train.param_shardings(net, mesh)
    params = kt.train.shard_params(net.params, p_shard, mesh)
    optimizer, _ = kt.train.make_optimizer(params, **opt)
    step = kt.train.make_sharded_train_step(net, optimizer, mesh)[0]
    with planted_fault(kt, mesh, fault):
        loss = float(step(params, images, labels))
    grads = {k: {kk: v.grad for kk, v in d.items()} for k, d in params.items()}
    return (loss, p_shard, kt.train.gather_params(params, p_shard, mesh),
            kt.train.gather_params(grads, p_shard, mesh))


def single_step(kt, net, device, images, labels, **opt):
    """One single-process make_train_step step from ``net``'s params:
    (loss, the updated params, the gradients), trees of numpy arrays."""
    import torch
    params = kt.train.params_tree(net, device)
    optimizer, _ = kt.train.make_optimizer(params, **opt)
    loss = kt.train.make_train_step(net, optimizer)(
        params, torch.as_tensor(images).to(device), torch.as_tensor(labels).to(device))
    numpy = lambda t: t.detach().cpu().numpy()
    return (float(loss), {k: {kk: numpy(v) for kk, v in d.items()} for k, d in params.items()},
            {k: {kk: numpy(v.grad) for kk, v in d.items()} for k, d in params.items()})


def worst_leaf(got, want, tol=1e-5):
    """(leaf, max|got - want|, tol·max(1, max|want|)) of the leaf of two
    {layer: {name: array}} trees whose error is largest against its bound."""
    rows = []
    for k, d in want.items():
        for kk, w in d.items():
            err = float(np.abs(np.asarray(got[k][kk]) - w).max())
            rows.append(("%s.%s" % (k, kk), err, tol * max(1.0, float(np.abs(w).max()))))
    return max(rows, key=lambda r: r[1] / r[2])


def rank_checks(rank, world, shape, inputs):
    """Everything test_torch_parallel.py holds against keynet_tpu, on one
    rank of a (dp, tp) = ``shape`` mesh on the CPU."""
    import scipy.sparse
    import torch
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.ops import operators as O
    from keynet_tpu_torch.parallel import sharding as S
    mesh = S.Mesh(shape, ("dp", "tp"), device="cpu")
    out = {}

    # the real stochastic conversion, checked equal on every rank
    sensor, knet = stochastic_lenet(kt)
    digest = np.array([float(sum(float(t.double().sum()) for t in op.arrays().values()))
                       for op in knet.published_ops()])
    sums = [None] * world
    torch.distributed.all_gather_object(sums, digest)
    out["same_conversion"] = all(np.array_equal(s, sums[0]) for s in sums)
    xc = sensor.fromtensor(inputs["lenet_x"]).encrypt().tensor()
    out["xc"] = xc.numpy()
    out["y_single"] = knet.run(xc).numpy()
    plan = S.shard_keynet_ops(knet, mesh, "tp", min_tp_bytes=1 << 14)
    out["decisions"] = [decision(op) for op in plan]
    out["report"] = S.replication_report(plan, min_bytes=1 << 14)
    out["y_dp_tp"] = S.keyed_forward_dp_tp(knet, mesh, min_tp_bytes=1 << 14)(xc).numpy()
    out["y_dp"] = S.keyed_forward_sharded(knet, mesh, "dp")(xc).numpy()
    out["y_batch"] = S.keyed_forward_sharded(knet, S.batch_mesh(device="cpu"))(xc).numpy()

    # one sharded train step, fc1 tp-split
    net = kt.models.LeNet_AvgPool(seed=1)
    out["loss"], out["p_shard"], out["params"], out["grads"] = sharded_step(
        kt, net, mesh, inputs["train_x"], inputs["train_y"], lr=0.003, momentum=0.9)
    out["fault_grads"] = {f: sharded_step(kt, net, mesh, inputs["train_x"], inputs["train_y"],
                                          fault=f, lr=0.003, momentum=0.9)[3]
                          for f in FAULTS}

    # the dryrun's toy sections
    blocks = inputs["blocks"]
    A = scipy.sparse.block_diag(list(blocks), format="csr")
    op = O.BlockSparseOp.from_scipy(A, tileshape=(128, 128))
    out["blockell"] = S.tp_shard_block_op(op, mesh, "tp").apply(
        torch.from_numpy(inputs["blockell_x"])).numpy()
    out["zero_tile"] = zero_tile_apply(kt, mesh, A, inputs["blockell_x"])
    out["zero_tile_unshifted"] = zero_tile_apply(kt, mesh, A, inputs["blockell_x"],
                                                 shift=False)
    k = inputs["kron"]
    chain = O.ChainedOp([O.KroneckerOp(*k[0]), O.TapSumOp(*k[1]), O.KroneckerOp(*k[2])])
    tpc = S.tp_shard_chain_op(chain, mesh, "tp")
    out["kron_decision"] = decision(tpc)
    out["kron"] = tpc.apply(torch.from_numpy(inputs["kron_x"])).numpy()
    eop = O.EllOp.from_scipy(inputs["ell"])
    out["ell"] = S.TpShardedEllOp.from_ell_op(eop, mesh, "tp").apply(
        torch.from_numpy(inputs["ell_x"])).numpy()
    rop = O.RepeatedBlockDiagOp(*inputs["rbd"], 64)
    out["rbd"] = S.TpShardedRepeatedBlockDiagOp.from_op(rop, mesh, "tp").apply(
        torch.from_numpy(inputs["rbd_x"])).numpy()
    sop = streamed_layer(kt, *inputs["stream_wb"])
    tps = S.tp_shard_chain_op(sop, mesh, "tp", max_replication=1.01)
    out["stream_decision"] = decision(tps)
    out["stream_single"] = sop.apply(torch.from_numpy(inputs["stream_x"])).numpy()
    out["stream"] = tps.apply(torch.from_numpy(inputs["stream_x"])).numpy()
    return out


def card_block_ell(rank, world, blocks, x, mode="highest"):
    """On the card (ranks sharing cuda:0 over gloo): the 8-block
    block-diagonal tile-row tp-sharded over every rank and applied through
    the CUDA kernel under PRECISION ``mode``; returns (y, the kernel
    launches, those of them that ran tf32)."""
    import scipy.sparse
    import torch
    import keynet_tpu_torch as kt
    from keynet_tpu_torch.ops import block_ell
    from keynet_tpu_torch.parallel import sharding as S
    torch.cuda.set_device(0)
    kt.globals.precision(mode)
    mesh = S.Mesh((1, world), ("dp", "tp"), device="cuda")
    A = scipy.sparse.block_diag(list(blocks), format="csr")
    op = kt.ops.operators.BlockSparseOp.from_scipy(A, tileshape=(128, 128))
    tpop = S.tp_shard_block_op(op, mesh, "tp")
    block_ell.reset_launches()
    y = tpop.apply(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    return y.cpu().numpy(), dict(block_ell.LAUNCHES), dict(block_ell.TF32_LAUNCHES)


def fail_on_last(rank, world):
    """The last rank raises; the others wait in a collective for it."""
    import torch
    import torch.distributed as dist
    if rank == world - 1:
        raise ValueError("rank %d fails on purpose" % rank)
    dist.all_reduce(torch.ones(1))


def hang_on_last(rank, world):
    """The last rank never returns."""
    import time
    if rank == world - 1:
        time.sleep(3600)
    return rank
