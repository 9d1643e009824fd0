"""Multi-rank keyed inference on torch.distributed: dp × tp.

The port of keynet_tpu/parallel/sharding.py.  The scaling axes are the
same:

  * dp — the cipher batch: keyed inference is row-parallel over the
    N x (D+1) homogeneous batch, so batch rows split over the dp ranks and
    the keys replicate;
  * tp — large keyed matrices split over the tp ranks: Block-ELL, ELL and
    Kronecker factors by output rows, tap sums by taps, repeated block
    diagonals by blocks, dense layers by input columns.

keynet_tpu is single-controller: one process sees a ``Mesh`` and XLA puts
the collectives where the shard_map specs ask for them.  Here every rank
is a process (parallel.launch starts them) that holds only its own shards,
on its device, and applies them with explicit collectives at the same
places: an ``all_gather`` over tp where a spec concatenates the shards'
outputs along features (``out_specs=P(None, tp)``), an ``all_reduce`` over
tp where keynet_tpu takes a psum, and an ``all_gather`` over dp where the
batch comes back together.  Every rank of a tp group holds the same
(replicated) input of a sharded op, as keynet_tpu's ``P()`` in_specs do.

A ``Mesh`` is this rank's place in the (dp, tp) grid: its coordinates and
one process group per axis (``dist.new_group`` over the grid's rows and
columns).  The caller initialises the world (parallel.launch.init_rank)
with its backend: gloo on the CPU and for ranks that share one card, NCCL
for one rank a card.  ``torch.distributed.device_mesh`` is not used.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..globals import precision, resolve_device
from ..ops.operators import (BlockSparseOp, ChainedOp, ChannelBroadcastOp, DenseOp,
                             DirectConvOp, EllOp, KroneckerOp, LinearOp,
                             PermutedBlockSparseOp, RepeatedBlockDiagOp, TapSumOp,
                             find_row_period)


class Mesh:
    """This rank's view of a mesh of ``shape`` ranks over ``axis_names``
    (row-major over the world's ranks, as ``np.arange(world).reshape(shape)``):
    ``shape`` {axis: size}, ``coords`` {axis: this rank's index},
    ``groups`` {axis: the process group of the ranks that differ from this
    one only along that axis} and ``device``, where its shards live.  Every
    rank of the world must build the same mesh, in the same order."""

    def __init__(self, shape, axis_names=("dp", "tp"), device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: torch.distributed is not initialised "
                               "(parallel.launch or parallel.launch.init_rank)")
        sizes = tuple(int(s) for s in shape)
        world, rank = dist.get_world_size(), dist.get_rank()
        if len(sizes) != len(axis_names) or int(np.prod(sizes)) != world:
            raise ValueError("Mesh: shape %s over %s does not cover a world of %d ranks"
                             % (sizes, tuple(axis_names), world))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.device = resolve_device(device)
        self.rank = rank
        grid = np.arange(world).reshape(sizes)
        self.coords = {ax: int(c) for ax, c in
                       zip(self.axis_names, np.unravel_index(rank, sizes))}
        self.groups = {}
        for i, ax in enumerate(self.axis_names):
            for ranks in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist():
                group = dist.new_group(ranks)  # collective: every rank, same order
                if rank in ranks:
                    self.groups[ax] = group

    def size(self, axis):
        """The axis's size, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def __repr__(self):
        return "Mesh(%s, rank %d at %s, %s)" % (self.shape, self.rank, self.coords,
                                                self.device)


def batch_mesh(n_devices=None, axis="dp", device="cuda"):
    """1-D mesh over the whole world for batch-parallel keyed inference."""
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError("batch_mesh: %d devices asked for, the world has %d ranks"
                         % (n_devices, world))
    return Mesh((world,), (axis,), device)


# ------------------------------------------------------------- collectives

def all_gather_cat(x, mesh, axis, dim):
    """The ranks' ``x`` along ``axis``, concatenated along ``dim`` in
    coordinate order (list-form all_gather)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x, mesh, axis):
    """The sum of the ranks' ``x`` along ``axis`` (a new tensor)."""
    if mesh.size(axis) == 1:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=mesh.groups[axis])
    return x


def _rows(n, mesh, axis, what):
    """[a, b): this rank's share of ``n`` rows split evenly over ``axis``."""
    k = mesh.size(axis)
    if n % k:
        raise ValueError("%s: %d rows do not split over %s=%d" % (what, n, axis, k))
    j = mesh.coords.get(axis, 0)
    return j * (n // k), (j + 1) * (n // k)


def shard_batch(x, mesh, axis="dp"):
    """This rank's rows of a (N, D) batch whose rows split over ``axis``
    (N divisible by its size, as keynet_tpu's NamedSharding requires), on
    the mesh's device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    a, b = _rows(x.shape[0], mesh, axis, "shard_batch")
    return x[a:b].to(mesh.device)


def replicate_ops(ops, mesh):
    """Every keyed-matrix op on the mesh's device, whole on every rank."""
    return tuple(op.to(mesh.device) for op in ops)


def keyed_forward_sharded(knet, mesh, axis="dp"):
    """Return f(x): knet's keyed forward (KeyedModel.run) on a full cipher
    batch with its rows split over ``axis`` and the keys replicated (a
    residual net's shortcut ops too: its plan is per row); every rank gets
    the whole batch's output.  The ops are the published ones, as
    shard_keynet_ops takes them."""
    ops = replicate_ops(knet.published_ops(), mesh)

    def f(x):
        precision()
        return all_gather_cat(knet.run(shard_batch(x, mesh, axis), ops), mesh, axis, 0)

    return f


def keyed_forward_dp_tp(knet, mesh, dp_axis="dp", tp_axis="tp", **kwargs):
    """Batch-parallel + tensor-parallel keyed inference over a (dp, tp)
    mesh: f(x) on a full cipher batch (rows divisible by dp) returns the
    whole batch's output on every rank.  ``kwargs`` go to
    shard_keynet_ops; ``f.ops`` is the plan f runs."""
    ops = shard_keynet_ops(knet, mesh, tp_axis, **kwargs)

    def f(x):
        precision()
        y = knet.run(shard_batch(x, mesh, dp_axis), ops)
        return all_gather_cat(y, mesh, dp_axis, 0)

    f.ops = ops
    return f


# ------------------------------------------------------------- sharded ops

class _TpOp(LinearOp):
    """A tp-sharded op: this rank's shard, applied with collectives over
    the mesh's ``tp_axis`` group."""

    def nnz(self):
        return self._nnz

    def local_bytes(self):
        """Bytes of the tensors this rank holds."""
        return sum(int(t.numel()) * t.element_size() for t in self.arrays().values())

    def _tp(self):
        return self.mesh.size(self.tp_axis), self.mesh.coords[self.tp_axis]


def _zero_tile_first(tiles, ids):
    """Keep local tile 0 the zero tile.  Every CUDA kernel skips id-0 slots
    (pallas_kernels.py:80-81), but row_shard_plan compacts a shard's store
    to its unique ids, so in a shard without an id-0 slot local id 0 is a
    real tile: put a zero tile in front and shift the ids."""
    if not bool(tiles[0].any()):
        return tiles, ids
    return torch.cat([torch.zeros_like(tiles[:1]), tiles]), ids + 1


class TpShardedBlockEllOp(_TpOp):
    """Tensor-parallel Block-ELL apply (keynet_tpu's TpShardedBlockEllOp):
    the rank holds the compacted tile store and local index arrays of its
    contiguous row-block range (BlockSparseOp.row_shard_plan) as a local
    BlockSparseOp, whose schedule sends 128-multiple tiles to the CUDA
    kernels; x is replicated, and the shards' output rows are all-gathered
    over tp and concatenated along features."""

    def __init__(self, tiles, tile_ids, col_blk, shape, tileshape, nnz, mesh,
                 tp_axis="tp", u_max=None):
        self.mesh, self.tp_axis = mesh, tp_axis
        self.shape = tuple(shape)
        self.tileshape = tuple(tileshape)
        self._nnz = int(nnz)
        tiles = torch.as_tensor(tiles)
        ids = np.asarray(tile_ids)
        self.u_max = int(tiles.shape[0] if u_max is None else u_max)
        n_stored = tiles.shape[0]
        tiles, ids = _zero_tile_first(tiles, ids)
        # True where the ids were shifted behind a zero tile put first
        self.zero_tile_added = tiles.shape[0] > n_stored
        self.local = BlockSparseOp(tiles, ids, col_blk,
                                   (ids.shape[0] * self.tileshape[0], self.shape[1]),
                                   self.tileshape, nnz, period=find_row_period(ids))
        self.local.to(mesh.device)

    @staticmethod
    def from_block_op(op, mesh, tp_axis="tp"):
        """This rank's shard of a BlockSparseOp, on the mesh's device."""
        tp, j = mesh.size(tp_axis), mesh.coords[tp_axis]
        plan = op.row_shard_plan(tp)
        # a copy: a view would keep every shard's tiles alive on this rank
        return TpShardedBlockEllOp(plan["tiles"][j].clone(), plan["tile_ids"][j],
                                   plan["col_blk"][j], op.shape, op.tileshape,
                                   op.nnz(), mesh, tp_axis,
                                   u_max=plan["tiles"].shape[1])

    def to(self, device):
        self.local.to(device)
        return self

    @property
    def device(self):
        return self.local.device

    def apply(self, x):
        y = all_gather_cat(self.local.apply(x), self.mesh, self.tp_axis, 1)
        return y[:, :self.shape[0]]

    def device_bytes(self):
        """keynet_tpu's count, over all shards: tp x (u_max tiles + the
        rank's ids as 8 bytes a slot); per rank it is 1/tp of it."""
        tp, _ = self._tp()
        TM, TN = self.tileshape
        return tp * (self.u_max * TM * TN * self.local.tiles.element_size()
                     + int(self.local.tile_ids.numel()) * 8)

    def per_chip_tile_bytes(self):
        TM, TN = self.tileshape
        return self.u_max * TM * TN * self.local.tiles.element_size()

    def local_bytes(self):
        """What this rank's shard holds (its store with the zero tile put in
        front where one was, its grouped-row plan)."""
        return self.local.device_bytes()

    def arrays(self):
        return self.local.arrays()


class TpShardedKroneckerOp(_TpOp):
    """Tensor-parallel KroneckerOp (keynet_tpu's): the channel factor C
    (C2, C1) split over its output rows, so each rank computes a contiguous
    channel-major slice of y = (C ⊗ S)·x; the spatial matmul X·Sᵀ is
    recomputed per rank (S is the small factor).  Slices are all-gathered
    over tp.  Keys with a row gather (perm_out) stay replicated."""
    _tensors = ("Cm", "Sm", "bias", "perm_in")

    def __init__(self, Cm, Sm, bias, shape, nnz, mesh, tp_axis="tp", perm_in=None):
        self.Cm = Cm          # (C2/tp, C1), this rank's rows
        self.Sm = Sm          # (p2, p1) replicated
        self.bias = bias      # (n_out,) replicated, final output coords
        self.perm_in = perm_in
        self.shape = tuple(shape)
        self._nnz = int(nnz)
        self.mesh, self.tp_axis = mesh, tp_axis

    @staticmethod
    def from_kron_op(op, mesh, tp_axis="tp"):
        tp, j = mesh.size(tp_axis), mesh.coords.get(tp_axis, 0)
        C2 = op.Cm.shape[0]
        if op.perm_out is not None or C2 % tp or C2 // tp < 1:
            return None
        k = C2 // tp
        dev = mesh.device
        return TpShardedKroneckerOp(
            op.Cm[j * k:(j + 1) * k].to(dev).clone(), op.Sm.to(dev), op.bias.to(dev),
            op.shape, op.nnz(), mesh, tp_axis,
            perm_in=None if op.perm_in is None else op.perm_in.to(dev))

    def apply(self, x):
        B = x.shape[0]
        C1 = self.Cm.shape[1]
        p2, p1 = self.Sm.shape
        n_in = C1 * p1
        xc, xh = x[:, :n_in], x[:, n_in:]
        if self.perm_in is not None:
            xc = xc[:, self.perm_in]
        t = torch.matmul(xc.reshape(B, C1, p1), self.Sm.T)
        y = torch.matmul(self.Cm, t).reshape(B, -1)     # (B, C2/tp * p2)
        y = all_gather_cat(y, self.mesh, self.tp_axis, 1)
        y = y + xh * self.bias[None, :]
        return torch.cat([y, xh], dim=1)

    def device_bytes(self):
        tp, _ = self._tp()
        return int(tp * self.Cm.numel() + self.Sm.numel() + self.bias.numel()) * 4

    def arrays(self):
        return {"Cm": self.Cm, "Sm": self.Sm, "bias": self.bias}


class TpShardedTapSumOp(_TpOp):
    """Tensor-parallel TapSumOp (keynet_tpu's): the taps of Σ_t K_t ⊗ S_t
    zero-padded to a multiple of tp and split over the ranks; each rank sums
    its taps' contribution and one all_reduce over tp gives y."""
    _tensors = ("K", "S", "bias")

    def __init__(self, K, S, bias, shape, nnz, mesh, tp_axis="tp"):
        self.K = K          # (T/tp, C2, C1), this rank's taps
        self.S = S          # (T/tp, p2, p1)
        self.bias = bias    # (n_out,) replicated
        self.shape = tuple(shape)
        self._nnz = int(nnz)
        self.mesh, self.tp_axis = mesh, tp_axis

    @staticmethod
    def from_tapsum_op(op, mesh, tp_axis="tp"):
        tp, j = mesh.size(tp_axis), mesh.coords.get(tp_axis, 0)
        T = op.K.shape[0]
        k = -(-T // tp)
        pad = k * tp - T
        K = torch.cat([op.K, op.K.new_zeros((pad,) + tuple(op.K.shape[1:]))]) \
            if pad else op.K
        S = torch.cat([op.S, op.S.new_zeros((pad,) + tuple(op.S.shape[1:]))]) \
            if pad else op.S
        dev = mesh.device
        return TpShardedTapSumOp(K[j * k:(j + 1) * k].to(dev).clone(),
                                 S[j * k:(j + 1) * k].to(dev).clone(), op.bias.to(dev),
                                 op.shape, op.nnz(), mesh, tp_axis)

    def apply(self, x):
        B = x.shape[0]
        C1 = self.K.shape[2]
        p1 = self.S.shape[2]
        n_in = C1 * p1
        xc = x[:, :n_in].reshape(B, C1, p1)
        xh = x[:, n_in:]
        y = None
        for t in range(self.K.shape[0]):
            yt = torch.matmul(self.K[t], torch.matmul(xc, self.S[t].T))
            y = yt if y is None else y + yt
        y = all_reduce_sum(y.reshape(B, -1), self.mesh, self.tp_axis)
        y = y + xh * self.bias[None, :]
        return torch.cat([y, xh], dim=1)

    def device_bytes(self):
        tp, _ = self._tp()
        return int(tp * (self.K.numel() + self.S.numel()) + self.bias.numel()) * 4

    def arrays(self):
        return {"K": self.K, "S": self.S, "bias": self.bias}


class TpShardedEllOp(_TpOp):
    """Tensor-parallel ELL apply (keynet_tpu's): contiguous output-row
    shards of the (n_out, K) cols/vals; each rank applies a local EllOp on
    its rows of the replicated x, and the rows are all-gathered over tp."""

    def __init__(self, cols, vals, shape, nnz, mesh, tp_axis="tp"):
        self.shape = tuple(shape)
        self._nnz = int(nnz)
        self.mesh, self.tp_axis = mesh, tp_axis
        self.local = EllOp(cols, vals, (cols.shape[0], self.shape[1]), 1)

    @staticmethod
    def from_ell_op(op, mesh, tp_axis="tp"):
        if not isinstance(op, EllOp):
            return None
        tp = mesh.size(tp_axis)
        n_out = op.shape[0]
        if tp <= 1 or n_out < 8 * tp:
            return None
        rows_per = -(-n_out // tp)
        a = mesh.coords[tp_axis] * rows_per
        K = op.cols.shape[1]
        cols = op.cols.new_zeros((rows_per, K))
        vals = op.vals.new_zeros((rows_per, K))
        n = max(0, min(n_out, a + rows_per) - a)
        cols[:n], vals[:n] = op.cols[a:a + n], op.vals[a:a + n]
        return TpShardedEllOp(cols.to(mesh.device), vals.to(mesh.device), op.shape,
                              op.nnz(), mesh, tp_axis)

    def to(self, device):
        self.local.to(device)
        return self

    @property
    def device(self):
        return self.local.device

    def apply(self, x):
        y = all_gather_cat(self.local.apply(x), self.mesh, self.tp_axis, 1)
        return y[:, :self.shape[0]]

    def device_bytes(self):
        """keynet_tpu's count over all shards; per rank it is exactly 1/tp."""
        return self._tp()[0] * self.per_chip_bytes()

    def per_chip_bytes(self):
        return int(self.local.cols.numel()) * 8

    def arrays(self):
        return self.local.arrays()


class TpShardedRepeatedBlockDiagOp(_TpOp):
    """Tensor-parallel RepeatedBlockDiagOp (keynet_tpu's): the core's
    repeated (p, p) blocks split into contiguous block ranges over tp; the
    factor replicates, each rank holds its range's bias and multiplies only
    its columns of x; the ranges are all-gathered over tp."""
    _tensors = ("F", "bias")

    def __init__(self, F, bias, shape, nnz, mesh, tp_axis="tp"):
        self.F = F          # (p, p) replicated
        self.bias = bias    # (n/tp,) this rank's range
        self.shape = tuple(shape)
        self._nnz = int(nnz)
        self.mesh, self.tp_axis = mesh, tp_axis

    @staticmethod
    def from_op(op, mesh, tp_axis="tp"):
        if not isinstance(op, RepeatedBlockDiagOp):
            return None
        tp = mesh.size(tp_axis)
        n = op.shape[0] - 1
        p = op.F.shape[0]
        if tp <= 1 or (n // p) % tp != 0:
            return None
        k = n // tp
        j = mesh.coords[tp_axis]
        return TpShardedRepeatedBlockDiagOp(
            op.F.to(mesh.device), op.bias[j * k:(j + 1) * k].to(mesh.device).clone(),
            op.shape, op.nnz(), mesh, tp_axis)

    def apply(self, x):
        n = self.shape[0] - 1
        p = self.F.shape[0]
        k = self.bias.shape[0]
        j = self.mesh.coords[self.tp_axis]
        B = x.shape[0]
        xs, xh = x[:, j * k:(j + 1) * k], x[:, n:]
        y = torch.matmul(xs.reshape(B, k // p, p), self.F.T).reshape(B, k)
        y = all_gather_cat(y + xh * self.bias[None, :], self.mesh, self.tp_axis, 1)
        return torch.cat([y, xh], dim=1)

    def device_bytes(self):
        return int(self.F.numel() + self._tp()[0] * self.bias.numel()) * 4

    def arrays(self):
        return {"F": self.F, "bias": self.bias}


class TpShardedDenseOp(_TpOp):
    """Tensor-parallel DenseOp: W (n_out, n_in) split over its input
    columns (keynet_tpu shards W as P(None, tp), sharding.py:74-78); each
    rank multiplies its columns of x and an all_reduce over tp sums the
    partial products."""
    _tensors = ("W",)

    def __init__(self, W, shape, nnz, mesh, tp_axis="tp"):
        self.W = W            # (n_out, n_in/tp), this rank's columns
        self.shape = tuple(shape)
        self._nnz = int(nnz)
        self.mesh, self.tp_axis = mesh, tp_axis

    @staticmethod
    def from_dense_op(op, mesh, tp_axis="tp"):
        tp, j = mesh.size(tp_axis), mesh.coords[tp_axis]
        k = op.shape[1] // tp
        return TpShardedDenseOp(op.W[:, j * k:(j + 1) * k].to(mesh.device).contiguous(),
                                op.shape, op.nnz(), mesh, tp_axis)

    def apply(self, x):
        k = self.W.shape[1]
        j = self.mesh.coords[self.tp_axis]
        return all_reduce_sum(torch.matmul(x[:, j * k:(j + 1) * k], self.W.T),
                              self.mesh, self.tp_axis)

    def device_bytes(self):
        return int(np.prod(self.shape)) * 4

    def arrays(self):
        return {"W": self.W}


def _is_tp(op):
    return type(op).__name__.startswith("TpSharded")


def _links(plan):
    """Every op of a plan and every link of its chains."""
    for op in plan:
        yield from (op.ops if isinstance(op, ChainedOp) else (op,))


def _tp_of(link):
    """The tp-sharded op a plan link is, or wraps in permutations and
    channel broadcasts; None for a replicated link."""
    while not _is_tp(link) and isinstance(link, (PermutedBlockSparseOp,
                                                 ChannelBroadcastOp)):
        link = link.inner
    return link if _is_tp(link) else None


def plan_local_bytes(plan):
    """Bytes of a shard_keynet_ops plan that this rank holds: its shards'
    local_bytes, the wrappers around them and the replicated ops whole."""
    total = 0
    for link in _links(plan):
        tp = _tp_of(link)
        total += link.device_bytes() if tp is None else \
            link.device_bytes() - tp.device_bytes() + tp.local_bytes()
    return total


def tp_block_ops(plan):
    """The TpShardedBlockEllOps of a plan (their ``local`` BlockSparseOps
    are the cores the Block-ELL kernels run on)."""
    return [tp for tp in map(_tp_of, _links(plan)) if isinstance(tp, TpShardedBlockEllOp)]


# ------------------------------------------------------------------ plans

def shard_keynet_ops(knet, mesh, tp_axis="tp", min_tp_bytes=32 * 1024 * 1024):
    """The keynet's ops for a (dp, tp) mesh, with keynet_tpu's decisions
    and gates: a DenseOp of at least ``min_tp_bytes`` whose n_in divides by
    tp splits over its input columns; (Permuted)BlockSparseOps and EllOps of
    at least ``min_tp_bytes`` split over row-blocks/rows (Block-ELL only
    where no shard needs more than 75% of the unique tiles); every
    RepeatedBlockDiagOp whose block count divides by tp splits over blocks;
    a channel-broadcast pool of at least ``min_tp_bytes`` shards its
    spatial factor; chains of at least ``min_tp_bytes // 8`` shard their
    shardable links (tp_shard_chain_op).  Everything else replicates, moved
    to the mesh's device.  The plan is made from the published ops
    (``knet.published_ops()``), whose chains keep their Kronecker links:
    the single-device plan's fold is not taken here.  A residual net's
    shortcut ops follow its stages' ops there and take the same decisions
    (an add needs their whole output, which every tp form gives).  Returns
    the ops for knet.run(x, ops)."""
    tp = mesh.size(tp_axis)
    out = []
    for op in knet.published_ops():
        if (isinstance(op, DenseOp) and tp > 1
                and op.W.numel() * 4 >= min_tp_bytes and op.W.shape[1] % tp == 0):
            out.append(TpShardedDenseOp.from_dense_op(op, mesh, tp_axis))
            continue
        if (isinstance(op, (BlockSparseOp, PermutedBlockSparseOp)) and tp > 1
                and op.device_bytes() >= min_tp_bytes):
            tpop = tp_shard_block_op(op, mesh, tp_axis)
            if tpop is not None:
                out.append(tpop)
                continue
        if (isinstance(op, EllOp) and tp > 1
                and op.device_bytes() >= min_tp_bytes):
            tpop = TpShardedEllOp.from_ell_op(op, mesh, tp_axis)
            if tpop is not None:
                out.append(tpop)
                continue
        if isinstance(op, RepeatedBlockDiagOp) and tp > 1:
            tpop = TpShardedRepeatedBlockDiagOp.from_op(op, mesh, tp_axis)
            if tpop is not None:
                out.append(tpop)
                continue
        if (isinstance(op, ChannelBroadcastOp) and tp > 1
                and op.device_bytes() >= min_tp_bytes):
            # the pool's memory lives in its spatial inner op: shard that and
            # rebuild the broadcast wrapper (the inner sees (B*C, p1) batches)
            inner = None
            if isinstance(op.inner, EllOp):
                inner = TpShardedEllOp.from_ell_op(op.inner, mesh, tp_axis)
            elif isinstance(op.inner, (BlockSparseOp, PermutedBlockSparseOp)):
                inner = tp_shard_block_op(op.inner, mesh, tp_axis)
            if inner is not None:
                out.append(ChannelBroadcastOp(inner, op.C, op.bias_sp.to(mesh.device),
                                              nnz=op.nnz()))
                continue
        # Kronecker/TapSum chains are factor-compact (MBs) but FLOP-heavy;
        # shard their matmuls once the factors are big enough
        if (isinstance(op, ChainedOp) and tp > 1
                and op.device_bytes() >= min_tp_bytes // 8):
            tpop = tp_shard_chain_op(op, mesh, tp_axis)
            if tpop is not None:
                out.append(tpop)
                continue
        out.append(op.to(mesh.device))
    return tuple(out)


def tp_shard_chain_op(op, mesh, tp_axis="tp", max_replication=0.75):
    """A ChainedOp with its shardable links in tp form: TapSum over taps,
    Kronecker over channel rows, (Permuted)BlockSparseOp over row-blocks
    (tp_shard_block_op), EllOp over rows, RepeatedBlockDiagOp over blocks;
    the other links replicate.  None when no link shards."""
    if not isinstance(op, ChainedOp) or mesh.size(tp_axis) <= 1:
        return None
    out, any_sharded = [], False
    for link in op.ops:
        conv = None
        if isinstance(link, TapSumOp):
            conv = TpShardedTapSumOp.from_tapsum_op(link, mesh, tp_axis)
        elif isinstance(link, KroneckerOp):
            conv = TpShardedKroneckerOp.from_kron_op(link, mesh, tp_axis)
        elif isinstance(link, (BlockSparseOp, PermutedBlockSparseOp)):
            conv = tp_shard_block_op(link, mesh, tp_axis,
                                     max_replication=max_replication)
        elif isinstance(link, EllOp):
            conv = TpShardedEllOp.from_ell_op(link, mesh, tp_axis)
        elif isinstance(link, RepeatedBlockDiagOp):
            conv = TpShardedRepeatedBlockDiagOp.from_op(link, mesh, tp_axis)
        if conv is not None:
            out.append(conv)
            any_sharded = True
        else:
            out.append(link.to(mesh.device))
    return ChainedOp(out) if any_sharded else None


def tp_shard_block_op(op, mesh, tp_axis="tp", max_replication=0.75):
    """A (Permuted)BlockSparseOp in tile-row tp form where the per-shard
    compacted stores cut per-rank memory: no shard may need more than
    ``max_replication`` of the unique non-zero tiles (periodic matrices
    share tiles across shards and stay replicated).  None otherwise."""
    inner = op.inner if isinstance(op, PermutedBlockSparseOp) else op
    if not isinstance(inner, BlockSparseOp):
        return None
    tp = mesh.size(tp_axis)
    if tp <= 1:
        return None
    ids = inner.tile_ids.cpu().numpy()
    rb_per = -(-ids.shape[0] // tp)
    full_u = max(1, len(np.setdiff1d(np.unique(ids), [0])))
    per_u = max(len(np.setdiff1d(np.unique(ids[j * rb_per:(j + 1) * rb_per]), [0]))
                for j in range(tp))
    if per_u > max_replication * full_u:
        return None
    tp_inner = TpShardedBlockEllOp.from_block_op(inner, mesh, tp_axis)
    if isinstance(op, PermutedBlockSparseOp):
        return PermutedBlockSparseOp(tp_inner, op.perm_in.to(mesh.device),
                                     op.perm_out_pos.to(mesh.device), op.shape,
                                     layout_in=op.layout_in, layout_out=op.layout_out)
    return tp_inner


def replication_report(plan, min_bytes=32 << 20):
    """Audit a shard_keynet_ops plan (keynet_tpu's): every op or chain link
    that stays whole on every rank with at least ``min_bytes``, as
    (path, type name, bytes, reason); reason is None for a replication
    with no structural reason, which callers may assert never happens."""

    def reason_for(op):
        inner = op.inner if isinstance(op, PermutedBlockSparseOp) else op
        if isinstance(inner, BlockSparseOp):
            if inner.period is not None:
                return "periodic tile store: shards share the period's tiles"
            return "row shards would each need >75% of the unique tiles"
        if isinstance(op, DirectConvOp):
            return "conv filter: O(C^2 k^2) bytes, below any sharding payoff"
        if isinstance(op, DenseOp):
            return "in_features not divisible by tp"
        if isinstance(op, KroneckerOp):
            return "perm_out gather crosses shard boundaries" \
                if op.perm_out is not None else None
        if isinstance(op, RepeatedBlockDiagOp):
            return "block count not divisible by tp"
        if isinstance(op, (TapSumOp, EllOp, ChannelBroadcastOp)):
            return None
        return "no tp form for %s" % type(op).__name__

    rows = []
    for i, op in enumerate(plan):
        links = op.ops if isinstance(op, ChainedOp) else [op]
        for j, link in enumerate(links):
            if _is_tp(link) or (isinstance(link, (PermutedBlockSparseOp,
                                                  ChannelBroadcastOp))
                                and _is_tp(link.inner)):
                continue
            nbytes = int(link.device_bytes())
            if nbytes < min_bytes:
                continue
            rows.append(("op%d.link%d" % (i, j), type(link).__name__, nbytes,
                         reason_for(link)))
    return rows
