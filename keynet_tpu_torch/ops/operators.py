"""Device-resident linear operators for keyed inference (PyTorch).

Each keyed matrix is packed ONCE on the host into one device format chosen by
size/occupancy, and the keyed forward runs with keys resident in device
memory:

  * DenseOp  — one matmul.  Best whenever the dense footprint is small.
  * BlockSparseOp — Block-ELL: (TM, TN) tiles, only nonzero tiles stored,
    deduplicated by content, each tile-row padded to the max tile count.
    BlockSparseOp.schedule says which kernels of ops/block_ell.py, or
    which of their plain versions, an apply runs.
  * EllOp    — row-wise fixed-K scalar sparse (gather + weighted reduce).
  * ChannelBroadcastOp — I_C ⊗ M for keyed pools with per-channel-identical
    keys, M any of the above.

All operators implement apply(x) with x: (B, n_in) -> (B, n_out), i.e.
y = x @ W^T, and hold their arrays as tensors on one device; ``to(device)``
moves them (conversion builds every op on the CPU, KeyedModel moves the
finished ops once).
"""

import collections

import numpy as np
import scipy.sparse
import torch
import torch.nn.functional as F

from ..globals import GLOBAL, kernel_precision
from ..profiling import GROUPED_ROWS, annotate

# Default tile for blocked-sparse keyed matrices.
DEFAULT_TILE = (128, 128)


def _cdiv(a, b):
    return -(-a // b)


def _t(a, dtype=None):
    """Host array -> CPU tensor (numpy arrays are copied, never aliased)."""
    if torch.is_tensor(a):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(np.array(a), dtype=dtype)


def tile_dtype():
    return torch.bfloat16 if GLOBAL.get("TILE_DTYPE") == "bfloat16" \
        else torch.float32


# One part of a Block-ELL apply (BlockSparseOp.schedule): ``kind`` "rows",
# "periodic" or "grouped" produces row-blocks [a, b) by launching the
# ops/block_ell entry named ``entry``, or its plain version where it is None.
Step = collections.namedtuple("Step", "kind a b entry")


class LinearOp:
    """Base protocol: shape (n_out, n_in) operator with batched apply."""
    shape = (0, 0)
    _tensors = ()   # names of the tensor attributes ``to`` moves

    def apply(self, x):  # (B, n_in) -> (B, n_out)
        raise NotImplementedError

    def nnz(self):
        raise NotImplementedError

    def device_bytes(self):
        raise NotImplementedError

    def arrays(self):
        """Dict of the op's tensors (for serialization)."""
        raise NotImplementedError

    def to(self, device):
        """Move every tensor of the op to ``device`` (in place); returns self."""
        for name in self._tensors:
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.to(device))
        return self

    @property
    def device(self):
        for name in self._tensors:
            v = getattr(self, name)
            if v is not None:
                return v.device
        return torch.device("cpu")


class DenseOp(LinearOp):
    _tensors = ("W",)

    def __init__(self, W, nnz=None):
        self.W = _t(W, torch.float32)  # (n_out, n_in)
        self.shape = tuple(self.W.shape)
        self._nnz = int(nnz) if nnz is not None else int(np.prod(self.shape))

    @staticmethod
    def from_scipy(A):
        dense = np.asarray(A.todense(), dtype=np.float32)
        return DenseOp(dense, nnz=A.nnz)

    def apply(self, x):
        return torch.matmul(x, self.W.T)

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return int(np.prod(self.shape)) * 4

    def arrays(self):
        return {"W": self.W}


class DirectConvOp(LinearOp):
    """Identity-keyed conv2d / avgpool2d applied as a convolution: with both
    layer keys exact identities, Ŵ IS the homogeneous Toeplitz matrix of the
    source layer, so the op stores the (C2, C1/groups, kh, kw) filter.

    Homogeneous contract: x (B, C1·H1·W1+1) -> (B, C2·H2·W2+1); the
    per-channel bias rides the trailing column and the trailing 1 carries
    through.  Padding/stride semantics match toeplitz_conv2d.  ``groups=C``
    gives the channel-diagonal avgpool form.  nnz() is the exact Toeplitz
    stored-entry count.
    """
    _tensors = ("weight", "bias")

    def __init__(self, weight, bias, inshape, outshape, stride, groups=1,
                 nnz=None):
        self.weight = _t(weight, torch.float32)
        self.bias = None if bias is None else _t(bias, torch.float32)
        self.inshape = tuple(inshape)
        self.outshape = tuple(outshape)
        self.stride = int(stride)
        self.groups = int(groups)
        self.shape = (int(np.prod(outshape)) + 1, int(np.prod(inshape)) + 1)
        self._nnz = int(nnz) if nnz is not None else self.toeplitz_nnz(
            inshape, outshape, self.weight.shape[2], self.weight.shape[3],
            stride, groups, bias is not None)

    @staticmethod
    def toeplitz_nnz(inshape, outshape, kh, kw, stride, groups, has_bias):
        C1, H1, W1 = inshape
        C2, H2, W2 = outshape
        hp, hq = (kh - 1) // 2, (kw - 1) // 2
        ku = np.arange(H2, dtype=np.int64) * stride
        kv = np.arange(W2, dtype=np.int64) * stride
        nu = np.minimum(H1, ku - hp + kh) - np.maximum(0, ku - hp)
        nv = np.minimum(W1, kv - hq + kw) - np.maximum(0, kv - hq)
        taps = int(nu.sum() * nv.sum())
        body = taps * C2 * (C1 // groups)
        return body + (C2 * H2 * W2 if has_bias else 0) + 1

    def apply(self, x):
        B = x.shape[0]
        C1, H1, W1 = self.inshape
        C2, H2, W2 = self.outshape
        kh, kw = self.weight.shape[2], self.weight.shape[3]
        hp, hq = (kh - 1) // 2, (kw - 1) // 2
        s = self.stride
        pr_h = max(0, (H2 - 1) * s + kh - 1 - hp - (H1 - 1))
        pr_w = max(0, (W2 - 1) * s + kw - 1 - hq - (W1 - 1))
        xc = F.pad(x[:, :-1].reshape(B, C1, H1, W1), (hq, pr_w, hp, pr_h))
        xh = x[:, -1:]
        y = F.conv2d(xc, self.weight, stride=s, groups=self.groups)
        y = y[:, :, :H2, :W2].reshape(B, C2, H2 * W2)
        if self.bias is not None:
            y = y + xh[:, :, None] * self.bias[None, :, None]
        return torch.cat([y.reshape(B, -1), xh], dim=1)

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return int(self.weight.numel() + (self.bias.numel() if self.bias is not None
                                          else 0)) * 4

    def arrays(self):
        a = {"weight": self.weight}
        if self.bias is not None:
            a["bias"] = self.bias
        return a


class BlockSparseOp(LinearOp):
    """Block-ELL sparse operator with content-deduplicated tiles.

    Layout:
      tiles:    (n_unique, TM, TN) f32 or bf16 — tile 0 is zero
      tile_ids: (n_rb, KB) int32 — for each row-block, ids into tiles
      col_blk:  (n_rb, KB) int32 — column-block index of each slot
    Apply:
      y[:, r] = sum_k tiles[tile_ids[r,k]] @ x[:, col_blk[r,k]]

    ``period=(s, P, R)`` records row-block periodicity (tile_ids rows
    s+rho+j*P identical for j in [0,R)); its rows apply as a periodic step
    and the period's tiles are expanded once where that step is an einsum
    (``_Texp``).  Non-periodic ops whose rows repeat in arbitrary order get
    a grouped-row plan (find_row_groups), which applies as a grouped step.
    ``schedule`` decides the steps of an apply, ``run_step`` runs one.
    """
    _tensors = ("tiles", "tile_ids", "col_blk")

    def __init__(self, tiles, tile_ids, col_blk, shape, tileshape, nnz,
                 period=None):
        self.tiles = _t(tiles)
        self.tile_ids = _t(tile_ids, torch.int32)
        self.col_blk = _t(col_blk, torch.int32)
        self.shape = tuple(shape)            # logical (n_out, n_in)
        self.tileshape = tuple(tileshape)
        self._nnz = int(nnz)
        self.period = tuple(int(v) for v in period) if period else None
        n_rb, KB = self.tile_ids.shape
        TM, TN = self.tileshape
        if tuple(self.tiles.shape[1:]) != (TM, TN) \
                or n_rb != _cdiv(self.shape[0], TM):
            raise ValueError("Block-ELL arrays do not match shape %s / tile %s"
                             % (self.shape, self.tileshape))
        if self.tile_ids.numel():
            ids = self.tile_ids.cpu()
            cbs = self.col_blk.cpu()
            if int(ids.min()) < 0 or int(ids.max()) >= self.tiles.shape[0] \
                    or int(cbs.min()) < 0 \
                    or int(cbs.max()) >= _cdiv(self.shape[1], TN):
                raise ValueError("Block-ELL tile_ids/col_blk out of range")
        self._Texp = None
        self._sync_texp()
        # the grouped-row plan: int32 (patterns (ΣG, KB), rows (n_rb,)), each
        # bucket's in turn (find_row_groups), and (m, G) a bucket
        self._rgroups = None
        self._rgroup_meta = ()
        self._rgroup_reads = ()
        self._rgroup_tables = {}     # B -> the grouped kernel's launches
        if (self.period is None
                and n_rb * KB * TM * TN * self.tiles.element_size()
                >= int(GLOBAL.get("ROWGROUP_MIN_SLOT_BYTES", 64 << 20))):
            ids_np = self.tile_ids.cpu().numpy()
            plan = find_row_groups(ids_np)
            if plan is not None:
                cb_np = self.col_blk.cpu().numpy()
                self._rgroups = tuple(
                    torch.as_tensor(np.concatenate([b[i] for b in plan["buckets"]]),
                                    dtype=torch.int32, device=self.tile_ids.device)
                    for i in (2, 1))
                self._rgroup_meta = tuple((m, len(p)) for m, _, p in plan["buckets"])
                # what the apply has to read, kept in profiling.GROUPED_ROWS:
                # each bucket's non-zero pattern slots, the distinct non-zero
                # tiles and the x blocks that non-zero slots read
                nz = ids_np > 0
                self._rgroup_reads = (
                    tuple(int((p > 0).sum()) for _, _, p in plan["buckets"]),
                    int(np.unique(ids_np[nz]).size), int(np.unique(cb_np[nz]).size))

    def to(self, device):
        super().to(device)
        if self._rgroups is not None:
            self._rgroups = tuple(t.to(device) for t in self._rgroups)
            self._rgroup_tables = {}
        self._sync_texp()
        return self

    def _sync_texp(self):
        """Keep the period's expanded tile set tiles[tile_ids[s:s+P]]
        (P, KB, TM, TN) off the kernel side, where the periodic einsum uses
        it, within GLOBAL['PERIODIC_EXPAND_BYTES'].  The expansion is the
        TPU's way round a per-forward gather; the CUDA kernel reads tiles
        through tile_ids."""
        if self.period is None or self._kernel_side(self.tiles.device) \
                or self._expand_bytes() > int(GLOBAL.get("PERIODIC_EXPAND_BYTES",
                                                         512 << 20)):
            self._Texp = None
        elif self._Texp is None or self._Texp.device != self.tiles.device:
            s, P, _ = self.period
            self._Texp = self.tiles[self.tile_ids[s:s + P].long()]

    def _kernel_side(self, device):
        """Whether an apply on ``device`` launches the CUDA kernels of
        ops/block_ell.py: off the CPU, for TM and TN multiples of 128, as
        keynet_tpu gates its Pallas kernels (keynet_tpu/ops/operators.py:515,
        :559); the kernel wrappers refuse other tiles."""
        TM, TN = self.tileshape
        return torch.device(device).type != "cpu" and TM % 128 == 0 and TN % 128 == 0

    def _expand_bytes(self):
        if self.period is None:
            return 0
        P = self.period[1]
        KB = self.tile_ids.shape[1]
        TM, TN = self.tileshape
        return P * KB * TM * TN * self.tiles.element_size()

    @staticmethod
    def plan(A, tileshape=DEFAULT_TILE, chunk_entries=8_000_000):
        """Pack a scipy sparse matrix into Block-ELL arrays (host side),
        processing row-block-aligned chunks so peak memory stays bounded.
        Returns the constructor kwargs (tiles as a CPU tensor)."""
        A = scipy.sparse.csr_matrix(A)
        TM, TN = tileshape
        n_out, n_in = A.shape
        packer = StreamingBlockPacker((n_out, n_in), tileshape)
        indptr = A.indptr
        rb = 0
        n_rb = _cdiv(n_out, TM)
        while rb < n_rb:
            rb_end, r0 = rb, rb * TM
            while rb_end < n_rb:
                r1 = min(n_out, (rb_end + 1) * TM)
                if rb_end > rb and indptr[r1] - indptr[r0] > chunk_entries:
                    break
                rb_end += 1
            r1 = min(n_out, rb_end * TM)
            e0, e1 = indptr[r0], indptr[r1]
            if e1 > e0:
                Sc = scipy.sparse.csr_matrix(
                    (A.data[e0:e1], A.indices[e0:e1],
                     indptr[r0:r1 + 1].astype(np.int64) - int(e0)),
                    shape=(r1 - r0, n_in))
                packer.add_strip_csr(Sc, r0)
            rb = rb_end
        op = packer.finalize()
        return dict(tiles=op.tiles, tile_ids=op.tile_ids.numpy(),
                    col_blk=op.col_blk.numpy(), shape=(n_out, n_in),
                    tileshape=(TM, TN), nnz=A.nnz, period=op.period)

    @staticmethod
    def from_scipy(A, tileshape=DEFAULT_TILE):
        plan = BlockSparseOp.plan(A, tileshape)
        return BlockSparseOp(plan["tiles"], plan["tile_ids"], plan["col_blk"],
                             plan["shape"], plan["tileshape"], plan["nnz"],
                             period=plan.get("period"))

    def apply(self, x):
        TM, TN = self.tileshape
        n_out, n_in = self.shape
        pad_in = _cdiv(n_in, TN) * TN - n_in
        if pad_in:
            x = F.pad(x, (0, pad_in))
        if self.tiles.dtype != torch.float32:
            x = x.to(self.tiles.dtype)  # bf16 operands, f32 accumulation
        x = x.contiguous()
        parts = [self.run_step(step, x) for step in self.schedule(x.shape[0], x.device)]
        y = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        return y[:, :n_out]

    def schedule(self, B, device):
        """The steps an apply to B rows on ``device`` runs, in order: a
        tuple of Step(kind, a, b, entry).  Under the period's gate, the
        rows before it, the periodic step and the rows after it; else, with
        a grouped-row plan, the grouped step where it reads less than the
        slot walk; else the slot walk of every row.  On the kernel side
        (_kernel_side) each step names its ops/block_ell entry, and the
        grouped step does so for IEEE f32 products only (kernel_precision)."""
        from . import block_ell
        TM, TN = self.tileshape
        n_rb, KB = self.tile_ids.shape
        kernel = self._kernel_side(device)
        rows = None
        if kernel:
            # by identity, not __name__: a wrapper may stand in for an entry
            # (the kernel bench counts each launch's work so)
            walk = block_ell.route(KB)
            rows = next(n for n in block_ell.ENTRIES if getattr(block_ell, n) is walk)
        if self.period is not None and B <= (self.period[2] - 1) * TM // self.period[2]:
            s, P, R = self.period
            steps = (Step("rows", 0, s, rows),) if s else ()
            steps += (Step("periodic", s, s + P * R,
                           "periodic_block_ell_matvec" if kernel else None),)
            if s + P * R < n_rb:
                steps += (Step("rows", s + P * R, n_rb, rows),)
            return steps
        if self._rgroups is not None:
            # no traffic model for the grouped kernel: it reads each distinct
            # non-zero tile once, and a plan's rows repeat patterns, so there
            # are fewer of those than the slot walk's slots
            if kernel and kernel_precision(self.tiles.dtype) == "ieee":
                return (Step("grouped", 0, n_rb, "grouped_block_ell_matmul"),)
            # the grouped einsum gathers each pattern's tiles once (write and
            # read), the x blocks a slot and reorders the output; the slot
            # walk reads a tile a slot, its gather + einsum writes and reads it
            it = self.tiles.element_size()
            tile_b, x_b = TM * TN * it, n_rb * KB * B * TN * it
            grouped = 2 * sum(G * KB for _, G in self._rgroup_meta) * tile_b + x_b \
                + 2 * B * n_rb * TM * 4
            if grouped < (1 if kernel else 2) * n_rb * KB * tile_b + x_b:
                return (Step("grouped", 0, n_rb, None),)
        return (Step("rows", 0, n_rb, rows),)

    def run_step(self, step, x):
        """One step of ``schedule`` on the padded, cast, contiguous
        (B, n_cb·TN) x: its entry, looked up in ops/block_ell at the call,
        or the entry's plain version.  A grouped step runs in the span
        ``keynet.grouped``, with its launches laid out once a batch size
        (_rgroup_tables), and is recorded in profiling.GROUPED_ROWS,
        ``chunks`` counting the kernel's launches or the einsums.  Returns
        (B, (b-a)·TM) f32."""
        from . import block_ell
        kind, a, b, entry = step
        TM, TN = self.tileshape
        if kind == "rows":
            fn = block_ell.block_ell_plain if entry is None else getattr(block_ell, entry)
            return fn(x, self.tiles, self.tile_ids[a:b], self.col_blk[a:b], (b - a) * TM)
        if kind == "periodic":
            if entry is None:
                return block_ell.periodic_block_ell_plain(
                    x, self.tiles, self.tile_ids, self.col_blk, *self.period, texp=self._Texp)
            return getattr(block_ell, entry)(x, self.tiles, self.tile_ids, self.col_blk,
                                             *self.period)
        B = x.shape[0]
        n_rb, KB = self.tile_ids.shape
        it = self.tiles.element_size()
        patterns, rows = self._rgroups
        with annotate("keynet.grouped"):
            if entry is None:
                y = block_ell.grouped_block_ell_plain(x, self.tiles, patterns, rows,
                                                      self.col_blk, self._rgroup_meta, n_rb * TM)
                chunks = sum(-(-G // block_ell.grouped_chunk(B, m, G, KB, TN, it))
                             for m, G in self._rgroup_meta)
            else:
                tables = self._rgroup_tables.get(B)
                if tables is None:
                    if len(self._rgroup_tables) >= 8:   # a few batch sizes are served
                        self._rgroup_tables.clear()
                    tables = self._rgroup_tables[B] = block_ell.grouped_tables(
                        self._rgroup_meta, patterns, B, TM, TN, self.tiles.dtype, x.device)
                y = getattr(block_ell, entry)(x, self.tiles, patterns, rows, self.col_blk,
                                              self._rgroup_meta, n_rb * TM, tables)
                chunks = len(tables["launches"])
            nz_slots, n_tiles, x_blocks = self._rgroup_reads
            GROUPED_ROWS["applies"] += 1
            GROUPED_ROWS["chunks"] += chunks
            GROUPED_ROWS["cores"]["%dx%d" % self.shape] = dict(
                last=GROUPED_ROWS["applies"], B=B, x_itemsize=x.element_size(),
                tiles=n_tiles, x_blocks=x_blocks,
                buckets=[[m, G, KB, TM, TN, it, nz]
                         for (m, G), nz in zip(self._rgroup_meta, nz_slots)])
        return y

    def row_shard_plan(self, tp):
        """Host-side tile-row partition for tensor-parallel serving
        (keynet_tpu/ops/operators.py:579-616): split the row-blocks into
        ``tp`` contiguous shards, each with a COMPACTED tile store holding
        only the unique tiles its rows reference, and local ids into it:

          tiles:    (tp, u_max, TM, TN)   per-shard unique tiles, zero-padded
          tile_ids: (tp, rb_per, KB)      LOCAL ids into that shard's tiles
          col_blk:  (tp, rb_per, KB)
          rb_per:   row-blocks per shard (row padding uses the zero tile)

        tile_ids and col_blk are numpy arrays equal to keynet_tpu's; tiles
        is a tensor on the op's device (numpy has no bfloat16) whose values
        equal keynet_tpu's.  Local id 0 is the shard's smallest global id,
        a real tile where the shard has no id-0 slot
        (parallel.sharding.TpShardedBlockEllOp puts the zero tile first)."""
        ids = self.tile_ids.cpu().numpy()
        cols = self.col_blk.cpu().numpy()
        n_rb, KB = ids.shape
        rb_per = _cdiv(n_rb, tp)
        pad = rb_per * tp - n_rb
        if pad:
            ids = np.vstack([ids, np.zeros((pad, KB), ids.dtype)])
            cols = np.vstack([cols, np.zeros((pad, KB), cols.dtype)])
        ids3 = ids.reshape(tp, rb_per, KB)
        uniqs = [np.unique(ids3[j]) for j in range(tp)]
        u_max = max(len(u) for u in uniqs)
        tiles_st = torch.zeros((tp, u_max) + tuple(self.tiles.shape[1:]),
                               dtype=self.tiles.dtype, device=self.tiles.device)
        ids_st = np.zeros_like(ids3)
        for j, u in enumerate(uniqs):
            tiles_st[j, :len(u)] = self.tiles[torch.from_numpy(u).long()
                                              .to(self.tiles.device)]
            remap = np.zeros(int(u.max()) + 1, dtype=ids.dtype)
            remap[u] = np.arange(len(u), dtype=ids.dtype)
            ids_st[j] = remap[ids3[j]]
        return dict(tiles=tiles_st, tile_ids=ids_st,
                    col_blk=cols.reshape(tp, rb_per, KB), rb_per=int(rb_per))

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        texp = self._Texp.numel() * self._Texp.element_size() \
            if self._Texp is not None else 0
        rg = 0
        if self._rgroups is not None:   # as keynet_tpu counts its plan: int32
            n_rb, KB = self.tile_ids.shape   # patterns, column blocks, order
            rg = (sum(G for _, G in self._rgroup_meta) * KB + n_rb * KB + n_rb) * 4
        return int(self.tiles.numel()) * self.tiles.element_size() \
            + int(self.tile_ids.numel()) * 8 + texp + rg

    def arrays(self):
        return {"tiles": self.tiles, "tile_ids": self.tile_ids, "col_blk": self.col_blk}


class StreamingBlockPacker:
    """Incremental Block-ELL packer: feed COO strips covering whole row-blocks,
    get content-deduplicated tiles + per-row-block slot arrays.  Tiles are
    numbered in first-seen order, so the native and numpy feeds give the same
    tile_ids for the same strips as the JAX package's packer."""

    def __init__(self, shape, tileshape=DEFAULT_TILE):
        from .. import native
        self.shape = shape
        self.TM, self.TN = tileshape
        self.n_rb = _cdiv(shape[0], self.TM)
        self.n_cb = _cdiv(shape[1], self.TN)
        self._native = native if native.available() else None
        self._uniq = {}
        # unique tiles in fixed-size chunks, each byte written exactly once
        self._chunk = 1024
        self._chunks = [np.empty((self._chunk, self.TM, self.TN), dtype=np.float32)]
        self._chunks[0][0] = 0.0
        self._n_tiles = 1  # tile 0 is the zero tile
        self._uniq[self._key(self._chunks[0][0])] = 0
        self._rb_slots = [[] for _ in range(self.n_rb)]  # (col_blk, tile_id)
        self._rb_slot_entries = [[] for _ in range(self.n_rb)]
        self.nnz = 0

    @staticmethod
    def _hash(b):
        import hashlib
        return hashlib.blake2b(b, digest_size=16).digest()

    def _tile(self, tid):
        return self._chunks[tid // self._chunk][tid % self._chunk]

    def _reserve_tile(self):
        if self._n_tiles == len(self._chunks) * self._chunk:
            self._chunks.append(np.empty((self._chunk, self.TM, self.TN),
                                         dtype=np.float32))
        self._n_tiles += 1
        return self._n_tiles - 1

    def _add_tile(self, tile):
        tid = self._reserve_tile()
        self._tile(tid)[...] = tile
        return tid

    def _key(self, tile):
        if self._native is not None:
            if self._native.tile_hashes128 is not None:
                h = self._native.tile_hashes128(
                    np.ascontiguousarray(tile[None], dtype=np.float32))
                return (int(h[0, 0]), int(h[0, 1]))
            return int(self._native.tile_hashes(tile[None])[0])
        return self._hash(tile.tobytes())

    def _dedup_retained(self, packed):
        """Dedup one strip's placed tiles from a native pack_*_hash result
        (128-bit hash identity; only NEW uniques are copied out)."""
        pairs, hashes, counts = packed
        uniq = self._uniq
        rb_slots, rb_entries = self._rb_slots, self._rb_slot_entries
        n_cb = self.n_cb
        h0 = hashes[:, 0].tolist()
        h1 = hashes[:, 1].tolist()
        pl = pairs.tolist()
        cl = counts.tolist()
        new = []
        for i in range(len(pl)):
            key = (h0[i], h1[i])
            tid = uniq.get(key)
            if tid is None:
                tid = self._reserve_tile()
                uniq[key] = tid
                new.append((i, tid))
            p = pl[i]
            rb_slots[p // n_cb].append((p % n_cb, tid))
            rb_entries[p // n_cb].append(cl[i])
        if new:
            got = self._native.take_tiles(
                np.asarray([i for i, _ in new], dtype=np.int64))
            for j, (_, tid) in enumerate(new):
                self._tile(tid)[...] = got[j]

    def add_strip_csr(self, S, r0=0, cpos=None):
        """Feed one scipy CSR strip whose rows occupy final rows
        [r0, r0 + S.shape[0]); ``cpos`` optionally relabels columns."""
        nnz = int(S.indptr[-1])
        if self._native is not None \
                and self._native.pack_csr_hash is not None \
                and S.indices.dtype == np.int32 \
                and S.data.dtype == np.float32 \
                and (cpos is None or cpos.dtype == np.int32):
            if nnz == 0:
                return
            self.nnz += nnz
            self._dedup_retained(self._native.pack_csr_hash(
                np.ascontiguousarray(S.indptr, dtype=np.int64),
                S.indices, S.data, int(r0),
                cpos if cpos is None else np.ascontiguousarray(cpos),
                self.TM, self.TN, self.n_cb))
            return
        C = S.tocoo(copy=False)
        rows = C.row.astype(np.int32) + np.int32(r0)
        cols = C.col if cpos is None else cpos[C.col]
        self.add_strip(rows, cols.astype(np.int32, copy=False), C.data)

    def add_strip(self, rows, cols, vals):
        """rows/cols in final coordinates; (row, col) pairs unique, rows
        non-decreasing, each row-block fed by exactly one strip."""
        if len(rows) == 0:
            return
        idt = np.int32 if (np.asarray(rows).dtype == np.int32
                           and np.asarray(cols).dtype == np.int32) else np.int64
        rows = np.ascontiguousarray(rows, dtype=idt)
        cols = np.ascontiguousarray(cols, dtype=idt)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        self.nnz += len(vals)
        if self._native is not None and self._native.pack_strip_hash is not None:
            self._dedup_retained(self._native.pack_strip_hash(
                rows, cols, vals, self.TM, self.TN, self.n_cb))
            return
        if self._native is not None:
            # stale-build path: 64-bit hash hits verified by content compare
            placed_pairs, placed, entry_counts = self._native.pack_strip(
                rows, cols, vals, self.TM, self.TN, self.n_cb)
            hashes = self._native.tile_hashes(placed)
            for i, (p, h) in enumerate(zip(placed_pairs, hashes)):
                tid = self._uniq.get(int(h))
                if tid is not None and not np.array_equal(self._tile(tid), placed[i]):
                    tid = None
                if tid is None:
                    tid = self._add_tile(placed[i])
                    self._uniq[int(h)] = tid
                self._rb_slots[int(p // self.n_cb)].append((int(p % self.n_cb), tid))
                self._rb_slot_entries[int(p // self.n_cb)].append(int(entry_counts[i]))
            return
        pair = (rows // self.TM) * self.n_cb + (cols // self.TN)
        placed_pairs, inv = np.unique(pair, return_inverse=True)
        entry_counts = np.bincount(inv, minlength=len(placed_pairs))
        placed = np.zeros((len(placed_pairs), self.TM, self.TN), dtype=np.float32)
        placed[inv, rows % self.TM, cols % self.TN] = vals
        for i, p in enumerate(placed_pairs):
            key = self._hash(placed[i].tobytes())
            tid = self._uniq.get(key)
            if tid is None:
                tid = self._add_tile(placed[i])
                self._uniq[key] = tid
            self._rb_slots[int(p // self.n_cb)].append((int(p % self.n_cb), tid))
            self._rb_slot_entries[int(p // self.n_cb)].append(int(entry_counts[i]))

    def finalize(self, detect_period=True):
        KB = max(1, max((len(s) for s in self._rb_slots), default=1))
        tile_ids = np.zeros((self.n_rb, KB), dtype=np.int32)
        col_blk = np.zeros((self.n_rb, KB), dtype=np.int32)
        for r, slots in enumerate(self._rb_slots):
            for k, (cb, tid) in enumerate(slots):
                tile_ids[r, k] = tid
                col_blk[r, k] = cb
        period = find_row_period(tile_ids) if detect_period else None
        parts = []
        left = self._n_tiles
        for c in self._chunks:
            parts.append(torch.from_numpy(c[:min(left, self._chunk)]).to(tile_dtype()))
            left -= self._chunk
            if left <= 0:
                break
        tiles = parts[0].clone() if len(parts) == 1 else torch.cat(parts, dim=0)
        return BlockSparseOp(tiles, tile_ids, col_blk, self.shape,
                             (self.TM, self.TN), self.nnz, period=period)

    def n_unique(self):
        return self._n_tiles


class EllOp(LinearOp):
    """Row-wise fixed-K sparse (ELLPACK): cols/vals of shape (n_out, K).

    y[:, i] = sum_k vals[i, k] * x[:, cols[i, k]]: one gather and a weighted
    reduce, row-chunked so the gathered (B, rows, K) block stays under
    GLOBAL['ELL_GATHER_BYTES'].  ``cols`` are int32, as keynet_tpu holds them
    (8 bytes an entry with ``vals``); index_select reads them as they are.
    """
    _tensors = ("cols", "vals")

    def __init__(self, cols, vals, shape, nnz):
        self.cols = _t(cols, torch.int32)   # (n_out, K)
        self.vals = _t(vals, torch.float32)  # (n_out, K)
        self.shape = tuple(shape)
        self._nnz = int(nnz)

    @staticmethod
    def from_scipy(A):
        A = scipy.sparse.csr_matrix(A)
        n_out, n_in = A.shape
        counts = np.diff(A.indptr)
        K = max(1, int(counts.max()) if len(counts) else 1)
        cols = np.zeros((n_out, K), dtype=np.int32)
        vals = np.zeros((n_out, K), dtype=np.float32)
        within = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        rows = np.repeat(np.arange(n_out), counts)
        cols[rows, within] = A.indices
        vals[rows, within] = A.data
        return EllOp(cols, vals, (n_out, n_in), A.nnz)

    def apply(self, x):
        K = self.cols.shape[1]
        B = x.shape[0]
        n_out = self.shape[0]
        budget = int(GLOBAL.get("ELL_GATHER_BYTES", 512 << 20))
        rc = max(1, min(n_out, budget // max(1, B * K * 4)))
        parts = []
        for r0 in range(0, n_out, rc):
            c = self.cols[r0:r0 + rc]
            xg = x.index_select(1, c.reshape(-1)).reshape(B, c.shape[0], K)
            parts.append(torch.einsum("bnk,nk->bn", xg, self.vals[r0:r0 + rc]))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return int(self.cols.numel()) * 8

    def arrays(self):
        return {"cols": self.cols, "vals": self.vals}


class PermutedBlockSparseOp(LinearOp):
    """Block-ELL over an internal layout permutation: applies
    y = Pout^T · B · (Pin · x) where B = Ŵ[perm_out][:, perm_in] is packed as
    a BlockSparseOp.  Re-ordering rows/cols to (pixel-block,
    pixel-within-block, channel) makes each tile of a keyed conv a dense
    channel-matrix block, and the periodic Toeplitz structure deduplicates
    almost all interior tiles.  The structured layouts apply as
    reshape/permute; without a layout descriptor, as index gathers.
    """
    _tensors = ("perm_in", "perm_out_pos")

    def __init__(self, inner, perm_in, perm_out_pos, shape,
                 layout_in=None, layout_out=None):
        self.inner = inner
        self.perm_in = _t(perm_in, torch.int64)            # x_new[j] = x[perm_in[j]]
        self.perm_out_pos = _t(perm_out_pos, torch.int64)  # y[k] = y_new[perm_out_pos[k]]
        self.shape = tuple(shape)
        #   ('run', C, npix, p)            run_layout_perm order (run, pos, ch)
        #   ('runp', C, npix, p, W_run)    'run' with each run zero-padded
        #   ('blk', C, H, W, bh, bw)       conv_layout_perm pixel-block order
        self.layout_in = tuple(layout_in) if layout_in else None
        self.layout_out = tuple(layout_out) if layout_out else None

    def to(self, device):
        super().to(device)
        self.inner.to(device)
        return self

    @staticmethod
    def _to_layout(x, meta):
        """(B, n_core) channel-major -> layout order."""
        B = x.shape[0]
        if meta[0] == "run":
            _, C, npix, p = meta
            return x.reshape(B, C, npix // p, p).permute(0, 2, 3, 1).reshape(B, -1)
        if meta[0] == "runp":
            _, C, npix, p, W_run = meta
            t = x.reshape(B, C, npix // p, p).permute(0, 2, 3, 1) \
                .reshape(B, npix // p, p * C)
            t = F.pad(t, (0, W_run - p * C))
            return t.reshape(B, -1)
        _, C, H, W, bh, bw = meta
        return x.reshape(B, C, H // bh, bh, W // bw, bw) \
            .permute(0, 2, 4, 3, 5, 1).reshape(B, -1)

    @staticmethod
    def _from_layout(y, meta):
        """(B, n_core) layout order -> channel-major (inverse of _to_layout)."""
        B = y.shape[0]
        if meta[0] == "run":
            _, C, npix, p = meta
            return y.reshape(B, npix // p, p, C).permute(0, 3, 1, 2).reshape(B, -1)
        _, C, H, W, bh, bw = meta
        return y.reshape(B, H // bh, W // bw, bh, bw, C) \
            .permute(0, 5, 1, 3, 2, 4).reshape(B, -1)

    @staticmethod
    def from_scipy(A, perm_out, perm_in, tileshape=DEFAULT_TILE, max_pack_bytes=None,
                   layout_in=None, layout_out=None):
        """perm_out/perm_in: layout vectors (new position -> old index).
        Returns None when the pre-dedup placed-tile footprint would exceed
        ``max_pack_bytes`` (layout tiles that stay sparse)."""
        A = scipy.sparse.coo_matrix(A)
        n_out, n_in = A.shape
        rpos = np.empty(n_out, dtype=np.int64)
        rpos[np.asarray(perm_out)] = np.arange(n_out)
        cpos = np.empty(n_in, dtype=np.int64)
        cpos[np.asarray(perm_in)] = np.arange(n_in)
        TM, TN = tileshape
        rows, cols = rpos[A.row], cpos[A.col]
        if max_pack_bytes is not None:
            n_cb = _cdiv(n_in, TN)
            placed = np.unique((rows // TM) * n_cb + (cols // TN)).size
            if placed * TM * TN * 4 > max_pack_bytes:
                return None
        B = scipy.sparse.coo_matrix((A.data, (rows, cols)), shape=A.shape)
        inner = BlockSparseOp.from_scipy(B, tileshape=tileshape)
        return PermutedBlockSparseOp(inner, np.asarray(perm_in), rpos, A.shape,
                                     layout_in=layout_in, layout_out=layout_out)

    def apply(self, x):
        if self.layout_in is not None:
            xp = torch.cat([self._to_layout(x[:, :-1], self.layout_in), x[:, -1:]],
                           dim=1)
        else:
            xp = x[:, self.perm_in]
        y = self.inner.apply(xp)
        if self.layout_out is not None:
            return torch.cat([self._from_layout(y[:, :-1], self.layout_out),
                              y[:, -1:]], dim=1)
        return y[:, self.perm_out_pos]

    def nnz(self):
        return self.inner.nnz()

    def device_bytes(self):
        return self.inner.device_bytes() \
            + int(self.perm_in.numel() + self.perm_out_pos.numel()) * 4

    def arrays(self):
        d = self.inner.arrays()
        d.update({"perm_in": self.perm_in.to(torch.int32),
                  "perm_out_pos": self.perm_out_pos.to(torch.int32)})
        return d


class RepeatedBlockDiagOp(LinearOp):
    """Homogeneous operator (I ⊗ F) + bias column: one dense (p, p) block
    repeated along the core diagonal.

      y[:, :n] = blockwise( x[:, :n] · Fᵀ ) + x[:, n:] · bias
      y[:, n]  = x[:, n]
    """
    _tensors = ("F", "bias")

    def __init__(self, F, bias, n, nnz=None):
        self.F = _t(F, torch.float32)        # (p, p)
        self.bias = _t(bias, torch.float32)  # (n,)
        self.shape = (n + 1, n + 1)
        self._nnz = int(nnz) if nnz is not None \
            else int(torch.count_nonzero(self.F)) + int(torch.count_nonzero(self.bias))

    def apply(self, x):
        n = self.shape[0] - 1
        p = self.F.shape[0]
        xc, xh = x[:, :n], x[:, n:]
        y = torch.matmul(xc.reshape(x.shape[0], n // p, p), self.F.T)
        y = y.reshape(x.shape[0], n) + xh * self.bias[None, :]
        return torch.cat([y, xh], dim=1)

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return int(self.F.numel() + self.bias.numel()) * 4

    def arrays(self):
        return {"F": self.F, "bias": self.bias}


class KroneckerOp(LinearOp):
    """Homogeneous Kronecker operator  [[C ⊗ S, b], [0, 1]]:

      y[:, :n_out] = (C ⊗ S) · x[:, :n_in]  +  b · x[:, n_in]
      y[:, n_out]  = x[:, n_in]

    with the core viewed channel-major (B, C1, p1), C: (C2, C1), S: (p2, p1);
    two dense matmuls.  Optional core gathers perm_in (before the product)
    and perm_out (after it) cover keys that factor as G·(I⊗D) / (I⊗D)·G.
    """
    _tensors = ("Cm", "Sm", "bias", "perm_in", "perm_out")

    def __init__(self, Cm, Sm, bias, nnz=None, perm_in=None, perm_out=None):
        self.Cm = _t(Cm, torch.float32)      # (C2, C1)
        self.Sm = _t(Sm, torch.float32)      # (p2, p1)
        self.bias = _t(bias, torch.float32)  # (n_out,) in FINAL output coords
        self.perm_in = None if perm_in is None else _t(perm_in, torch.int64)
        self.perm_out = None if perm_out is None else _t(perm_out, torch.int64)
        n_out = self.Cm.shape[0] * self.Sm.shape[0]
        n_in = self.Cm.shape[1] * self.Sm.shape[1]
        self.shape = (n_out + 1, n_in + 1)
        self._nnz = int(nnz) if nnz is not None else \
            int(torch.count_nonzero(self.Cm)) + int(torch.count_nonzero(self.Sm)) \
            + int(torch.count_nonzero(self.bias))

    def apply(self, x):
        B = x.shape[0]
        C2, C1 = self.Cm.shape
        p2, p1 = self.Sm.shape
        n_in = C1 * p1
        xc = x[:, :n_in]
        xh = x[:, n_in:]
        if self.perm_in is not None:
            xc = xc[:, self.perm_in]
        t = torch.matmul(xc.reshape(B, C1, p1), self.Sm.T)      # (B, C1, p2)
        y = torch.matmul(self.Cm, t)                             # (B, C2, p2)
        y = y.reshape(B, C2 * p2)
        if self.perm_out is not None:
            y = y[:, self.perm_out]
        y = y + xh * self.bias[None, :]
        return torch.cat([y, xh], dim=1)

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return int(self.Cm.numel() + self.Sm.numel() + self.bias.numel()) * 4

    def arrays(self):
        d = {"Cm": self.Cm, "Sm": self.Sm, "bias": self.bias}
        if self.perm_in is not None:
            d["perm_in"] = self.perm_in.to(torch.int32)
        if self.perm_out is not None:
            d["perm_out"] = self.perm_out.to(torch.int32)
        return d


class TapSumOp(LinearOp):
    """Homogeneous sum-of-Kronecker operator  [[Σ_t K_t ⊗ S_t, b], [0, 1]]
    with K: (T, C2, C1) channel factors and S: (T, p2, p1) spatial factors.

    Applied per chunk of Bc images as two GEMMs, the batch folded into the
    rows and the taps stacked into the GEMM dimensions, so the tap sum
    accumulates inside the second GEMM:

      Z   = X · [S_0; …; S_{T−1}]ᵀ    X: the chunk's cores as (Bc·C1, p1) rows;
                                      Z: (Bc·C1, T·p2), image b's block a
                                      (C1·T, p2) matrix with rows (c1, t)
      Y_b = K_st · Z_b                K_st: (C2, C1·T), K_st[c2, c1·T + t] = K[t, c2, c1]

    Y_b lands in the output's rows directly.  The op holds the channel
    factor only as K_st; ``K`` is a view of it in the published layout.
    """
    _tensors = ("K_st", "S", "bias")

    def __init__(self, K, S, bias, nnz=None):
        K = _t(K, torch.float32)
        T, C2, C1 = K.shape
        self.K_st = K.permute(1, 2, 0).reshape(C2, C1 * T).contiguous()
        self.S = _t(S, torch.float32)
        self.bias = _t(bias, torch.float32)
        n_out = C2 * self.S.shape[1]
        n_in = C1 * self.S.shape[2]
        self.shape = (n_out + 1, n_in + 1)
        self._nnz = int(nnz) if nnz is not None else \
            int(torch.count_nonzero(K)) + int(torch.count_nonzero(self.S)) \
            + int(torch.count_nonzero(self.bias))

    @property
    def K(self):
        """The channel factors as published: (T, C2, C1), a view of K_st."""
        T = self.S.shape[0]
        C2, C1T = self.K_st.shape
        return self.K_st.view(C2, C1T // T, T).permute(2, 0, 1)

    def chunks(self, B):
        """[(b0, b1), ...]: the batch split into the fewest near-equal chunks
        whose X and Z buffers together hold at most three outputs' floats
        (two for a single tap).  The link's peak, its output included, then
        stays within a tap-at-a-time sum's: the running sum, a tap's
        product and the bias term beside the output (the output and the
        bias term for a single tap)."""
        T, p2, p1 = self.S.shape
        C2, C1T = self.K_st.shape
        per_image = C1T * p2 + C1T // T * p1
        budget = (3 if T > 1 else 2) * B * C2 * p2
        n = _cdiv(B, max(1, budget // per_image))
        return [(i * B // n, (i + 1) * B // n) for i in range(n)]

    def apply(self, x):
        B = x.shape[0]
        T, p2, p1 = self.S.shape
        C2, C1T = self.K_st.shape
        C1 = C1T // T
        n_in, n_out = C1 * p1, C2 * p2
        xh = x[:, n_in:]
        out = x.new_empty((B, n_out + 1))
        y = out[:, :n_out]
        S = self.S.reshape(T * p2, p1)
        chunks = self.chunks(B)
        for b0, b1 in chunks:
            n = b1 - b0
            z = torch.mm(x[b0:b1, :n_in].reshape(n * C1, p1), S.T)
            torch.bmm(self.K_st.expand(n, C2, C1T), z.view(n, C1T, p2),
                      out=y[b0:b1].view(n, C2, p2))
            del z   # before the next chunk's Z is allocated
        y.addcmul_(xh, self.bias)
        out[:, n_out:] = xh
        return out

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return int(self.K_st.numel() + self.S.numel() + self.bias.numel()) * 4

    def arrays(self):
        return {"K": self.K, "S": self.S, "bias": self.bias}


class ChannelBroadcastOp(LinearOp):
    """Homogeneous channel-broadcast operator  [[I_C ⊗ M, 1_C ⊗ b], [0, 1]]
    for a per-channel-identical keyed spatial action M: (p2, p1).

    A keyed avgpool Ŵ = A·W·A⁻¹ whose keys have identical per-channel
    spatial blocks (A = I_C ⊗ D̃, the structure keygen's local families
    produce; see ops/kronfactor.py) is exactly I_C ⊗ (D̃_out·S·D̃_in') with S
    the single-channel pool Toeplitz — the device analog of the reference's
    channel-broadcast Conv2dTiledMatrix (keynet/sparse.py:690-777) composed
    with its avgpool lowering (keynet/sparse.py:206-212).  Storing only the
    spatial factor is C× smaller than the materialized pool, and the apply
    batches all channels through the factor as (B·C, p1) rows.

    Publishing the factor reveals nothing the materialized pool would not:
    the materialized matrix IS I_C ⊗ M, so M is readable off it directly.

    ``inner`` is any LinearOp over the NON-homogeneous spatial vectors
    ((N, p1) -> (N, p2)); ``bias_sp`` is the (p2,) per-channel bias (the keyed
    pool's bias column is p2-periodic because both key biases are).
    """
    _tensors = ("bias_sp",)

    def __init__(self, inner, C, bias_sp, nnz=None):
        self.inner = inner      # LinearOp (p2, p1)
        self.C = int(C)
        self.bias_sp = _t(bias_sp, torch.float32)  # (p2,)
        p2, p1 = inner.shape
        self.shape = (self.C * p2 + 1, self.C * p1 + 1)
        self._nnz = int(nnz) if nnz is not None else \
            self.C * (inner.nnz() + int(torch.count_nonzero(self.bias_sp))) + 1

    def to(self, device):
        super().to(device)
        self.inner.to(device)
        return self

    def apply(self, x):
        B = x.shape[0]
        p2, p1 = self.inner.shape
        xh = x[:, -1:]
        with annotate("keynet.link/0/%s" % type(self.inner).__name__):
            yc = self.inner.apply(x[:, :-1].reshape(B * self.C, p1))
        yc = yc.reshape(B, self.C, p2) + xh[:, :, None] * self.bias_sp[None, None, :]
        return torch.cat([yc.reshape(B, -1), xh], dim=1)

    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return self.inner.device_bytes() + int(self.bias_sp.numel()) * 4

    def arrays(self):
        d = {"bias_sp": self.bias_sp}
        for k, v in self.inner.arrays().items():
            d["inner_" + k] = v
        return d


class ChainedOp(LinearOp):
    """Composition operator: apply(x) = ops[-1](…ops[0](x)).  Publishes a
    keyed layer as a factored chain behind a secret re-key (see
    streaming.split_dense_inverse and kronfactor)."""

    def __init__(self, ops):
        flat = []
        for op in ops:  # flatten nested chains
            flat.extend(op.ops if isinstance(op, ChainedOp) else [op])
        self.ops = tuple(flat)
        self.shape = (self.ops[-1].shape[0], self.ops[0].shape[1])

    def to(self, device):
        for op in self.ops:
            op.to(device)
        return self

    @property
    def device(self):
        return self.ops[0].device

    def apply(self, x):
        for j, op in enumerate(self.ops):
            with annotate("keynet.link/%d/%s" % (j, type(op).__name__)):
                x = op.apply(x)
        return x

    def nnz(self):
        return int(sum(op.nnz() for op in self.ops))

    def device_bytes(self):
        return int(sum(op.device_bytes() for op in self.ops))

    def arrays(self):
        out = {}
        for i, op in enumerate(self.ops):
            for k, v in op.arrays().items():
                out["c%d_%s" % (i, k)] = v
        return out


def conv_layout_blocks(shape_chw, target_block_elems=256):
    """Pixel-block (bh, bw) used by conv_layout_perm for a (C,H,W) shape."""
    from ..util import find_closest_positive_divisor
    C, H, W = shape_chw
    npix = max(1, int(round((target_block_elems / max(C, 1)) ** 0.5)))
    bh = find_closest_positive_divisor(H, min(npix, H)) if H > 1 else 1
    bw = find_closest_positive_divisor(W, min(npix, W)) if W > 1 else 1
    return bh, bw


def run_layout_perm(shape_chw, p, homogeneous=True):
    """1-D layout: order a (C,H,W) activation as (raster-run, pos-in-run,
    channel) for runs of p consecutive raster pixels."""
    C, H, W = shape_chw
    npix = H * W
    assert npix % p == 0
    idx = np.arange(C * npix).reshape(C, npix // p, p)
    lay = idx.transpose(1, 2, 0).reshape(-1)
    if homogeneous:
        lay = np.concatenate([lay, [C * npix]])
    return lay


def find_row_period(tile_ids, min_reps=2, min_cover=0.5, min_saved=8,
                    max_period=None):
    """Detect row-block periodicity in a Block-ELL tile_ids array: the
    (s, P, R) with tile_ids[s+rho+j*P] == tile_ids[s+rho] for rho in [0,P),
    j in [0,R) that maximizes the number of tile-reusing row-blocks, or None
    unless R >= ``min_reps``, the window covers ``min_cover`` of all
    row-blocks and at least ``min_saved`` row-blocks reuse tiles."""
    tile_ids = np.asarray(tile_ids)
    n_rb = len(tile_ids)
    if n_rb < 2 * min_reps:
        return None
    _, tok = np.unique(tile_ids, axis=0, return_inverse=True)
    tok = tok.astype(np.int64).ravel()
    best = None  # (reused_rows, -P, s, P, R)
    max_period = max_period or n_rb // min_reps
    budget = int(GLOBAL.get("ROW_PERIOD_SCAN_BUDGET", 1 << 27))
    max_period = min(max_period, max(min_saved, budget // max(1, n_rb)))
    for P in range(1, max_period + 1):
        if best is not None and best[0] >= n_rb - P:
            break
        m = tok[:-P] == tok[P:]
        if not m.any():
            continue
        d = np.diff(np.concatenate(([0], m.astype(np.int8), [0])))
        starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
        li = int(np.argmax(ends - starts))
        run, s = int(ends[li] - starts[li]), int(starts[li])
        R = run // P + 1
        if R < min_reps or P * R < min_cover * n_rb or (R - 1) * P < min_saved:
            continue
        cand = ((R - 1) * P, -P, s, P, R)
        if best is None or cand > best:
            best = cand
    if best is None:
        return None
    _, _, s, P, R = best
    return (s, P, R)


def find_row_groups(tile_ids, max_distinct_frac=0.5, min_saved=64):
    """Group row-blocks by identical tile_ids rows.  Returns None when fewer
    than ``min_saved`` row-blocks share patterns or the distinct fraction
    exceeds ``max_distinct_frac``; else a plan dict:

      buckets: list of (m, rows (G*m,) int64, patterns (G, KB) int64)
      inv_order: (n_rb,) int64, position of row-block r in bucket order
    """
    tile_ids = np.asarray(tile_ids)
    n_rb = len(tile_ids)
    if n_rb < 2:
        return None
    _, first, tok, counts = np.unique(tile_ids, axis=0, return_index=True,
                                      return_inverse=True, return_counts=True)
    tok = tok.astype(np.int64).ravel()
    n_groups = len(first)
    if n_rb - n_groups < min_saved or n_groups > max_distinct_frac * n_rb:
        return None
    order = np.argsort(tok, kind="stable")
    m_of_group = counts
    buckets = []
    out_order = []
    group_starts = np.concatenate(([0], np.cumsum(m_of_group)))
    for m in np.unique(m_of_group):
        gsel = np.flatnonzero(m_of_group == m)
        rows = np.concatenate([order[group_starts[g]:group_starts[g + 1]]
                               for g in gsel])
        patterns = tile_ids[order[group_starts[gsel]]].astype(np.int64)
        buckets.append((int(m), rows.astype(np.int64), patterns))
        out_order.append(rows)
    out_order = np.concatenate(out_order)
    inv_order = np.empty(n_rb, dtype=np.int64)
    inv_order[out_order] = np.arange(n_rb)
    return {"buckets": buckets, "inv_order": inv_order}


def block_diag_period(A, candidates):
    """Smallest p among candidates such that the (homogeneous) key matrix A is
    block diagonal with p-sized blocks on its core.  None if none fits."""
    A = scipy.sparse.coo_matrix(A)
    n = A.shape[0] - 1
    core = (A.row < n) & (A.col < n)
    r, c = A.row[core], A.col[core]
    for p in sorted(candidates):
        if n % p == 0 and bool(np.all(r // p == c // p)):
            return int(p)
    return None


def conv_layout_perm(shape_chw, homogeneous=True, target_block_elems=256, blocks=None):
    """Layout vector (new position -> channel-major index) ordering a (C,H,W)
    activation as (pixel-block, pixel-within-block, channel); the trailing
    homogeneous coordinate stays last."""
    C, H, W = shape_chw
    bh, bw = blocks if blocks is not None else conv_layout_blocks(shape_chw, target_block_elems)
    idx = np.arange(C * H * W).reshape(C, H, W)
    lay = idx.reshape(C, H // bh, bh, W // bw, bw).transpose(1, 3, 2, 4, 0).reshape(-1)
    if homogeneous:
        lay = np.concatenate([lay, [C * H * W]])
    return lay


def materialize(A, tileshape=DEFAULT_TILE, dense_max_bytes=None, format=None):
    """Pick the device format for a host scipy sparse matrix: dense if it
    fits the dense budget; else Block-ELL if the packed tiles fit; else ELL.
    ``format`` in {'dense','block','ell'} forces a format.  The op is built
    on the CPU; move it with ``.to(device)``."""
    dense_max_bytes = dense_max_bytes or GLOBAL["DENSE_MAX_BYTES"]
    A = scipy.sparse.csr_matrix(A).astype(np.float32)
    n_out, n_in = A.shape

    if format == "dense" or (format is None and n_out * n_in * 4 <= dense_max_bytes):
        return DenseOp.from_scipy(A)
    if format == "ell":
        return EllOp.from_scipy(A)

    plan = BlockSparseOp.plan(A.tocoo(), tileshape)
    block_bytes = plan["tiles"].numel() * 4
    if format == "block" or block_bytes <= max(dense_max_bytes, 4 * A.nnz * 8):
        return BlockSparseOp(plan["tiles"], plan["tile_ids"], plan["col_blk"],
                             plan["shape"], plan["tileshape"], plan["nnz"])
    return EllOp.from_scipy(A)
