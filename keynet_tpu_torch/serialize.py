"""Saving and loading keyed systems, on keynet_tpu's bundle schema.

A bundle is one .npz: every device operator's arrays plus a JSON manifest
(format, shapes, layer order, relu plan) and, with include_keys, the private
keys as CSR arrays.  Private keys are stored only when ``include_keys=True``
— a public release stores none, like KeyedModel.public().  ``save_keynet``
writes the array names, dtypes and manifest of keynet_tpu/serialize.py:24-86,
:147-190 (bf16 tiles as their uint16 bit pattern, ``period`` in the meta,
the expanded period tiles not saved), and ``load_keynet`` reads the same
schema (:89-145, :193-232), so a bundle from either package serves in the
other.
"""

import contextlib
import json
import time
from collections import OrderedDict

import numpy as np
import scipy.sparse
import torch

from . import profiling
from .layer import KeyedLayer
from .ops.operators import (DenseOp, BlockSparseOp, EllOp, PermutedBlockSparseOp,
                            ChainedOp, RepeatedBlockDiagOp, KroneckerOp, TapSumOp,
                            ChannelBroadcastOp, DirectConvOp)


def _np(t, int32=False):
    """A tensor as the numpy array keynet_tpu stores: on the host, in C
    order (a view such as TapSumOp.K is written as its contiguous copy),
    integer index arrays as int32 (JAX's default integer width)."""
    a = t.detach().cpu().contiguous()
    if int32 and a.dtype == torch.int64:
        a = a.to(torch.int32)
    return a.numpy()


def _op_state(op):
    """(kind, arrays, meta) of an op, as keynet_tpu/serialize.py:24-86."""
    if isinstance(op, DenseOp):
        return "dense", {"W": _np(op.W)}, {"nnz": op.nnz()}
    if isinstance(op, DirectConvOp):
        arrs = {"weight": _np(op.weight)}
        if op.bias is not None:
            arrs["bias"] = _np(op.bias)
        return "directconv", arrs, \
            {"inshape": op.inshape, "outshape": op.outshape,
             "stride": op.stride, "groups": op.groups, "nnz": op.nnz()}
    if isinstance(op, BlockSparseOp):
        bf16 = op.tiles.dtype == torch.bfloat16
        # npz has no bfloat16: bf16 tiles are stored as their uint16 bit pattern
        arrs = {"tiles": _np(op.tiles.view(torch.int16)).view(np.uint16) if bf16
                else _np(op.tiles),
                "tile_ids": _np(op.tile_ids), "col_blk": _np(op.col_blk)}
        return "block", arrs, \
            {"shape": op.shape, "tileshape": op.tileshape, "nnz": op.nnz(),
             "period": op.period, "tile_dtype": "bfloat16" if bf16 else "float32"}
    if isinstance(op, PermutedBlockSparseOp):
        kind, arrs, meta = _op_state(op.inner)
        arrs.update({"perm_in": _np(op.perm_in, True),
                     "perm_out_pos": _np(op.perm_out_pos, True)})
        meta["outer_shape"] = op.shape
        meta["layout_in"] = op.layout_in
        meta["layout_out"] = op.layout_out
        return "permuted_block", arrs, meta
    if isinstance(op, EllOp):
        return "ell", {"cols": _np(op.cols, True), "vals": _np(op.vals)}, \
            {"shape": op.shape, "nnz": op.nnz()}
    if isinstance(op, RepeatedBlockDiagOp):
        return "repblockdiag", {"F": _np(op.F), "bias": _np(op.bias)}, \
            {"shape": op.shape, "nnz": op.nnz()}
    if isinstance(op, KroneckerOp):
        arrs = {"Cm": _np(op.Cm), "Sm": _np(op.Sm), "bias": _np(op.bias)}
        if op.perm_in is not None:
            arrs["perm_in"] = _np(op.perm_in, True)
        if op.perm_out is not None:
            arrs["perm_out"] = _np(op.perm_out, True)
        return "kron", arrs, {"shape": op.shape, "nnz": op.nnz()}
    if isinstance(op, TapSumOp):
        return "tapsum", {"K": _np(op.K), "S": _np(op.S), "bias": _np(op.bias)}, \
            {"shape": op.shape, "nnz": op.nnz()}
    if isinstance(op, ChannelBroadcastOp):
        k, a, m = _op_state(op.inner)
        arrs = {"in_" + kk: vv for kk, vv in a.items()}
        arrs["bias_sp"] = _np(op.bias_sp)
        return "chanbcast", arrs, \
            {"inner_kind": k, "inner_meta": _jsonable(m), "C": op.C,
             "nnz": op.nnz()}
    if isinstance(op, ChainedOp):
        arrs, parts = {}, []
        for i, sub in enumerate(op.ops):
            k, a, m = _op_state(sub)
            for kk, vv in a.items():
                arrs["c%d_%s" % (i, kk)] = vv
            parts.append({"kind": k, "meta": _jsonable(m)})
        return "chain", arrs, {"parts": parts, "shape": op.shape}
    raise TypeError(type(op))


def _jsonable(meta):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in meta.items()}


def _csr_arrays(prefix, M):
    M = scipy.sparse.csr_matrix(M)
    return {prefix + "_data": M.data, prefix + "_indices": M.indices,
            prefix + "_indptr": M.indptr,
            prefix + "_shape": np.asarray(M.shape)}


def save_keynet(path, knet, sensor=None, include_keys=False):
    """Serialize a KeyedModel (and optionally its sensor keypair) to .npz
    (keynet_tpu/serialize.py:160-190); returns ``path``."""
    arrays, manifest = {}, {"layers": [], "outshape": list(knet._outshape),
                            "include_keys": bool(include_keys)}
    for name, l in knet.layers().items():
        assert "__" not in name, \
            "layer name %r: '__' is the array-key separator" % name
        if l == "relu":
            manifest["layers"].append({"name": name, "kind": "relu"})
            continue
        kind, arrs, meta = _op_state(l.op())
        for k, v in arrs.items():
            arrays["layer_%s__%s" % (name, k)] = v
        manifest["layers"].append({
            "name": name, "kind": kind, "meta": _jsonable(meta),
            "relu": bool(l._relu), "repr": l._repr, "layertype": l._layertype,
            "shape": list(l.shape), "nnz": l.nnz()})
    if include_keys:
        if knet._imagekey is not None:
            arrays.update(_csr_arrays("imagekey", knet._imagekey))
        if knet._embeddingkey is not None:
            arrays.update(_csr_arrays("embeddingkey", knet._embeddingkey))
        if sensor is not None:
            arrays.update(_csr_arrays("sensor_encrypt", sensor._encryptkey))
            arrays.update(_csr_arrays("sensor_decrypt", sensor._decryptkey))
            manifest["sensor_inshape"] = list(sensor._inshape[1:])
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def _tiles(arrs, meta):
    """Block-ELL tiles as a tensor: bf16 bundles store the uint16 bit
    pattern (npz has no bfloat16)."""
    tiles = arrs["tiles"]
    if tiles.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(tiles).view(np.int16)).view(torch.bfloat16)
    dt = torch.bfloat16 if meta.get("tile_dtype") == "bfloat16" else torch.float32
    return torch.as_tensor(np.asarray(tiles, dtype=np.float32)).to(dt)


def _op_restore(kind, arrs, meta):
    if kind == "dense":
        return DenseOp(arrs["W"], nnz=meta["nnz"])
    if kind == "directconv":
        return DirectConvOp(arrs["weight"], arrs.get("bias"),
                            tuple(meta["inshape"]), tuple(meta["outshape"]),
                            int(meta["stride"]), groups=int(meta["groups"]),
                            nnz=meta["nnz"])
    if kind == "block":
        return BlockSparseOp(_tiles(arrs, meta), arrs["tile_ids"], arrs["col_blk"],
                             tuple(meta["shape"]), tuple(meta["tileshape"]),
                             meta["nnz"], period=meta.get("period"))
    if kind == "permuted_block":
        inner = _op_restore("block", arrs, meta)
        return PermutedBlockSparseOp(inner, arrs["perm_in"], arrs["perm_out_pos"],
                                     tuple(meta["outer_shape"]),
                                     layout_in=meta.get("layout_in"),
                                     layout_out=meta.get("layout_out"))
    if kind == "ell":
        return EllOp(arrs["cols"], arrs["vals"], tuple(meta["shape"]), meta["nnz"])
    if kind == "repblockdiag":
        return RepeatedBlockDiagOp(arrs["F"], arrs["bias"],
                                   int(meta["shape"][0]) - 1, nnz=meta["nnz"])
    if kind == "kron":
        return KroneckerOp(arrs["Cm"], arrs["Sm"], arrs["bias"], nnz=meta["nnz"],
                           perm_in=arrs.get("perm_in"), perm_out=arrs.get("perm_out"))
    if kind == "tapsum":
        return TapSumOp(arrs["K"], arrs["S"], arrs["bias"], nnz=meta["nnz"])
    if kind == "chanbcast":
        sub = {k[len("in_"):]: v for k, v in arrs.items() if k.startswith("in_")}
        inner = _op_restore(meta["inner_kind"], sub, meta["inner_meta"])
        return ChannelBroadcastOp(inner, int(meta["C"]), arrs["bias_sp"],
                                  nnz=meta["nnz"])
    if kind == "chain":
        ops = []
        for i, part in enumerate(meta["parts"]):
            pref = "c%d_" % i
            sub = {k[len(pref):]: v for k, v in arrs.items() if k.startswith(pref)}
            ops.append(_op_restore(part["kind"], sub, part["meta"]))
        return ChainedOp(ops)
    raise NotImplementedError("op kind %r is not ported to keynet_tpu_torch" % kind)


def _csr_members(prefix, z):
    return [z[prefix + k] for k in ("_data", "_indices", "_indptr", "_shape")]


def _csr(data, indices, indptr, shape):
    return scipy.sparse.csr_matrix((data, indices, indptr), shape=tuple(shape))


@contextlib.contextmanager
def _phase(phase):
    """The block as part of load_keynet's ``phase``: its host seconds added
    to profiling.LOAD_SECONDS[phase], inside the span keynet.load.<phase>."""
    t = time.perf_counter()
    with profiling.annotate("keynet.load." + phase):
        yield
    profiling.LOAD_SECONDS[phase] += time.perf_counter() - t


def load_keynet(path, device="cuda"):
    """Restore (sensor_or_None, KeyedModel) from a save_keynet bundle, with
    the ops on ``device``.  Fills profiling.LOAD_SECONDS with the host
    seconds of the two phases: ``read`` (opening the bundle, reading and
    inflating its members) and ``restore`` (the ops, the model and the
    sensor built from them)."""
    from .system import KeyedModel, KeyedSensor

    profiling.LOAD_SECONDS.clear()
    profiling.LOAD_SECONDS.update(read=0.0, restore=0.0)
    with _phase("read"):
        z = np.load(path, allow_pickle=False)
    with z:
        with _phase("read"):
            manifest = json.loads(bytes(z["__manifest__"]).decode())
        layers = OrderedDict()
        for entry in manifest["layers"]:
            name = entry["name"]
            if entry["kind"] == "relu":
                layers[name] = "relu"
                continue
            key = "layer_%s__" % name
            with _phase("read"):
                arrs = {k[len(key):]: z[k] for k in z.files if k.startswith(key)}
            with _phase("restore"):
                op = _op_restore(entry["kind"], arrs, entry["meta"])
            kl = KeyedLayer.__new__(KeyedLayer)
            kl._op = op
            kl._relu = entry["relu"]
            kl._repr = entry["repr"]
            kl._layertype = entry["layertype"]
            kl._inshape = kl._outshape = kl._tileshape = None
            kl.shape = tuple(entry["shape"])
            kl._nnz = entry["nnz"]
            kl.W = None
            layers[name] = kl

        with _phase("read"):
            keys = {k: _csr_members(k, z) for k in
                    ("imagekey", "embeddingkey", "sensor_encrypt", "sensor_decrypt")
                    if k + "_data" in z.files}
    with _phase("restore"):
        csr = {k: _csr(*v) for k, v in keys.items()}
        knet = KeyedModel.from_layers(layers, manifest["outshape"],
                                      imagekey=csr.get("imagekey"),
                                      embeddingkey=csr.get("embeddingkey"), device=device)
        sensor = None
        if "sensor_encrypt" in csr:
            sensor = KeyedSensor(tuple(manifest["sensor_inshape"]),
                                 (csr["sensor_encrypt"], csr["sensor_decrypt"]),
                                 device=device)
    return sensor, knet
