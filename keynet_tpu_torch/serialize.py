"""Loading keyed systems saved by keynet_tpu.serialize.save_keynet.

A bundle is one .npz: every device operator's arrays plus a JSON manifest
(format, shapes, layer order, relu plan) and, with include_keys, the private
keys as CSR arrays.  ``load_keynet`` reads the same manifest and op kinds as
keynet_tpu/serialize.py:89-145, :193-232, so a bundle converted by the JAX
package serves in the port.  Saving is not ported yet.
"""

import json
from collections import OrderedDict

import numpy as np
import scipy.sparse
import torch

from .layer import KeyedLayer
from .ops.operators import (DenseOp, BlockSparseOp, EllOp, PermutedBlockSparseOp,
                            ChainedOp, RepeatedBlockDiagOp, KroneckerOp, TapSumOp,
                            DirectConvOp)


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
    if kind == "chain":
        ops = []
        for i, part in enumerate(meta["parts"]):
            pref = "c%d_" % i
            sub = {k[len(pref):]: v for k, v in arrs.items() if k.startswith(pref)}
            ops.append(_op_restore(part["kind"], sub, part["meta"]))
        return ChainedOp(ops)
    raise NotImplementedError("op kind %r is not ported to keynet_tpu_torch" % kind)


def _csr_restore(prefix, z):
    return scipy.sparse.csr_matrix(
        (z[prefix + "_data"], z[prefix + "_indices"], z[prefix + "_indptr"]),
        shape=tuple(z[prefix + "_shape"]))


def load_keynet(path, device="cuda"):
    """Restore (sensor_or_None, KeyedModel) from a save_keynet bundle, with
    the ops on ``device``."""
    from .system import KeyedModel, KeyedSensor

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        layers = OrderedDict()
        for entry in manifest["layers"]:
            name = entry["name"]
            if entry["kind"] == "relu":
                layers[name] = "relu"
                continue
            key = "layer_%s" % name
            arrs = {k.split("__", 1)[1]: z[k] for k in z.files
                    if k.startswith(key + "__")}
            kl = KeyedLayer.__new__(KeyedLayer)
            kl._op = _op_restore(entry["kind"], arrs, entry["meta"])
            kl._relu = entry["relu"]
            kl._repr = entry["repr"]
            kl._layertype = entry["layertype"]
            kl._inshape = kl._outshape = kl._tileshape = None
            kl.shape = tuple(entry["shape"])
            kl._nnz = entry["nnz"]
            kl.W = None
            layers[name] = kl

        imagekey = _csr_restore("imagekey", z) if "imagekey_data" in z.files else None
        embeddingkey = _csr_restore("embeddingkey", z) \
            if "embeddingkey_data" in z.files else None
        knet = KeyedModel.from_layers(layers, manifest["outshape"],
                                      imagekey=imagekey, embeddingkey=embeddingkey,
                                      device=device)
        sensor = None
        if "sensor_encrypt_data" in z.files:
            sensor = KeyedSensor(tuple(manifest["sensor_inshape"]),
                                 (_csr_restore("sensor_encrypt", z),
                                  _csr_restore("sensor_decrypt", z)),
                                 device=device)
    return sensor, knet
