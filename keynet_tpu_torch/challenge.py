"""Loader for the reference's released cryptanalysis challenge artifact.

The port of keynet_tpu/challenge.py.  The 2020 challenge (reference
demo/challenge.ipynb) shipped a dill pickle of (PublicKeyedSensor,
KeyedModel) built from torch nn.Modules wrapping scipy CSR matrices, plus
an encrypted 28x28 PNG and its public output embedding.  This module
unpickles that artifact WITHOUT the reference package installed — a custom
Unpickler maps the legacy class paths (keynet.*, scipy.sparse.csr.*) to
lightweight shims — and rebuilds the keynet as keynet_tpu_torch operators
on the card (or wherever ``device`` says).
"""

import importlib
import pickle
from collections import OrderedDict

import numpy as np
import scipy.sparse

from .layer import KeyedLayer
from .system import KeyedModel, PublicKeyedSensor


class _Shim:
    """Absorbs any pickled object state; attribute access over the dict."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __getattr__(self, k):
        raise AttributeError(k)


class _ShimKeyedLayer(_Shim):
    pass


class _ShimSparseMatrix(_Shim):
    pass


class _ShimKeyedModel(_Shim):
    pass


class _ShimPublicKeyedSensor(_Shim):
    pass


_LEGACY = {
    ("keynet.layer", "KeyedLayer"): _ShimKeyedLayer,
    ("keynet.sparse", "SparseMatrix"): _ShimSparseMatrix,
    ("keynet.torch", "SparseMatrix"): _ShimSparseMatrix,
    ("keynet.system", "KeyedModel"): _ShimKeyedModel,
    ("keynet.system", "PublicKeyedSensor"): _ShimPublicKeyedSensor,
    # scipy moved these modules after 2020
    ("scipy.sparse.csr", "csr_matrix"): scipy.sparse.csr_matrix,
    ("scipy.sparse.csc", "csc_matrix"): scipy.sparse.csc_matrix,
    ("scipy.sparse.coo", "coo_matrix"): scipy.sparse.coo_matrix,
    ("scipy.sparse.dia", "dia_matrix"): scipy.sparse.dia_matrix,
}


def _dill_import_module(name, safe=False):
    return importlib.import_module(name)


def _dill_get_attr(obj, name):
    return getattr(obj, name)


def _dill_load_type(name):
    import types
    import builtins
    return getattr(builtins, name, getattr(types, name, None))


class _LegacyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _LEGACY:
            return _LEGACY[(module, name)]
        if module == "dill._dill":
            return {"_import_module": _dill_import_module,
                    "_get_attr": _dill_get_attr,
                    "_load_type": _dill_load_type}[name]
        return super().find_class(module, name)


def _extract_csr(sparse_shim):
    M = sparse_shim if scipy.sparse.issparse(sparse_shim) else sparse_shim.__dict__["_matrix"]
    return scipy.sparse.csr_matrix(M).astype(np.float32)


def load_challenge(pklfile, device="cuda"):
    """Unpickle the released (sensor, keynet) tuple and rebuild both on
    ``device``.  Returns (PublicKeyedSensor, KeyedModel)."""
    with open(pklfile, "rb") as f:
        sensor_shim, model_shim = _LegacyUnpickler(f).load()

    # ---- sensor: identity keys at the recorded inshape ----------------------
    _, C, H, W = sensor_shim.__dict__["_inshape"]
    sensor = PublicKeyedSensor((C, H, W), device=device)

    # ---- model: rebuild each keyed layer from its stored matrix -------------
    seq = model_shim.__dict__["_keynet"]   # torch nn.Sequential of shims/ReLU
    layers = OrderedDict()
    outshape = tuple(model_shim.__dict__.get("_outshape", (10, 1, 1)))
    for name, child in seq._modules.items():
        if isinstance(child, _ShimKeyedLayer):
            kl = KeyedLayer(W=_extract_csr(child.__dict__["W"]))
            kl._relu = "ReLU" in str(child.__dict__.get("_layertype", ""))
            layers[name] = kl
        else:  # torch nn.ReLU
            layers[name] = "relu"

    return sensor, KeyedModel.from_layers(layers, outshape,
                                          imagekey=model_shim.__dict__.get("_imagekey"),
                                          embeddingkey=model_shim.__dict__.get("_embeddingkey"),
                                          device=device)
