"""A challenge artifact in the 2020 release's pickle format, for the tests
of challenge.load_challenge (the released file is not in the repository).

The release pickled (PublicKeyedSensor, KeyedModel) of the reference
package: the model's ``_keynet`` is a torch nn.Sequential of
keynet.layer.KeyedLayer modules, each holding a keynet.sparse.SparseMatrix
around a scipy CSR matrix, and nn.ReLU modules.  ``write`` registers
throwaway modules under those names, pickles objects of their classes and
drops the modules again.  This module imports neither JAX nor keynet_tpu.
"""

import pickle
import sys
import types
from collections import OrderedDict

import numpy as np

_MODULES = ("keynet", "keynet.layer", "keynet.sparse", "keynet.system")


def _legacy_classes():
    import torch

    class KeyedLayer(torch.nn.Module):
        def __init__(self, W, layertype):
            super().__init__()
            self.W = W
            self._layertype = layertype

    class SparseMatrix:
        def __init__(self, A):
            self._matrix = A

    class KeyedModel:
        pass

    class PublicKeyedSensor:
        pass

    mods = {name: types.ModuleType(name) for name in _MODULES}
    for cls, mod in ((KeyedLayer, "keynet.layer"), (SparseMatrix, "keynet.sparse"),
                     (KeyedModel, "keynet.system"), (PublicKeyedSensor, "keynet.system")):
        cls.__module__ = mod
        cls.__qualname__ = cls.__name__
        setattr(mods[mod], cls.__name__, cls)
    return mods


def write(path, inshape, layers, outshape=(10, 1, 1)):
    """Pickle a public (sensor, keynet) in the release's format.  ``layers``
    is a list of (name, CSR matrix, fused relu) for keyed layers and
    (name, None, None) for a ReLU module."""
    import torch
    mods = _legacy_classes()
    saved = {name: sys.modules.get(name) for name in _MODULES}
    sys.modules.update(mods)
    try:
        L, S = mods["keynet.layer"], mods["keynet.sparse"]
        seq = OrderedDict()
        for name, W, relu in layers:
            seq[name] = torch.nn.ReLU() if W is None else L.KeyedLayer(
                S.SparseMatrix(W.astype(np.float32)),
                "<KeyedLayer: %s%s>" % (name, ", ReLU" if relu else ""))
        model = mods["keynet.system"].KeyedModel()
        model._keynet = torch.nn.Sequential(seq)
        model._outshape = tuple(outshape)
        model._imagekey = model._embeddingkey = None
        sensor = mods["keynet.system"].PublicKeyedSensor()
        sensor._inshape = (1,) + tuple(inshape)
        with open(path, "wb") as f:
            pickle.dump((sensor, model), f)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def layers_of(knet):
    """(name, host CSR, fused relu) of a keyed net's layers, in order."""
    return [(name, None, None) if l == "relu" else (name, l.W.tocsr(), bool(l._relu))
            for name, l in knet.layers().items()]


def oracle(layers, xc):
    """The host scipy forward over the artifact's matrices
    (tests/test_challenge.py:40-55): (N, D) cipher -> (N, n_out)."""
    xT = np.asarray(xc, dtype=np.float32).T
    for _, W, relu in layers:
        xT = np.maximum(xT, 0) if W is None else W @ xT
        if relu:
            xT = np.maximum(xT, 0)
    return xT[:-1].T
