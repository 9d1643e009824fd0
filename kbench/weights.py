"""The weights of a configuration, made by the benchmark from the
configuration's ``weights.seed``: He-normal (std sqrt(2/fan_in)) for every
conv and linear layer, N(0, bias_std²) biases, drawn in layer order, weight
then bias, as float32 numpy arrays.  The same arrays go to the program (the
zoo spec's ``Model.load_torch_state_dict``) and to the plain reference."""

import math

import numpy as np


def he_normal(cfg):
    """{layer name: {"weight", "bias"}} for the configuration ``cfg``."""
    w = cfg["weights"]
    if w["init"] != "he_normal":
        raise ValueError("unknown weight init %r" % w["init"])
    rng = np.random.default_rng(w["seed"])
    out = {}
    for l in cfg["layers"]:
        if l["kind"] == "conv":
            shape, fan_in = (l["out"], l["in"], l["k"], l["k"]), l["in"] * l["k"] * l["k"]
        elif l["kind"] == "linear":
            shape, fan_in = (l["out"], l["in"]), l["in"]
        else:
            continue
        weight = rng.standard_normal(shape, dtype=np.float32)
        weight *= np.float32(math.sqrt(2.0 / fan_in))
        bias = rng.standard_normal(l["out"], dtype=np.float32)
        bias *= np.float32(w["bias_std"])
        out[l["name"]] = {"weight": weight, "bias": bias}
    return out


def state_dict(weights):
    """The torch-style state dict ("<layer>.weight", "<layer>.bias")."""
    return {"%s.%s" % (n, k): v for n, p in weights.items() for k, v in p.items()}
