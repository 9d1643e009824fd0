"""The recipe of the allconv-stoch-32 configuration: the port's All-CNN-C spec
from its zoo, and the StochasticKeynet conversion of bench.py:163-177 with
the keys of the configuration file."""


def source_model(kt, cfg):
    return kt.models.AllConvNet(n_classes=cfg["num_classes"])


def convert(kt, cfg, net, device):
    keys = dict(cfg["keys"])
    factory = getattr(kt, keys.pop("factory"))
    return factory(tuple(cfg["inshape"]), net, device=device, **keys)
