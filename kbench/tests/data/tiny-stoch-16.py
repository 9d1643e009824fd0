"""The recipe of the CPU tests' narrow configuration: its spec from the layer
list, keyed by StochasticKeynet."""


def source_model(kt, cfg):
    m = kt.models.specs
    kinds = {"conv": lambda l: m.Conv2d(l["name"], l["in"], l["out"], l["k"], l["stride"]),
             "relu": lambda l: m.ReLU(l["name"]),
             "avgpool": lambda l: m.AvgPool2d(l["name"], l["k"], l["stride"]),
             "dropout": lambda l: m.Dropout(l["name"]),
             "linear": lambda l: m.Linear(l["name"], l["in"], l["out"])}
    return m.Model([kinds[l["kind"]](l) for l in cfg["layers"]], inshape=cfg["inshape"])


def convert(kt, cfg, net, device):
    keys = dict(cfg["keys"])
    factory = getattr(kt, keys.pop("factory"))
    return factory(tuple(cfg["inshape"]), net, device=device, **keys)
