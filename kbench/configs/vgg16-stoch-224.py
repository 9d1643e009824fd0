"""The recipe of the vgg16-stoch-224 configuration: the port's VGG-16 spec
from its zoo, and the stochastic keyed conversion of
scripts/run_vgg_stochastic_224.py:39-46 (hierarchical global block
permutation, doubly-stochastic local keys, local affine) with the keys of the
configuration file, whose JSON lists become the tuples the recipe takes."""


def source_model(kt, cfg):
    return kt.models.VGG16(num_classes=cfg["num_classes"])


def convert(kt, cfg, net, device):
    keys = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["keys"].items()}
    factory = getattr(kt, keys.pop("factory"))
    return factory(tuple(cfg["inshape"]), net, device=device, **keys)
