"""The recipe of the vgg16-orth-224 configuration: the port's VGG-16 spec from
its zoo, and the Givens-orthogonal keyed conversion of
scripts/run_vgg_orth_224.py:36-41 with the keys of the configuration file."""


def source_model(kt, cfg):
    return kt.models.VGG16(num_classes=cfg["num_classes"])


def convert(kt, cfg, net, device):
    keys = dict(cfg["keys"])
    factory = getattr(kt, keys.pop("factory"))
    return factory(tuple(cfg["inshape"]), net, device=device, **keys)
