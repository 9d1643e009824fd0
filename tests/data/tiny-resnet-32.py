"""The recipe of the CPU tests' narrow residual configuration: the port's
ResNetA at two stages of two blocks, keyed as the resnet34a-orth-224
configuration keys ResNet-34."""


def source_model(kt, cfg):
    return kt.models.ResNetA((2, 2), (8, 16), stem=8, num_classes=cfg["num_classes"],
                             inshape=tuple(cfg["inshape"]))


def convert(kt, cfg, net, device):
    keys = dict(cfg["keys"])
    factory = getattr(kt, keys.pop("factory"))
    return factory(tuple(cfg["inshape"]), net, device=device, **keys)
