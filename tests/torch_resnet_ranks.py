"""The rank function of tests/test_torch_resnet.py's sharded checks: the
narrow residual net keyed with the orth recipe on every rank, served
unsharded, dp-sharded over the batch and tp-sharded with the shortcuts'
ELL ops split over rows.  Imports neither JAX nor keynet_tpu."""


def resnet_rank(rank, world, cfg, x):
    """On one rank of a world of ``world`` gloo ranks on the CPU: the keyed
    forward of ``x`` unsharded, over a (world, 1) dp mesh and a (1, world)
    tp mesh, and the tp plan's op classes."""
    import torch
    import keynet_tpu_torch as kt
    from kbench import weights as kweights
    from keynet_tpu_torch.parallel import sharding as S
    net = kt.models.ResNetA((2, 2), (8, 16), stem=8, num_classes=cfg["num_classes"],
                            inshape=tuple(cfg["inshape"]))
    net.load_torch_state_dict(kweights.state_dict(kweights.he_normal(cfg)))
    keys = dict(cfg["keys"])
    factory = getattr(kt, keys.pop("factory"))
    sensor, knet = factory(tuple(cfg["inshape"]), net, device="cpu", **keys)
    xc = sensor.fromtensor(torch.from_numpy(x)).encrypt().tensor()
    dp = S.Mesh((world, 1), ("dp", "tp"), device="cpu")
    tp = S.Mesh((1, world), ("dp", "tp"), device="cpu")
    f_tp = S.keyed_forward_dp_tp(knet, tp, min_tp_bytes=1 << 10)
    return {"single": knet.run(xc).numpy(),
            "dp": S.keyed_forward_sharded(knet, dp, "dp")(xc).numpy(),
            "dp_tp": f_tp(xc).numpy(),
            "tp_classes": [type(op).__name__ for op in f_tp.ops],
            "n_stage_ops": sum(relu is not None for _, relu in knet._stages)}
