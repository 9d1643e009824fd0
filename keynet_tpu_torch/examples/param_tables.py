"""Keynet parameter-count tables (reference demo/figures.py:236-293; the port
of examples/param_tables.py): nnz of each named keynet configuration beside
the source model, at LeNet scale or (``--allconv``) AllConvNet scale.

    python -m keynet_tpu_torch.examples.param_tables [--allconv] [--device cpu]

``device`` is ``device_bytes()``, keynet_tpu's count of the bytes a keyed
net's ops hold on the device.  On the card the table also gives what
building the net added to ``torch.cuda.memory_allocated()``.  A
kernel-routed periodic Block-ELL core keeps no expanded period tiles
(keynet_tpu's ``_Texp``), so neither number counts them.
"""

import argparse

import torch

from .. import models
from ..globals import resolve_device
from ..system import (IdentityKeynet, PermutationKeynet, StochasticKeynet,
                      TiledIdentityKeynet, TiledOrthogonalKeynet, TiledPermutationKeynet)

TEXP_NOTE = ("kernel-routed periodic Block-ELL cores keep no expanded period tiles "
             "(keynet_tpu's _Texp): device bytes count the packed tiles only")


def configs(tile):
    """The six factories of the table: (name, factory, kwargs)."""
    return [
        ("IdentityKeynet", IdentityKeynet, dict(seed=0)),
        ("PermutationKeynet", PermutationKeynet, dict(seed=0)),
        ("TiledIdentityKeynet-%d" % tile, TiledIdentityKeynet, dict(tilesize=tile, seed=0)),
        ("TiledPermutationKeynet-%d" % tile, TiledPermutationKeynet,
         dict(tilesize=tile, seed=0)),
        ("TiledOrthogonalKeynet-%d" % tile, TiledOrthogonalKeynet,
         dict(tilesize=tile, seed=0)),
        ("StochasticKeynet-a2", StochasticKeynet, dict(alpha=2, blocksize=tile, seed=0)),
    ]


def table(net, inshape, configs, device="cuda", verbose=True):
    """One row a configuration: {"name", "nnz", "device_bytes",
    "memory_allocated"} (the last None off the card); printed as it goes."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if verbose:
        print("source parameters: %d" % net.num_parameters())
        print("(%s)" % TEXP_NOTE)
    rows = []
    for name, fac, kwargs in configs:
        before = torch.cuda.memory_allocated() if on_card else None
        sensor, knet = fac(inshape, net, device=device, **kwargs)
        knet._build()
        alloc = torch.cuda.memory_allocated() - before if on_card else None
        row = {"name": name, "nnz": knet.num_parameters(),
               "device_bytes": knet.device_bytes(), "memory_allocated": alloc}
        rows.append(row)
        if verbose:
            print("%-28s nnz=%-10d device=%6.1f MB%s"
                  % (name, row["nnz"], row["device_bytes"] / 1e6,
                     "" if alloc is None else "  memory_allocated=%6.1f MB" % (alloc / 1e6)))
        del sensor, knet
    return rows


def run(allconv=False, device="cuda", verbose=True):
    """The table at LeNet scale (LeNet_AvgPool(seed=0), 1x28x28, tiles of 14)
    or AllConvNet scale (AllConvNet(seed=0), 3x32x32, tiles of 8); returns
    {"source_parameters", "rows"}."""
    if allconv:
        net, inshape, tile = models.AllConvNet(batchnorm=False, seed=0), (3, 32, 32), 8
    else:
        net, inshape, tile = models.LeNet_AvgPool(seed=0), (1, 28, 28), 14
    return {"source_parameters": net.num_parameters(),
            "rows": table(net, inshape, configs(tile), device=device, verbose=verbose)}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Keynet parameter-count tables")
    ap.add_argument("--allconv", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.allconv, args.device)


if __name__ == "__main__":
    main()
