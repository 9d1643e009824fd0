"""Serve a keynet from a save_keynet snapshot (the port of
scripts/serve_vgg_orth.py): load the .npz in this process, without
converting anything, and time warm keyed forwards at the requested batch
sizes, with an optional torch.profiler trace.

    python -m keynet_tpu_torch.scripts.serve --snapshot NPZ [--batches 1,8,32]
        [--reps 5] [--check vgg16:5|allconv:1] [--profile DIR] [--out NPZ]
        [--device cpu]

The inputs are seeded: images drawn from default_rng(B) and encrypted
with the snapshot's sensor when it holds one (save_keynet(...,
sensor=sensor, include_keys=True)), else seeded cipher rows with a trailing
1 (what a server that holds only the public keynet receives).  ``--check``
rebuilds the source net (``vgg16:SEED`` is VGG16(seed=SEED), ``allconv:SEED``
AllConvNet(seed=SEED); default vgg16:5, as the JAX script) and holds keyed
== source within 1e-5·max(1, scale); it needs the sensor.  Each batch is
timed with CUDA events on the card (the host clock elsewhere): one cold
call, then ``reps`` warm calls.  The last line printed is the kernel
launches of the run, ``[serve] launches {...}``.
"""

import argparse
import hashlib
import json
import statistics
import time

import numpy as np
import torch

from .. import models
from ..globals import resolve_device
from ..ops import block_ell
from ..profiling import timed_ms, trace
from ..serialize import load_keynet

TOL = 1e-5
SOURCES = {"vgg16": models.VGG16, "allconv": models.AllConvNet}


def source_net(spec):
    """'vgg16:5' -> VGG16(seed=5); 'allconv:1' -> AllConvNet(seed=1)."""
    name, _, seed = spec.partition(":")
    if name not in SOURCES:
        raise ValueError("--check %r: want one of %s followed by :SEED"
                         % (spec, sorted(SOURCES)))
    return SOURCES[name](seed=int(seed or 0))


def inputs(sensor, knet_in, B, inshape, device):
    """The seeded cipher batch of size B (see the module docstring)."""
    rng = np.random.default_rng(B)
    if sensor is not None:
        x = rng.standard_normal((B, *inshape)).astype(np.float32)
        return sensor.fromtensor(torch.from_numpy(x).to(device)).encrypt().tensor()
    x = rng.standard_normal((B, knet_in)).astype(np.float32)
    x[:, -1] = 1.0
    return torch.from_numpy(x).to(device)


def serve(snapshot, batches, reps=5, check=None, profile=None, device="cuda", verbose=True):
    """Load ``snapshot`` and serve seeded batches of each size in ``batches``;
    ``check`` is a source spec string or a models.Model.  Returns {"load_s",
    "device_bytes", "check", "batches": {B: {"cold_ms", "warm_ms", "reps_ms",
    "imgs_per_s", "sha1"}}, "outputs": {B: array}, "launches": the kernel
    launches of this call}."""
    device = resolve_device(device)

    def log(*a):
        if verbose:
            print(*a, flush=True)

    before = dict(block_ell.LAUNCHES)
    t = time.perf_counter()
    sensor, knet = load_keynet(snapshot, device=device)
    knet._build()
    load_s = time.perf_counter() - t
    log("[serve] loaded %s in %.1fs on %s  device_bytes=%d  sensor=%s"
        % (snapshot, load_s, device, knet.device_bytes(), sensor is not None))
    knet_in = next(l for l in knet.layers().values() if l != "relu").shape[1]
    res = {"load_s": load_s, "device_bytes": knet.device_bytes(), "check": None,
           "batches": {}, "outputs": {}}

    if check:
        if sensor is None:
            raise ValueError("--check needs a snapshot saved with its sensor "
                             "(save_keynet(..., sensor=sensor, include_keys=True))")
        net = source_net(check) if isinstance(check, str) else check
        if tuple(net.inshape) != tuple(sensor._inshape[1:]):
            raise ValueError("--check %s takes %s images, the snapshot's sensor %s"
                             % (check, tuple(net.inshape), tuple(sensor._inshape[1:])))
        x = np.random.default_rng(0).standard_normal((1, *net.inshape)).astype(np.float32)
        xd = torch.from_numpy(x).to(device)
        y = net.forward(xd)
        yk = knet.forward(sensor.fromtensor(xd).encrypt().tensor())
        err, scale = float((y - yk).abs().max()), float(y.abs().max())
        label = check if isinstance(check, str) else "Model%s" % (net.inshape,)
        res["check"] = {"source": label,
                        "max_abs_err": err, "scale": scale}
        log("[serve] keyed==source max err %.3g (scale %.3g)" % (err, scale))
        if not err <= TOL * max(1.0, scale):
            raise AssertionError("keyed vs source: max|diff| %.3g > %.3g"
                                 % (err, TOL * max(1.0, scale)))
        inshape = net.inshape
    else:
        inshape = tuple(sensor._inshape[1:]) if sensor is not None else None

    for B in batches:
        xc = inputs(sensor, knet_in, B, inshape, device)
        yb, cold = timed_ms(device, knet.forward, xc)
        times = [timed_ms(device, knet.forward, xc)[1] for _ in range(reps)]
        warm = statistics.median(times)
        y = yb.cpu().numpy()
        res["outputs"][B] = y
        res["batches"][B] = {"cold_ms": cold, "warm_ms": warm, "reps_ms": times,
                             "imgs_per_s": B / (warm / 1e3),
                             "sha1": hashlib.sha1(np.ascontiguousarray(y).tobytes()).hexdigest()}
        log("[serve] B=%d  warm %.3f ms  %.1f imgs/sec  (cold %.1f ms)  sha1 %s"
            % (B, warm, B / (warm / 1e3), cold, res["batches"][B]["sha1"]))
        if profile:
            name = "serve_B%d" % B
            with trace(name, trace_dir=profile):
                for _ in range(3):
                    knet.forward(xc)
                if device.type == "cuda":
                    torch.cuda.synchronize()
            log("[serve] trace for B=%d -> %s/%s.json" % (B, profile, name))
    if device.type == "cuda":
        torch.cuda.synchronize()
    res["launches"] = {n: block_ell.LAUNCHES[n] - before[n] for n in block_ell.ENTRIES}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="Serve a save_keynet snapshot")
    ap.add_argument("--snapshot", required=True)
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", nargs="?", const="vgg16:5", default=None,
                    help="rebuild the source net (vgg16:SEED or allconv:SEED, default "
                         "vgg16:5) and hold keyed == source")
    ap.add_argument("--profile", default=None, help="write a trace per batch size here")
    ap.add_argument("--out", default=None, help="save the outputs here (npz, key B<n>)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = serve(args.snapshot, [int(b) for b in args.batches.split(",")], args.reps,
                args.check, args.profile, args.device)
    if args.out:
        np.savez(args.out, **{"B%d" % B: y for B, y in res["outputs"].items()})
    print("[serve] summary %s" % json.dumps(
        {"load_s": res["load_s"], "device_bytes": res["device_bytes"],
         "check": res["check"],
         "batches": {str(B): {k: v for k, v in r.items() if k != "reps_ms"}
                     for B, r in res["batches"].items()}}), flush=True)
    print("[serve] launches %s" % json.dumps(res["launches"]), flush=True)
    return res


if __name__ == "__main__":
    main()
