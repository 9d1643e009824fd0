"""The plain reference of the benchmark's residual configurations: the
source network of a configuration's layer list with its residual edges, in
plain PyTorch and IEEE float32 (TF32 off in cuBLAS and cuDNN), with no
kernel, key or cache.

It imports nothing of the program.  ``conv``, ``avgpool``, ``relu``,
``linear`` and ``dropout`` keep the frozen semantics of ``reference/cnn.py``;
besides:

- an ``avgpool`` entry with ``"global": true`` is the mean over each
  channel's H×W map (output (C, 1, 1));
- a ``relu`` entry with ``"residual": "<layer>"`` first adds the option-A
  shortcut (He et al., arXiv:1512.03385 §3.3) of that earlier layer's
  output: the identity where the shapes agree; where they differ, every
  s-th pixel ``x[:, :, ::s, ::s]`` cut to (H//s, W//s), with zero channels
  appended after the first C.
"""

import torch
import torch.nn.functional as F

from kbench.reference.cnn import ieee_f32


def shortcut(x, like):
    """The option-A shortcut of ``x`` to the shape of ``like``."""
    C, H, W = like.shape[1:]
    s = max(1, x.shape[2] // H)
    x = x[:, :, ::s, ::s][:, :, :H, :W]
    if tuple(x.shape[2:]) != (H, W) or x.shape[1] > C:
        raise ValueError("no option-A shortcut from %s to %s"
                         % (tuple(x.shape[1:]), tuple(like.shape[1:])))
    return F.pad(x, (0, 0, 0, 0, 0, C - x.shape[1]))


def forward(layers, params, x):
    """The source network on a (N, C, H, W) float32 batch; ``params`` maps a
    layer name to {"weight", "bias"} tensors on x's device."""
    sources = {l["residual"] for l in layers if l.get("residual")}
    saved = {}
    for l in layers:
        kind = l["kind"]
        if kind == "conv":
            H, W = x.shape[2], x.shape[3]
            s, k = l["stride"], l["k"]
            x = F.conv2d(x, params[l["name"]]["weight"], None, stride=s, padding=k // 2)
            x = x[:, :, :H // s, :W // s] + params[l["name"]]["bias"][None, :, None, None]
        elif kind == "avgpool" and l.get("global"):
            x = x.mean((2, 3), keepdim=True)
        elif kind == "avgpool":
            H, W = x.shape[2], x.shape[3]
            s, k = l["stride"], l["k"]
            lo, hi = (k - 1) // 2, k // 2
            x = F.avg_pool2d(F.pad(x, (lo, hi, lo, hi)), k, s)[:, :, :H // s, :W // s]
        elif kind == "relu":
            if l.get("residual"):
                x = x + shortcut(saved[l["residual"]], x)
            x = torch.clamp_min(x, 0.0)
        elif kind == "linear":
            x = x.reshape(x.shape[0], -1)
            p = params[l["name"]]
            x = x @ p["weight"].T + p["bias"]
        elif kind != "dropout":
            raise ValueError("unknown layer kind %r" % kind)
        if l["name"] in sources:
            saved[l["name"]] = x
    return x


def run(layers, weights, images, device, block=32):
    """The source network's outputs for ``images`` (a host float32 tensor
    (N, C, H, W)), computed on ``device`` in blocks of ``block`` images in
    IEEE float32 and returned on the host.  ``weights`` maps a layer name to
    numpy {"weight", "bias"}."""
    params = {n: {k: torch.from_numpy(v).to(device) for k, v in p.items()}
              for n, p in weights.items()}
    out = []
    with ieee_f32(), torch.no_grad():
        for i in range(0, images.shape[0], block):
            out.append(forward(layers, params, images[i:i + block].to(device)).cpu())
    return torch.cat(out)
