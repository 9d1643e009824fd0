"""The plain reference of the benchmark's CNN configurations: the source
network of a configuration's layer list, in plain PyTorch and IEEE float32
(TF32 off in cuBLAS and cuDNN), with no kernel, key or cache.

It imports nothing of the program.  The layer semantics are frozen copies of
the model specs' (``keynet_tpu_torch/models/specs.py``), which Key-Nets keys
exactly:

- conv: correlation with stride s and padding k//2, the output cut to
  (H//s, W//s), then the bias;
- avgpool: a constant 1/k² window with zero padding ((k-1)//2 before, k//2
  after) that counts the padding, the output cut to (H//s, W//s) (the
  Key-Net variant of VGG-16, not torch's AvgPool2d(padding=0));
- relu; linear on the (C, H, W)-ordered flattening; dropout is the identity
  at inference.
"""

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_f32():
    """IEEE float32 in cuBLAS and cuDNN for the block (TF32 off), the flags
    put back on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
        torch.set_float32_matmul_precision(flags[2])


def forward(layers, params, x):
    """The source network on a (N, C, H, W) float32 batch; ``params`` maps a
    layer name to {"weight", "bias"} tensors on x's device."""
    for l in layers:
        kind = l["kind"]
        if kind == "conv":
            H, W = x.shape[2], x.shape[3]
            s, k = l["stride"], l["k"]
            x = F.conv2d(x, params[l["name"]]["weight"], None, stride=s, padding=k // 2)
            x = x[:, :, :H // s, :W // s] + params[l["name"]]["bias"][None, :, None, None]
        elif kind == "avgpool":
            H, W = x.shape[2], x.shape[3]
            s, k = l["stride"], l["k"]
            lo, hi = (k - 1) // 2, k // 2
            x = F.avg_pool2d(F.pad(x, (lo, hi, lo, hi)), k, s)[:, :, :H // s, :W // s]
        elif kind == "relu":
            x = torch.clamp_min(x, 0.0)
        elif kind == "linear":
            x = x.reshape(x.shape[0], -1)
            p = params[l["name"]]
            x = x @ p["weight"].T + p["bias"]
        elif kind != "dropout":
            raise ValueError("unknown layer kind %r" % kind)
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
