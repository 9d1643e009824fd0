"""Declarative model specifications with PyTorch forwards.

The reference introspects torch nn.Modules with forward hooks to recover layer
shapes and ordering (keynet/torch.py:21-62, `netshape`).  Here models are
declared as an ordered list of layer specs, so shapes and the prev/next layer
graph are computed analytically — no hooks, no dummy forward, and the spec
doubles as the keying plan.

Semantics notes (all chosen so keyed == source EXACTLY):
  * conv2d: spatial correlation, stride s, padding k//2, output sliced to
    (U//s, V//s) — the Toeplitz lowering's output grid (keynet/sparse.py:140-142
    samples output rows at arange(0, U, stride)).
  * avgpool2d: constant 1/k^2 window with zero padding k//2 and
    count-include-pad semantics, identical to the Toeplitz avgpool
    (keynet/sparse.py:206-212).  NOTE: torch's AvgPool2d(padding=0) differs;
    the reference's own keyed VGG16 implements this centered/padded variant.
  * batchnorm2d evaluates in inference mode (running stats).
  * dropout is identity at inference and is removed during keying.
  * globalavgpool2d: the mean over each channel's H×W map, output (C, 1, 1).
  * a ReLU with ``residual`` adds, before it clamps, the output of the named
    earlier layer through the option-A shortcut (He et al., arXiv:1512.03385
    §3.3): the identity where the shapes agree; where they differ, every
    s-th pixel ``x[:, :, ::s, ::s]`` cut to the convs' output grid
    (H//s, W//s), then zero channels after the first C (``shortcut_apply``).

Naming conventions required by the keying pass (same as the reference):
ReLU layer names contain 'relu'; a batchnorm keyed against layer 'xyz' must be
named 'xyz_bn' and directly follow 'xyz' (keynet/system.py:66-69).
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..globals import precision


@dataclass(frozen=True)
class Conv2d:
    name: str
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    padding: Optional[int] = None  # defaults to kernel_size // 2

    def pad(self):
        return self.kernel_size // 2 if self.padding is None else self.padding


@dataclass(frozen=True)
class AvgPool2d:
    name: str
    kernel_size: int
    stride: int


@dataclass(frozen=True)
class GlobalAvgPool2d:
    name: str


@dataclass(frozen=True)
class MaxPool2d:
    name: str
    kernel_size: int
    stride: int
    padding: int = 0


@dataclass(frozen=True)
class ReLU:
    name: str
    residual: Optional[str] = None  # layer whose output is added before the clamp


@dataclass(frozen=True)
class Shortcut:
    """The option-A shortcut into the residual ReLU ``name``: not a layer of
    a Model, the spec the keyed conversion lowers for that ReLU's add."""
    name: str


@dataclass(frozen=True)
class Linear:
    name: str
    in_features: int
    out_features: int


@dataclass(frozen=True)
class BatchNorm2d:
    name: str
    num_features: int
    eps: float = 1e-5


@dataclass(frozen=True)
class Dropout:
    name: str
    p: float = 0.5


def conv2d_apply(x, w, b, stride, pad):
    """Correlation conv with explicit padding, output sliced to (U//s, V//s).
    Runs in IEEE f32 (precision() turns cuDNN's TF32 off): the source model
    is the exactness oracle for the keyed path."""
    U, V = x.shape[2], x.shape[3]
    y = F.conv2d(x, w, None, stride=stride, padding=pad)
    y = y[:, :, : U // stride, : V // stride]
    if b is not None:
        y = y + b[None, :, None, None]
    return y


def avgpool2d_apply(x, kernel_size, stride):
    """Zero-padded constant-window average, count-include-pad.

    Window taps sit at offsets arange(k) - (k-1)//2 around each output pixel
    (matching toeplitz.toeplitz_avgpool2d's lowering): symmetric (k//2, k//2)
    padding for odd k, asymmetric ((k-1)//2, k//2) for even k."""
    U, V = x.shape[2], x.shape[3]
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    y = F.avg_pool2d(F.pad(x, (lo, hi, lo, hi)), kernel_size, stride)
    return y[:, :, : U // stride, : V // stride]


def shortcut_shape(inshape, outshape):
    """The stride s of the option-A shortcut from a (C, H, W) activation to
    ``outshape``; raises where no such shortcut joins them."""
    (C, H, W), (Co, Ho, Wo) = inshape, outshape
    s = max(1, H // max(Ho, 1))
    if Co < C or (H // s, W // s) != (Ho, Wo):
        raise ValueError("no option-A shortcut from %s to %s" % (tuple(inshape),
                                                                tuple(outshape)))
    return s


def shortcut_apply(x, outshape):
    """The option-A shortcut of a (N, C, H, W) batch to ``outshape``: every
    s-th pixel cut to (H//s, W//s), zero channels appended after the first C."""
    C, H, W = outshape
    s = shortcut_shape(tuple(x.shape[1:]), outshape)
    x = x[:, :, ::s, ::s][:, :, :H, :W]
    return F.pad(x, (0, 0, 0, 0, 0, C - x.shape[1]))


def maxpool2d_apply(x, kernel_size, stride, pad):
    """torch.nn.MaxPool2d semantics (-inf padding, floor output size)."""
    return F.max_pool2d(x, kernel_size, stride, padding=pad)


class Model:
    """An ordered stack of layer specs + a params dict (name -> numpy arrays)."""

    def __init__(self, layers, inshape, params=None, seed=0):
        names = [l.name for l in layers]
        assert len(names) == len(set(names)), "layer names must be unique"
        self.layers = list(layers)
        self.inshape = tuple(inshape)  # (C, H, W)
        self.params = params if params is not None else self.init_params(seed)

    # ----------------------------------------------------------- parameters
    def init_params(self, seed=0):
        """Kaiming-uniform init matching torch defaults closely enough for
        equivalence testing on untrained nets."""
        rng = np.random.default_rng(seed)
        params = {}
        for l in self.layers:
            if isinstance(l, Conv2d):
                fan_in = l.in_channels * l.kernel_size ** 2
                bound = 1.0 / np.sqrt(fan_in)
                params[l.name] = {
                    "weight": rng.uniform(-bound, bound,
                                          (l.out_channels, l.in_channels,
                                           l.kernel_size, l.kernel_size)).astype(np.float32),
                    "bias": rng.uniform(-bound, bound, l.out_channels).astype(np.float32),
                }
            elif isinstance(l, Linear):
                bound = 1.0 / np.sqrt(l.in_features)
                params[l.name] = {
                    "weight": rng.uniform(-bound, bound,
                                          (l.out_features, l.in_features)).astype(np.float32),
                    "bias": rng.uniform(-bound, bound, l.out_features).astype(np.float32),
                }
            elif isinstance(l, BatchNorm2d):
                params[l.name] = {
                    "weight": np.abs(rng.normal(1.0, 0.1, l.num_features)).astype(np.float32),
                    "bias": rng.normal(0.0, 0.1, l.num_features).astype(np.float32),
                    "running_mean": rng.normal(0.0, 0.5, l.num_features).astype(np.float32),
                    "running_var": np.abs(rng.normal(1.0, 0.2, l.num_features)).astype(np.float32),
                }
        return params

    def load_torch_state_dict(self, path_or_dict):
        """Load parameters from a torch .pth state dict (e.g. the checkpoints
        shipped with the reference in models/*.pth); parameters stay numpy."""
        if isinstance(path_or_dict, (str, bytes)):
            sd = torch.load(path_or_dict, map_location="cpu")
            sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
        else:
            sd = {k: np.asarray(v) for k, v in path_or_dict.items()}
        for l in self.layers:
            for key in list(self.params.get(l.name, {})):
                full = f"{l.name}.{key}"
                if full in sd:
                    self.params[l.name][key] = sd[full].astype(np.float32)
        return self

    # ----------------------------------------------------------- inference
    def forward(self, x, params=None, device=None, linear=None):
        """Plain (un-keyed) source-model forward; x: (N,C,H,W) tensor or
        array.  Runs on ``device``, else on x's device (the CPU for numpy).
        Numpy params move to that device; tensor params (the trainer's,
        train.py) pass through as they are, so autograd reaches them.
        ``linear(layer, x, weight, bias)``, where given, applies the Linear
        layers in place of x @ weightᵀ + bias (the tp-split layers of
        train.make_sharded_train_step)."""
        params = self.params if params is None else params
        precision()
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            dtype=torch.float32, device=device)
        dev = x.device

        def t(a):
            if torch.is_tensor(a):
                return a
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
        keep = self.residual_sources()
        saved = {}
        for l in self.layers:
            if isinstance(l, Conv2d):
                p = params[l.name]
                x = conv2d_apply(x, t(p["weight"]), t(p["bias"]), l.stride, l.pad())
            elif isinstance(l, AvgPool2d):
                x = avgpool2d_apply(x, l.kernel_size, l.stride)
            elif isinstance(l, GlobalAvgPool2d):
                x = x.mean((2, 3), keepdim=True)
            elif isinstance(l, MaxPool2d):
                x = maxpool2d_apply(x, l.kernel_size, l.stride, l.padding)
            elif isinstance(l, ReLU):
                if l.residual is not None:
                    x = x + shortcut_apply(saved[l.residual], tuple(x.shape[1:]))
                x = torch.clamp_min(x, 0.0)
            elif isinstance(l, Linear):
                if x.ndim == 4:
                    x = x.reshape(x.shape[0], -1)
                p = params[l.name]
                if linear is not None:
                    x = linear(l, x, t(p["weight"]), t(p["bias"]))
                else:
                    x = torch.matmul(x, t(p["weight"]).T) + t(p["bias"])
            elif isinstance(l, BatchNorm2d):
                p = {k: t(v) for k, v in params[l.name].items()}
                scale = p["weight"] / torch.sqrt(p["running_var"] + l.eps)
                x = x * scale[None, :, None, None] + \
                    (p["bias"] - p["running_mean"] * scale)[None, :, None, None]
            elif isinstance(l, Dropout):
                pass  # identity at inference
            else:
                raise ValueError("unsupported layer %r" % (l,))
            if l.name in keep:
                saved[l.name] = x
        return x

    def __call__(self, x):
        return self.forward(x)

    # ----------------------------------------------------------- shape graph
    def netshape(self):
        """OrderedDict name -> {inshape, outshape, prevlayer, nextlayer} with
        'input'/'output' sentinels (analytic replacement for the reference's
        hook-based netshape, keynet/torch.py:21-62).  Shapes are (C,H,W).
        A residual ReLU's entry also holds ``residual``, the layer it adds."""
        d = OrderedDict()
        shape = self.inshape
        prev = "input"
        d["input"] = {"prevlayer": None, "nextlayer": None,
                      "inshape": shape, "outshape": shape}
        for l in self.layers:
            ins = shape
            if isinstance(l, Conv2d):
                C, U, V = shape
                assert C == l.in_channels
                shape = (l.out_channels, U // l.stride, V // l.stride)
            elif isinstance(l, (AvgPool2d, MaxPool2d)):
                C, U, V = shape
                shape = (C, U // l.stride, V // l.stride)
            elif isinstance(l, GlobalAvgPool2d):
                shape = (shape[0], 1, 1)
            elif isinstance(l, Linear):
                assert int(np.prod(shape)) == l.in_features, \
                    "flatten mismatch at %s: %s vs %d" % (l.name, shape, l.in_features)
                ins = (l.in_features, 1, 1)
                shape = (l.out_features, 1, 1)
            # ReLU/BatchNorm/Dropout keep shape
            d[l.name] = {"inshape": ins, "outshape": shape,
                         "prevlayer": prev, "nextlayer": None}
            if getattr(l, "residual", None) is not None:
                src = l.residual
                assert src in d and src != "input", \
                    "%s adds %r, which is not an earlier layer" % (l.name, src)
                shortcut_shape(d[src]["outshape"], shape)
                d[l.name]["residual"] = src
            d[prev]["nextlayer"] = l.name
            prev = l.name
        d["output"] = {"prevlayer": prev, "nextlayer": None,
                       "inshape": shape, "outshape": shape}
        d["input"]["nextlayer"] = d["input"]["nextlayer"] or "output"
        return d

    def residual_sources(self):
        """The layers whose output a residual ReLU adds later."""
        return {l.residual for l in self.layers
                if isinstance(l, ReLU) and l.residual is not None}

    def layer(self, name):
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def num_parameters(self):
        return int(sum(v.size for d in self.params.values() for v in d.values()))
