"""Public Key-Net API: KeyedModel, KeyedSensor and named keynet factories.

The same surface as keynet_tpu.system on PyTorch: the converter walks a
declarative model spec, fuses batchnorm, folds ReLU keys into the preceding
linear layer, removes dropout, and keys every remaining layer as
Ŵ = A·W·A⁻¹.  Conversion is host numpy/scipy and builds every op on the CPU;
the finished ops move to the entry point's ``device`` once.  ``device``
defaults to 'cuda' and raises without a card unless 'cpu' is asked for.
"""

from collections import OrderedDict

import numpy as np
import scipy.sparse
import torch

from .globals import vprint, precision, resolve_device
from .util import find_closest_positive_divisor  # noqa: F401  (public re-export)
from .homogeneous import affine_to_linear, linear_to_affine, mat2gray_key
from .keys import keygen, identity_matrix
from .layer import KeyedLayer
from .ops.operators import materialize
from .models import specs

_DEFAULT_KEY = object()  # sentinel: "use the model's embedding key"


def fuse_conv2d_and_bn(conv_w, conv_b, bn_mean, bn_var, bn_eps, bn_w, bn_b):
    """Fold an inference-mode batchnorm into the preceding conv's weights
    (same algebra as reference keynet/torch.py:99-113):
      w' = w * g/sqrt(var+eps),  b' = (b - mean) * g/sqrt(var+eps) + beta."""
    scale = np.asarray(bn_w) / np.sqrt(np.asarray(bn_var) + np.float32(bn_eps))
    w = np.asarray(conv_w) * scale.reshape(-1, 1, 1, 1)
    b = np.asarray(conv_b) if conv_b is not None else np.zeros_like(bn_mean)
    b = (b - np.asarray(bn_mean)) * scale + np.asarray(bn_b)
    return w.astype(np.float32), b.astype(np.float32)


def repair_tileshape(tileshape):
    """Snap a requested tileshape to the nearest allowed device tile (each
    dim a divisor of 128 >= 4, or a multiple of 128), as the JAX package
    does; the CUDA slot walk takes the multiples of 128."""
    if tileshape is None:
        return None
    allowed = [4, 8, 16, 32, 64] + [128 * k for k in range(1, 65)]

    def snap(t):
        return min(allowed, key=lambda a: (abs(a - int(t)), -a))
    snapped = (snap(tileshape[0]), snap(tileshape[1]))
    if snapped != tuple(tileshape):
        vprint("[keynet_tpu_torch.layergen]: tileshape %s is not aligned; "
               "using device tileshape %s" % (tuple(tileshape), snapped))
    return snapped


def layergen(module, inshape, outshape, A, Ainv, params=None, tileshape=None,
             backend="torch", rng=None, mask_alpha=None):
    """KeyedLayer factory with tileshape repair.  ``rng`` seeds the secret
    conversion-time masks; ``mask_alpha`` scales the mask strength with the
    keygen alpha privacy parameter."""
    tileshape = repair_tileshape(tileshape)
    if backend != "torch":
        raise ValueError("invalid backend '%s' (keynet_tpu_torch supports 'torch')"
                         % backend)
    return KeyedLayer(module, inshape, outshape, A, Ainv, params=params,
                      tileshape=tileshape, rng=rng, mask_alpha=mask_alpha)


class KeyedModel:
    """Convert a source model spec into a keynet (reference keynet/system.py:26-157).

    The conversion walks the layer graph:
      * dropout layers are deleted from the graph (identity at inference);
      * 'xyz_bn' batchnorms are fused into conv 'xyz', keyed with the bn outkey;
      * ReLU outkeys (restricted to families that commute with ReLU) are
        applied to the preceding layer, leaving a plain elementwise ReLU; a
        ReLU following a fused batchnorm is keyed explicitly;
      * every other layer becomes a KeyedLayer with Ŵ = A_out · W · A_in⁻¹.
    """

    def __init__(self, net, inshape, inkey, f_layername_to_keypair,
                 f_module_to_keyedmodule=None, do_output_encryption=False,
                 device="cuda"):
        self._device = resolve_device(device)
        shapes = net.netshape()

        # --- remove dropout nodes (doubly-linked-list deletion) -------------
        dropouts = {l.name for l in net.layers if isinstance(l, specs.Dropout)}
        for v in shapes.values():
            while v["nextlayer"] in dropouts:
                v["nextlayer"] = shapes[v["nextlayer"]]["nextlayer"]
            while v["prevlayer"] in dropouts:
                v["prevlayer"] = shapes[v["prevlayer"]]["prevlayer"]

        # --- per-layer output keypairs (lazy + memoized): keys are drawn from
        # the shared rng stream at first use, in the JAX package's order ----
        last = shapes["output"]["prevlayer"]
        kp_names = [k for k in shapes
                    if k not in ("input", "output") and k not in dropouts]
        kp_cache = {}

        def _outkeypair(k):
            if k not in kp_cache:
                kp_cache[k] = f_layername_to_keypair(k, shapes[k]["outshape"])
            return kp_cache[k]

        class _LayerKey:
            """Lazy view of {'A': ..., 'Ainv': ...} for one layer."""
            __slots__ = ("k",)

            def __init__(self, k):
                self.k = k

            def __getitem__(self, which):
                if which == "A":
                    return _outkeypair(self.k)[0] \
                        if (self.k != last or do_output_encryption) else None
                prev = shapes[self.k]["prevlayer"]
                return inkey if prev == "input" else _outkeypair(prev)[1]

        layerkey = {k: _LayerKey(k) for k in kp_names}
        self._imagekey = inkey
        self._embeddingkey = _outkeypair(last)[1] if do_output_encryption else None

        keyed = OrderedDict()
        self._key_layers(net, shapes, layerkey, keyed, f_module_to_keyedmodule)
        self._layers = keyed
        self._outshape = shapes["output"]["outshape"]
        self._ops = None  # device ops, built lazily by _build
        self._embeddingkey_op = None

    def _key_layers(self, net, shapes, layerkey, keyed, f_module_to_keyedmodule):
        import time as _time
        for l in net.layers:
            k = l.name
            if isinstance(l, specs.Dropout):
                continue
            _t0 = _time.perf_counter()
            vprint('[keynet_tpu_torch.KeyedModel]: keying "%s"' % k)

            if isinstance(l, specs.BatchNorm2d):
                assert k.endswith("_bn"), \
                    "batchnorm layers must be named 'xyz_bn' for conv 'xyz'"
                k_prev = k[:-3]
                assert shapes[k]["prevlayer"] == k_prev, \
                    "'%s' must directly follow '%s'" % (k, k_prev)
                conv = net.layer(k_prev)
                p_bn, p_conv = net.params[k], net.params[k_prev]
                w, b = fuse_conv2d_and_bn(p_conv["weight"], p_conv.get("bias"),
                                          p_bn["running_mean"], p_bn["running_var"],
                                          l.eps, p_bn["weight"], p_bn["bias"])
                keyed[k_prev] = f_module_to_keyedmodule(
                    conv, shapes[k_prev]["inshape"], shapes[k]["outshape"],
                    layerkey[k]["A"], layerkey[k_prev]["Ainv"],
                    params={"weight": w, "bias": b})
                vprint("[keynet_tpu_torch.KeyedModel]:     %r" % keyed[k_prev])

            elif isinstance(l, specs.ReLU):
                k_prev = shapes[k]["prevlayer"]
                if not k_prev.endswith("_bn"):
                    # fold the (commuting) relu outkey into the previous layer
                    prev = net.layer(k_prev)
                    keyed[k_prev] = f_module_to_keyedmodule(
                        prev, shapes[k_prev]["inshape"], shapes[k_prev]["outshape"],
                        layerkey[k]["A"], layerkey[k_prev]["Ainv"],
                        params=net.params.get(k_prev))
                    keyed[k] = "relu"  # plain elementwise relu marker
                    vprint("[keynet_tpu_torch.KeyedModel]:     %r + ReLU" % keyed[k_prev])
                else:
                    # previous layer already keyed by bn fusion: explicit keyed relu
                    keyed[k] = KeyedLayer(l, shapes[k]["inshape"], shapes[k]["outshape"],
                                          layerkey[k]["A"], layerkey[k]["Ainv"])
                    vprint("[keynet_tpu_torch.KeyedModel]:     %r" % keyed[k])

            elif (shapes[k]["nextlayer"] is not None
                  and shapes[k]["nextlayer"] != "output"
                  and (shapes[k]["nextlayer"] == k + "_bn"
                       or isinstance(net.layer(shapes[k]["nextlayer"]), specs.ReLU))):
                pass  # keyed later, merged with its bn/relu successor

            else:
                keyed[k] = f_module_to_keyedmodule(
                    l, shapes[k]["inshape"], shapes[k]["outshape"],
                    layerkey[k]["A"], layerkey[k]["Ainv"], params=net.params.get(k))
                vprint("[keynet_tpu_torch.KeyedModel]:     %r" % keyed[k])
            if k in keyed or (k.endswith("_bn")):
                vprint("[keynet_tpu_torch.KeyedModel]:     %.1fs"
                       % (_time.perf_counter() - _t0))

    @classmethod
    def from_layers(cls, layers, outshape, imagekey=None, embeddingkey=None,
                    device="cuda"):
        """Assemble a KeyedModel directly from an OrderedDict of KeyedLayer /
        'relu' entries (deserialization path)."""
        self = cls.__new__(cls)
        self._device = resolve_device(device)
        self._layers = OrderedDict(layers)
        self._outshape = tuple(outshape)
        self._imagekey = imagekey
        self._embeddingkey = embeddingkey
        self._ops = None
        self._embeddingkey_op = None
        return self

    # ----------------------------------------------------------------- runtime
    @property
    def device(self):
        return self._device

    def _build(self):
        """Static plan ('relu' | ('op', fused_relu, name)) and the ops, moved
        to the device once."""
        if self._ops is not None:
            return
        stages, ops = [], []
        for name, l in self._layers.items():
            if l == "relu":
                stages.append("relu")
            else:
                stages.append(("op", bool(l._relu), name))
                ops.append(l.op().to(self._device))
        self._stages = stages
        self._ops = ops

    def run(self, x):
        """The keyed forward on an encrypted homogeneous batch already on the
        device: every layer's op with ReLU between layers
        (keynet_tpu/system.py:256-270).  Returns the cipher output."""
        self._build()
        i = 0
        for stage in self._stages:
            if stage == "relu":
                x = torch.clamp_min(x, 0.0)
            else:
                x = self._ops[i].apply(x)
                if stage[1]:
                    x = torch.clamp_min(x, 0.0)
                i += 1
        return x

    def forward(self, img_cipher, outkey=_DEFAULT_KEY):
        """Run the keynet on an encrypted homogeneous batch (N, D+1) and return
        the decrypted affine output reshaped to (N, *outshape) — or the raw
        cipher embedding when no key is supplied/held (public release)."""
        precision()
        y = self.run(torch.as_tensor(img_cipher, dtype=torch.float32,
                                     device=self._device))
        key = self._embeddingkey if outkey is _DEFAULT_KEY else outkey
        if key is not None:
            y = self.decrypt(y, key)
        out = linear_to_affine(y, None)
        C, H, W = self._outshape
        return out.reshape((-1, C, H, W)) if (H, W) != (1, 1) else out

    __call__ = forward

    def decrypt(self, y_cipher, outkey=_DEFAULT_KEY):
        key = self._embeddingkey if outkey is _DEFAULT_KEY else outkey
        if key is None:
            return y_cipher
        if key is self._embeddingkey:
            if self._embeddingkey_op is None:
                self._embeddingkey_op = materialize(
                    scipy.sparse.csr_matrix(key)).to(self._device)
            op = self._embeddingkey_op
        else:
            op = materialize(scipy.sparse.csr_matrix(key)).to(self._device)
        return op.apply(torch.as_tensor(y_cipher, dtype=torch.float32,
                                        device=self._device))

    # ------------------------------------------------------------------- keys
    def imagekey(self):
        return self._imagekey

    def embeddingkey(self):
        return self._embeddingkey

    def public(self):
        """Strip private keys before release (reference keynet/system.py:147-151)."""
        self._imagekey = None
        self._embeddingkey = None
        self._embeddingkey_op = None
        return self

    # -------------------------------------------------------------- accounting
    def num_parameters(self):
        return int(sum(l.nnz() for l in self._layers.values() if isinstance(l, KeyedLayer)))

    def device_bytes(self):
        return int(sum(l.device_bytes() for l in self._layers.values()
                       if isinstance(l, KeyedLayer)))

    def layers(self):
        return self._layers

    def __repr__(self):
        lines = ["<keynet_tpu_torch.KeyedModel:"]
        for name, l in self._layers.items():
            lines.append("  (%s): %s" % (name, "ReLU()" if l == "relu" else repr(l)))
        return "\n".join(lines) + "\n>"


class KeyedSensor(KeyedLayer):
    """Keyed optical sensor: holds an image tensor and its encryption keypair
    (reference keynet/system.py:160-263).  Fluent API:
    sensor.fromtensor(x).encrypt().tensor()."""

    def __init__(self, inshape, keypair, device="cuda"):
        assert isinstance(inshape, tuple) and len(inshape) == 3
        self._device = resolve_device(device)
        self._encryptkey, self._decryptkey = keypair
        self._inshape = (1, *inshape)
        self._tensor = None
        self._layertype = "input"
        self._relu = False
        self._repr = "KeyedSensor"
        self.W = scipy.sparse.csr_matrix(self._encryptkey).astype(np.float32)
        self.shape = self.W.shape
        self._op = materialize(self.W).to(self._device)
        self._decrypt_op = None

    def __repr__(self):
        return "<keynet_tpu_torch.KeyedSensor: height=%d, width=%d, channels=%d>" % (
            self._inshape[2], self._inshape[3], self._inshape[1])

    def _as_device(self, x):
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                               dtype=torch.float32).to(self._device)

    # ------------------------------------------------------------------ image io
    def load(self, imgfile, imagekey=None):
        from PIL import Image
        im = Image.open(imgfile)
        C, H, W = self._inshape[1:]
        if imagekey is not None:
            # load an already-encrypted PNG saved by .save(); undo mat2gray
            if C == 1:
                im = im.split()[0]
            arr = np.asarray(im, dtype=np.float32) / 255.0
            x = arr[None, None] if arr.ndim == 2 else arr.transpose(2, 0, 1)[None]
            x_lin = affine_to_linear(torch.from_numpy(np.ascontiguousarray(x))).numpy()
            x_lin = np.asarray(scipy.sparse.csr_matrix(imagekey) @ x_lin.T).T
            self._tensor = self._as_device(x_lin)
        else:
            im = im.resize((W, H))
            im = im.convert("L") if C == 1 else im.convert("RGB")
            arr = np.asarray(im, dtype=np.float32)
            arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
            self._tensor = self._as_device(arr[None])  # 1xCxHxW in [0,255]
        return self

    def fromimage(self, im):
        arr = np.asarray(im, dtype=np.float32)
        arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
        assert (1, *arr.shape) == self._inshape
        self._tensor = self._as_device(arr[None])
        return self

    def fromtensor(self, x):
        if x is not None:
            self._tensor = self._as_device(x)
        return self

    def tensor(self):
        return self._tensor[None] if self._tensor.ndim == 3 else self._tensor

    astensor = tensor
    totensor = tensor

    def asimage(self):
        """Return the current tensor as a uint8 HxWxC numpy image (mat2gray)."""
        x = self._tensor
        if self.isencrypted():
            x = x[:, :-1]
        x = x.detach().cpu().numpy().reshape(self._inshape[1:])
        x = (x - x.min()) / max(x.max() - x.min(), 1e-12)
        img = (255 * x).astype(np.uint8)
        return img.transpose(1, 2, 0) if img.shape[0] == 3 else img[0]

    toimage = asimage

    def save(self, outfile="keynet_cipher.png"):
        """Save the encrypted image as a PNG by composing a mat2gray
        normalization key into the decrypt key (reference keynet/system.py:173-181).
        Returns (outfile, composed_decrypt_key)."""
        from PIL import Image
        assert self.isencrypted()
        x_lin = self._tensor.detach().cpu().numpy().T   # (D+1, 1) column
        A, Ainv = mat2gray_key(x_lin[:-1].ravel())
        x_gray = (A @ x_lin).T                           # in [0,1], trailing 1
        arr = x_gray[:, :-1].reshape(self._inshape[1:])
        img = (255 * np.clip(arr, 0, 1)).astype(np.uint8)
        img = img.transpose(1, 2, 0) if img.shape[0] == 3 else img[0]
        Image.fromarray(img).save(outfile)
        return outfile, scipy.sparse.csr_matrix(self._decryptkey) @ Ainv

    # ----------------------------------------------------------------- crypto
    def keypair(self):
        return (self._encryptkey, self._decryptkey)

    def key(self):
        return self._decryptkey

    def isloaded(self):
        return self._tensor is not None

    def isencrypted(self):
        """Encrypted = homogeneous 1x(C*H*W+1) row (reference keynet/system.py:243-245)."""
        return self.isloaded() and self._tensor.ndim == 2 and \
            self._tensor.shape == (self._tensor.shape[0], int(np.prod(self._inshape[1:])) + 1)

    def encrypt(self):
        assert self.isloaded(), "load image first"
        if not self.isencrypted():
            precision()
            self._tensor = self.forward(affine_to_linear(self._tensor))
        return self

    def decrypt(self):
        assert self.isloaded(), "load image first"
        if self.isencrypted():
            if self._decrypt_op is None:
                self._decrypt_op = materialize(
                    scipy.sparse.csr_matrix(self._decryptkey)).to(self._device)
            x = self._decrypt_op.apply(self._tensor)
            self._tensor = linear_to_affine(x).reshape((-1, *self._inshape[1:]))
        return self


class PublicKeyedSensor(KeyedSensor):
    """Identity-keyed sensor used to marshal already-encrypted images
    (reference keynet/system.py:266-284)."""

    def __init__(self, inshape, device="cuda"):
        n = int(np.prod(inshape)) + 1
        super().__init__(inshape, (identity_matrix(n), identity_matrix(n)),
                         device=device)

    def __repr__(self):
        return "<keynet_tpu_torch.PublicKeyedSensor: height=%d, width=%d, channels=%d>" % (
            self._inshape[2], self._inshape[3], self._inshape[1])

    def encrypt(self):
        raise ValueError("PublicKeyedSensor has no encryption keys")

    def decrypt(self):
        raise ValueError("PublicKeyedSensor has no decryption keys")

    def tensor(self):
        assert self.isloaded(), "load image first"
        if not self.isencrypted():
            self._tensor = self.forward(affine_to_linear(self._tensor))
        return self._tensor


# -------------------------------------------------------------------- factories

def Keynet(inshape, net=None, backend="torch", global_photometric="identity",
           local_photometric="identity", global_geometric="identity",
           local_geometric="identity", memoryorder="channel",
           do_output_encryption=False, alpha=None, beta=None, gamma=None,
           hierarchical_blockshape=None, hierarchical_permute_at_level=None,
           blocksize=None, tileshape=None, seed=None, device="cuda"):
    """Build (sensor, keynet) with per-layer keys drawn from the configured
    families.  ReLU layers receive keys restricted to families that commute
    with ReLU (reference keynet/system.py:472-486).  The rng streams are
    seeded exactly as keynet_tpu.system.Keynet seeds them, so the same seed
    gives the same keys."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    # secret-mask rng on an independent stream of the same seed
    mask_rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(1,)) if seed is not None
        else None)

    def f_keypair(layername, shape):
        relu = "relu" in layername
        return keygen(
            shape,
            global_photometric=global_photometric if not relu or global_photometric == "identity" else "identity",
            local_photometric=local_photometric if not relu or local_photometric == "identity" else "uniform_random_gain",
            global_geometric=global_geometric if not relu or global_geometric == "identity" else "identity",
            local_geometric=local_geometric if not relu or local_geometric == "identity" else "permutation",
            memoryorder=memoryorder, blocksize=blocksize, tileshape=tileshape,
            alpha=alpha, beta=beta, gamma=gamma,
            hierarchical_blockshape=hierarchical_blockshape,
            hierarchical_permute_at_level=hierarchical_permute_at_level,
            rng=rng)

    def f_layergen(module, inshape_, outshape_, A, Ainv, params=None):
        return layergen(module, inshape_, outshape_, A, Ainv, params=params,
                        tileshape=tileshape, backend=backend, rng=mask_rng,
                        mask_alpha=alpha)

    sensor = KeyedSensor(inshape, f_keypair("input", inshape), device=device)
    model = KeyedModel(net, inshape, sensor.key(), f_keypair, f_layergen,
                       do_output_encryption=do_output_encryption,
                       device=device) if net is not None else None
    return sensor, model


def IdentityKeynet(inshape, net, backend="torch", seed=None, device="cuda"):
    return Keynet(inshape, net, backend=backend, seed=seed, device=device)


def PermutationKeynet(inshape, net, do_output_encryption=False, seed=None,
                      device="cuda"):
    return Keynet(inshape, net, global_geometric="permutation",
                  do_output_encryption=do_output_encryption, seed=seed,
                  device=device)


def StochasticKeynet(inshape, net, alpha=2, blocksize=8, seed=None,
                     device="cuda", **kwargs):
    """Doubly-stochastic local keys with hierarchical global permutation; the
    alpha privacy parameter sets nonzeros per key row."""
    return Keynet(inshape, net, global_geometric="hierarchical_permutation",
                  hierarchical_blockshape=(2, 2), hierarchical_permute_at_level=(0, 1),
                  local_geometric="doubly_stochastic", alpha=alpha, blocksize=blocksize,
                  local_photometric="uniform_random_affine",
                  beta=kwargs.pop("beta", 1.0), gamma=kwargs.pop("gamma", 1.0),
                  seed=seed, device=device, **kwargs)
