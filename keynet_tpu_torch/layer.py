"""KeyedLayer: one layer of a keynet = one keyed homogeneous matrix on device.

Construction (host): lower the source layer to its homogeneous sparse matrix
W (Toeplitz for conv/avgpool, [W b;0 1] for linear), key it as
Ŵ = A · W · A⁻¹ (reference keynet/layer.py:16-82), then pack Ŵ into a
device operator (dense / Block-ELL / ELL, see keynet_tpu_torch/ops/operators.py).
Every op is built on the CPU; KeyedModel moves the finished ops to the device
once.

Inference (device): y = x @ Ŵᵀ for homogeneous row batches x: (N, D_in+1),
with an elementwise ReLU fused afterward for keyed-ReLU layers
(reference keynet/layer.py:88-93).
"""

import numpy as np
import scipy.sparse
import torch

from .globals import vprint, GLOBAL, precision
from .toeplitz import (toeplitz_conv2d, toeplitz_avgpool2d, toeplitz_global_avgpool2d,
                       toeplitz_shortcut)
from .homogeneous import affine_to_linear_matrix
from .ops.operators import (materialize, DenseOp, EllOp, PermutedBlockSparseOp,
                            conv_layout_perm, DEFAULT_TILE)
from .models import specs


def is_identity_key(A):
    """Cheap structural identity test for a key matrix (lets Identity keynets
    skip the A·W·A⁻¹ products entirely)."""
    if A is None:
        return True
    A = scipy.sparse.csr_matrix(A)
    return (A.nnz == A.shape[0] and A.shape[0] == A.shape[1]
            and bool((A.diagonal() == 1.0).all()))


def _key_sandwich(W, A, Ainv):
    """Ŵ = A·W·A⁻¹ with optional missing outer key (A=None for the unkeyed
    output layer, reference keynet/layer.py:59,70).  Identity keys skip their
    product; non-identity products run in float32 (the device dtype)."""
    W = scipy.sparse.csr_matrix(W).astype(np.float32)
    if Ainv is not None and not is_identity_key(Ainv):
        W = W @ scipy.sparse.csr_matrix(Ainv).astype(np.float32)
    if A is not None and not is_identity_key(A):
        W = scipy.sparse.csr_matrix(A).astype(np.float32) @ W
    return W


class KeyedLayer:
    """A keyed sparse matrix with a device-resident operator.

    ``module`` is a keynet_tpu_torch layer spec (models/specs.py) or None when
    constructing directly from a matrix (W=...).
    """

    def __init__(self, module=None, inshape=None, outshape=None, A=None, Ainv=None,
                 params=None, tileshape=None, W=None, format=None, rng=None,
                 mask_alpha=None):
        self._inshape = inshape
        self._outshape = outshape
        self._tileshape = tileshape
        self._relu = False
        # Secret-mask rng: factories thread one derived from the keygen seed so
        # conversions are reproducible (same seed -> same published artifact);
        # an unseeded default keeps ad-hoc constructions secret-by-default.
        self._rng = rng if rng is not None else np.random.default_rng()
        # Secret-mask strength scales with the keygen privacy parameter alpha
        # (floored by GLOBAL['MASK_ALPHA']) so masks are never weaker than the
        # keys they hide (ops.streaming._mask_rotations).
        self._mask_alpha = mask_alpha

        # Identity keys: Ŵ = A·W·A⁻¹ IS the source conv/pool Toeplitz, so
        # apply the convolution itself (ops.operators.DirectConvOp) — no
        # Toeplitz materialization, no key products.
        if GLOBAL.get("IDENTITY_DIRECT", "auto") != "never" and W is None \
                and inshape is not None and outshape is not None \
                and len(inshape) == 3 and len(outshape) == 3 \
                and isinstance(module, (specs.Conv2d, specs.AvgPool2d)) \
                and is_identity_key(A) and is_identity_key(Ainv):
            from .ops.operators import DirectConvOp
            if isinstance(module, specs.Conv2d):
                assert module.pad() == module.kernel_size // 2
                self._layertype = "conv2d"
                self._repr = "Conv2d: in_channels=%d, out_channels=%d, kernel_size=%d, stride=%d" % (
                    module.in_channels, module.out_channels, module.kernel_size,
                    module.stride)
                w = np.asarray(params["weight"], dtype=np.float32)
                b = None if params.get("bias") is None else \
                    np.asarray(params["bias"], dtype=np.float32).reshape(-1)
                op = DirectConvOp(w, b, inshape, outshape, module.stride)
            else:
                self._layertype = "avgpool2d"
                self._repr = "AvgPool2d: kernel_size=%d, stride=%d" % (
                    module.kernel_size, module.stride)
                k = module.kernel_size
                w = np.full((inshape[0], 1, k, k), 1.0 / (k * k),
                            dtype=np.float32)
                op = DirectConvOp(w, None, inshape, outshape, module.stride,
                                  groups=inshape[0])
            self._op = op
            self.shape = op.shape
            self._nnz = op.nnz()
            self._pending_f2 = None
            self._split_ok = False
            # host CSR for spy/serialization parity only at small scale (the
            # direct route exists precisely to avoid emitting the big ones)
            self.W = None
            if self._nnz <= min(GLOBAL.get("KEEP_HOST_NNZ", 50_000_000),
                                5_000_000):
                if isinstance(module, specs.Conv2d):
                    self.W = toeplitz_conv2d(inshape, params["weight"],
                                             bias=params["bias"],
                                             stride=module.stride)
                else:
                    self.W = scipy.sparse.csr_matrix(
                        toeplitz_avgpool2d(inshape, module.kernel_size,
                                           module.stride))
            return

        # Big keyed avgpools with per-channel-identical keys factor into
        # I_C ⊗ (spatial) and store/apply only the spatial factor — C× less
        # device memory and batched spatial products instead of a scalar ELL
        # gather (see ops.kronfactor.channel_broadcast_keyed_pool).  Tried
        # BEFORE the dense-inverse split below: the spatial-scale product
        # never materializes the p²-per-row fill the split exists to avoid.
        pool_op = None
        if isinstance(module, specs.AvgPool2d) and W is None \
                and inshape is not None and len(inshape) == 3 \
                and outshape is not None \
                and int(np.prod(outshape)) >= int(GLOBAL.get("POOL_FACTOR_MIN_N",
                                                             20_000)):
            from .ops.kronfactor import channel_broadcast_keyed_pool
            pool_op = channel_broadcast_keyed_pool(
                inshape, outshape, module.kernel_size, module.stride, A, Ainv,
                tileshape=tileshape)

        # Dense-blocks inverse input keys (doubly-stochastic locals) are split
        # behind a secret re-key R so the p²-per-row fill of W·A⁻¹ never
        # materializes: the layer becomes the chain (A·W·R)·(R⁻¹·A⁻¹)
        # (see ops.streaming.split_dense_inverse; R is discarded here).
        # The mask is a dense Haar orthogonal wherever the downstream route
        # can afford its fill (all-dense Kron chains; materialized layers
        # under the byte gate) — the published F2 block is then exactly
        # Haar-masked — and a thin Givens product on the strip-streaming
        # route, where fill = mixing is the binding constraint.
        self._split_ok = (pool_op is None and Ainv is not None and W is None
                          and inshape is not None and len(inshape) == 3
                          and inshape[1] * inshape[2] > 1
                          and not isinstance(module, specs.Linear))
        self._pending_f2 = None
        deferred_split = isinstance(module, specs.Conv2d)  # conv routes decide below
        if self._split_ok and not deferred_split:
            s = self._try_split(Ainv, module)
            if s is not None:
                Ainv, self._pending_f2 = s[0], s[1]

        if W is not None:
            self._layertype = "matrix"
            self._repr = "Matrix: shape=%s" % (W.shape,)
            W_hom = scipy.sparse.csr_matrix(W)
        elif isinstance(module, specs.Conv2d):
            assert module.pad() == module.kernel_size // 2, \
                "keyable convs require padding == kernel_size//2 (reference keynet/layer.py:28)"
            self._layertype = "conv2d"
            self._repr = "Conv2d: in_channels=%d, out_channels=%d, kernel_size=%d, stride=%d" % (
                module.in_channels, module.out_channels, module.kernel_size, module.stride)
            pred_nnz = (module.out_channels * module.in_channels * module.kernel_size ** 2
                        * (inshape[1] // module.stride) * (inshape[2] // module.stride))
            n_out_h = int(np.prod(outshape)) + 1
            n_in_h = int(np.prod(inshape)) + 1
            streaming_scale = pred_nnz > GLOBAL.get("STREAM_NNZ", 30_000_000)
            # a materialized scattered-key conv would land in ELL with
            # K ≈ C_in·k² rows — e.g. global-permutation cifar convs hit
            # K=865/1729 (measured 170 MB + VPU-bound apply); try the Kron
            # factorization for those even below streaming scale
            fat_ell = (module.in_channels * module.kernel_size ** 2 + 1
                       > GLOBAL.get("ELL_MAX_K", 128)
                       and n_out_h * n_in_h * 4 > GLOBAL["DENSE_MAX_BYTES"])
            if streaming_scale or fat_ell:
                # Never materialize Ŵ at these scales.  Keys with identical
                # per-channel spatial blocks (up to global permutation
                # factors) publish as a Kronecker-factored masked chain
                # (tens of MB of dense factors + dense matmuls,
                # ops/kronfactor.py); everything else streams strips.
                from .ops.streaming import masked_keyed_conv_streaming
                from .ops.kronfactor import kron_factored_keyed_conv
                import scipy.sparse as _sp
                A_ = A if A is not None else _sp.identity(n_out_h, format="csr")
                Ainv_ = Ainv if Ainv is not None else _sp.identity(n_in_h, format="csr")
                op = None
                # per-route child rngs: a probe that draws masks and then
                # DECLINES must not perturb the stream the taken route reads,
                # or seeded mask reproducibility would depend on which routes
                # were tried.  spawn() is deterministic from the seed, so
                # same seed -> same artifact.
                rng_kron, rng_stream = self._rng.spawn(2)
                if GLOBAL.get("KRON_FACTORED", "auto") != "never":
                    # the Kron chain is all dense GEMMs: split with the dense
                    # Haar mask (published F2 block exactly Haar-masked)
                    s = self._try_split(Ainv_, module, force_dense=True,
                                        rng=rng_kron)
                    op = kron_factored_keyed_conv(inshape, outshape,
                                                  params["weight"],
                                                  params["bias"], module.stride,
                                                  A_,
                                                  s[0] if s is not None else Ainv_,
                                                  rng=rng_kron)
                    if op is not None and s is not None:
                        self._pending_f2 = s[1]
                if op is None and streaming_scale:
                    # streaming route: thin Givens mask (fill = mixing is the
                    # binding constraint; keyed-interposition security)
                    s = self._try_split(Ainv_, module, force_thin=True,
                                        rng=rng_stream)
                    if s is not None:
                        Ainv_, self._pending_f2 = s[0], s[1]
                    op = masked_keyed_conv_streaming(inshape, outshape,
                                                     params["weight"],
                                                     params["bias"],
                                                     module.stride, A_, Ainv_,
                                                     rng=rng_stream,
                                                     mask_alpha=mask_alpha,
                                                     tileshape=tileshape
                                                     or DEFAULT_TILE)
                if op is not None:
                    self._op = op
                    self._chain_f2()
                    self.W = None
                    self.shape = self._op.shape
                    self._nnz = self._op.nnz()
                    return
                assert not streaming_scale  # fat_ell probe declined: materialize
                self._pending_f2 = None     # fat_ell kron split didn't engage
            if self._split_ok and self._pending_f2 is None:
                s = self._try_split(Ainv, module)
                if s is not None:
                    Ainv, self._pending_f2 = s[0], s[1]
            W_hom = toeplitz_conv2d(inshape, params["weight"], bias=params["bias"],
                                    stride=module.stride)
            W_hom = _key_sandwich(W_hom, A, Ainv)
        elif isinstance(module, specs.AvgPool2d):
            self._layertype = "avgpool2d"
            self._repr = "AvgPool2d: kernel_size=%d, stride=%d" % (module.kernel_size, module.stride)
            if pool_op is not None:
                self._op = pool_op
                self.W = None
                self.shape = pool_op.shape
                self._nnz = pool_op.nnz()
                return
            W_hom = toeplitz_avgpool2d(inshape, module.kernel_size, module.stride)
            W_hom = _key_sandwich(W_hom, A, Ainv)
        elif isinstance(module, specs.GlobalAvgPool2d):
            self._layertype = "avgpool2d"
            self._repr = "GlobalAvgPool2d"
            W_hom = _key_sandwich(toeplitz_global_avgpool2d(inshape), A, Ainv)
        elif isinstance(module, specs.Shortcut):
            # Ŝ = A_out·S·A_src⁻¹ with its homogeneous row zeroed: the residual
            # sum then keeps the branch's trailing 1 alone
            self._layertype = "shortcut"
            self._repr = "Shortcut: stride=%d" % specs.shortcut_shape(inshape, outshape)
            W_hom = _key_sandwich(toeplitz_shortcut(inshape, outshape), A, Ainv)
            W_hom = scipy.sparse.vstack([W_hom[:-1], scipy.sparse.csr_matrix(
                (1, W_hom.shape[1]), dtype=np.float32)], format="csr")
        elif isinstance(module, specs.Linear):
            self._layertype = "linear"
            self._repr = "Linear: in_features=%d, out_features=%d" % (
                module.in_features, module.out_features)
            # dense fast path: Linear weights are dense, so key with two
            # sparse·dense products instead of sparse·sparse spgemm
            Wd = affine_to_linear_matrix(params["weight"], params["bias"])
            if Ainv is not None:
                Wd = scipy.sparse.csr_matrix(Ainv).T.dot(Wd.T).T
            if A is not None:
                Wd = scipy.sparse.csr_matrix(A).dot(Wd)
            W_hom = np.ascontiguousarray(Wd)  # stays dense end to end
        elif isinstance(module, specs.ReLU):
            # Explicitly keyed ReLU (only when it cannot be folded into the
            # previous layer, e.g. after a fused batchnorm;
            # reference keynet/layer.py:43-46, keynet/system.py:96-101)
            self._layertype = "relu"
            self._repr = "ReLU"
            self._relu = True
            W_hom = _key_sandwich(scipy.sparse.identity(A.shape[0], format="csr"), A, Ainv) \
                if A is not None else scipy.sparse.csr_matrix(Ainv)
        elif isinstance(module, (specs.BatchNorm2d, specs.Dropout)):
            raise ValueError("batchnorm must be fused ('xyz_bn' after 'xyz') and dropout "
                             "removed before keying (reference keynet/layer.py:72-76)")
        else:
            raise ValueError("unsupported layer type %r" % (module,))

        if isinstance(W_hom, np.ndarray):  # dense keyed linear layer
            W_hom = W_hom.astype(np.float32)
            self.shape = W_hom.shape
            self._nnz = int(np.count_nonzero(W_hom))
            self._op = DenseOp(W_hom, nnz=self._nnz)
            self.W = scipy.sparse.csr_matrix(W_hom) \
                if self._nnz <= GLOBAL.get("KEEP_HOST_NNZ", 50_000_000) else None
            return

        W_hom = W_hom.astype(np.float32)
        self.shape = W_hom.shape
        self._nnz = int(W_hom.nnz)
        self._op = self._materialize(W_hom, format)
        if self._pending_f2 is not None:
            self._chain_f2()
            self._nnz = self._op.nnz()
            self.shape = self._op.shape
            self.W = None  # factored layer: no single host matrix
            return
        # retain the host CSR only when small (spy/serialization/baselines);
        # big keyed matrices live on device only
        self.W = W_hom if self._nnz <= GLOBAL.get("KEEP_HOST_NNZ", 50_000_000) else None

    def _try_split(self, Ainv, module, force_dense=False, force_thin=False,
                   rng=None):
        """Split a dense-blocks inverse key behind a secret re-key, or None
        when the structure does not hold (ops.streaming.split_dense_inverse).

        Mask density follows the route: a dense Haar orthogonal wherever the
        downstream math is dense (``force_dense``: the all-GEMM Kron chain;
        the materialize path when the estimated post-mask fill stays under
        GLOBAL['MASK_DENSE_MAX_BYTES']), a thin Givens product on the
        strip-streaming route (``force_thin``) where mask fill multiplies
        strip spgemm work and tile count.  ``rng`` overrides the layer rng
        (route probes pass per-route children so a declined draw does not
        perturb another route's mask stream)."""
        if not self._split_ok or Ainv is None:
            return None
        rng = rng if rng is not None else self._rng
        from .ops.streaming import split_dense_inverse, factor_left_identical
        Ainv = scipy.sparse.csr_matrix(Ainv)
        npix = self._inshape[1] * self._inshape[2]
        divs = [d for d in range(2, min(npix, 8192) + 1) if npix % d == 0]
        dense = force_dense
        if not force_dense and not force_thin:
            f = factor_left_identical(Ainv, divs)
            if f is None:
                return None
            p = int(f[0])
            if isinstance(module, specs.Conv2d):
                q = module.in_channels * module.kernel_size ** 2
            elif isinstance(module, specs.AvgPool2d):
                q = module.kernel_size ** 2
            else:
                q = 4  # keyed-ReLU sandwiches: ReLU-restricted keys are ~diag
            n_out = int(np.prod(self._outshape)) + 1 if self._outshape is not None \
                else Ainv.shape[0]
            est = 8 * n_out * min(q * p, Ainv.shape[1])
            dense = est <= int(GLOBAL.get("MASK_DENSE_MAX_BYTES", 64 << 20))
        return split_dense_inverse(Ainv, divs, rng=rng,
                                   mask_alpha=self._mask_alpha,
                                   dense_mask=dense)

    def _chain_f2(self):
        """Append the split-off compact inverse factor: op ← op ∘ F2."""
        if self._pending_f2 is not None:
            from .ops.operators import ChainedOp
            self._op = ChainedOp([self._pending_f2, self._op])
            self._pending_f2 = None

    def _materialize(self, W_hom, format):
        """Pick the device format.  Linear layers are dense by nature; spatial
        layers (conv/avgpool/keyed-relu) that exceed the dense budget are
        packed as Block-ELL under the channel-minor pixel-block layout, with
        ELL scalar-sparse as the scattered-key fallback.  A user-supplied
        ``tileshape`` (snapped by system.repair_tileshape) sets the
        Block-ELL device tile."""
        n_out, n_in = W_hom.shape
        tile = self._tileshape or DEFAULT_TILE
        if format is not None:
            return materialize(W_hom, tileshape=tile, format=format)
        spatial = (self._inshape is not None and self._outshape is not None
                   and len(self._inshape) == 3 and len(self._outshape) == 3
                   and self._inshape[1] * self._inshape[2] > 1)
        # pooling / keyed-ReLU / shortcut matrices are a few nnz per row (pool
        # window x key fill): ELL (8 bytes/nnz) beats dense whenever the row
        # fill K is small; BIG spatial ones fall through to the Block-ELL
        # packing below like the convs, with ELL the fallback if the packing
        # declines.  Same routing as the JAX package.  A shortcut of one gain
        # a row (ReLU-restricted keys at both ends) is always an ELL gather.
        if self._layertype in ("avgpool2d", "relu", "shortcut"):
            K = int(np.diff(W_hom.indptr).max()) if W_hom.nnz else 1
            if self._layertype == "shortcut" and K <= 1:
                return EllOp.from_scipy(W_hom)
            if K <= GLOBAL.get("ELL_MAX_K", 128) \
                    and 8 * 8 * n_out * K <= n_out * n_in * 4:
                big = 8 * n_out * K > int(GLOBAL.get("POOL_BLOCK_ELL_MIN_BYTES",
                                                     16 << 20))
                if not (big and spatial):
                    return EllOp.from_scipy(W_hom)
        if self._layertype == "linear" or n_out * n_in * 4 <= GLOBAL["DENSE_MAX_BYTES"]:
            return DenseOp.from_scipy(W_hom)
        ell_bytes = 8 * n_out * max(1, int(np.diff(W_hom.indptr).max()))
        if spatial:
            from .ops.operators import conv_layout_blocks
            hom_in = n_in == int(np.prod(self._inshape)) + 1
            hom_out = n_out == int(np.prod(self._outshape)) + 1
            bi = conv_layout_blocks(self._inshape)
            bo = conv_layout_blocks(self._outshape)
            perm_in = conv_layout_perm(self._inshape, homogeneous=hom_in, blocks=bi)
            perm_out = conv_layout_perm(self._outshape, homogeneous=hom_out, blocks=bo)
            op = PermutedBlockSparseOp.from_scipy(
                W_hom, perm_out, perm_in, tileshape=tile,
                max_pack_bytes=max(8 * ell_bytes, GLOBAL["DENSE_MAX_BYTES"]),
                layout_in=("blk", *self._inshape, *bi) if hom_in else None,
                layout_out=("blk", *self._outshape, *bo) if hom_out else None)
            if op is not None and op.device_bytes() <= max(4 * ell_bytes,
                                                           GLOBAL["DENSE_MAX_BYTES"]):
                return op
            vprint("[KeyedLayer]: layout-BSR unattractive for %s, using ELL"
                   % (self._layertype,))
        return EllOp.from_scipy(W_hom)

    # --------------------------------------------------------------- runtime
    def forward(self, x):
        """x: (N, D_in+1) homogeneous batch on the op's device -> (N, D_out+1)."""
        precision()
        y = self._op.apply(torch.as_tensor(x, dtype=torch.float32,
                                           device=self._op.device))
        return torch.clamp_min(y, 0.0) if self._relu else y

    __call__ = forward

    def decrypt(self, Ainv, x):
        """Decrypt this layer's output with the supplied inverse key."""
        x = torch.as_tensor(x, dtype=torch.float32)
        op = materialize(scipy.sparse.csr_matrix(Ainv)).to(x.device)
        return op.apply(x)

    # ------------------------------------------------------------ accounting
    def nnz(self):
        return self._nnz

    def device_bytes(self):
        return self._op.device_bytes()

    def op(self):
        return self._op

    def spy(self, mindim=256):
        from .visualize import spy
        assert self.W is not None, \
            "host matrix was dropped (nnz > GLOBAL['KEEP_HOST_NNZ']); raise the cap to spy"
        return spy(self.W, mindim=mindim)

    def __repr__(self):
        return "<KeyedLayer: %s, format=%s, shape=%s, nnz=%d>" % (
            self._repr, type(self._op).__name__, self.shape, self.nnz())
