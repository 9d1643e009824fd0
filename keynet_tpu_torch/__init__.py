"""keynet_tpu_torch — Key-Nets on PyTorch and CUDA (NVIDIA H100).

The port of keynet_tpu (JAX/Pallas on a TPU), which stays the reference.
Host conversion (keygen, Toeplitz lowering, keying Ŵ = A·W·A⁻¹, packing)
is numpy/scipy/C++ with the same rng draws, so the same seed gives the same
keys and packed arrays; the keyed forward runs in PyTorch with the Block-ELL
slot walk and its periodic mid-section as hand-written CUDA kernels
(csrc/block_ell.cu, csrc/periodic_block_ell.cu).  The two Block-ELL variants
no operator routes to (csrc/block_ell_xres.cu, csrc/block_ell_grid.cu) run
in the kernel bench, ``python -m keynet_tpu_torch.bench_kernels``.

Quickstart:

    import keynet_tpu_torch as keynet
    net = keynet.models.AllConvNet(seed=1)
    sensor, knet = keynet.StochasticKeynet((3, 32, 32), net, alpha=2,
                                           blocksize=8, seed=0, device="cuda")
    y = knet.forward(sensor.fromtensor(x).encrypt().tensor())

Entry points take ``device=`` (default "cuda") and raise without a card
unless device="cpu" is given.
"""

from . import globals
globals.tune_allocator()  # warm-heap allocator policy (see globals.tune_allocator)
from . import util
from . import homogeneous
from . import native
from . import toeplitz
from . import blockpermute
from . import keys
from . import ops
from . import layer
from . import models
from . import system
from . import serialize
from . import profiling

from .keys import keygen
from .layer import KeyedLayer
from .system import (KeyedModel, KeyedSensor, PublicKeyedSensor, Keynet,
                     IdentityKeynet, PermutationKeynet, StochasticKeynet,
                     layergen, fuse_conv2d_and_bn)
from .serialize import load_keynet
