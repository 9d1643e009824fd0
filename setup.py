"""Build the keynet_tpu native host-runtime extension.

    python setup.py build_ext --inplace

The package degrades gracefully to pure-numpy paths when the extension is
absent (see keynet_tpu/native.py).
"""

import numpy
from setuptools import setup, Extension

setup(
    name="keynet_tpu",
    version="0.1.0",
    packages=["keynet_tpu", "keynet_tpu.models", "keynet_tpu.ops", "keynet_tpu.parallel",
              "keynet_tpu_torch", "keynet_tpu_torch.models", "keynet_tpu_torch.ops",
              "keynet_tpu_torch.parallel", "keynet_tpu_torch.examples",
              "keynet_tpu_torch.scripts"],
    ext_modules=[
        Extension(
            "keynet_tpu._native",
            sources=["native/packer.cpp"],
            include_dirs=[numpy.get_include()],
            # -ffp-contract=off: emit_pba_fill's bias accumulation must round
            # like numpy (no FMA contraction) so the native and numpy
            # emission paths stay bitwise-identical
            extra_compile_args=["-O3", "-std=c++17", "-march=native",
                                "-ffp-contract=off"],
            language="c++",
        ),
        Extension(
            "keynet_tpu_torch._native",
            sources=["native/packer.cpp"],
            include_dirs=[numpy.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-march=native",
                                "-ffp-contract=off"],
            language="c++",
        ),
    ],
)
