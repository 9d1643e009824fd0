"""keynet_tpu_torch host conversion against keynet_tpu: the same seed gives
array-equal keys, Toeplitz lowerings, block permutations and homogeneous
helpers (all numpy/scipy/C++ on the host, so equality is exact)."""

import numpy as np
import pytest
import scipy.sparse
import torch

import keynet_tpu as kj
import keynet_tpu_torch as kt


def _csr_equal(a, b):
    a, b = scipy.sparse.csr_matrix(a), scipy.sparse.csr_matrix(b)
    a.sort_indices()
    b.sort_indices()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data))


STOCHASTIC = dict(global_geometric="hierarchical_permutation",
                  hierarchical_blockshape=(2, 2), hierarchical_permute_at_level=(0, 1),
                  local_geometric="doubly_stochastic", alpha=2, blocksize=8,
                  local_photometric="uniform_random_affine", beta=1.0, gamma=1.0)
RELU_STOCHASTIC = dict(STOCHASTIC, local_photometric="uniform_random_gain",
                       local_geometric="permutation", global_geometric="identity")
PERMUTATION = dict(global_geometric="permutation")
GIVENS = dict(local_geometric="givens_orthogonal", alpha=2, blocksize=4,
              memoryorder="block")


@pytest.mark.parametrize("recipe,shape", [
    (r, s) for r in ("stochastic", "relu_stochastic", "permutation")
    for s in ((3, 32, 32), (8, 16, 16), (10, 1, 1))]
    + [("givens", (3, 32, 32)), ("givens", (8, 16, 16))])
def test_keygen_keypairs_equal(recipe, shape):
    kw = {"stochastic": STOCHASTIC, "relu_stochastic": RELU_STOCHASTIC,
          "permutation": PERMUTATION, "givens": GIVENS}[recipe]
    A0, Ai0 = kj.keys.keygen(shape, seed=5, **kw)
    A1, Ai1 = kt.keys.keygen(shape, seed=5, **kw)
    assert _csr_equal(A0, A1) and _csr_equal(Ai0, Ai1)


def test_keygen_shared_stream_equal():
    """Consecutive draws from one rng (the Keynet factory's key stream)."""
    r0, r1 = np.random.default_rng(3), np.random.default_rng(3)
    for shape in [(3, 32, 32), (96, 32, 32), (6, 14, 14)]:
        k0 = kj.keys.keygen(shape, rng=r0, **STOCHASTIC)
        k1 = kt.keys.keygen(shape, rng=r1, **STOCHASTIC)
        assert _csr_equal(k0[0], k1[0]) and _csr_equal(k0[1], k1[1])


@pytest.mark.parametrize("inshape,cout,k,stride,bias", [
    ((3, 16, 16), 8, 3, 1, True), ((4, 12, 12), 6, 3, 2, True),
    ((2, 9, 9), 3, 5, 1, False), ((8, 8, 8), 4, 1, 1, True)])
def test_toeplitz_conv2d_equal(inshape, cout, k, stride, bias):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((cout, inshape[0], k, k)).astype(np.float32)
    w[0, 0, 0, 0] = 0.0   # explicit zero taps stay stored entries
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    T0 = kj.toeplitz.toeplitz_conv2d(inshape, w, bias=b, stride=stride)
    T1 = kt.toeplitz.toeplitz_conv2d(inshape, w, bias=b, stride=stride)
    assert _csr_equal(T0, T1) and T0.nnz == T1.nnz


@pytest.mark.parametrize("inshape,k,stride", [((6, 28, 28), 3, 2), ((3, 8, 8), 2, 2)])
def test_toeplitz_avgpool2d_equal(inshape, k, stride):
    assert _csr_equal(kj.toeplitz.toeplitz_avgpool2d(inshape, k, stride),
                      kt.toeplitz.toeplitz_avgpool2d(inshape, k, stride))


def test_hierarchical_block_permutation_equal():
    p0 = kj.blockpermute.hierarchical_block_permutation((32, 32, 3), (2, 2), [0, 1],
                                                        seed=4)
    p1 = kt.blockpermute.hierarchical_block_permutation((32, 32, 3), (2, 2), [0, 1],
                                                        seed=4)
    assert np.array_equal(p0, p1)


def test_homogeneous_tensor_helpers():
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 4)).astype(np.float32)
    h0 = np.asarray(kj.homogeneous.affine_to_linear(x))
    h1 = kt.homogeneous.affine_to_linear(torch.from_numpy(x))
    assert np.array_equal(h0, h1.numpy())
    assert np.array_equal(np.asarray(kj.homogeneous.linear_to_affine(h0, (3, 4, 4))),
                          kt.homogeneous.linear_to_affine(h1, (3, 4, 4)).numpy())
    with pytest.raises(ValueError):
        kt.homogeneous.linear_to_affine(torch.zeros(2, 5))


def test_port_imports_no_jax():
    """The port imports neither jax nor keynet_tpu (checked in a fresh
    interpreter, where nothing else has loaded them)."""
    import subprocess
    import sys
    code = ("import sys, keynet_tpu_torch, keynet_tpu_torch.ops.block_ell; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'keynet_tpu' or m.startswith('keynet_tpu.')]; "
            "assert not bad, bad")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
