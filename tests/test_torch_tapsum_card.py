"""Card-only test of TapSumOp's stacked-GEMM apply (marked ``cuda``; it
skips without a card).  Imports neither JAX nor keynet_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_tapsum_card.py

At All-CNN conv2's shape (C1 = C2 = 96, 32x32 pixels, 3x3 taps) with a
batch small enough to run quickly but large enough to be cut into chunks."""

import pytest
import torch

from keynet_tpu_torch.ops.operators import TapSumOp

B, T, C1, C2, P1, P2 = 16, 9, 96, 96, 1024, 1024


def _per_tap(K, S, bias, x):
    """The plain version: one tap at a time, a running sum of the taps'
    products, then the bias and the homogeneous column."""
    B = x.shape[0]
    n_in = K.shape[2] * S.shape[2]
    xc = x[:, :n_in].reshape(B, K.shape[2], S.shape[2])
    xh = x[:, n_in:]
    y = None
    for t in range(K.shape[0]):
        yt = torch.matmul(K[t], torch.matmul(xc, S[t].T))
        y = yt if y is None else y + yt
    y = y.reshape(B, -1) + xh * bias[None, :]
    return torch.cat([y, xh], dim=1)


def _peak_bytes(fn):
    """Device bytes ``fn`` allocates beyond what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


@pytest.mark.cuda
def test_tapsum_stacked_on_card():
    """Within 1e-5 (relative to the largest output) of the float64 per-tap
    product, and no more device memory at its peak than the per-tap sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python3 chip_smoke.py)")
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device="cuda").manual_seed(0)
    K = torch.randn(T, C2, C1, device="cuda", generator=g) / (C1 * T) ** 0.5
    S = torch.randn(T, P2, P1, device="cuda", generator=g) / P1 ** 0.5
    bias = torch.randn(C2 * P2, device="cuda", generator=g)
    x = torch.randn(B, C1 * P1 + 1, device="cuda", generator=g)
    op = TapSumOp(K, S, bias)
    chunks = op.chunks(B)
    assert len(chunks) > 1, chunks

    y = op.apply(x)
    torch.cuda.synchronize()

    ref = _per_tap(K.double(), S.double(), bias.double(), x.double())
    err = float((y.double() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
    del y, ref

    plain = _peak_bytes(lambda: _per_tap(K, S, bias, x))
    stacked = _peak_bytes(lambda: op.apply(x))
    assert stacked <= plain, (stacked, plain)
