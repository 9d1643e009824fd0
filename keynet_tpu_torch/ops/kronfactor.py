"""Kronecker-factored keyed convolutions, and channel-broadcast keyed pools
(channel_broadcast_keyed_pool, at the end).

A conv's Toeplitz matrix is exactly a sum of Kronecker products over its taps

    W = Σ_o  k_o ⊗ T_o        (channel-major vector order)

with k_o the (C_out, C_in) channel matrix of tap o and T_o the 0/1 pixel
shift-with-edge-clipping matrix of that tap's offset.  When a layer's keys
have identical per-channel spatial blocks — A = I_C ⊗ D̃ + p-periodic bias,
the exact structure keygen's local (blockwise) keys produce in channel
memoryorder (keys.keygen; reference keynet/system.py:370-412) — the keyed
matrix Ŵ = A·W·A⁻¹ inherits the form

    Ŵ = Σ_o  k_o ⊗ (D̃_out · T_o · D̃_in')

Materializing this (as Block-ELL tiles) throws that structure away: at VGG
conv5 scale every (channel-pair × pixel-pair) tile is distinct (~27 K unique
tiles, ~GBs).  This module instead PUBLISHES the layer as a 3-link chain with
secret Kronecker masks R = Q ⊗ E (Q, E dense orthogonal; discarded after
conversion) and a secret tap-basis mixer G:

    F1 = A · R_out              =  Q_out ⊗ (D̃_out·E_out)       KroneckerOp
    M  = R_out⁻¹ · W · R_in     =  Σ_t K̃_t ⊗ S̃_t               TapSumOp
    F2 = R_in⁻¹ · A⁻¹           =  Q_inᵀ ⊗ (E_inᵀ·D̃_in')       KroneckerOp

    K̃_t = Σ_o (G⁻ᵀ)[t,o] · Q_outᵀ k_o Q_in
    S̃_t = Σ_o G[t,o] · E_outᵀ T_o E_in

F1·M·F2 == Ŵ exactly (each factor is the exact homogeneous matrix), at
T·(C² + p²) + 2(C² + p²) floats — tens of MB where tiles need gigabytes —
and the apply path is a short chain of dense matmuls.

Security (docs/DESIGN.md §kron-factored): every published array is the true
key/weight factor masked by a secret dense orthogonal (or their composite);
the tap mixer G prevents the known-values attack on the spatial factors
(without it, the center tap publishes E_outᵀE_in since T_center = I).  The
invariants an adversary can extract from the factors (tap-span of Ŵ, channel
matrices up to orthogonal basis change) are computable from a materialized Ŵ
as well — the factored publication reveals nothing the dense form does not.
"""

import numpy as np
import scipy.sparse
import torch

from ..globals import GLOBAL, vprint
from ..toeplitz import toeplitz_conv2d
from .operators import KroneckerOp, TapSumOp, ChainedOp


def identical_channel_blocks(A, npix, n_channels):
    """Detect A = [[I_C ⊗ D̃, tile(b)], [0, 1]] for a homogeneous key matrix:
    core block-diagonal at npix with ALL channel blocks identical and an
    npix-periodic bias column.  Returns (D̃ dense (npix, npix) f32,
    b (npix,) f32) or None.  D̃'s internal structure is irrelevant — any
    per-channel-identical spatial key qualifies (local permutation, Givens,
    doubly-stochastic, with local photometric gain/bias folded in)."""
    from .streaming import _key_blocks_identical
    n = A.shape[0] - 1
    if n != npix * n_channels:
        return None
    if not _key_blocks_identical(A, npix):
        return None
    A = scipy.sparse.csr_matrix(A)
    D = np.asarray(A[:npix, :npix].todense(), dtype=np.float32)
    b = np.asarray(A[:npix, [n]].todense(), dtype=np.float32).ravel()
    return D, b


def _zero_bias(M):
    """Copy of a homogeneous CSR with the bias column zeroed (so the
    bias-periodicity clause of _key_blocks_identical passes trivially —
    biases are handled numerically by the Kron factorization)."""
    M = scipy.sparse.csr_matrix(M, copy=True)
    n = M.shape[0] - 1
    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    M.data[(M.indices == M.shape[1] - 1) & (rows < n)] = 0.0
    M.eliminate_zeros()
    return M


def _kron_side(M, npix, C, side):
    """Factor one key side into Kronecker-compatible parts.  Returns
    (D (npix, npix) f32, b (n,) f32 raw bias column, gather int64 or None):

      side='out' (the forward key A):
          M = G_row · (I_C ⊗ D) + bias   →  y = take(kron_y, gather) + bias
      side='in' (the inverse key A⁻¹):
          M = (I_C ⊗ D) · G_col + bias   →  x' = take(x_core, gather)

    Covers global permutation factors (flat or hierarchical spatial
    permutations compose with per-channel-identical local keys into exactly
    these forms) in addition to the plain I_C ⊗ D case; returns None when
    the structure does not hold."""
    from ..layer import is_identity_key
    from .streaming import _key_blocks_identical, factor_left_identical, \
        factor_right_perm
    n = npix * C
    if M is None or is_identity_key(M):
        return (np.eye(npix, dtype=np.float32), np.zeros(n, dtype=np.float32),
                None)
    if M.shape[0] - 1 != n:
        return None
    M = scipy.sparse.csr_matrix(M)
    b = np.asarray(M[:n, [n]].todense(), dtype=np.float32).ravel()
    if _key_blocks_identical(_zero_bias(M), npix):
        D = np.asarray(M[:npix, :npix].todense(), dtype=np.float32)
        return D, b, None
    if side == "out":
        f = factor_left_identical(M, [npix])
        if f is None:
            return None
        p, g, D0, _ = f
        return np.asarray(D0, dtype=np.float32), b, g.astype(np.int64)
    f = factor_right_perm(M, [npix])
    if f is None:
        return None
    p, g, B = f
    if not _key_blocks_identical(_zero_bias(B), npix):
        return None
    D = np.asarray(scipy.sparse.csr_matrix(B)[:npix, :npix].todense(),
                   dtype=np.float32)
    return D, b, np.argsort(g).astype(np.int64)   # xp[k] = x[g⁻¹(k)]


def _detected_period(M, npix):
    """Smallest pixel-divisor block-diagonal period of a key's core, or npix
    when no divisor fits (no block structure / permutation-composed keys —
    those dedup at whole-image scale if they stream).  Identity keys are 1."""
    from ..layer import is_identity_key
    from .operators import block_diag_period
    if M is None or is_identity_key(M):
        return 1
    divs = [d for d in range(2, npix + 1) if npix % d == 0]
    p = block_diag_period(M, divs)
    return int(p) if p is not None else npix


def _wide_kron_wanted(A, Ainv, p1, p2):
    """Engage the wide npix range only when streaming would dedup poorly:
    some key side has no block period below GLOBAL['KRON_WIDE_PERIOD'], i.e.
    its local blocks span (nearly) the whole image.  Streamed tiles for such
    keys are pairwise distinct (measured: stochastic VGG-224 conv3_1, key
    period 3136 = whole 56x56 image, 13,974 unique tiles = 458 MB bf16 +
    272 s of strip spgemm — vs ~430 MB of dense Kron factors built in
    seconds and applied as dense matmuls).  Small-period keys stream into a
    few hundred deduped tiles, far smaller than p^2 dense factors — keep
    streaming those."""
    wide_min = int(GLOBAL.get("KRON_WIDE_PERIOD", 512))
    return max(_detected_period(A, p2), _detected_period(Ainv, p1)) > wide_min


def random_orthogonal(m, rng):
    """Haar-ish random dense orthogonal via QR with sign fix."""
    Q, R = np.linalg.qr(rng.standard_normal((m, m)))
    return np.ascontiguousarray(Q * np.sign(np.diag(R))[None, :]).astype(np.float32)


def _tap_matrices(inshape, kh, kw, stride):
    """T_o for every tap offset, built from the SAME Toeplitz lowering the
    rest of the runtime uses (single-tap unit filters), so edge clipping and
    stride semantics match bit-for-bit.  Returns list of (p2, p1) csr."""
    _, H, W = inshape
    taps = []
    for dy in range(kh):
        for dx in range(kw):
            w1 = np.zeros((1, 1, kh, kw), dtype=np.float32)
            w1[0, 0, dy, dx] = 1.0
            taps.append(toeplitz_conv2d((1, H, W), w1, bias=None, stride=stride))
    return taps


def kron_factored_keyed_conv(inshape, outshape, weight, bias, stride,
                             A, Ainv, rng=None, selfcheck=True):
    """Build the masked Kronecker chain for Ŵ = A·toeplitz(weight,bias)·A⁻¹.

    Engages when both keys have identical per-channel spatial blocks (or are
    identity) and the pixel counts are within GLOBAL['KRON_NPIX_MAX'] (dense
    (npix, npix) spatial factors).  Returns a ChainedOp ([F2, M, F1] in apply
    order) or None when the structure does not hold.  ``selfcheck`` verifies
    the chain against a direct conv oracle on random vectors and rejects the
    factorization on mismatch (fall back to streaming) — the fast path can
    only be fast, never wrong.
    """
    C1, H1, W1 = inshape
    C2, H2, W2 = outshape
    p1, p2 = H1 * W1, H2 * W2
    npix_max = int(GLOBAL.get("KRON_NPIX_MAX", 1024))
    wide_max = int(GLOBAL.get("KRON_NPIX_WIDE", 4096))
    if p1 > wide_max or p2 > wide_max or p1 <= 1 or p2 <= 1:
        return None
    if p1 > npix_max or p2 > npix_max:
        # wide range: dense (npix, npix) factors are only worth it when the
        # streamed alternative would dedup at whole-image scale
        if not _wide_kron_wanted(A, Ainv, p1, p2):
            return None
        kh_, kw_ = np.asarray(weight).shape[2], np.asarray(weight).shape[3]
        est = 4 * (kh_ * kw_ * p1 * p2 + p1 * p1 + p2 * p2
                   + C1 * C1 + C2 * C2)
        if est > int(GLOBAL.get("KRON_WIDE_MAX_BYTES", 1 << 30)):
            return None
    rng = rng if rng is not None else np.random.default_rng()

    fo = _kron_side(A, p2, C2, "out")
    if fo is None:
        return None
    D_out, b_out_full, g_out = fo
    fi = _kron_side(Ainv, p1, C1, "in")
    if fi is None:
        return None
    D_in, b_in_raw, g_in = fi

    weight = np.asarray(weight, dtype=np.float32)
    bias = np.asarray(bias, dtype=np.float32).reshape(-1) if bias is not None \
        else np.zeros(C2, dtype=np.float32)
    kh, kw = weight.shape[2], weight.shape[3]
    T = kh * kw
    taps = _tap_matrices(inshape, kh, kw, stride)
    k_taps = weight.reshape(C2, C1, T).transpose(2, 0, 1)   # (T, C2, C1)

    # secret masks (discarded with this function's frame)
    Q_out = random_orthogonal(C2, rng)
    E_out = random_orthogonal(p2, rng)
    Q_in = random_orthogonal(C1, rng)
    E_in = random_orthogonal(p1, rng)
    G = rng.standard_normal((T, T))
    while abs(np.linalg.det(G)) < 1e-6:          # secret tap-basis mixer
        G = rng.standard_normal((T, T))
    Hmix = np.linalg.inv(G).T

    # published middle factors: Σ_t K̃_t ⊗ S̃_t == Σ_o (Q_outᵀk_oQ_in) ⊗ (E_outᵀT_oE_in)
    # The tap mixer G is applied to the SPARSE taps before the dense mask
    # products: S̃_mix[t] = E_outᵀ·(Σ_o G[t,o]·T_o)·E_in — one dense GEMM
    # chain per mixed tap and no (T, p2, p1) unmixed intermediate (354 MB +
    # a memory-bound tensordot at conv3 scale, ~16 s of first-touch pages).
    # (mix the sparse taps in f64 — the G/Hmix cancellation must be exact to
    # f64 so the mixer adds no tap-basis leakage beyond f32 rounding — then
    # cast each mixed tap to f32 for the dense mask GEMMs)
    S_mix = np.stack([
        np.asarray(E_out.T @ (sum(G[t, o] * taps[o] for o in range(T))
                              .astype(np.float32) @ E_in), dtype=np.float32)
        for t in range(T)])
    # batched matmuls, NOT one naive einsum: "dc,tce,ef->tdf" unoptimized is
    # O(T·C2²·C1²) — 1.5e11 ops at conv4 (measured ~200 s); this is ~2 GFLOP
    K_hat = np.matmul(Q_out.T[None], np.matmul(k_taps, Q_in))
    K_mix = np.tensordot(Hmix, K_hat, axes=(1, 0)).astype(np.float32)
    m_bias = np.kron(Q_out.T @ bias, E_out.T @ np.ones(p2, dtype=np.float32))

    # F1 = A·R = G_row·(I⊗D_out)·(Q⊗E) = G_row·(Q ⊗ D_out·E); A's raw bias
    # column is added in final output coordinates (after the row gather)
    F1 = KroneckerOp(Q_out, D_out @ E_out, b_out_full, perm_out=g_out)
    M = TapSumOp(K_mix, S_mix, m_bias.astype(np.float32))
    # F2 = R⁻¹·A⁻¹ = (Qᵀ ⊗ EᵀD_in)·G_col, with bias (Qᵀ⊗Eᵀ)·b applied
    # numerically: ((Q⊗E)ᵀ b) viewed as (C1, p1) is Qᵀ·B·E
    b_f2 = (Q_in.T @ b_in_raw.reshape(C1, p1) @ E_in).ravel().astype(np.float32)
    F2 = KroneckerOp(Q_in.T, E_in.T @ D_in, b_f2, perm_in=g_in)
    op = ChainedOp([F2, M, F1])

    if selfcheck:
        from ..util import conv2d_oracle
        n_in = C1 * p1 + 1
        x = rng.standard_normal((2, n_in)).astype(np.float32)
        x[:, -1] = 1.0
        got = op.apply(torch.from_numpy(x)).numpy()   # CPU tensors at conversion
        Ai = scipy.sparse.csr_matrix(Ainv, dtype=np.float32) if Ainv is not None \
            else scipy.sparse.identity(n_in, format="csr", dtype=np.float32)
        z = np.asarray((Ai @ x.T).T)
        y = conv2d_oracle(z[:, :-1].reshape(-1, C1, H1, W1), weight, bias,
                          stride=stride)
        yh = np.concatenate([y.reshape(2, -1), z[:, -1:]], axis=1)
        if A is not None:
            yh = np.asarray((scipy.sparse.csr_matrix(A, dtype=np.float32)
                             @ yh.T).T)
        err = np.abs(got - yh).max()
        scale = max(1.0, np.abs(yh).max())
        if err > 1e-3 * scale:
            vprint("[kron_factored_keyed_conv]: selfcheck FAILED "
                   "(err %.3g, scale %.3g) — falling back" % (err, scale))
            return None
        vprint("[kron_factored_keyed_conv]: selfcheck ok (err %.3g)" % err)

    op.kron_stats = {"taps": T, "p_in": p1, "p_out": p2}
    return op


def channel_broadcast_keyed_pool(inshape, outshape, kernelsize, stride,
                                 A, Ainv, tileshape=None, selfcheck=True):
    """Factor a keyed avgpool Ŵ = A·W_pool·A⁻¹ with per-channel-identical
    keys into its channel-broadcast form I_C ⊗ (D̃_out·S·D̃_in') and return a
    ChannelBroadcastOp, or None when the structure does not hold.

    W_pool is a conv with a constant 1/k² channel-diagonal filter
    (reference keynet/sparse.py:206-212), i.e. W = I_C ⊗ S for the
    single-channel pool Toeplitz S, so per-channel-identical keys conjugate
    it block-by-block.  Unlike kron_factored_keyed_conv there is no npix cap:
    the spatial factor stays SPARSE (D̃ is block-diagonal over keygen's local
    pixel runs, S is a 9-tap window), and no masking is needed — the
    materialized pool matrix is I_C ⊗ M verbatim, so publishing M reveals
    nothing extra.  ``selfcheck`` verifies against the full sparse sandwich
    on random vectors (cheap matvecs, in torch on the CPU) and rejects on
    mismatch.
    """
    from .streaming import _key_blocks_identical
    from .operators import ChannelBroadcastOp, materialize, DEFAULT_TILE
    from ..toeplitz import toeplitz_avgpool2d

    C1, H1, W1 = inshape
    C2, H2, W2 = outshape
    if C1 != C2:
        return None
    p1, p2 = H1 * W1, H2 * W2
    n1, n2 = C1 * p1, C2 * p2

    def _side(M, p, n):
        """(sparse spatial block D, (p,) bias) or None."""
        if M is None:
            return (scipy.sparse.identity(p, format="csr", dtype=np.float32),
                    np.zeros(p, dtype=np.float32))
        if M.shape[0] - 1 != n or not _key_blocks_identical(M, p):
            return None
        M = scipy.sparse.csr_matrix(M)
        D = M[:p, :p].astype(np.float32).tocsr()
        b = np.asarray(M[:p, [n]].todense(), dtype=np.float32).ravel()
        return D, b

    fo = _side(A, p2, n2)
    if fo is None:
        return None
    D_out, b_out = fo
    fi = _side(Ainv, p1, n1)
    if fi is None:
        return None
    D_in, b_in = fi

    S = scipy.sparse.csr_matrix(
        toeplitz_avgpool2d((1, H1, W1), kernelsize, stride))[:p2, :p1]
    M_sp = (D_out @ S @ D_in).tocsr()
    M_sp.eliminate_zeros()
    b_sp = (D_out @ (S @ b_in) + b_out).astype(np.float32)

    # The spatial factor always stays f32: it is tiny next to the conv tile
    # stores (the factored pool IS the compression — C× fewer bytes), and
    # bf16 tiles cost ~2e-3 relative error (measured at VGG-224 pool2_2,
    # the one pool whose factor lands in Block-ELL), which breaks the f32
    # equivalence tier and trips the selfcheck into the slow ELL fallback.
    old_dt = GLOBAL.get("TILE_DTYPE")
    GLOBAL["TILE_DTYPE"] = "float32"
    try:
        inner = materialize(M_sp, tileshape=tileshape or DEFAULT_TILE,
                            dense_max_bytes=min(GLOBAL["DENSE_MAX_BYTES"], 32 << 20))
    finally:
        if old_dt is None:
            GLOBAL.pop("TILE_DTYPE", None)
        else:
            GLOBAL["TILE_DTYPE"] = old_dt
    nnz = C1 * (int(M_sp.nnz) + int(np.count_nonzero(b_sp))) + 1
    op = ChannelBroadcastOp(inner, C1, b_sp, nnz=nnz)

    if selfcheck:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, n1 + 1)).astype(np.float32)
        x[:, -1] = 1.0
        got = op.apply(torch.from_numpy(x)).numpy()   # CPU tensors at conversion
        W_hom = scipy.sparse.csr_matrix(
            toeplitz_avgpool2d(inshape, kernelsize, stride))
        z = x.T
        if Ainv is not None:
            z = scipy.sparse.csr_matrix(Ainv, dtype=np.float32) @ z
        z = W_hom @ z
        if A is not None:
            z = scipy.sparse.csr_matrix(A, dtype=np.float32) @ z
        ref = np.asarray(z.T)
        err = np.abs(got - ref).max()
        scale = max(1.0, np.abs(ref).max())
        if err > 1e-3 * scale:
            vprint("[channel_broadcast_keyed_pool]: selfcheck FAILED "
                   "(err %.3g, scale %.3g) — falling back" % (err, scale))
            return None
        vprint("[channel_broadcast_keyed_pool]: selfcheck ok (err %.3g, "
               "%s spatial factor, %d nnz)" % (err, type(inner).__name__,
                                               M_sp.nnz))
    return op
