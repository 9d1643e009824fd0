"""Adversarial cryptanalysis of self-published challenge bundles (the port of
scripts/attack_bundle.py, with its own copy of the attack's numpy math).

The adversary holds ONLY the public artifacts of
keynet_tpu_torch.examples.release_challenge (public keynet .npz, encrypted
PNG, public embedding) plus what the reference makes public by design: the
model TOPOLOGY (LeNet_AvgPool) and the key family.  Model WEIGHTS, keys, and
the seed are private.

Attack 1 — structure attack on PERMUTATION keynets.  Permutation keys
conjugate the conv1 Toeplitz by row/column permutations, so every published
entry of Ŵ1 = P_out·W1·P_in⁻¹ IS a source weight, merely relocated:

  1. value-set clustering of Ŵ1 rows recovers the output channels and the
     exact 9 kernel values per channel (weights recovered bit-for-bit);
  2. per-value occurrence counts label the taps (center H·W, edge-adjacent
     H·(W-1), corners (H-1)(W-1)), up to the dihedral group of the square;
  3. rows link the cipher column holding the center value to the columns
     holding each neighbor value: a 4-regular oriented grid graph over
     cipher pixels, which BFS embeds into 28×28 coordinates;
  4. the recovered inverse permutation applied to the cipher yields the
     secret image up to the mat2gray global affine and a dihedral transform.

Attack 2 — the same pipeline against a STOCHASTIC bundle (hierarchical
permutation + doubly-stochastic α + local affine): every published entry is
a mixture of weights, value-set clustering finds no channel structure, and
the attack aborts before recovering anything.  Reported alongside: direct
statistical leakage of the ciphers (histogram EMD, plaintext-cipher pixel
correlation).

Scoring uses the PRIVATE secret image / weights — marked clearly below; the
attack itself never touches them.  The secret image is the seeded synthetic
one of keynet_tpu_torch.examples unless ``--secret-image`` names another.

    python -m keynet_tpu_torch.scripts.attack_bundle [--outdir DIR] [--device cpu]
"""

import argparse
import itertools
import json
import os
from collections import defaultdict

import numpy as np

from .. import models, serialize
from ..globals import resolve_device
from ..system import PermutationKeynet, PublicKeyedSensor, StochasticKeynet
from ..examples import outdir as _outdir
from ..examples import write_secret_image
from ..examples.release_challenge import build_bundle


def _load_first_layer_dense(npz_path, device="cuda"):
    """Public step: read the first keyed layer's matrix from the bundle, as
    keynet_tpu holds it: (n_out + 1, n_in + 1), the homogeneous row last."""
    _, knet = serialize.load_keynet(npz_path, device=device)
    first = next(l for l in knet.layers().values() if l != "relu")
    op = first.op()
    W = op.W.cpu().numpy() if hasattr(op, "W") else None
    if W is None:
        raise ValueError("first layer is not dense: %r" % type(op).__name__)
    return W, knet


def cluster_rows_by_valueset(Wc, k_taps=9):
    """Group core rows by their nonzero value set; full rows (k_taps nnz)
    define the channel prototypes, partial (edge) rows join the prototype
    containing their values.  Returns (prototypes, row2ch) or None when the
    bundle has no such structure (non-permutation keys)."""
    n_rows = Wc.shape[0]
    protos = {}           # frozenset(values) -> channel id
    row2ch = np.full(n_rows, -1, dtype=np.int64)
    partial = []
    for r in range(n_rows):
        v = Wc[r]
        nz = v[v != 0.0]
        if len(nz) == k_taps:
            key = frozenset(nz.tolist())
            if len(key) != k_taps:
                return None   # repeated values inside one row: not generic
            if key not in protos:
                protos[key] = len(protos)
            row2ch[r] = protos[key]
        elif 0 < len(nz) < k_taps:
            partial.append((r, frozenset(nz.tolist())))
        else:
            return None       # dense/empty row: mixtures, not a permutation key
    if not protos:
        return None
    for r, key in partial:
        homes = [cid for pk, cid in protos.items() if key <= pk]
        if len(homes) != 1:
            return None       # ambiguous or foreign values: abort
        row2ch[r] = homes[0]
    return protos, row2ch


def label_taps(Wc, row2ch, ch, H, W):
    """Occurrence counts of channel ``ch``'s 9 values across its rows pin the
    tap classes: center H*W; edge-adjacent H*(W-1) / (H-1)*W; corners
    (H-1)*(W-1).  Returns (center_value, [4 edge values], {4 corner values});
    which edge value maps to which direction is NOT determined here — the
    caller tries all 24 assignments and lets the consistency-checked grid
    embedding reject the wrong ones (8 of the 24 survive: the dihedral
    group of the square, the Toeplitz pattern's true automorphisms)."""
    rows = np.flatnonzero(row2ch == ch)
    counts = defaultdict(int)
    for r in rows:
        for v in Wc[r][Wc[r] != 0.0]:
            counts[float(v)] += 1
    cnt = sorted(counts.items(), key=lambda kv: -kv[1])
    if len(cnt) != 9:
        return None
    c_center, c_edge, c_corner = H * W, H * (W - 1), (H - 1) * (W - 1)
    center = [v for v, c in cnt if c == c_center]
    edges = [v for v, c in cnt if c == c_edge]
    corners = [v for v, c in cnt if c == c_corner]
    if len(center) != 1 or len(edges) != 4 or len(corners) != 4:
        return None
    return center[0], edges, set(corners)


def recover_grid(Wc, row2ch, ch, lab, H, W):
    """Link cipher columns through the labeled taps: in each row of channel
    ``ch``, the column holding the center value is a pixel and the column
    holding edge value with label d is its d-neighbor.  BFS-embed the
    resulting oriented grid graph into (H, W) coordinates, rejecting any
    assignment whose edges imply two different coordinates for one column
    (this is what kills 16 of the 24 candidate direction labelings).
    Returns pos: (n_pix,) -> flat plaintext index (up to dihedral), or
    None."""
    rows = np.flatnonzero(row2ch == ch)
    val2dir = {v: d for v, d in lab.items() if d != (0, 0)}
    v_center = next(v for v, d in lab.items() if d == (0, 0))
    nbr = {}   # pixel column -> {dir: column}
    for r in rows:
        vr = Wc[r]
        nz = np.flatnonzero(vr)
        vals = vr[nz]
        if v_center not in vals:
            continue
        c0 = int(nz[np.flatnonzero(vals == v_center)[0]])
        d = nbr.setdefault(c0, {})
        for j, v in zip(nz, vals):
            dv = val2dir.get(float(v))
            if dv is not None:
                d[dv] = int(j)
    if len(nbr) < H * W * 0.9:
        return None
    # BFS embedding
    start = next(iter(nbr))
    coord = {start: (0, 0)}
    stack = [start]
    while stack:
        p = stack.pop()
        y, x = coord[p]
        for (dy, dx), q in nbr.get(p, {}).items():
            want = (y + dy, x + dx)
            if q not in coord:
                coord[q] = want
                stack.append(q)
            elif coord[q] != want:
                return None   # inconsistent labeling: wrong direction guess
    if len(coord) != H * W:
        return None
    if len(set(coord.values())) != H * W:
        return None           # two columns mapped to one pixel
    ys = [c[0] for c in coord.values()]
    xs = [c[1] for c in coord.values()]
    y0, x0 = min(ys), min(xs)
    span_y, span_x = max(ys) - y0 + 1, max(xs) - x0 + 1
    if {span_y, span_x} != {H, W}:
        return None
    pos = np.full(H * W, -1, dtype=np.int64)
    for col, (y, x) in coord.items():
        yy, xx = y - y0, x - x0
        if span_y == H:
            pos[col] = yy * W + xx
        else:  # axes swapped (part of the dihedral ambiguity)
            pos[col] = xx * W + yy
    return pos if (pos >= 0).all() else None


def dihedral_images(img):
    """All 8 flips/rotations of a 2-D image."""
    out = []
    for k in range(4):
        r = np.rot90(img, k)
        out.extend([r, r[:, ::-1]])
    return out


def best_dihedral_corr(rec, truth):
    """Max |pearson| between recovered image and truth over the dihedral
    orbit (the attack's provable ambiguity class)."""
    best = 0.0
    t = truth.ravel().astype(np.float64)
    t = (t - t.mean())
    tn = np.linalg.norm(t) + 1e-12
    for d in dihedral_images(rec):
        v = d.ravel().astype(np.float64)
        v = v - v.mean()
        c = abs(float(v @ t) / ((np.linalg.norm(v) + 1e-12) * tn))
        best = max(best, c)
    return best


def hist_emd(a, b, bins=64):
    """1-D earth-mover distance between normalized intensity histograms
    (permutation-invariant leak: a permutation cipher has EMD ≈ 0)."""
    lo, hi = min(a.min(), b.min()), max(a.max(), b.max())
    ha, _ = np.histogram(a, bins=bins, range=(lo, hi), density=True)
    hb, _ = np.histogram(b, bins=bins, range=(lo, hi), density=True)
    ha, hb = ha / ha.sum(), hb / hb.sum()
    return float(np.abs(np.cumsum(ha - hb)).sum() / bins)


def attack(bundle_dir, inshape=(1, 28, 28), device="cuda"):
    """Run the structure attack on a bundle directory.  Returns a dict of
    measured results (everything here uses PUBLIC artifacts only)."""
    device = resolve_device(device)
    H, W = inshape[1], inshape[2]
    n_pix = H * W
    res = {"bundle": bundle_dir}
    Wfull, _ = _load_first_layer_dense(
        os.path.join(bundle_dir, "challenge_keynet.npz"), device)
    Wc = np.asarray(Wfull[:-1, :-1])   # core (bias col + homogeneous row off)
    cl = cluster_rows_by_valueset(Wc)
    if cl is None:
        res["channels_found"] = 0
        res["status"] = "no permutation structure (value-set clustering found mixtures)"
        return res
    protos, row2ch = cl
    res["channels_found"] = len(protos)
    res["weights_recovered"] = sorted(
        [sorted(map(float, p)) for p in protos])  # exact kernel values
    pos = None
    dirs4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    for ch in range(len(protos)):
        tl = label_taps(Wc, row2ch, ch, H, W)
        if tl is None:
            continue
        v_center, edges, _ = tl
        # try all 24 direction assignments; the consistency-checked BFS
        # rejects all but the true labeling's dihedral orbit
        for perm in itertools.permutations(edges):
            lab = {v_center: (0, 0)}
            lab.update(zip(perm, dirs4))
            pos = recover_grid(Wc, row2ch, ch, lab, H, W)
            if pos is not None:
                break
        if pos is not None:
            res["grid_channel"] = ch
            break
    if pos is None:
        res["status"] = "channels recovered but grid embedding failed"
        return res
    cipher = _marshal(os.path.join(bundle_dir, "challenge_cipher.png"), inshape,
                      device)[:n_pix]
    rec = np.zeros(n_pix, dtype=np.float64)
    rec[pos] = cipher
    res["recovered_image"] = rec.reshape(H, W)
    res["status"] = "image recovered up to dihedral + global affine"
    return res


def _marshal(png, inshape, device):
    """The public homogeneous cipher row of a PNG, on the host."""
    return PublicKeyedSensor(tuple(inshape), device=device).load(png).tensor()[0] \
        .cpu().numpy()


def run(outdir=None, seed=2020, secret_image=None, perm_dir=None, device="cuda",
        verbose=True):
    """Build (unless ``perm_dir`` holds one) a permutation bundle and a
    stochastic bundle (StochasticKeynet alpha 2, blocksize 7) of the same
    secret image, attack both and score the attack against the private
    truth.  Returns the report dict (the JAX script's keys) and writes
    attack_report.json and the recovered image into ``outdir``."""
    device = resolve_device(device)
    outdir = outdir or _outdir("attack_bundle")
    os.makedirs(outdir, exist_ok=True)
    if secret_image is None:
        secret_image = write_secret_image(os.path.join(outdir, "private", "secret.png"))
    report = {}

    # ---- permutation bundle (the reference quickstart family) ----
    if perm_dir is None:
        perm_dir = os.path.join(outdir, "perm")
        build_bundle(perm_dir, seed=seed, secret_image=secret_image, device=device,
                     verbose=False)
    r = attack(perm_dir, device=device)
    # ---------- SCORING ONLY: private ground truth below this line ----------
    net = models.LeNet_AvgPool(seed=0)
    sensor, _ = PermutationKeynet((1, 28, 28), net, seed=seed,
                                  do_output_encryption=True, device=device)
    truth = sensor.load(secret_image).tensor()[0, 0].cpu().numpy()
    w_true = np.asarray(net.params["conv1"]["weight"])
    n_ch = w_true.shape[0]                      # LeNet conv1: 6 channels, 3x3
    w_true = w_true.reshape(n_ch, -1)
    w_true_sets = sorted([sorted(map(float, w)) for w in w_true])
    if "recovered_image" in r:
        corr = best_dihedral_corr(r["recovered_image"], truth)
        w_match = sum(1 for a, b in zip(r["weights_recovered"], w_true_sets)
                      if np.allclose(a, b, atol=0)) if r.get(
                          "channels_found") == n_ch else 0
        cipher = _marshal(os.path.join(perm_dir, "challenge_cipher.png"), (1, 28, 28),
                          device)[:784]
        report["permutation"] = {
            "status": r["status"], "channels_found": r["channels_found"],
            "conv1_valuesets_exact": "%d/%d" % (w_match, n_ch),
            "image_corr_best_dihedral": round(corr, 4),
            "cipher_hist_emd_vs_plain": round(hist_emd(
                cipher, truth.ravel() / max(1e-9, truth.max())), 4),
        }
        from PIL import Image
        rec = r["recovered_image"]
        rec8 = np.uint8(255 * (rec - rec.min()) / max(1e-9, rec.max() - rec.min()))
        Image.fromarray(rec8).save(os.path.join(outdir, "recovered.png"))
    else:
        report["permutation"] = {"status": r["status"],
                                 "channels_found": r.get("channels_found", 0)}

    # ---- stochastic bundle (hardened recipe): the attack must find nothing ----
    stoch_dir = os.path.join(outdir, "stoch")
    os.makedirs(stoch_dir, exist_ok=True)
    sensor2, knet2 = StochasticKeynet((1, 28, 28), net, alpha=2, blocksize=7, seed=seed,
                                      do_output_encryption=True, device=device)
    sensor2.load(secret_image).encrypt()
    png2 = os.path.join(stoch_dir, "challenge_cipher.png")
    sensor2.save(png2)
    serialize.save_keynet(os.path.join(stoch_dir, "challenge_keynet.npz"), knet2,
                          include_keys=False)
    r2 = attack(stoch_dir, device=device)
    truth2 = sensor2.decrypt().tensor()[0, 0].cpu().numpy()
    cipher2 = _marshal(png2, (1, 28, 28), device)[:784]
    # direct statistical leakage of the cipher itself
    pc = abs(float(np.corrcoef(cipher2, truth2.ravel())[0, 1]))
    report["stochastic"] = {
        "status": r2["status"], "channels_found": r2.get("channels_found", 0),
        "cipher_plain_pixel_corr": round(pc, 4),
        "cipher_hist_emd_vs_plain": round(hist_emd(
            cipher2, truth2.ravel() / max(1e-9, truth2.max())), 4),
    }
    if verbose:
        print(json.dumps(report, indent=2))
    with open(os.path.join(outdir, "attack_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="Structure attack on challenge bundles")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--seed", type=int, default=2020)
    ap.add_argument("--secret-image", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.outdir, args.seed, args.secret_image, device=args.device)


if __name__ == "__main__":
    main()
