"""keynet_tpu_torch.bench_kernels on the CPU at a tiny operand: one checked
row per (dtype, variant, B) in each of its three modes, the work and bound
it reports, and the rule that without a card it raises unless
device='cpu' is given.  The timed runs need the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

from keynet_tpu_torch import bench_kernels as bk
from keynet_tpu_torch.ops import block_ell

TINY = dict(n_rb=4, KB=3, n_uniq=6, TM=128, TN=128)

# mode, keyword arguments, variants per (dtype, B)
MODES = {"kernel_bench": (dict(TINY, batches=(1, 3)), ["hbm", "xres", "xres2", "grid"]),
         "depth_sweep": (dict(TINY, batches=(2,)),
                         ["d1/xres", "d2/xres2", "d2/xresd", "d4/xresd", "d8/xresd"]),
         "depth_bench": (dict(TINY, n_rb=5, batches=(1, 2)), ["hbm", "xres", "grid"])}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_rows_on_cpu(mode, capsys):
    kw, variants = MODES[mode]
    out = getattr(bk, mode)(device="cpu", **kw)
    rows = out[0] if mode == "depth_sweep" else out
    printed = [l for l in capsys.readouterr().out.splitlines() if not l.startswith("[bench]")]
    want = [(dt, v, B) for dt in ("f32", "bf16") for v in variants for B in kw["batches"]]
    assert [(r["dtype"], r["variant"], r["B"]) for r in rows] == want
    assert len(printed) == len(rows)
    for r, line in zip(rows, printed):
        assert r["max_abs_err"] <= bk.TOL[r["dtype"]] * max(1.0, r["scale"])
        assert r["scale"] > 0 and r["launches"] == 0 and r["ms"] is None
        assert "B=%4d" % r["B"] in line and "not timed (cpu)" in line
        assert r["nonzero_slots"] == kw["n_rb"] * kw["KB"]      # ids are drawn from [1, n_uniq)
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    if mode == "depth_sweep":
        assert out[1] == {}                  # no spread without timings


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_raises_without_card(mode):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(bk, mode)(**MODES[mode][0])


def test_cli_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bk.main(["--depth-sweep"])


def test_work_counts_distinct_tiles_and_bound():
    ids = torch.tensor([[1, 2, 0], [2, 2, 3]], dtype=torch.int32)
    # x block 2 is read only through the id-0 slot: it does not count
    cols = torch.tensor([[0, 1, 2], [1, 1, 0]], dtype=torch.int32)
    w = bk.work(ids, cols, 128, 128, n_out=2 * 128, B=4, itemsize=4,
                peaks=bk.PEAKS["H100 SXM"])
    assert w["nonzero_slots"] == 5 and w["unique_tiles"] == 3 and w["x_blocks"] == 2
    assert w["flops"] == 2.0 * 128 * 128 * 4 * 5
    assert w["bytes"] == 3 * 128 * 128 * 4 + 4 * 256 * 4 + 4 * 256 * 4 + 2 * 6 * 4
    assert w["slot_bytes"] == 5 * (128 * 128 + 4 * 128) * 4
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(w["bytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("name,label", [("NVIDIA H100 80GB HBM3", "H100 SXM"),
                                        ("NVIDIA H100 PCIe", "H100 PCIe"),
                                        ("NVIDIA H100 NVL", "H100 NVL"),
                                        ("NVIDIA H200", "H200")])
def test_card_peaks(name, label):
    assert bk.card_peaks(name) == (label, bk.PEAKS[label])


def test_depth_operand_is_seeded_and_scaled():
    a = bk.depth_operand("cpu", n_rb=3, KB=2, n_uniq=4)
    b = bk.depth_operand("cpu", n_rb=3, KB=2, n_uniq=4)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    tiles, ids, cols, _ = a
    assert tiles.shape == (4, 128, 128) and bool((tiles[0] == 0).all())
    assert int(ids.min()) >= 1 and int(cols.max()) < 3
    assert float(tiles[1:].std()) == pytest.approx(1 / np.sqrt(2 * 128), rel=0.05)


def test_bench_operand_width_feeds_the_chain():
    """The bench chains y back into x: every variant's output has the width
    of its square operand's input."""
    rng = np.random.default_rng(0)
    tiles, ids, cols = (torch.from_numpy(a) for a in bk._synthetic(rng, 5, 3, 6, 128, 128))
    x = torch.from_numpy(rng.normal(size=(2, 5 * 128)).astype(np.float32))
    for fn in (block_ell.block_ell_matmul, block_ell.block_ell_matmul_xres,
               block_ell.block_ell_matmul_xres2, block_ell.block_ell_matmul_grid):
        assert fn(x, tiles, ids, cols, 5 * 128).shape == x.shape
