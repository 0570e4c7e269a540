"""The port's offline alignment CLI (fbanet_tpu_torch/align.py) against
fbanet_tpu.align on the CPU.

A synthetic unaligned burst (fbanet_tpu.data.synthetic) is written as
frame-numbered PNGs with an HR file beside them (skipped by both CLIs) and
aligned by both trees with `--motion affine`. The written PNGs may differ by
at most one 8-bit level: the aligned values agree to ~1e-5, so rounding to
uint8 can only flip a value lying on a half level.

`align_stream`, the loop under `align_tree`, is driven with in-memory
bursts: each comes back exactly as `align_burst` aligns it alone, in order,
and the overlapped loop hands burst N back only after drawing burst N+1.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from fbanet_tpu import align as jalign
from fbanet_tpu.data.synthetic import synthetic_burst
from fbanet_tpu_torch import align


def _write_bursts(root, count=1, seed=0):
    rng = np.random.default_rng(seed)
    for b in range(count):
        lr, hr, _ = synthetic_burst(rng, num_frames=3, lr_size=32,
                                    aligned=False, max_shift=2.0)
        d = root / f"00{b}_0"
        d.mkdir(parents=True)
        for f in range(3):
            Image.fromarray((lr[f] * 255 + 0.5).astype(np.uint8)).save(
                d / f"00{b}_MFSR_Sony_000{b}_x4_{f:02d}.png")
        Image.fromarray((hr * 255 + 0.5).astype(np.uint8)).save(
            d / f"00{b}_MFSR_Sony_000{b}_x4warp.png")


def _pngs(root):
    return {p.relative_to(root): np.asarray(Image.open(p)).astype(int)
            for p in sorted(root.rglob("*.png"))}


def test_align_tree_matches_jax(tmp_path):
    _write_bursts(tmp_path / "un")
    kw = dict(motion="affine", levels=2, iters_per_level=15,
              report_metrics=False)
    assert jalign.align_tree(tmp_path / "un", tmp_path / "jax", **kw) == 1
    assert align.align_tree(tmp_path / "un", tmp_path / "port", device="cpu",
                            **kw) == 1
    ref, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(ref) and len(got) == 3  # HR file skipped
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 1, k
    frame0 = "000_0/000_MFSR_Sony_0000_x4_00.png"
    np.testing.assert_array_equal(
        got[next(k for k in got if str(k) == frame0)],
        np.asarray(Image.open(tmp_path / "un" / frame0)))


def test_main_flags_serial_and_parity(tmp_path, capsys):
    """--no_overlap writes the same PNGs as the overlapped default, and
    --parity (one level, 100 iterations, eps 1e-10) runs end to end."""
    _write_bursts(tmp_path / "un", count=2, seed=5)
    common = ["--input_dir", str(tmp_path / "un"), "--motion", "homography",
              "--levels", "2", "--iters", "10", "--device", "cpu"]
    align.main([*common, "--output_dir", str(tmp_path / "overlap")])
    align.main([*common, "--output_dir", str(tmp_path / "serial"),
                "--no_overlap"])
    a, b = _pngs(tmp_path / "overlap"), _pngs(tmp_path / "serial")
    assert len(a) == 6 and a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    align.main(["--input_dir", str(tmp_path / "un"), "--output_dir",
                str(tmp_path / "parity"), "--parity", "--device", "cpu"])
    assert len(_pngs(tmp_path / "parity")) == 6
    out = capsys.readouterr()
    assert out.out.count("aligned 2 bursts") == 3
    assert "PSNR vs ref" in out.err


@pytest.mark.parametrize("overlap", [True, False])
def test_align_stream_order_and_results(overlap):
    """In-memory bursts: each is handed back aligned as `align_burst` aligns
    it, in order; overlapped, burst N is handed back only after burst N+1
    was drawn, serially before."""
    from fbanet_tpu_torch.ops.registration import align_burst

    rng = np.random.default_rng(3)
    bursts = [synthetic_burst(rng, num_frames=3, lr_size=32, aligned=False,
                              max_shift=2.0)[0].astype(np.float32)
              for _ in range(3)]
    events, got = [], {}

    def draw():
        for i, b in enumerate(bursts):
            events.append(("draw", i))
            yield i, b

    def on_aligned(key, frames, aligned, rhos, seconds):
        events.append(("back", key))
        got[key] = aligned
        assert frames is bursts[key] and rhos.shape == (3,) and seconds >= 0

    kw = dict(motion="euclidean", levels=2, iters_per_level=10)
    assert align.align_stream(draw(), on_aligned, overlap=overlap,
                              device="cpu", **kw) == 3
    for i, b in enumerate(bursts):
        np.testing.assert_array_equal(
            got[i], align_burst(torch.from_numpy(b), **kw)[0].numpy())
    backs = [events.index(("back", i)) for i in range(3)]
    assert backs == sorted(backs)
    for i in range(2):
        drawn_next = events.index(("draw", i + 1))
        assert (backs[i] > drawn_next) == overlap


def test_align_tree_wants_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        align.align_tree(tmp_path, tmp_path / "out")
