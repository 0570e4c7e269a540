"""The port's LPIPS, registration bake-off and measurement tools against
the JAX package, on the CPU (the formats they read and write:
tests/test_torch_formats.py).

Tolerances:
- LPIPS: `random_initialized_lpips(seed)` against JAX's on the same images,
  within 1e-5 relative (f32 convolutions summed in another order).
- Bake-off: `compare_registrations`' PSNR within 0.05 dB of JAX's on one
  rotated pair at 32 px, for every method; `main --synthetic` at 48 px:
  every method above the unaligned PSNR.
- Tools: each `main` on the CPU at a tiny size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import max_err, rng, t

# ------------------------------------------------------------------ LPIPS --

def _image_pair(size=72):
    r = rng(4)
    return (r.uniform(0, 1, (2, size, size, 3)).astype(np.float32),
            r.uniform(0, 1, (2, size, size, 3)).astype(np.float32))


@pytest.mark.parametrize("boundary", [None, 4])
@pytest.mark.parametrize("reference_range", [True, False])
def test_lpips_matches_jax(boundary, reference_range):
    from fbanet_tpu.models import lpips as jlpips
    from fbanet_tpu_torch.models import lpips

    a, b = _image_pair()
    jm = jlpips.random_initialized_lpips(3)
    jm.assume_reference_range = reference_range
    tm = lpips.random_initialized_lpips(3)
    tm.assume_reference_range = reference_range
    ref = np.asarray(jm(jnp.asarray(a), jnp.asarray(b),
                        boundary_ignore=boundary))
    got = tm(t(a), t(b), boundary_ignore=boundary)
    assert got.shape == (2,) and np.all(ref > 0)
    assert max_err(got, ref) <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------- bakeoff --

def test_compare_registrations_matches_jax():
    from fbanet_tpu import bakeoff as jbakeoff
    from fbanet_tpu_torch import bakeoff

    frames = bakeoff.synthetic_scene("rotation", size=32, num_frames=2)
    ref_frames = jbakeoff.synthetic_scene("rotation", size=32, num_frames=2)
    for a, b in zip(frames, ref_frames):
        np.testing.assert_array_equal(a, b)
    got = bakeoff.compare_registrations(*frames, device="cpu")
    ref = jbakeoff.compare_registrations(*ref_frames)
    assert list(got) == list(ref) == ["unaligned", *bakeoff.METHODS]
    for m in ref:
        assert abs(got[m]["psnr"] - ref[m]["psnr"]) <= 0.05, m


def test_bakeoff_main_synthetic(tmp_path, capsys):
    """Every method of every scene registers: its PSNR above the
    unaligned pair's."""
    from fbanet_tpu_torch import bakeoff

    res = bakeoff.main(["--synthetic", "--size", "48", "--device", "cpu",
                        "--markdown",
                        str(tmp_path / "b.md")])
    assert list(res) == ["translation", "rotation", "zoom"]
    for scene in res.values():
        assert set(scene) == {"unaligned", *bakeoff.METHODS}
        for m in bakeoff.METHODS:
            assert scene[m]["psnr"] > scene["unaligned"]["psnr"], (scene, m)
    assert "| homography |" in (tmp_path / "b.md").read_text()
    assert "mean PSNR" in capsys.readouterr().out


# ------------------------------------------------------------------ tools --

def test_measure_ecc_eps_main():
    from fbanet_tpu_torch.tools import measure_ecc_eps

    rows = measure_ecc_eps.main(["--batch", "1", "--frames", "3", "--size",
                                 "32", "--repeats", "1", "--device", "cpu"])
    assert [r["eps"] for r in rows] == [s[3] for s in measure_ecc_eps.SETTINGS]
    for r in rows:
        assert r["max_err_px"] < 0.5 and r["host_ms"] > 0
        assert r["event_ms"] is None


def test_measure_align_overlap_main():
    from fbanet_tpu_torch.tools import measure_align_overlap

    res = measure_align_overlap.main(["--bursts", "2", "--frames", "2",
                                      "--size", "16", "--reps", "1",
                                      "--device", "cpu"])
    assert len(res["serial"]) == len(res["pipelined"]) == 1


def test_measure_downsample_b16_main():
    from fbanet_tpu_torch.tools import measure_downsample_b16 as m

    out = m.main(["fwd", "align", "pipe", "prof", "down", "ab", "--batches",
                  "1", "--frames", "2", "--size", "16", "--embed", "8",
                  "--device", "cpu"])
    assert {"fwd B1", "align B1", "pipe B1", "prof tail B1",
            "ab fwd B1 s2d+mm", "ab fwd B1 conv"} <= set(out)
    assert all(v > 0 for v in out.values())


def test_align_parity_table_main():
    from fbanet_tpu_torch.tools import align_parity_table

    out = align_parity_table.main(["--n", "3", "--size", "48", "--device",
                                   "cpu"])
    assert set(out) == {"ours-default", "ours-parity", "cv2-reference"}
    for mean, worst, count in out.values():
        assert count == 3 and worst < 0.1
