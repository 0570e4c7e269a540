"""The port's warping (fbanet_tpu_torch/ops/warp.py, warp_kernels.py)
against the JAX package.

- `homography_coords`, `warp_image` (nearest, bilinear, bicubic, in nearest
  and constant mode), `warp_flow` and `warp_burst_homography` against
  fbanet_tpu.ops.warp to 1e-5: the same f32 arithmetic, at most a few ulps
  apart where an operation is fused or ordered differently.
- The plain versions of K5 and K6 against the Pallas kernels
  `warp_burst_bilinear_pallas` / `warp_burst_coords_pallas` in interpret
  mode to 1e-4: the TPU kernels split the image into a bf16 hi/lo pair
  (exact to about 2^-17 relative) and refine an approximate reciprocal,
  which the port's f32 versions do not.
- On the CPU each wrapper takes its plain version and counts no launch.

Coordinates reach outside the image on every side and land exactly on the
last row and column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity import n, rng, t

from fbanet_tpu.ops import warp as jwarp
from fbanet_tpu.ops.warp_pallas import (
    warp_burst_bilinear_pallas,
    warp_burst_coords_pallas,
)
from fbanet_tpu_torch.ops import warp, warp_kernels

H, W, C = 32, 40, 3


def _frames(f=3, seed=0):
    return rng(seed).uniform(size=(f, H, W, C)).astype(np.float32)


def _coords(f=3, seed=1):
    """(y, x) positions from 2.5 px above/left of the image to 2.5 px
    below/right of it, with exact hits on rows/columns 0, h-1 and w-1."""
    r = rng(seed)
    c = np.stack([r.uniform(-2.5, H + 1.5, (f, H, W)),
                  r.uniform(-2.5, W + 1.5, (f, H, W))], -1).astype(np.float32)
    c[:, 0, :4] = [[0, 0], [H - 1, W - 1], [H - 1, 3.5], [7.25, W - 1]]
    c[:, 1, :3] = [[-1e-3, W - 1], [H - 1 + 1e-3, 2.0], [3.0, W - 1 + 1e-3]]
    return c


def _matrices(f=3, seed=2):
    """Near-identity homographies: shifts of +-3 px, small rotation/shear
    and perspective terms, so some pixels map outside on every side."""
    r = rng(seed)
    m = np.tile(np.eye(3, dtype=np.float32), (f, 1, 1))
    m[:, :2, 2] = r.uniform(-3, 3, (f, 2))
    m[:, 0, 1], m[:, 1, 0] = r.uniform(-0.03, 0.03, (2, f))
    m[:, 2, :2] = r.uniform(-2e-4, 2e-4, (f, 2))
    return m.astype(np.float32)


def test_homography_coords_matches_jax():
    m = _matrices(1)[0]
    for mat in (m, m[:2], np.array([[1, 0, 0], [0, 1, 0], [0, 0, 0]],
                                   np.float32)):
        ref = np.asarray(jwarp.homography_coords(mat, H, W))
        got = n(warp.homography_coords(t(mat), H, W))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    # leading dimensions: one map per matrix
    batched = n(warp.homography_coords(t(_matrices(3)), H, W))
    for i, mat in enumerate(_matrices(3)):
        np.testing.assert_allclose(
            batched[i], np.asarray(jwarp.homography_coords(mat, H, W)),
            atol=1e-5)


@pytest.mark.parametrize("mode", ["nearest", "constant"])
@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic"])
def test_warp_image_matches_jax(interp, mode):
    img, coords = _frames(1)[0], _coords(1)[0]
    ref = jwarp.warp_image(img, coords, interp=interp, mode=mode, cval=0.25)
    got = warp.warp_image(t(img), t(coords), interp=interp, mode=mode,
                          cval=0.25)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)
    # batched over a leading frame dimension
    frames, cs = _frames(2, seed=3), _coords(2, seed=4)
    ref = jax.vmap(lambda i, c: jwarp.warp_image(i, c, interp=interp,
                                                 mode=mode))(frames, cs)
    got = warp.warp_image(t(frames), t(cs), interp=interp, mode=mode)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


def test_warp_flow_matches_jax():
    frames = _frames(2, seed=5)
    flow = rng(6).uniform(-4, 4, (2, H, W, 2)).astype(np.float32)
    for interp in ("bilinear", "bicubic"):
        ref = jax.vmap(lambda f, fl: jwarp.warp_flow(f, fl, interp=interp))(
            frames, flow)
        got = warp.warp_flow(t(frames), t(flow), interp=interp)
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("rows", [2, 3])
def test_warp_burst_homography_matches_jax(rows):
    frames = _frames(6, seed=7).reshape(2, 3, H, W, C)
    mats = _matrices(6, seed=8).reshape(2, 3, 3, 3)[..., :rows, :]
    for interp in ("bilinear", "bicubic", "nearest"):
        ref = jwarp.warp_burst_homography(frames, mats, interp=interp)
        got = warp.warp_burst_homography(t(frames), t(mats), interp=interp)
        assert got.shape == frames.shape
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)
    # K5 computes the same bilinear nearest-mode warp (its plain version on
    # the CPU)
    got = warp_kernels.warp_burst_bilinear(
        t(frames).reshape(-1, H, W, C),
        warp._pad_affine(t(mats)).reshape(-1, 3, 3))
    np.testing.assert_allclose(
        n(got).reshape(frames.shape),
        np.asarray(jwarp.warp_burst_homography(frames, mats)), atol=1e-5)


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_plain_kernels_match_pallas(mode):
    frames, mats, coords = _frames(), _matrices(), _coords()
    with pltpu.force_tpu_interpret_mode():
        ref5 = warp_burst_bilinear_pallas(jnp.asarray(frames),
                                          jnp.asarray(mats), mode=mode,
                                          cval=0.5)
        ref6 = warp_burst_coords_pallas(jnp.asarray(frames),
                                        jnp.asarray(coords), mode=mode,
                                        cval=0.5)
    got5 = warp_kernels.warp_burst_bilinear(t(frames), t(mats), mode=mode,
                                            cval=0.5)
    got6 = warp_kernels.warp_burst_coords(t(frames), t(coords), mode=mode,
                                          cval=0.5)
    np.testing.assert_allclose(n(got5), np.asarray(ref5), atol=1e-4)
    np.testing.assert_allclose(n(got6), np.asarray(ref6), atol=1e-4)
    if mode == "constant":  # the whole-pixel mask left pixels at cval
        assert (n(got6) == 0.5).all(-1).sum() > 100


def test_kernel_function_differs_from_warp_image_only_in_constant_mode():
    """In nearest mode the kernels' sample is warp_image's bilinear one; in
    constant mode the kernels mask whole pixels and warp_image blends per
    tap, so they part at positions within a pixel of the border."""
    frames, coords = _frames(), _coords()
    k = n(warp_kernels.warp_burst_coords(t(frames), t(coords)))
    ref = n(warp.warp_image(t(frames), t(coords)))
    np.testing.assert_allclose(k, ref, atol=1e-5)
    k = n(warp_kernels.warp_burst_coords(t(frames), t(coords),
                                         mode="constant"))
    ref = n(warp.warp_image(t(frames), t(coords), mode="constant"))
    assert np.abs(k - ref).max() > 0.01


def test_wrappers_on_cpu_take_the_plain_version():
    warp_kernels.warp_burst_bilinear.launches = 0
    warp_kernels.warp_burst_coords.launches = 0
    frames = t(_frames()).to(torch.float64)
    out = warp_kernels.warp_burst_bilinear(frames, t(_matrices()))
    assert out.dtype == torch.float64 and out.shape == frames.shape
    warp_kernels.warp_burst_coords(frames, t(_coords()))
    assert warp_kernels.warp_burst_bilinear.launches == 0
    assert warp_kernels.warp_burst_coords.launches == 0
    identity = t(np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)))
    np.testing.assert_array_equal(
        n(warp_kernels.warp_burst_bilinear(t(_frames()), identity)),
        _frames())
    with pytest.raises(ValueError):  # H < 2 has no cell to blend
        warp_kernels.warp_burst_coords(torch.zeros(1, 1, 5, 3),
                                       torch.zeros(1, 1, 5, 2))
    with pytest.raises(ValueError):
        warp_kernels.warp_burst_bilinear(t(_frames()), identity[:, :2])
    with pytest.raises(ValueError):
        warp_kernels.warp_burst_coords(t(_frames()), t(_coords()),
                                       mode="reflect")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("frames,coords,mode,why", [
    (_meta(2, 8, 8, 3), _meta(2, 8, 8, 2), "nearest", "CUDA tensors"),
    (_meta(2, 8, 8, 3), torch.zeros(2, 8, 8, 2), "nearest", "CUDA tensors"),
    (_meta(2, 8, 8, 3), _meta(2, 8, 7, 2), "nearest", r"\(2, 8, 8, 2\)"),
    (_meta(2, 1, 8, 3), _meta(2, 1, 8, 2), "nearest", "H, W >= 2"),
    (_meta(8, 8, 3), _meta(8, 8, 2), "nearest", r"\[F, H, W, C\]"),
    (_meta(2, 8, 8, 3, dtype=torch.int32), _meta(2, 8, 8, 2), "nearest",
     "floating point"),
    (_meta(2, 8, 8, 3), _meta(2, 8, 8, 2), "reflect", "unknown mode"),
], ids=["meta", "mixed-devices", "coords-shape", "H-1", "3-D", "int",
        "mode"])
def test_coords_wrapper_refuses(frames, coords, mode, why):
    """K6's wrapper off the CPU: a device, shape or dtype the kernel does
    not take raises (checked from attributes alone), and nothing launches."""
    warp_kernels.warp_burst_coords.launches = 0
    with pytest.raises(ValueError, match=why):
        warp_kernels.warp_burst_coords(frames, coords, mode=mode)
    assert warp_kernels.warp_burst_coords.launches == 0


def test_coords_wrapper_on_cpu_keeps_dtype_and_plain_values():
    """On the CPU the f32 path hands back the plain sample itself (no
    conversion), a bf16 input comes back in bf16, and `plain=True` is the
    same function."""
    frames, coords = t(_frames()), t(_coords())
    out = warp_kernels.warp_burst_coords(frames, coords)
    ref = warp_kernels.sample_plain(frames, coords[..., 0], coords[..., 1],
                                    False, 0.0)
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    half = warp_kernels.warp_burst_coords(frames.bfloat16(), coords)
    assert half.dtype == torch.bfloat16 and half.shape == frames.shape
    assert torch.equal(warp_kernels.warp_burst_coords(frames, coords,
                                                      plain=True), out)


def test_measure_warp_host_needs_the_card():
    """The K6 host-path tool times CUDA calls only: without a card its
    `main` exits with a message instead of timing the CPU path."""
    from fbanet_tpu_torch.tools import measure_warp_host

    if torch.cuda.is_available():
        pytest.skip("a card is present; the tool runs there")
    with pytest.raises(SystemExit, match="no CUDA device"):
        measure_warp_host.main(["--iters", "1"])
