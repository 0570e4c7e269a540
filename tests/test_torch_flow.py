"""Pyramidal Lucas-Kanade optical flow of the port (fbanet_tpu_torch/ops/
flow.py) and `online_register("flow")` against the JAX package.

Tolerances: the blur, halving and box sums 1e-5 of their largest value
(the same f32 sums in another order: XLA's convolution against shifted
sums); the bilinear flow upsampling 1e-6 at every pixel, borders included
(JAX renormalises the in-frame weights at an edge, the port clamps the
position: the same weights); flows 1e-4 px and registered frames 1e-4 (15
LK iterations carry those rounding differences; observed ~1e-5 px). The
Middlebury rendering is numpy on both sides and must be identical.
"""

import jax
import numpy as np
import pytest
from torch_parity import n, rng, t

import bench
from fbanet_tpu.ops import flow as jflow
from fbanet_tpu.ops import registration as jreg
from fbanet_tpu_torch.ops import flow, registration


@pytest.fixture(scope="module")
def burst():
    return np.asarray(bench.make_realistic_bursts(2, 3, 32, seed=3))


def test_blur_halve_box_match_jax(burst):
    img = burst[0, 1].mean(-1)
    for got, ref in ((flow._gauss_blur(t(img[None])), jflow._gauss_blur(img)),
                     (flow._halve(t(img[None])), jflow._halve(img)),
                     (flow._box_sum(t(img[None]), 4), jflow._box_sum(img, 4))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(n(got)[0], ref,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((7, 5), (13, 11)),
                                     ((4, 6), (9, 12))])
def test_flow_upsampling_matches_jax_resize(src, dst):
    f = rng(0).standard_normal((*src, 2)).astype(np.float32)
    ref = np.asarray(jax.image.resize(f, (*dst, 2), "bilinear"))
    got = n(flow._upsample_flow(t(f[None]), *dst))[0]
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the border rows and columns on their own (where the weights differ
    # most between a clamped position and renormalised in-frame weights)
    np.testing.assert_allclose(got[[0, -1]], ref[[0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-6)


def test_optical_flow_matches_jax(burst):
    ref = np.asarray(jax.jit(jflow.optical_flow)(burst[0, 0], burst[0, 1]))
    got = n(flow.optical_flow(t(burst[0, 0]), t(burst[0, 1])))
    assert got.shape == (32, 32, 2) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # batched: every pair of both bursts at once, as online_register does
    refs = np.asarray(jax.jit(jax.vmap(lambda b: jflow.burst_optical_flow(
        b, levels=3, iters_per_level=5)))(burst))
    got = n(flow.burst_optical_flow(t(burst), levels=3, iters_per_level=5))
    np.testing.assert_allclose(got, refs, atol=1e-4)
    np.testing.assert_array_equal(flow.flow_to_image(got[0, 0]),
                                  jflow.flow_to_image(refs[0, 0]))
    np.testing.assert_array_equal(
        flow.flow_to_image(got[1, 1], max_norm=3.0),
        jflow.flow_to_image(got[1, 1], max_norm=3.0))


def test_online_register_flow_matches_jax(burst):
    ref = np.asarray(jax.jit(lambda b: jreg.online_register(b, "flow"))(burst))
    got = n(registration.online_register(t(burst), "flow"))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got[:, 0], burst[:, 0])
    # the registration moved the frames toward frame 0
    before = np.abs(burst[:, 1:] - burst[:, :1])[:, :, 6:-6, 6:-6].mean()
    after = np.abs(got[:, 1:] - burst[:, :1])[:, :, 6:-6, 6:-6].mean()
    assert after < 0.5 * before
    with pytest.raises(ValueError):
        registration.online_register(t(burst), "dali")
