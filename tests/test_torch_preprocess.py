"""The port's preprocessing against the JAX package's, on the CPU.

Warps and resizes take the JAX version's arithmetic, so they agree to
float32 rounding (tolerance 1e-5 relative, 1e-5 absolute on unit-range
pixels); the numpy inverse transform is an exact copy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpe_tpu.data import preprocess as jpre
from rtpe_tpu.ops.affine import affine_warp as j_affine_warp
from rtpe_tpu.ops.resize import resize_bilinear as j_resize
from rtpe_tpu.ops.resize import upsample_nearest as j_upsample
from rtpe_tpu_torch.data import preprocess as tpre
from rtpe_tpu_torch.ops.affine import affine_warp, get_affine_transform
from rtpe_tpu_torch.ops.resize import resize_bilinear, upsample_nearest

TOL = 1e-5


@pytest.mark.parametrize("hw", [(120, 90), (90, 150), (100, 100)])
def test_resize_align_multi_scale_matches_jax(hw):
    img = np.random.default_rng(hw[0]).random((*hw, 3)).astype(np.float32)
    j_out, j_c, j_s = jpre.resize_align_multi_scale(img, 128, 1.0, 1.0)
    t_out, t_c, t_s = tpre.resize_align_multi_scale(img, 128, 1.0, 1.0,
                                                    device="cpu")
    np.testing.assert_array_equal(t_c, j_c)
    np.testing.assert_array_equal(t_s, j_s)
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tpre.normalize_image(t_out).numpy(),
                               jpre.normalize_image(j_out),
                               rtol=TOL, atol=TOL)


def test_affine_warp_matches_jax_with_rotation():
    rng = np.random.default_rng(0)
    x = rng.random((2, 40, 56, 3)).astype(np.float32)
    mats = np.stack([
        get_affine_transform(np.array([28.0, 20.0]), np.array([0.3, 0.25]),
                             rot, (48, 36))
        for rot in (0.0, 17.0)])
    j = np.asarray(j_affine_warp(jnp.asarray(x), jnp.asarray(mats),
                                 (36, 48)))
    t = affine_warp(torch.from_numpy(x), torch.from_numpy(mats), (36, 48))
    np.testing.assert_allclose(t.numpy(), j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_hw", [(64, 80), (13, 7)])
def test_resize_bilinear_matches_jax(align_corners, out_hw):
    x = np.random.default_rng(1).normal(size=(2, 32, 40, 5)).astype(
        np.float32)
    j = np.asarray(j_resize(jnp.asarray(x), out_hw,
                            align_corners=align_corners))
    t = resize_bilinear(torch.from_numpy(x), out_hw,
                        align_corners=align_corners)
    np.testing.assert_allclose(t.numpy(), j, rtol=TOL, atol=TOL)


def test_upsample_nearest_matches_jax():
    x = np.random.default_rng(2).normal(size=(1, 5, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        upsample_nearest(torch.from_numpy(x), 4).numpy(),
        np.asarray(j_upsample(jnp.asarray(x), 4)))


def test_get_final_preds_exact():
    rng = np.random.default_rng(3)
    people = [rng.uniform(0, 64, size=(17, 4)).astype(np.float32)
              for _ in range(3)]
    for hw in [(480, 640), (640, 360)]:
        _, center, scale = tpre.get_multi_scale_size(hw, 512, 1.0, 1.0)
        jc = jpre.get_multi_scale_size(hw, 512, 1.0, 1.0)
        np.testing.assert_array_equal(center, jc[1])
        np.testing.assert_array_equal(scale, jc[2])
        t = tpre.get_final_preds([people], center, scale, (64, 80))
        j = jpre.get_final_preds([people], center, scale, (64, 80))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
