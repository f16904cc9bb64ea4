"""The port's colorspace conversions against ``rtpe_tpu.ops.color``, on
the CPU: random pixels plus black, white, greys (``delta == 0``),
channel ties (hue's ``r`` before ``g`` before ``b``), pixels at the
sRGB knee (0.04045) and at the LAB ``eps`` knee.  LAB within atol 1e-3
(L spans 0-100), HSV within atol 1e-6; and the cube root's cost: the
port's ``pow(x, 1/3)`` is within 1 ulp of ``jnp.cbrt`` on (eps, 1.2].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpe_tpu.ops import color as j_color
from rtpe_tpu_torch.ops import color

EPS = 0.008856451679035631


def _pixels() -> np.ndarray:
    rng = np.random.default_rng(0)
    px = [rng.random((4000, 3))]
    g = np.linspace(0.0, 1.0, 41)
    px.append(np.stack([g, g, g], -1))                      # greys, 0, 1
    a, b = rng.random(200), rng.random(200)
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    for order in ((hi, hi, lo), (hi, lo, hi), (lo, hi, hi), (hi, lo, lo),
                  (lo, hi, lo), (lo, lo, hi)):
        px.append(np.stack(order, -1))                      # channel ties
    knee = 0.04045 + np.array([-1e-6, -1e-7, 0.0, 1e-7, 1e-6])
    px.append(np.stack([knee, knee[::-1], np.full(5, 0.5)], -1))
    # greys whose XYZ / white sit at eps: linear = eps, then companded
    lin = EPS * (1.0 + np.array([-1e-4, -1e-6, 0.0, 1e-6, 1e-4]))
    grey = 1.055 * lin ** (1 / 2.4) - 0.055
    px.append(np.stack([grey, grey, grey], -1))
    px.append(np.stack([lin * 12.92] * 3, -1))
    return np.concatenate(px).astype(np.float32)


@pytest.mark.parametrize("fn,atol", [("rgb_to_lab", 1e-3),
                                     ("rgb_to_hsv", 1e-6)])
def test_color_matches_jax(fn, atol):
    x = _pixels()
    want = np.asarray(getattr(j_color, fn)(jnp.asarray(x)))
    got = getattr(color, fn)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    err = np.abs(got.numpy() - want)
    print(f"{fn}: worst {err.max():.3g} at {x[err.max(-1).argmax()]}")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # any leading shape, as an image batch
    img = torch.from_numpy(x[:4000].reshape(2, 40, 50, 3))
    assert torch.equal(getattr(color, fn)(img).reshape(-1, 3), got[:4000])


def test_hsv_rules_for_ties_and_greys():
    x = torch.tensor([[0.5, 0.5, 0.2], [0.2, 0.5, 0.5], [0.5, 0.2, 0.5],
                      [0.3, 0.3, 0.3], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    hsv = color.rgb_to_hsv(x)
    want = np.asarray(j_color.rgb_to_hsv(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(hsv.numpy(), want, rtol=0, atol=1e-6)
    # r wins a tie with g, g wins one with b; greys and black: h = s = 0
    assert hsv[0, 0] == pytest.approx(1 / 6)
    assert hsv[1, 0] == pytest.approx(0.5)
    assert (hsv[3:, :2] == 0).all()


def test_cube_root_within_one_ulp_of_jax():
    x = np.random.default_rng(1).uniform(EPS, 1.2, 200_000).astype(
        np.float32)
    want = np.asarray(jnp.cbrt(jnp.asarray(x))).view(np.int32)
    got = torch.pow(torch.from_numpy(x), 1.0 / 3.0).numpy().view(np.int32)
    ulps = np.abs(got.astype(np.int64) - want)
    print(f"cbrt: {ulps.max()} ulp at most, {(ulps > 0).mean():.4f} off")
    assert ulps.max() <= 1
