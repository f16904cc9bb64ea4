"""Colorspace conversions on tensors (port of ``rtpe_tpu/ops/color.py``).

The student's second input is the image in LAB (or HSV), made on the
image's device inside the data pipeline instead of on the host with
skimage (reference ``rtpe/dataloaders.py:15,338-344,353-355``).

Conventions match ``skimage.color.rgb2lab`` / ``rgb2hsv`` for float
inputs in [0, 1]: sRGB, D65/2° white point; HSV channels all in [0, 1].

``jnp.cbrt`` has no torch counterpart.  On the branch that uses it the
argument is above ``eps > 0``, so ``torch.pow(x, 1 / 3)`` serves; it is
within 1 ulp of JAX's cube root (1.2 % of float32 values in (eps, 1.2]
differ, by exactly 1 ulp), which moves L, a and b by at most ~1e-5.
"""

import torch

# sRGB -> XYZ (D65) matrix, rows = X, Y, Z
_RGB2XYZ = (
    (0.412456439089692, 0.357576077643909, 0.180437483266399),
    (0.212672851405623, 0.715152155287818, 0.072174993306560),
    (0.019333895582329, 0.119192025881303, 0.950304078536368),
)

# D65 reference white
_XYZ_REF = (0.95047, 1.0, 1.08883)

_EPS = 0.008856451679035631  # (6/29)^3
_KAPPA = 7.787037037037035   # (29/6)^2 / 3


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0,1] -> CIELAB (L in [0,100], a/b roughly ±128),
    float32 on ``rgb``'s device."""
    rgb = rgb.float()
    m = torch.tensor(_RGB2XYZ, dtype=torch.float32, device=rgb.device)
    ref = torch.tensor(_XYZ_REF, dtype=torch.float32, device=rgb.device)
    # inverse sRGB companding
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    xyz = torch.einsum("ij,...j->...i", m, linear) / ref
    f = torch.where(xyz > _EPS, torch.pow(xyz.clamp(min=_EPS), 1.0 / 3.0),
                    _KAPPA * xyz + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0,1] -> HSV, all channels in [0,1], float32.

    Hue ties go to ``r`` before ``g`` before ``b``; hue is 0 where
    ``max == min`` and saturation 0 where ``max == 0``."""
    rgb = rgb.float()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    one = torch.ones((), dtype=torch.float32, device=rgb.device)
    zero = torch.zeros((), dtype=torch.float32, device=rgb.device)
    safe = torch.where(delta == 0, one, delta)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, torch.remainder(h / 6.0, 1.0))
    s = torch.where(maxc == 0, zero, delta / torch.where(maxc == 0, one, maxc))
    return torch.stack([h, s, maxc], dim=-1)
