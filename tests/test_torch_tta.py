"""The port's test-time augmentation against the JAX package, on the CPU.

* ``flip_back`` / ``flip_joints``: bitwise equal to ``rtpe_tpu.eval.tta``.
* ``tta_forward`` with stub models (the identity heads of
  ``tests/test_extras.py`` and a fixed seeded strided convolution, whose
  maps a flip changes), flip on and off, scales (1.0,) and
  (0.5, 1.0, 2.0): within 1e-6 of JAX's, and a batch equal to its
  images one at a time.
* ``PosePredictor(with_flip=True)`` and a flip + multi-scale predictor
  against JAX's on the small seeded HigherHRNet of
  ``tests/test_torch_slice.py``: ``predict``, ``predict_batch`` and
  ``stream``, with that test's tolerances, after asserting its decode
  margins on JAX's aggregated heatmaps.  Both sides decode on the
  device path: JAX's ``auto`` grouping patched to the interpret-mode
  lockstep kernel, the port's plain lockstep, now on D=2 tags.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.eval import tta as j_tta
from rtpe_tpu.eval.predictor import PosePredictor as JaxPredictor
from rtpe_tpu.models import PoseHigherHRNet as JaxHRNet
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.eval import tta
from test_torch_model import seeded_variables, small_cfgs
from test_torch_slice import (HM_TOL, IMAGE_HW, NUM_JOINTS, TAG_TOL,
                              _assert_decode_margins, _assert_same_people)

SCALE_SETS = [(1.0,), (0.5, 1.0, 2.0)]


@pytest.mark.parametrize("j", [17, 5])
def test_flip_back_and_flip_joints_are_bitwise_jax(j):
    rng = np.random.default_rng(j)
    hms = rng.normal(size=(3, 12, 20, j)).astype(np.float32)
    got = tta.flip_back(torch.from_numpy(hms)).numpy()
    want = np.asarray(j_tta.flip_back(jnp.asarray(hms)))
    np.testing.assert_array_equal(got, want)
    joints = rng.uniform(-5, 60, size=(4, 17, 3))
    np.testing.assert_array_equal(tta.flip_joints(joints, 57.0),
                                  j_tta.flip_joints(joints, 57.0))


def _identity_heads(j):
    """The symmetric stub of ``tests/test_extras.py``: every heatmap is
    the input's first channel, the tags are zero."""
    def jax_fn(batch):
        b = batch.shape[0]
        coarse = jnp.concatenate(
            [batch[..., :1].repeat(j, axis=-1),
             jnp.zeros((b, batch.shape[1], batch.shape[2], j))], axis=-1)
        return coarse, batch[..., :1].repeat(j, axis=-1)

    def torch_fn(batch):
        b, h, w, _ = batch.shape
        coarse = torch.cat([batch[..., :1].repeat(1, 1, 1, j),
                            torch.zeros((b, h, w, j))], dim=-1)
        return coarse, batch[..., :1].repeat(1, 1, 1, j)

    return jax_fn, torch_fn


def _conv_heads(j, seed=3):
    """A fixed seeded 3 x 3 convolution, stride 2 for the refined
    heatmaps and stride 4 for the coarse heatmaps + tags: a flip of its
    input does not flip its maps."""
    rng = np.random.default_rng(seed)
    k_ref = rng.normal(size=(3, 3, 3, j)).astype(np.float32)       # HWIO
    k_coarse = rng.normal(size=(3, 3, 3, 2 * j)).astype(np.float32)

    def jax_fn(batch):
        def conv(k, s):
            return jax.lax.conv_general_dilated(
                batch, jnp.asarray(k), (s, s), ((1, 1), (1, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                precision=jax.lax.Precision.HIGHEST)
        return conv(k_coarse, 4), conv(k_ref, 2)

    def torch_fn(batch):
        x = batch.permute(0, 3, 1, 2)

        def conv(k, s):
            w = torch.from_numpy(k).permute(3, 2, 0, 1)
            return F.conv2d(x, w, stride=s, padding=1).permute(0, 2, 3, 1)
        return conv(k_coarse, 4), conv(k_ref, 2)

    return jax_fn, torch_fn


@pytest.mark.parametrize("heads", ["identity", "conv"])
@pytest.mark.parametrize("with_flip", [False, True])
@pytest.mark.parametrize("scales", SCALE_SETS)
def test_tta_forward_matches_jax(heads, with_flip, scales):
    """(2, 128, 320) inputs: scale 0.5 makes 320 * 0.5 / 64 = 2.5, which
    Python's round takes to 2 (half to even)."""
    j = 5
    jax_fn, torch_fn = (_identity_heads if heads == "identity"
                        else _conv_heads)(j)
    img = np.random.default_rng(7).random((2, 128, 320, 3)).astype(
        np.float32)
    hm_j, tag_j = j_tta.tta_forward(jax_fn, jnp.asarray(img), num_joints=j,
                                    with_flip=with_flip, scales=scales)
    with torch.inference_mode():
        hm_t, tag_t = tta.tta_forward(torch_fn, torch.from_numpy(img),
                                      num_joints=j, with_flip=with_flip,
                                      scales=scales)
        one = [tta.tta_forward(torch_fn, torch.from_numpy(img[i:i + 1]),
                               num_joints=j, with_flip=with_flip,
                               scales=scales) for i in range(2)]
    assert hm_t.shape == hm_j.shape and tag_t.shape == tag_j.shape
    assert tag_t.shape[-1] == j * (2 if with_flip else 1)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tag_t.numpy(), np.asarray(tag_j), rtol=0,
                               atol=1e-6)
    for i, (hm_1, tag_1) in enumerate(one):
        np.testing.assert_allclose(hm_t[i:i + 1].numpy(), hm_1.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tag_t[i:i + 1].numpy(), tag_1.numpy(),
                                   rtol=0, atol=1e-6)


def test_tta_forward_refuses_scales_without_one():
    _, torch_fn = _identity_heads(3)
    with pytest.raises(ValueError, match="must include 1.0"):
        tta.tta_forward(torch_fn, torch.zeros((1, 64, 64, 3)),
                        num_joints=3, scales=(0.5, 2.0))


@pytest.fixture(scope="module")
def tta_predictors():
    """The JAX and port predictors on the same seeded weights, for flip
    alone and for flip at the scales (0.5, 1.0, 2.0)."""
    jcfg, tcfg = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    rng = np.random.default_rng(0)
    images = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
              for h, w in IMAGE_HW]
    # images 1 and 3 of test_torch_slice.py: at three scales each has one
    # pixel within 1e-5 of its window's maximum, a peak test no
    # tolerance can hold; the margin test below shows these two have none
    images = [images[0], images[2]]
    pairs = {}
    for name, scales in (("flip", (1.0,)), ("multiscale", (0.5, 1.0, 2.0))):
        kw = dict(num_joints=NUM_JOINTS, input_size=128, with_flip=True,
                  scales=scales, fused_decode=True)
        jp = JaxPredictor(JaxHRNet(cfg=jcfg, dtype=jnp.float32), variables,
                          **kw)
        tp = PosePredictor.from_jax(variables, tcfg, device="cpu", **kw)
        pairs[name] = (jp, tp)
    return pairs, images


@pytest.fixture
def lockstep_auto(monkeypatch):
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")


@pytest.mark.parametrize("name", ["flip", "multiscale"])
def test_tta_maps_agree_and_margins_hold(tta_predictors, name):
    pairs, images = tta_predictors
    jp, tp = pairs[name]
    for im in images:
        x_j, _, _ = jp._preprocess(im)
        hms_j, tags_j = j_tta.tta_forward(jp._fwd, jnp.asarray(x_j[None]),
                                          NUM_JOINTS, True, jp.scales)
        with torch.inference_mode():
            x_t, _, _ = tp._preprocess(im)
            hms_t, tags_t = tp._maps(x_t[None])
        assert tags_t.shape[-1] == 2 * NUM_JOINTS
        np.testing.assert_allclose(hms_t.numpy(), np.asarray(hms_j),
                                   rtol=0, atol=HM_TOL)
        np.testing.assert_allclose(tags_t.numpy(), np.asarray(tags_j),
                                   rtol=0, atol=TAG_TOL)
        params = tp.parser.params
        _assert_decode_margins(np.asarray(hms_j),
                               params.detection_threshold,
                               params.max_num_people)


@pytest.mark.parametrize("name", ["flip", "multiscale"])
def test_tta_predictor_matches_jax(tta_predictors, lockstep_auto, name):
    """The port's ``predict``, ``predict_batch`` and ``stream`` against
    JAX's ``predict`` (under TTA JAX's ``predict_batch`` is a loop of
    ``predict``)."""
    pairs, images = tta_predictors
    jp, tp = pairs[name]
    out_j = [jp.predict(im) for im in images]
    out_t = tp.predict_batch(images)
    assert len(out_t) == len(images)
    for got in ([tp.predict(im) for im in images], out_t,
                list(tp.stream(images))):
        for rt, rj in zip(got, out_j):
            _assert_same_people(rt, rj)
