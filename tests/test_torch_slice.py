"""The port's serving slice end to end against the JAX package, on the CPU.

The same seeded weights (a small HigherHRNet, numpy-drawn JAX variables
converted with ``state_dict_from_jax``) serve the same images of mixed
aspect ratio through the JAX ``PosePredictor(fused_decode=True)`` and
the port's ``PosePredictor(device="cpu")``.  The JAX side's ``auto``
grouping is patched to ``lockstep_interpret`` — what it resolves to on
the TPU — so both run the lockstep algorithm.  ``n_people`` must be
equal, coordinates and scores within 1e-3.  The host-grouping path
(``fused_decode=False``: ``parse_batch``) is held to the JAX predictor's
within 1e-4, and the single-image device decode (``parse_fused``, the
greedy grouping mega-kernel's plain version) to JAX ``decode_full``
with ``lap="greedy_interpret"`` on the same model's heatmaps.

Decode is discrete (peak tests, top-k order, thresholds), so a forward
difference far below the tolerance could still flip a decision near a
boundary.  The test therefore first asserts, on its fixed seeds, that
the two forwards agree (heatmaps within HM_TOL, resized tag maps within
TAG_TOL: float32 convolutions summed in another order) and that every
decision the decode takes on the heatmaps has a margin of more than
10 x HM_TOL.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.eval.predictor import PosePredictor as JaxPredictor
from rtpe_tpu.models import PoseHigherHRNet as JaxHRNet
from rtpe_tpu_torch.decode import HeatmapParser
from rtpe_tpu_torch.eval import PosePredictor
from test_torch_model import seeded_variables, small_cfgs
from test_torch_native import same_solver  # noqa: F401

HM_TOL = 1e-6
TAG_TOL = 5e-6
MARGIN = 10 * HM_TOL
TOL = 1e-3
NUM_JOINTS = 5
IMAGE_HW = [(96, 128), (128, 96), (100, 100), (80, 120)]


@pytest.fixture(scope="module")
def predictors():
    jcfg, tcfg = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    jp = JaxPredictor(JaxHRNet(cfg=jcfg, dtype=jnp.float32), variables,
                      num_joints=NUM_JOINTS, input_size=128,
                      fused_decode=True)
    tp = PosePredictor.from_jax(variables, tcfg, device="cpu",
                                num_joints=NUM_JOINTS, input_size=128)
    rng = np.random.default_rng(0)
    images = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
              for h, w in IMAGE_HW]
    return jp, tp, images


@pytest.fixture
def lockstep_auto(monkeypatch):
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")


def _assert_decode_margins(hms: np.ndarray, det_thr: float, k: int):
    """Every peak test, top-k order and threshold test on ``hms``
    (B, H, W, J) that can reach the output has a margin > MARGIN."""
    t = torch.from_numpy(np.array(hms)).permute(0, 3, 1, 2)
    pooled = F.max_pool2d(t, 5, 1, 2)
    peaks = torch.where(pooled == t, t, torch.zeros(()))
    vals = torch.sort(peaks.flatten(2), dim=-1, descending=True).values
    # rows at or below the detection threshold never reach the output
    relevant = t > det_thr - MARGIN
    near_peak = (pooled != t) & (pooled - t < MARGIN)
    assert not (near_peak & relevant).any(), "peak test within margin"
    top = vals[..., :k + 1]
    live = top > det_thr - MARGIN
    assert not (live & ((top - det_thr).abs() < MARGIN)).any()
    gaps = top[..., :-1] - top[..., 1:]
    assert not (live[..., :-1] & (gaps < MARGIN)).any(), "top-k order"


def test_forward_agrees_and_margins_hold(predictors):
    jp, tp, images = predictors
    for im in images:
        x_j, _, _ = jp._preprocess(im)
        hms_j, tags_j = jp._decode_outputs(*jp._fwd(jnp.asarray(x_j[None])))
        with torch.inference_mode():
            x_t, _, _ = tp._preprocess(im)
            hms_t, tags_t = tp._decode_outputs(*tp._forward(x_t[None]))
        np.testing.assert_allclose(hms_t.numpy(), np.asarray(hms_j),
                                   rtol=0, atol=HM_TOL)
        np.testing.assert_allclose(tags_t.numpy(), np.asarray(tags_j),
                                   rtol=0, atol=TAG_TOL)
        params = tp.parser.params
        _assert_decode_margins(np.asarray(hms_j),
                               params.detection_threshold,
                               params.max_num_people)


def _assert_same_people(res_t, res_j, tol=TOL):
    people_t, scores_t = res_t
    people_j, scores_j = res_j
    assert len(people_t) == len(people_j) > 0
    np.testing.assert_allclose(np.asarray(scores_t), np.asarray(scores_j),
                               rtol=0, atol=tol)
    for pt, pj in zip(people_t, people_j):
        assert pt.shape == pj.shape
        np.testing.assert_allclose(pt, pj, rtol=0, atol=tol)


def test_predict_batch_matches_jax(predictors, lockstep_auto):
    jp, tp, images = predictors
    out_t = tp.predict_batch(images)
    out_j = jp.predict_batch(images)
    assert len(out_t) == len(out_j) == len(images)
    for rt, rj in zip(out_t, out_j):
        _assert_same_people(rt, rj)


def test_predict_and_stream_match_jax(predictors, lockstep_auto):
    jp, tp, images = predictors
    out_j = [jp.predict(im) for im in images[:2]]
    for rt, rj in zip([tp.predict(im) for im in images[:2]], out_j):
        _assert_same_people(rt, rj)
    for rt, rj in zip(list(tp.stream(images[:2])), out_j):
        _assert_same_people(rt, rj)


def test_host_grouping_predict_batch_matches_jax(predictors, monkeypatch,
                                                same_solver):  # noqa: F811
    """``fused_decode=False`` on both sides: NMS + top-k with the adjust,
    host grouping, the refine of the people that miss a joint.  Both
    sides solve their assignments on the same solver (native where both
    libraries load, else scipy), so that both break exact cost ties
    alike."""
    jp, tp, images = predictors
    monkeypatch.setattr(jp, "fused_decode", False)
    host = PosePredictor(tp.model, device="cpu", num_joints=NUM_JOINTS,
                         input_size=128, fused_decode=False)
    assert not host.fused_decode and tp.fused_decode
    out_t = host.predict_batch(images)
    out_j = jp.predict_batch(images)
    assert len(out_t) == len(out_j) == len(images)
    for rt, rj in zip(out_t, out_j):
        _assert_same_people(rt, rj, tol=1e-4)


def test_parse_fused_matches_jax_greedy_on_model_heatmaps(predictors):
    jp, tp, images = predictors
    parser = HeatmapParser(num_joints=NUM_JOINTS, max_num_people=8)
    for im in images[:2]:
        hms_j, tags_j = jp._decode_outputs(
            *jp._fwd(jnp.asarray(jp._preprocess(im)[0][None])))
        with torch.inference_mode():
            x_t = tp._preprocess(im)[0]
            hms_t, tags_t = tp._decode_outputs(*tp._forward(x_t[None]))
        people, scores = parser.parse_fused(hms_t, tags_t)
        p_j, n_j, s_j = j_fused.decode_full(hms_j, tags_j, max_num_people=8,
                                            lap="greedy_interpret")
        n = int(n_j)
        assert len(people[0]) == len(scores) == n > 0
        for pt, pj in zip(people[0], np.asarray(p_j)[:n]):
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(scores, np.asarray(s_j)[:n], rtol=0,
                                   atol=1e-4)
