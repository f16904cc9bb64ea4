"""The port's host-grouping decode and single-image device decode against
the JAX package's, on the CPU.

* ``munkres_assign``, the host grouping oracle ``match_by_tag`` and the
  production ``match_by_tag_fast`` on the scenes of
  ``tests/test_decode.py:340,360``: exactly equal;
* the device finishes of the host paths (``adjust_refine_device``,
  ``refine_batch_device``, the per-person refine) within 1e-5;
* ``HeatmapParser.parse`` (host and device finish), ``parse_batch``
  (fast and oracle grouping) and ``parse_fused``: the same people,
  within 1e-5;
* ``decode_full`` for every ``lap`` against JAX ``decode_full`` with the
  matching solver (``*_interpret`` for a Pallas kernel): n_people
  exact, people and scores within 1e-5 (summation order of the tag
  means).

The rounded tag distances of the grouping cost tie often, and an exact
tie may be broken differently by two assignment solvers.  The JAX side
therefore solves with scipy here, the fallback its ``decode/group.py``
documents for when its native library is not built, as the port does.
"""

import numpy as np
import pytest
import torch

from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from rtpe_tpu.decode import HeatmapParser as JaxParser
from rtpe_tpu.decode import group as j_group
from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.decode import munkres_assign as j_munkres_assign
from rtpe_tpu.decode.group import match_by_tag as j_match_by_tag
from rtpe_tpu.decode.group_fast import match_by_tag_fast as j_match_fast
from rtpe_tpu.decode import refine_device as j_refine
from rtpe_tpu_torch.decode import (HeatmapParser, decode_full,
                                   match_by_tag, munkres_assign)
from rtpe_tpu_torch.decode.group import GroupingParams
from rtpe_tpu_torch.decode.group_fast import match_by_tag_fast
from rtpe_tpu_torch.decode import refine_device
from rtpe_tpu_torch.decode.parser import GroupingParams as ParserParams
from test_torch_decode import make_scene

TOL = 1e-5


@pytest.fixture(autouse=True)
def jax_grouping_on_scipy(monkeypatch):
    monkeypatch.setattr(j_group, "lap_solve", scipy_lap_solve)


def scipy_lap_solve(cost):
    return linear_sum_assignment(cost)


def noisy_scene(seed, b=1, hw=64, j=17, blobs=6, tag_sd=0.3):
    """Bright square blobs on a noise floor with noisy tags (the scenes
    of ``tests/test_decode.py:340,360``): many detections, crowded
    people, rounded tag distances that tie."""
    rng = np.random.RandomState(seed)
    det = np.clip(rng.rand(b, hw, hw, j) * 0.2, 0, 1).astype(np.float32)
    for i in range(b):
        for _ in range(blobs):
            y, x = rng.randint(3, hw - 4, 2)
            det[i, y:y + 3, x:x + 3, :] = rng.rand() * 0.5 + 0.5
    tag = (rng.randn(b, hw, hw, j) * tag_sd).astype(np.float32)
    return det, tag


def assert_same_people(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


def test_munkres_assign_matches_jax():
    rng = np.random.RandomState(3)
    for n, m in [(3, 5), (5, 5), (7, 2), (1, 1)]:
        cost = rng.rand(n, m)
        got = munkres_assign(cost)
        assert got.dtype == np.int32 and got.shape == (max(n, m), 2)
        np.testing.assert_array_equal(got, j_munkres_assign(cost))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_grouping_matches_jax(seed):
    det, tag = noisy_scene(seed)
    parser = HeatmapParser(num_joints=17, max_num_people=30)
    vk, lk, tk = parser.top_k(torch.from_numpy(det), torch.from_numpy(tag))
    j_vk, j_lk, j_tk = JaxParser(num_joints=17, max_num_people=30).top_k(
        jnp.asarray(det), jnp.asarray(tag))
    for a, b in ((vk, j_vk), (lk, j_lk), (tk, j_tk)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    want = j_match_by_tag(tk[0], lk[0], vk[0], parser.params)
    oracle = match_by_tag(tk[0], lk[0], vk[0], parser.params)
    fast = match_by_tag_fast(tk[0], lk[0], vk[0], parser.params)
    assert want.shape[0] > 1
    np.testing.assert_array_equal(oracle, want)
    np.testing.assert_array_equal(fast, want)
    np.testing.assert_array_equal(
        fast, j_match_fast(tk[0], lk[0], vk[0], parser.params))


def test_host_grouping_edge_cases():
    """Nothing above the threshold gives (0, J, 3+D); ``ignore_too_much``
    at the people cap skips a joint, as in the JAX oracle."""
    params = GroupingParams(num_joints=3, max_num_people=2,
                            ignore_too_much=True)
    assert ParserParams is GroupingParams
    assert params.joint_order == [0, 1, 2]
    tags = np.arange(3 * 4, dtype=np.float32).reshape(3, 4, 1)
    locs = np.zeros((3, 4, 2), np.float32)
    vals = np.full((3, 4), 0.05, np.float32)
    for fn in (match_by_tag, match_by_tag_fast):
        assert fn(tags, locs, vals, params).shape == (0, 3, 4)
    vals[:, :3] = 0.9
    for fn, j_fn in ((match_by_tag, j_match_by_tag),
                     (match_by_tag_fast, j_match_fast)):
        got = fn(tags, locs, vals, params)
        assert got.shape == (3, 3, 4)
        np.testing.assert_array_equal(got, j_fn(tags, locs, vals, params))


def test_device_refines_match_jax():
    rng = np.random.default_rng(5)
    b, h, w, j, d, p = 2, 24, 32, 4, 2, 6
    det = rng.uniform(0, 1, size=(b, h, w, j)).astype(np.float32)
    tag = rng.normal(size=(b, h, w, j, d)).astype(np.float32)
    people = np.zeros((b, p, j, 3 + d), np.float32)
    for i in range(b):
        for q in range(p - 1):                        # the last slot: padding
            vis = rng.random(j) > 0.4
            people[i, q, vis, 0] = rng.uniform(1, w - 2, size=vis.sum())
            people[i, q, vis, 1] = rng.uniform(1, h - 2, size=vis.sum())
            people[i, q, vis, 2] = rng.uniform(0.2, 1.0, size=vis.sum())
            people[i, q, vis, 3:] = rng.normal(size=(vis.sum(), d))
    t = [torch.from_numpy(a) for a in (det, tag, people)]
    got = refine_device.adjust_refine_device(t[0][0], t[1][0], t[2][0])
    want = j_refine.adjust_refine_device(det[0], tag[0], people[0])
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(
        refine_device.refine_batch_device(*t).numpy(),
        np.asarray(j_refine.refine_batch_device(det, tag, people)),
        rtol=TOL, atol=TOL)
    one = refine_device._make_refine_person(t[0][1], t[1][1])
    j_one = j_refine._make_refine_person(jnp.asarray(det[1]),
                                         jnp.asarray(tag[1]))
    for q in range(p):
        np.testing.assert_allclose(
            one(t[2][1, q]).numpy(),
            np.asarray(j_one(jnp.asarray(people[1, q]))), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("tag_per_joint", [True, False])
def test_parse_matches_jax(on_device, tag_per_joint):
    det, tag = make_scene(seed=1, h=48, w=64, num_joints=6,
                          tag_per_joint=tag_per_joint)
    kw = dict(num_joints=6, tag_per_joint=tag_per_joint)
    ans, scores = HeatmapParser(**kw).parse(
        torch.from_numpy(det[None]), torch.from_numpy(tag[None]),
        on_device=on_device)
    j_ans, j_scores = JaxParser(**kw).parse(
        jnp.asarray(det[None]), jnp.asarray(tag[None]), on_device=on_device)
    assert len(ans) == 1 and len(ans[0]) > 0
    assert_same_people(ans[0], j_ans[0])
    np.testing.assert_allclose(scores, j_scores, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fast", [True, False])
def test_parse_batch_matches_jax_and_parse(fast):
    det, tag = noisy_scene(0, b=2, tag_sd=0.5)
    parser = HeatmapParser(num_joints=17, max_num_people=30)
    ans, scores = parser.parse_batch(torch.from_numpy(det),
                                     torch.from_numpy(tag), fast=fast)
    j_ans, j_scores = JaxParser(num_joints=17, max_num_people=30
                                ).parse_batch(jnp.asarray(det),
                                              jnp.asarray(tag), fast=fast)
    assert len(ans) == 2
    for i in range(2):
        assert len(ans[i]) > 0
        assert_same_people(ans[i], j_ans[i])
        np.testing.assert_allclose(scores[i], j_scores[i], rtol=TOL,
                                   atol=TOL)
        one, one_scores = parser.parse(torch.from_numpy(det[i:i + 1]),
                                       torch.from_numpy(tag[i:i + 1]),
                                       on_device=False)
        assert_same_people(ans[i], one[0])
        np.testing.assert_allclose(scores[i], one_scores, rtol=1e-6)


# the port's lap -> JAX decode_full's solver for the same algorithm; on
# the CPU the port's "auto" is the plain greedy mega-kernel
J_LAP = {"auto": "greedy_interpret", "greedy": "greedy_interpret",
         "kernel": "kernel_interpret", "lockstep": "lockstep_interpret",
         "pallas": "pallas_interpret", "xla": "xla"}


@pytest.mark.parametrize("lap,tag_per_joint",
                         [(lap, True) for lap in sorted(J_LAP)]
                         + [("greedy", False), ("kernel", False)])
def test_decode_full_matches_jax(lap, tag_per_joint):
    det, tag = make_scene(seed=2, h=48, w=48, num_joints=4,
                          tag_per_joint=tag_per_joint)
    kw = dict(max_num_people=8, p_max=24, tag_per_joint=tag_per_joint)
    p_t, n_t, s_t = decode_full(torch.from_numpy(det[None]),
                                torch.from_numpy(tag[None]), lap=lap, **kw)
    p_j, n_j, s_j = j_fused.decode_full(jnp.asarray(det[None]),
                                        jnp.asarray(tag[None]),
                                        lap=J_LAP[lap], **kw)
    assert p_t.shape == (24, 4, 4) and n_t.dtype == torch.int32
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("tag_per_joint", [True, False])
def test_parse_fused_matches_jax_greedy(tag_per_joint):
    det, tag = make_scene(seed=3, h=48, w=64, num_joints=5,
                          tag_per_joint=tag_per_joint)
    parser = HeatmapParser(num_joints=5, max_num_people=8,
                           tag_per_joint=tag_per_joint)
    people, scores = parser.parse_fused(torch.from_numpy(det[None]),
                                        torch.from_numpy(tag[None]))
    p_j, n_j, s_j = j_fused.decode_full(
        jnp.asarray(det[None]), jnp.asarray(tag[None]), max_num_people=8,
        tag_per_joint=tag_per_joint, lap="greedy_interpret")
    n = int(n_j)
    assert len(people) == 1 and len(people[0]) == n == len(scores) > 0
    assert_same_people(people[0], np.asarray(p_j)[:n])
    np.testing.assert_allclose(scores, np.asarray(s_j)[:n], rtol=TOL,
                               atol=TOL)


def test_decode_full_refuses():
    det, tag = make_scene(seed=0, h=32, w=32, num_joints=2)
    two = (torch.from_numpy(np.stack([det, det])),
           torch.from_numpy(np.stack([tag, tag])))
    with pytest.raises(ValueError, match="one image"):
        decode_full(*two)
    with pytest.raises(ValueError, match="lap must be one of"):
        decode_full(two[0][:1], two[1][:1], lap="munkres")
