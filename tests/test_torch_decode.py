"""The port's decode stack against the JAX package's, on the CPU.

* NMS + top-k (plain version of ``csrc/nms_topk.cu``) against the JAX
  XLA ``top_k`` and the interpret-mode Pallas ``nms_topk_pallas``:
  exact, including planes with fewer than K peaks and planted ties.
* Lockstep grouping (plain version of ``csrc/group_lockstep.cu``)
  against the interpret-mode Pallas ``match_by_tag_lockstep``: exact.
* ``adjust_refine_batch`` with the slot cap on and off, and
  ``decode_full_batch`` end to end against JAX
  ``decode_full_batch`` with the matching solver, for every ``lap``:
  n_people exact, people and scores within 1e-5 (summation order of the
  tag means).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.decode.nms import adjust_locs as j_adjust_locs
from rtpe_tpu.decode.nms import nms_heatmaps as j_nms_heatmaps
from rtpe_tpu.decode.nms import top_k as j_top_k
from rtpe_tpu.decode.refine_device import \
    adjust_refine_batch as j_adjust_refine_batch
from rtpe_tpu.ops.pallas_decode import nms_topk_pallas
from rtpe_tpu.ops.pallas_group_lockstep import \
    match_by_tag_lockstep as j_lockstep
from rtpe_tpu_torch.decode import HeatmapParser, decode_full_batch
from rtpe_tpu_torch.decode.nms import adjust_locs, nms_heatmaps, top_k
from rtpe_tpu_torch.decode.refine_device import adjust_refine_batch
from rtpe_tpu_torch.ops.group_lockstep import match_by_tag_lockstep
from rtpe_tpu_torch.ops.nms_topk import nms_topk, nms_topk_plain


def make_scene(seed=0, h=64, w=80, num_people=3, num_joints=17,
               tag_per_joint=True, sigma=2.0):
    """Gaussian peaks with per-person tag values (the scene generator of
    ``tests/test_decode.py``)."""
    rng = np.random.RandomState(seed)
    det = np.zeros((h, w, num_joints), np.float32)
    tdim = num_joints if tag_per_joint else 1
    tag = rng.randn(h, w, tdim).astype(np.float32) * 0.05
    yy, xx = np.mgrid[0:h, 0:w]
    for p in range(num_people):
        tval = float(p) * 2.0
        for j in range(num_joints):
            if rng.rand() < 0.2:
                continue
            cx = rng.randint(4, w - 4)
            cy = rng.randint(4, h - 4)
            g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
            det[:, :, j] = np.maximum(det[:, :, j], g * rng.uniform(0.5, 1.0))
            ti = j if tag_per_joint else 0
            tag[g > 0.3, ti] = tval + rng.randn() * 0.05
    return det, tag


def topk_cases():
    rng = np.random.default_rng(7)
    sparse, _ = make_scene(seed=5, h=48, w=64)       # < K peaks per plane
    ties = np.zeros((40, 56, 3), np.float32)
    for y, x in [(5, 5), (5, 30), (20, 10), (35, 50), (12, 44)]:
        ties[y, x, :] = 0.5                           # equal peaks
    ties[30, 3, 1] = 0.75
    ties[0, 0, 2] = 0.5                               # tie at the corner
    dense = np.round(rng.normal(size=(33, 47, 4)) * 3).astype(np.float32)
    negative = -rng.uniform(0.1, 5.0, size=(24, 40, 2)).astype(np.float32)
    return [sparse[None], ties[None], np.stack([dense, dense[::-1]]),
            negative[None]]


@pytest.mark.parametrize("case", range(4))
def test_topk_matches_xla_and_pallas_interpret(case):
    det = topk_cases()[case]
    b, h, w, j = det.shape
    tag = np.random.default_rng(case).normal(size=(b, h, w, j)).astype(
        np.float32)
    v_x, loc_x, tag_x = j_top_k(jnp.asarray(det), jnp.asarray(tag), 30, 5,
                                2, True)
    v_p, x_p, y_p = nms_topk_pallas(jnp.asarray(det), max_people=30,
                                    ksize=5, interpret=True)
    v_t, loc_t, tag_t = top_k(torch.from_numpy(det), torch.from_numpy(tag),
                              30, 5, 2, True)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_x))
    np.testing.assert_array_equal(loc_t.numpy(), np.asarray(loc_x))
    np.testing.assert_array_equal(tag_t.numpy(), np.asarray(tag_x))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_p))
    np.testing.assert_array_equal(loc_t[..., 0].numpy(), np.asarray(x_p))
    np.testing.assert_array_equal(loc_t[..., 1].numpy(), np.asarray(y_p))
    assert loc_t.dtype == torch.int32


def test_topk_shared_tag_and_strided_det():
    """``tag_per_joint=False`` broadcasts one tag map; a permuted (NCHW
    seen as NHWC) ``det`` gives the same answer as a contiguous one."""
    det = topk_cases()[0]
    tag = np.random.default_rng(1).normal(size=det.shape[:3] + (1,)
                                          ).astype(np.float32)
    v_x, loc_x, tag_x = j_top_k(jnp.asarray(det), jnp.asarray(tag), 30, 5,
                                2, False)
    det_nchw = torch.from_numpy(det).permute(0, 3, 1, 2).contiguous()
    v_t, loc_t, tag_t = top_k(det_nchw.permute(0, 2, 3, 1),
                              torch.from_numpy(tag), 30, 5, 2, False)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_x))
    np.testing.assert_array_equal(loc_t.numpy(), np.asarray(loc_x))
    np.testing.assert_array_equal(tag_t.numpy(), np.asarray(tag_x))


def test_nms_heatmaps_and_adjust_locs_match_jax():
    det = topk_cases()[2]
    np.testing.assert_array_equal(
        nms_heatmaps(torch.from_numpy(det)).numpy(),
        np.asarray(j_nms_heatmaps(jnp.asarray(det))))
    loc = np.random.default_rng(4).integers(
        0, 33, size=(2, 4, 10, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        adjust_locs(torch.from_numpy(det), torch.from_numpy(loc)).numpy(),
        np.asarray(j_adjust_locs(jnp.asarray(det), jnp.asarray(loc))))


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    det = torch.from_numpy(topk_cases()[1])
    before = nms_topk.launches
    for a, b in zip(nms_topk(det, 30, 5), nms_topk_plain(det, 30, 5)):
        assert torch.equal(a, b)
    assert nms_topk.launches == before
    with pytest.raises(ValueError):
        nms_topk(det.to("meta"), 30, 5)


def lockstep_inputs(shape):
    b, j, k, d = shape
    rng = np.random.default_rng(b * 100 + j)
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * 2
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2     # force key ties
    locs = rng.uniform(0, 128, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.5, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    return tags, locs, vals


@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("shape", [(3, 17, 30, 1), (1, 17, 30, 1),
                                   (5, 4, 8, 2), (8, 6, 12, 1)])
def test_lockstep_matches_pallas_interpret(shape, ignore_too_much):
    tags, locs, vals = lockstep_inputs(shape)
    kw = dict(max_num_people=shape[2], ignore_too_much=ignore_too_much,
              p_max=90)
    p_j, n_j = j_lockstep(jnp.asarray(tags), jnp.asarray(locs),
                          jnp.asarray(vals), interpret=True, **kw)
    before = match_by_tag_lockstep.launches
    p_t, n_t = match_by_tag_lockstep(torch.from_numpy(tags),
                                     torch.from_numpy(locs),
                                     torch.from_numpy(vals), **kw)
    assert match_by_tag_lockstep.launches == before  # CPU: plain version
    assert n_t.dtype == torch.int32
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("ignore_too_much", [False, True])
def test_lockstep_edge_cases_match_pallas_interpret(ignore_too_much):
    """An empty image beside a setdefault-merge scene (same-key new
    persons chain onto one slot), and a crowded image that hits the
    max_num_people cap — exact against the interpret-mode kernel."""
    j, k, d = 3, 4, 1
    rng = np.random.default_rng(1)
    tags = np.zeros((3, j, k, d), np.float32)
    tags[1, 0, :2, 0] = 7.25
    tags[1, 0, 2:, 0] = 100.0 + np.arange(k - 2) * 50.0
    tags[1, 1:, :, 0] = 1e6
    tags[2] = rng.normal(size=(j, k, d)).astype(np.float32) * 50
    locs = rng.uniform(0, 32, size=(3, j, k, 2)).astype(np.float32)
    vals = np.full((3, j, k), -1.0, np.float32)
    vals[1, 0] = np.linspace(1.0, 0.4, k, dtype=np.float32)
    vals[2] = 0.9
    kw = dict(max_num_people=k, ignore_too_much=ignore_too_much, p_max=6)
    p_j, n_j = j_lockstep(jnp.asarray(tags), jnp.asarray(locs),
                          jnp.asarray(vals), interpret=True, **kw)
    p_t, n_t = match_by_tag_lockstep(torch.from_numpy(tags),
                                     torch.from_numpy(locs),
                                     torch.from_numpy(vals), **kw)
    assert int(n_t[0]) == 0 and torch.all(p_t[0] == 0)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def test_lockstep_refuses_shapes_outside_the_envelope():
    tags, locs, vals = lockstep_inputs((1, 2, 8, 1))
    with pytest.raises(ValueError):
        match_by_tag_lockstep(torch.from_numpy(tags), torch.from_numpy(locs),
                              torch.from_numpy(vals), max_num_people=4)


@pytest.mark.parametrize("occupancy,cap", [([2, 4, 1], 4), ([2, 9, 1], 4),
                                           ([2, 9, 1], 0)])
def test_adjust_refine_batch_matches_jax(occupancy, cap):
    """cap=4 with every image inside it (the capped branch), one image
    beyond it (the full branch), and cap=0 (no cap)."""
    rng = np.random.default_rng(3)
    b, h, w, j, d, p = 3, 32, 40, 4, 1, 12
    det = rng.uniform(0, 1, size=(b, h, w, j)).astype(np.float32)
    tag = rng.normal(size=(b, h, w, j, d)).astype(np.float32)
    people = np.zeros((b, p, j, 3 + d), np.float32)
    for i, n_occ in enumerate(occupancy):
        for q in range(n_occ):
            vis = rng.random(j) > 0.3
            vis[rng.integers(0, j)] = True
            people[i, q, vis, 0] = rng.uniform(1, w - 2, size=vis.sum())
            people[i, q, vis, 1] = rng.uniform(1, h - 2, size=vis.sum())
            people[i, q, vis, 2] = rng.uniform(0.2, 1.0, size=vis.sum())
            people[i, q, vis, 3] = rng.normal()
    n_b = np.asarray(occupancy, np.int32)
    p_j, s_j = j_adjust_refine_batch(jnp.asarray(det), jnp.asarray(tag),
                                     jnp.asarray(people), jnp.asarray(n_b),
                                     cap=cap)
    p_t, s_t = adjust_refine_batch(torch.from_numpy(det),
                                   torch.from_numpy(tag),
                                   torch.from_numpy(people),
                                   torch.from_numpy(n_b), cap=cap)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tag_per_joint", [True, False])
def test_decode_full_batch_matches_jax_lockstep(tag_per_joint):
    det_b, tag_b = [], []
    for seed in (0, 1, 2, 3):
        det, tag = make_scene(seed=seed, tag_per_joint=tag_per_joint)
        det_b.append(det)
        tag_b.append(tag)
    det, tag = np.stack(det_b), np.stack(tag_b)
    p_j, n_j, s_j = j_fused.decode_full_batch(
        jnp.asarray(det), jnp.asarray(tag), tag_per_joint=tag_per_joint,
        lap="lockstep_interpret")
    p_t, n_t, s_t = decode_full_batch(torch.from_numpy(det),
                                      torch.from_numpy(tag),
                                      tag_per_joint=tag_per_joint)
    assert np.asarray(n_j).min() > 0
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)

    grouped, scores = HeatmapParser(
        tag_per_joint=tag_per_joint).parse_fused_batch(
            torch.from_numpy(det), torch.from_numpy(tag))
    for i in range(det.shape[0]):
        assert len(grouped[i]) == int(n_j[i]) == len(scores[i])


# the port's lap -> JAX decode_full_batch's solver for the same algorithm;
# on the CPU the port's batch "auto" is the plain lockstep kernel
J_LAP = {"auto": "lockstep_interpret", "greedy": "greedy_interpret",
         "kernel": "kernel_interpret", "lockstep": "lockstep_interpret",
         "pallas": "pallas_interpret", "xla": "xla"}


@pytest.mark.parametrize("lap", sorted(J_LAP))
def test_decode_full_batch_runs_every_solver(lap):
    """Every grouping solver runs on the CPU (the plain versions of the
    card's kernels) and equals JAX's decode with the same solver."""
    det_b, tag_b = zip(*(make_scene(seed=s, h=48, w=48, num_joints=4)
                         for s in (0, 1)))
    det, tag = np.stack(det_b), np.stack(tag_b)
    kw = dict(max_num_people=8, p_max=24)
    p_t, n_t, s_t = decode_full_batch(torch.from_numpy(det),
                                      torch.from_numpy(tag), lap=lap, **kw)
    p_j, n_j, s_j = j_fused.decode_full_batch(
        jnp.asarray(det), jnp.asarray(tag), lap=J_LAP[lap], **kw)
    assert np.asarray(n_j).min() > 0
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="lap must be one of"):
        decode_full_batch(torch.from_numpy(det), torch.from_numpy(tag),
                          lap=lap + "_interpret")
