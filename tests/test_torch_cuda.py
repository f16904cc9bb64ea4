"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and needs an NVIDIA GPU and ``nvcc``;
without them each one
skips with that reason (decided in a fixture, never at import).  On a
machine with the card, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover what ``chip_smoke.py``'s main-path shapes do not: planes whose
size is not a multiple of the NMS tile, other pooling windows, more
than one tag dimension, LAP matrices of every size the kernel takes,
and the checks the wrappers make.
"""

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.ops.group import (match_by_tag_kernel,
                                      match_by_tag_kernel_plain)
from rtpe_tpu_torch.ops.group_lockstep import (match_by_tag_lockstep,
                                               match_by_tag_lockstep_plain)
from rtpe_tpu_torch.ops.lap import lap_rect, lap_rect_plain
from rtpe_tpu_torch.ops.nms_topk import nms_topk, nms_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _heatmaps(shape, seed):
    rng = np.random.default_rng(seed)
    det = np.round(rng.normal(size=shape) * 4) / 4      # plateaus, ties
    det[..., 0] = 0.0                                    # all-zero plane
    det[0, 1, 1, 0] = 0.7                                # one peak
    return torch.from_numpy(det.astype(np.float32))


@pytest.mark.parametrize("shape,ksize,k", [
    ((1, 37, 45, 3), 5, 30),      # ragged tiles on both axes
    ((2, 70, 130, 4), 3, 17),     # several tiles, 3x3 window
    ((3, 33, 65, 2), 9, 30),      # widest window the kernel takes
    ((1, 6, 5, 2), 5, 30),        # a plane of exactly K pixels
])
def test_nms_topk_kernel_equals_plain(cuda, shape, ksize, k):
    det = _heatmaps(shape, seed=sum(shape)).to(cuda)
    for view in (det, det.permute(0, 3, 1, 2).contiguous()
                 .permute(0, 2, 3, 1)):
        before = nms_topk.launches
        got = nms_topk(view, k, ksize)
        want = nms_topk_plain(view, k, ksize)
        torch.cuda.synchronize()
        assert nms_topk.launches == before + 1
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)


def test_nms_topk_wrapper_refuses(cuda):
    det = torch.zeros((1, 16, 16, 2), device=cuda)
    with pytest.raises(TypeError):
        nms_topk(det.double(), 5, 5)
    with pytest.raises(ValueError):
        nms_topk(det, 5, 4)
    with pytest.raises(ValueError):
        nms_topk(det[:, :2, :2], 5, 5)


@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("b,j,k,d,m,p_max", [
    (5, 4, 8, 2, 8, 12),
    (3, 17, 30, 3, 30, 90),
    (2, 6, 12, 1, 20, 6),         # people beyond p_max fold onto the last
])
def test_lockstep_kernel_equals_plain(cuda, b, j, k, d, m, p_max,
                                      ignore_too_much):
    rng = np.random.default_rng(b * 31 + j)
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * 2
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    locs = rng.integers(0, 64, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    vals[0] = -1.0                                       # an empty image
    args = [torch.from_numpy(a).to(cuda) for a in (tags, locs, vals)]
    kw = dict(max_num_people=m, ignore_too_much=ignore_too_much,
              p_max=p_max)
    before = match_by_tag_lockstep.launches
    got = match_by_tag_lockstep(*args, **kw)
    want = match_by_tag_lockstep_plain(*args, **kw)
    torch.cuda.synchronize()
    assert match_by_tag_lockstep.launches == before + 1
    assert int(got[1][0]) == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,n,m", [(3, 1, 1), (2, 32, 32), (4, 30, 127),
                                   (5, 17, 60), (1, 8, 9)])
def test_lap_rect_kernel_equals_plain(cuda, b, n, m):
    rng = np.random.default_rng(n * 7 + m)
    cost = rng.integers(0, 4, size=(b, n, m)).astype(np.float32)  # ties
    cost[0] = (rng.integers(0, 11, (n, m)) * 100.0
               - rng.random((n, m))).astype(np.float32)
    cost[0, :, m // 2:] = 2048.0                         # decode sentinels
    c = torch.from_numpy(cost).to(cuda)
    before = lap_rect.launches
    got = lap_rect(c)
    want = lap_rect_plain(c)
    torch.cuda.synchronize()
    assert lap_rect.launches == before + 1
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_lap_rect_kernel_marks_costs_that_are_not_finite(cuda, bad):
    cost = torch.from_numpy(np.random.default_rng(0).random(
        (3, 5, 7)).astype(np.float32)).to(cuda)
    cost[1, 3] = bad
    got = lap_rect(cost)
    want = lap_rect_plain(cost)
    torch.cuda.synchronize()
    assert got[1].tolist() == [-1] * 5
    assert torch.equal(got, want)


def test_lap_rect_wrapper_refuses(cuda):
    with pytest.raises(ValueError):
        lap_rect(torch.zeros((1, 33, 40), device=cuda))
    with pytest.raises(ValueError):
        lap_rect(torch.zeros((1, 5, 4), device=cuda))
    with pytest.raises(ValueError):
        lap_rect(torch.zeros((1, 5, 128), device=cuda))


@pytest.mark.parametrize("solver", ["lap", "greedy"])
@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("b,j,k,d,m,p_max", [
    (5, 4, 8, 2, 8, 12),
    (3, 17, 30, 3, 30, 90),
    (2, 6, 12, 1, 20, 6),         # people beyond p_max fold onto the last
])
def test_group_mega_kernel_equals_plain(cuda, solver, b, j, k, d, m, p_max,
                                        ignore_too_much):
    rng = np.random.default_rng(b * 31 + j)
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * 2
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    locs = rng.integers(0, 64, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    vals[0] = -1.0                                       # an empty image
    args = [torch.from_numpy(a).to(cuda) for a in (tags, locs, vals)]
    kw = dict(max_num_people=m, ignore_too_much=ignore_too_much,
              p_max=p_max, solver=solver)
    before = match_by_tag_kernel.launches
    got = match_by_tag_kernel(*args, **kw)
    want = match_by_tag_kernel_plain(*args, **kw)
    torch.cuda.synchronize()
    assert match_by_tag_kernel.launches == before + 1
    assert int(got[1][0]) == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if solver == "greedy":
        kw.pop("solver")
        lock = match_by_tag_lockstep(*args, **kw)
        assert torch.equal(got[0], lock[0]) and torch.equal(got[1], lock[1])
