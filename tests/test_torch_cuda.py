"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and needs an NVIDIA GPU and ``nvcc``;
without them each one
skips with that reason (decided in a fixture, never at import).  On a
machine with the card, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover what ``chip_smoke.py``'s main-path shapes do not: planes whose
size is not a multiple of the NMS tile, other pooling windows, more
than one tag dimension, and the checks the wrappers make.
"""

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.ops.group_lockstep import (match_by_tag_lockstep,
                                               match_by_tag_lockstep_plain)
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
