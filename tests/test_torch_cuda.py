"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and needs an NVIDIA GPU and ``nvcc``;
without them each one
skips with that reason (decided in a fixture, never at import).  On a
machine with the card, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover what ``chip_smoke.py``'s main-path shapes do not: planes whose
size is not a multiple of the NMS tile, wider planes, NaN heatmaps, other
pooling windows, LAP matrices on both sides of the solver's column
layouts (m = 63 / 64) and with signed zero costs, more than one tag
dimension (D=2, flip TTA's, at the main path's shape), flip and
multi-scale TTA decoded on the card, LAP matrices of every size the
kernel takes, NaN tags in the grouping kernels, BasicBlock chains at ragged and
narrow shapes, a small packed forward with its chains on the kernel,
the six fused-CAM kernels at small and ragged shapes (random inputs,
exact-sum inputs, per-image gates of both signs), the 2-D tiles of the
six ops at ragged shapes (a side smaller than a tile, a
dilation larger than a tile side) and their plans against the C
formulas, the s8 convolution ``qconv`` at ragged channels, Cout and
pixel counts (bitwise, its plan against the C one) and a small int8 and
int8-act forward bitwise against the plain ``qconv``, and the checks
the wrappers make.

Chain tolerance: the kernel and its plain version (float32 convolutions,
TF32 off) differ only in the order of each conv's float32 sum.  On
inputs whose every sum is exact in float32 (small integers times powers
of two) they must be bitwise equal.  On random inputs the order flips
some bf16 roundings (2^-8 relative) and each flip carries into the next
convs of the chain, so the worst element must lie within 2^-5 of the
output's largest magnitude (4 bf16 ulps there).

CAM tolerance: each kernel against its plain version (float32
convolutions, TF32 off) on the same inputs.  The batch statistics
differ only by sum order and by the rare bf16 rounding of a conv output
that lands on the other side of a tie: within 2^-8 of the statistic's
largest magnitude.  Activations and gradients also pass such roundings
through a ReLU mask or a weight-gradient sum: within 2^-5 of the
output's largest magnitude.  On exact-sum inputs (small integers,
weights in {-1, 0, 1}, dyadic BN rows, gates and cotangents) every
output is bitwise equal.
"""

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.decode.fused import kernel_selfcheck
from rtpe_tpu_torch.device import set_tf32
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.models.hrnet import (HRNetConfig, PoseHigherHRNet,
                                         StageCfg, init_random_)
from rtpe_tpu_torch.models.hrnet_packed import pack_w48_params, packed_forward
from rtpe_tpu_torch.ops import cam
from rtpe_tpu_torch.ops.blocks import (basicblock_chain,
                                       basicblock_chain_plain, chain_plan,
                                       chain_plan_c)
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


@pytest.fixture
def no_tf32(cuda):
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    set_tf32(False)
    yield cuda
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


CHAIN_TOL = 2.0 ** -5


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
    ((2, 64, 480, 2), 5, 30),     # a wider plane (a non-square image)
    ((1, 29, 150, 3), 5, 30),     # ragged on both axes, 3 tiles wide
    ((1, 40, 70, 2), 5, 1),       # K = 1
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


def _nan_heatmaps():
    """A peak beside a NaN, NaNs on tile borders beside peaks, NaNs
    among random planes."""
    rng = np.random.default_rng(11)
    det = np.round(rng.normal(size=(2, 70, 130, 3)) * 4) / 4
    det[rng.random(det.shape) < 0.01] = np.nan
    det[0, :, :, 0] = 0.0
    det[0, 10, 11, 0] = 1.0
    det[0, 10, 10, 0] = np.nan
    det[0, 30, 40, 0] = 0.5
    det[0, 31, 63, 1] = np.nan
    det[0, 32, 64, 1] = 9.0
    det[1, 63, 63, 2] = np.nan                           # a tile corner
    det[1, 64, 64, 2] = 9.0
    return torch.from_numpy(det.astype(np.float32))


def test_nms_topk_kernel_keeps_nan_windows(cuda):
    """A NaN pixel, and every pixel whose window holds one, is no peak:
    the kernel pools as max_pool2d and jnp.maximum do (NaN propagates)."""
    det = _nan_heatmaps()
    for ksize in (3, 5, 9):
        want = nms_topk_plain(det, 30, ksize)
        got = nms_topk(det.to(cuda), 30, ksize)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)
    v, x, y = nms_topk(det.to(cuda), 4, 5)
    assert v[0, 0].tolist() == [0.5, 0.0, 0.0, 0.0]
    assert x[0, 0].tolist() == [40, 0, 1, 2]
    assert y[0, 0].tolist() == [30, 0, 0, 0]


def test_nms_topk_wrapper_refuses(cuda):
    det = torch.zeros((1, 16, 16, 2), device=cuda)
    with pytest.raises(TypeError):
        nms_topk(det.double(), 5, 5)
    with pytest.raises(ValueError):
        nms_topk(det, 5, 4)
    with pytest.raises(ValueError):
        nms_topk(det[:, :2, :2], 5, 5)


GROUP_CASES = [
    (5, 4, 8, 2, 8, 12),
    (3, 17, 30, 3, 30, 90),
    (2, 6, 12, 1, 20, 6),         # people beyond p_max fold onto the last
    (3, 17, 30, 1, 30, 90),       # the main path's shape
    (3, 17, 30, 1, 30, 20),       # saturation at the main path's K
    (2, 9, 32, 2, 63, 96),        # two candidate slots a lane
    (2, 9, 32, 8, 63, 96),
    (2, 6, 12, 3, 40, 48),
    (8, 17, 30, 2, 30, 90),       # flip TTA: D=2 at the main path's shape
]


@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("b,j,k,d,m,p_max", GROUP_CASES)
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
                                   (5, 17, 60), (1, 8, 9), (4, 30, 63),
                                   (4, 30, 64), (3, 32, 63), (3, 32, 64)])
def test_lap_rect_kernel_equals_plain(cuda, b, n, m):
    """m = 63 and 64 straddle the kernel's two column layouts (two
    columns a lane up to 63, four beyond)."""
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


@pytest.mark.parametrize("m", [30, 60, 63, 64, 127])
def test_lap_rect_kernel_on_signed_zero_costs(cuda, m):
    """Costs of -0.0 and +0.0 tie (the argmin's order key makes them
    equal, the smallest column wins) and the potentials keep the sign of
    the winning zero, as in the plain version."""
    rng = np.random.default_rng(m)
    cost = rng.integers(-1, 2, size=(4, 30, m)).astype(np.float32)
    cost = np.where(cost == 0, np.where(rng.random(cost.shape) < 0.5,
                                        np.float32(-0.0), np.float32(0.0)),
                    cost)
    c = torch.from_numpy(cost.astype(np.float32)).to(cuda)
    got = lap_rect(c)
    want = lap_rect_plain(c)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("b,j,k,d,m,p_max", GROUP_CASES)
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


@pytest.mark.parametrize("m", [31, 32])
@pytest.mark.parametrize("spread", [2.0, 20.0])
def test_group_mega_lap_at_the_column_boundary(cuda, m, spread):
    """The exact solver's 2m cost columns: 62 take two columns a lane,
    64 four; each equal to the plain version."""
    rng = np.random.default_rng(m)
    b, j, k, d = 3, 9, 30, 1
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * spread
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    locs = rng.integers(0, 64, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    args = [torch.from_numpy(a).to(cuda) for a in (tags, locs, vals)]
    kw = dict(max_num_people=m, p_max=96, solver="lap")
    got = match_by_tag_kernel(*args, **kw)
    want = match_by_tag_kernel_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int(want[1].min()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _nan_scene(b, j, k, d, seed):
    """Tags with NaNs planted on active rows (a whole tag at the first
    joint, one dimension of a later row) beside an image without any."""
    rng = np.random.default_rng(seed)
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * 2
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    locs = rng.integers(0, 64, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    vals[:2, :, :3] = np.maximum(vals[:2, :, :3], 0.5)
    tags[0, 0, 1] = np.nan
    tags[1, 2, 0, d - 1] = np.nan
    tags[1, 3, 2] = np.nan
    return tags, locs, vals


@pytest.mark.parametrize("grouping", ["lockstep", "greedy", "lap"])
@pytest.mark.parametrize("b,j,k,d,m,p_max", [(3, 5, 8, 1, 8, 24),
                                             (3, 17, 30, 2, 30, 90),
                                             (3, 17, 30, 1, 30, 90),
                                             (3, 9, 12, 3, 40, 48),
                                             (3, 6, 8, 8, 8, 16),
                                             (3, 17, 30, 1, 30, 20)])
def test_grouping_kernels_keep_nan_costs(cuda, grouping, b, j, k, d, m,
                                         p_max):
    """A NaN cost survives the clamp and matches no one, in the kernels
    as in their plain versions (and in JAX: ``tests/test_torch_group.py``)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _nan_scene(b, j, k, d, seed=j)]
    kw = dict(max_num_people=m, p_max=p_max)
    if grouping == "lockstep":
        got = match_by_tag_lockstep(*args, **kw)
        want = match_by_tag_lockstep_plain(*args, **kw)
    else:
        got = match_by_tag_kernel(*args, solver=grouping, **kw)
        want = match_by_tag_kernel_plain(*args, solver=grouping, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0][0]).any())
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got[1], want[1])


def _spread_scene(b, j, k, d, seed, spread, zeros=False):
    """Tags with many distinct keys (``spread`` wide: more people than 32
    candidate slots, or costs clamped at 1000 where the tie bias is below
    half an ulp: exact cost ties), or with ``zeros`` half the tags at
    -0.0 and +0.0 (distances of 0, costs of 0 at slot 0)."""
    rng = np.random.default_rng(seed)
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * spread
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    if zeros:
        sign = np.where(rng.random(tags.shape) < 0.5, np.float32(-0.0),
                        np.float32(0.0))
        tags = np.where(rng.random(tags.shape) < 0.5, sign, tags)
    locs = rng.integers(0, 64, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    return tags, locs, vals


@pytest.mark.parametrize("grouping", ["lockstep", "greedy", "lap"])
@pytest.mark.parametrize("case", [
    # (b, j, k, d), m, p_max, spread, zeros, use_detection_val
    ((3, 9, 32, 1), 63, 96, 20.0, False, True),    # > 32 candidates
    ((3, 9, 32, 3), 63, 96, 20.0, False, True),
    ((3, 17, 30, 1), 30, 90, 300.0, False, True),  # exact cost ties
    ((3, 9, 16, 1), 16, 40, 2.0, True, False),     # costs at -0 / +0
    ((3, 9, 16, 2), 16, 40, 2.0, True, True),
    ((4, 9, 12, 1), 20, 6, 20.0, False, True),     # saturation at p_max
])
def test_grouping_kernels_on_spread_scenes(cuda, grouping, case):
    """The paths the main path's scenes seldom take: more people than 32
    candidate slots (two a lane), exact cost ties, zero costs, and new
    people past p_max folding onto the last slot; equal to the plain
    version, and the greedy kernels to each other."""
    shape, m, p_max, spread, zeros, use_val = case
    args = [torch.from_numpy(a).to(cuda) for a in _spread_scene(
        *shape, seed=sum(shape) + m, spread=spread, zeros=zeros)]
    kw = dict(max_num_people=m, p_max=p_max, use_detection_val=use_val)
    if grouping == "lockstep":
        got = match_by_tag_lockstep(*args, **kw)
        want = match_by_tag_lockstep_plain(*args, **kw)
    else:
        got = match_by_tag_kernel(*args, solver=grouping, **kw)
        want = match_by_tag_kernel_plain(*args, solver=grouping, **kw)
        if grouping == "greedy":
            lock = match_by_tag_lockstep(*args, **kw)
            assert torch.equal(got[0], lock[0])
            assert torch.equal(got[1], lock[1])
    torch.cuda.synchronize()
    assert int(want[1].min()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _chain_inputs(shape, n, seed, device, exact=False):
    """Random normal inputs, or with ``exact`` small integers times
    powers of two, so that every conv sum of the chain is exact in
    float32 and only the bf16 roundings of the outputs remain."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    if exact:
        x = torch.randint(-4, 5, shape, generator=g).float()
        w = torch.randint(-1, 2, (n, 2, 3, 3, c, c), generator=g) / 64.0
        b = torch.randint(-8, 9, (n, 2, c), generator=g) / 64.0
    else:
        x = torch.randn(shape, generator=g)
        w = torch.randn((n, 2, 3, 3, c, c), generator=g) / (3 * c) ** 0.5
        b = torch.randn((n, 2, c), generator=g) * 0.1
    return (x.to(device, torch.bfloat16), w.to(device, torch.bfloat16),
            b.to(device))


@pytest.mark.parametrize("shape,n", [
    ((2, 12, 20, 96), 4),         # ragged: 480 pixels, not a tile multiple
    ((1, 80, 80, 96), 1),
    ((3, 40, 40, 192), 2),
    ((1, 20, 20, 384), 1),
    ((2, 7, 9, 64), 2),           # the 64-channel tile, odd H and W
    ((1, 3, 5, 32), 3),           # fewer pixels than one tile
    ((1, 40, 40, 192), 4),        # B=1: the K steps split 10 ways
    ((1, 20, 20, 384), 4),        # ... 16 ways, two N tiles
    ((1, 80, 80, 96), 3),         # ... 2 ways, K padded 864 -> 896
    ((8, 80, 80, 96), 1),         # no split: 200 tiles of 256 pixels
    ((2, 13, 11, 32), 4),         # ragged, the 32-channel tile
    ((2, 128, 132, 32), 2),       # 256-pixel tiles: 132 of them
    ((1, 200, 181, 64), 1),       # ... 142, the last one ragged
])
def test_basicblock_chain_kernel_equals_plain(no_tf32, shape, n):
    x, w, b = _chain_inputs(shape, n, seed=sum(shape) + n, device=no_tf32)
    before = basicblock_chain.launches
    got = basicblock_chain(x, w, b)
    want = basicblock_chain_plain(x, w, b)
    torch.cuda.synchronize()
    assert basicblock_chain.launches == before + 1
    assert got.is_cuda and got.dtype == torch.bfloat16
    assert got.shape == x.shape and got.is_contiguous()
    err = float((got.float() - want.float()).abs().max())
    assert err <= CHAIN_TOL * float(want.float().abs().max()), err
    # a channels_last NCHW tensor goes in as its NHWC view, no copy
    nchw = x.permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(basicblock_chain(nchw.permute(0, 2, 3, 1), w, b), got)


@pytest.mark.parametrize("shape,n", [((2, 12, 20, 96), 4),
                                     ((1, 20, 20, 384), 2),
                                     ((2, 7, 9, 64), 2),
                                     ((1, 80, 80, 96), 1),
                                     ((1, 40, 40, 192), 2),
                                     ((8, 40, 40, 192), 1),
                                     ((3, 5, 7, 32), 4)])
def test_basicblock_chain_kernel_is_exact_on_exact_sums(cuda, shape, n):
    """cuDNN is off for the plain version here: it may pick Winograd or
    FFT algorithms, which round inside their transforms; PyTorch's own
    convolution (a float32 GEMM) sums exactly what the kernel sums."""
    x, w, b = _chain_inputs(shape, n, seed=n, device=cuda, exact=True)
    got = basicblock_chain(x, w, b)
    with torch.backends.cudnn.flags(enabled=False):
        want = basicblock_chain_plain(x, w, b)
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) > 2       # the chain did work
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 80, 80, 96), (1, 40, 40, 192),
                                   (1, 20, 20, 384), (8, 40, 40, 192)])
def test_basicblock_chain_kernel_repeats_itself(cuda, shape):
    """The K splits' partials are summed in a fixed order (no float
    atomics): two runs are bitwise equal."""
    x, w, b = _chain_inputs(shape, 2, seed=5, device=cuda)
    first = basicblock_chain(x, w, b)
    second = basicblock_chain(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("shape", [
    (b, *hwc) for hwc in ((80, 80, 96), (40, 40, 192), (20, 20, 384))
    for b in (1, 2, 8)] + [(2, 12, 20, 96), (1, 3, 5, 32), (2, 7, 9, 64),
                           (3, 33, 17, 160), (1, 20, 20, 288)])
def test_basicblock_chain_plan_matches_the_kernel(cuda, shape):
    """The C plan (basicblock_chain_plan) and the Python one
    (ops/blocks.py:chain_plan) agree."""
    want = chain_plan(*shape)
    got = chain_plan_c(*shape)
    assert got == {k: want[k] for k in got}


def test_basicblock_chain_wrapper_refuses(cuda):
    x, w, b = _chain_inputs((1, 4, 4, 32), 1, seed=0, device=cuda)
    with pytest.raises(TypeError):
        basicblock_chain(x.float(), w, b)
    with pytest.raises(TypeError):
        basicblock_chain(x, w, b.to(torch.bfloat16))
    with pytest.raises(ValueError):                 # C not a multiple of 32
        x48, w48, b48 = _chain_inputs((1, 4, 4, 48), 1, seed=0, device=cuda)
        basicblock_chain(x48, w48, b48)
    with pytest.raises(ValueError):                 # NCHW storage
        basicblock_chain(x.permute(0, 3, 1, 2).contiguous()
                         .permute(0, 2, 3, 1), w, b)
    with pytest.raises(ValueError):
        basicblock_chain(x, w[:, :1], b)


def _chain_cfg():
    """A narrow teacher whose branches 1..3 take the kernel (channels
    multiples of 32)."""
    return HRNetConfig(num_joints=5,
                       stage2=StageCfg(1, 2, "BASIC", (1, 2), (32, 64)),
                       stage3=StageCfg(2, 3, "BASIC", (1, 2, 1), (32, 64, 96)),
                       stage4=StageCfg(1, 4, "BASIC", (1, 1, 2, 1),
                                       (32, 64, 96, 128)),
                       deconv_chans=(32,), deconv_num_blocks=1)


def test_packed_forward_chains_on_the_card(no_tf32):
    """bf16 with the chains on the kernel against bf16 with the chains on
    cuDNN, and float32 (chains on cuDNN) against the canonical float32
    forward; one kernel launch per branch > 0 of every stage module."""
    cfg = _chain_cfg()
    model = init_random_(PoseHigherHRNet(cfg), seed=4).eval()
    x = torch.randn((2, 3, 96, 128),
                    generator=torch.Generator().manual_seed(5)).to(no_tf32)
    pk = pack_w48_params(model.state_dict(), cfg, torch.bfloat16, no_tf32)
    with torch.inference_mode():
        before = basicblock_chain.launches
        on = packed_forward(pk, x, cfg, torch.bfloat16, pallas_chains=True)
        assert basicblock_chain.launches - before == 1 + 2 * 2 + 3
        off = packed_forward(pk, x, cfg, torch.bfloat16)
        for a, b in zip(on, off):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            scale = float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) < 0.05 * scale
        pk32 = pack_w48_params(model.state_dict(), cfg, torch.float32,
                               no_tf32)
        got = packed_forward(pk32, x, cfg, torch.float32)
        want = model.to(no_tf32)(x)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
        with pytest.raises(TypeError):
            packed_forward(pk32, x, cfg, torch.float32, pallas_chains=True)


CAM_STAT_TOL = 2.0 ** -8
CAM_TOL = 2.0 ** -5
CAM_WORST = 2.0 ** -2     # with ReLU-mask flips (chip_smoke.py CAM_*)
CAM_MEAN = 2.0 ** -8


def _cam_rows(s, n, gen, exact):
    """BN rows [mean, inv, scale, bias] per branch from sums ``s`` (2k, w)
    over n pixels: the batch statistics, or dyadic rows near them."""
    mean = s[0::2] / n
    var = (s[1::2] / n - mean * mean).clamp(min=0)
    if exact:
        mean = torch.round(mean)
        inv = torch.full_like(mean, 0.25)
        scale = 0.5 * torch.randint(1, 3, mean.shape, generator=gen)
        bias = torch.randint(-4, 5, mean.shape, generator=gen) / 8.0
    else:
        inv = torch.rsqrt(var + 1e-5)
        scale = 1.0 + 0.1 * torch.randn(mean.shape, generator=gen)
        bias = 0.1 * torch.randn(mean.shape, generator=gen)
    return torch.stack([mean, inv, scale.float(), bias.float()],
                       1).reshape(-1, mean.shape[1]).contiguous()


def cam_case(b, h, w, c, dils, hc, seed, device, exact=False,
             signed_gates=False):
    """Every input of the six CAM kernels, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    nb = len(dils)

    def weight(shape, fan_in):
        if exact:
            keep = torch.rand(shape, generator=gen) < 0.15
            return (torch.randint(-1, 2, shape, generator=gen) * keep).float()
        return torch.randn(shape, generator=gen) / fan_in ** 0.5

    if exact:
        x = torch.randint(-1, 2, (b, h, w, c), generator=gen).float()
    else:
        x = torch.rand((b, h, w, c), generator=gen)
    bf = dict(dtype=torch.bfloat16, device=device)
    case = {"x": x.to(**bf), "kr": weight((c, c), c).to(**bf),
            "kh": weight((nb, 3, 3, c, hc), 9 * c).to(**bf),
            "kt": weight((nb, hc, c), nb * hc).to(**bf), "dils": tuple(dils)}
    n = b * h * w
    with torch.backends.cudnn.flags(enabled=False):
        s_r, s_h, _ = cam.cam_f1_fwd_plain(case["x"], case["kr"],
                                           case["kh"], dils)
        case["bnh"] = _cam_rows(s_h.cpu(), n, gen, exact).to(device)
        case["bnr"] = _cam_rows(s_r.cpu(), n, gen, exact).to(device)
        s_t = cam.cam_f2_fwd_plain(case["x"], case["kh"], case["kt"],
                                   case["bnh"], dils)
    case["bnt"] = _cam_rows(s_t.cpu(), n, gen, exact).to(device)
    if exact:
        def cot(shape):
            return torch.randint(-4, 5, shape, generator=gen) / 8.0
        gate = torch.randint(-8, 9, (b, c), generator=gen) / 8.0
        g = torch.randint(-2, 3, (b, h, w, c), generator=gen).float()
    else:
        def cot(shape):
            return torch.randn(shape, generator=gen) * 1e-3
        gate = (torch.randn((b, c), generator=gen) if signed_gates
                else torch.rand((b, c), generator=gen))
        g = torch.randn((b, h, w, c), generator=gen)
    for name, shape in (("dsr", (2, c)), ("dsh", (2 * nb, hc)),
                        ("dgap", (b, c)), ("dst", (2, c))):
        case[name] = cot(shape).float().to(device)
    case["gate"] = gate.float().to(device)
    case["g"] = g.to(**bf)
    return case


def cam_calls(case):
    """(name, kernel, plain, args) of the six CAM kernels on ``case``."""
    k = case
    d = k["dils"]
    return [
        ("cam_f1_fwd", cam.cam_f1_fwd, cam.cam_f1_fwd_plain,
         (k["x"], k["kr"], k["kh"], d)),
        ("cam_f1_bwd", cam.cam_f1_bwd, cam.cam_f1_bwd_plain,
         (k["x"], k["kr"], k["kh"], k["dsr"], k["dsh"], k["dgap"], d)),
        ("cam_f2_fwd", cam.cam_f2_fwd, cam.cam_f2_fwd_plain,
         (k["x"], k["kh"], k["kt"], k["bnh"], d)),
        ("cam_f2_bwd", cam.cam_f2_bwd, cam.cam_f2_bwd_plain,
         (k["x"], k["kh"], k["kt"], k["bnh"], k["dst"], d)),
        ("cam_f3_fwd", cam.cam_f3_fwd, cam.cam_f3_fwd_plain,
         (k["x"], k["kr"], k["kh"], k["kt"], k["bnr"], k["bnh"], k["bnt"],
          k["gate"], d)),
        ("cam_f3_bwd", cam.cam_f3_bwd, cam.cam_f3_bwd_plain,
         (k["x"], k["kr"], k["kh"], k["kt"], k["bnr"], k["bnh"], k["bnt"],
          k["gate"], k["g"], d)),
    ]


# which outputs of each kernel are batch statistics (the rest are
# activations and gradients)
CAM_STATS = {"cam_f1_fwd": (0, 1, 2), "cam_f2_fwd": (0,),
             "cam_f2_bwd": (3,), "cam_f3_bwd": (4, 5, 6, 7)}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


CAM_SHAPES = [(2, 21, 21, 12, (1, 2, 3), 3),
              (3, 29, 21, 83, (1, 2, 3, 4), 20),
              (2, 17, 23, 163, (1, 2, 3), 40)]


@pytest.mark.parametrize("shape", CAM_SHAPES)
def test_cam_kernels_match_plain(no_tf32, shape):
    case = cam_case(*shape, seed=sum(shape[:4]), device=no_tf32)
    for name, kernel, plain, args in cam_calls(case):
        before = kernel.launches
        got = _as_tuple(kernel(*args))
        want = _as_tuple(plain(*args))
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
            assert bool(torch.isfinite(a.float()).all()), (name, i)
            tol = CAM_STAT_TOL if i in CAM_STATS.get(name, ()) else CAM_TOL
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            assert err <= tol * scale, (name, i, err, scale)


@pytest.mark.parametrize("shape", [(2, 12, 20, 163, (1, 2, 3), 40),
                                   (1, 9, 14, 83, (1, 2, 3, 4), 20)])
def test_cam_kernels_are_exact_on_exact_sums(cuda, shape):
    case = cam_case(*shape, seed=7, device=cuda, exact=True)
    for name, kernel, plain, args in cam_calls(case):
        got = _as_tuple(kernel(*args))
        with torch.backends.cudnn.flags(enabled=False):
            want = _as_tuple(plain(*args))
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (name, i)


def test_cam_f3b_uses_each_images_gate(no_tf32):
    """Distinct gates of both signs per image: the kernel's dx follows
    image b's gate (the plain version), on every image."""
    case = cam_case(3, 19, 17, 83, (1, 2, 3, 4), 20, seed=11,
                    device=no_tf32, signed_gates=True)
    name, kernel, plain, args = cam_calls(case)[5]
    got, want = kernel(*args)[0], plain(*args)[0]
    for b in range(3):
        scale = float(want[b].float().abs().max())
        assert float((got[b].float() - want[b].float()).abs().max()) \
            <= CAM_TOL * scale, b


# The 2-D tiles (csrc/cam_tile.cuh) of the backwards and of the forwards at
# shapes the train step does not give: H and W not multiples of the
# 8-pixel tile side, a side smaller than a tile, a dilation larger than a
# tile side, two dx channel chunks
F3B_SHAPES = [(2, 9, 13, 83, (1, 2, 3, 4), 20),
              (1, 5, 30, 163, (1, 2, 3), 40),
              (1, 30, 5, 83, (1, 2, 3, 4), 20),
              (1, 11, 19, 12, (1, 9), 3),
              (1, 9, 10, 170, (1, 2), 8)]
# op -> its index in cam_calls; F3b's cases keep their first ids
TILE_CALLS = {"f3b": 5, "f1b": 1, "f2b": 3, "f1": 0, "f3": 4, "f2": 2}


def by_op(shapes):
    return [pytest.param(op, s, id=f"shape{k}" if op == "f3b"
                         else f"{op}-shape{k}")
            for op in TILE_CALLS for k, s in enumerate(shapes)]


@pytest.mark.parametrize("op,shape", by_op(F3B_SHAPES))
def test_cam_f3b_ragged_tiles_match_plain(no_tf32, op, shape):
    """F3b, F1b, F2b, F1, F3 and F2 on ragged tiles.  Exact-sum inputs with
    gates of both signs: every output bitwise the plain version's, so each
    ragged tile's halo, masks and per-image sums are right.  Random inputs
    with signed gates: finite, F1's and F2's statistics within
    CAM_STAT_TOL of their largest magnitude, every other output within the
    card check's limits for ReLU-mask flips (``chip_smoke.py`` CAM_WORST,
    CAM_MEAN).  Where the kernel's and the plain version's float32 sums
    round a conv output to bf16 on either side of a tie and that moves a
    pre-activation across zero, the cotangent behind it changes by its own
    size; at these sizes one such flip moves a whole pixel row of dx
    (3.8 % of max |dx| at (1, 5, 30, 163) on an H100), so the worst
    element is held to 2^-2 and the mean to 2^-8 of max |plain|."""
    exact = cam_case(*shape, seed=7, device=no_tf32, exact=True)
    name, kernel, plain, args = cam_calls(exact)[TILE_CALLS[op]]
    before = kernel.launches
    got = _as_tuple(kernel(*args))
    with torch.backends.cudnn.flags(enabled=False):
        want = _as_tuple(plain(*args))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert bool((exact["gate"] < 0).any() and (exact["gate"] > 0).any())
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    case = cam_case(*shape, seed=sum(shape[:4]), device=no_tf32,
                    signed_gates=True)
    name, kernel, plain, args = cam_calls(case)[TILE_CALLS[op]]
    got, want = _as_tuple(kernel(*args)), _as_tuple(plain(*args))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all()), i
        d = (a.float() - b.float()).abs()
        scale = float(b.float().abs().max())
        if op in ("f1", "f2"):                  # batch statistics
            assert float(d.max()) <= CAM_STAT_TOL * scale, i
            continue
        assert float(d.max()) <= CAM_WORST * scale, i
        assert float(d.mean()) <= CAM_MEAN * scale, i


@pytest.mark.parametrize("op,shape", by_op(
    CAM_SHAPES + F3B_SHAPES + [(16, 113, 113, 163, (1, 2, 3), 40),
                               (16, 113, 113, 83, (1, 2, 3, 4), 20)]))
def test_cam_f3b_plan_matches_the_kernels(cuda, op, shape):
    """Shared memory and re-laid weight sizes: the C formulas
    (cam_tile.cuh:tile_plan, exported as cam_f{1,2,3}_plan and
    cam_f{1,2,3}b_plan) and the Python ones (ops/cam.py:tile_plan)
    agree, for each tile op."""
    b, h, w, c, dils, hc = shape
    x = torch.empty((b, h, w, c), dtype=torch.bfloat16)
    kh = torch.empty((len(dils), 3, 3, c, hc), dtype=torch.bfloat16)
    geo = cam._geo(x, kh, dils)
    lib = cam._lib(f"cam_{op[:2]}")
    p = cam.tile_plan(op, *shape)
    plan = getattr(lib, f"cam_{op}_plan")
    got = [plan(cam.ctypes.addressof(geo), k) for k in range(4)]
    assert got == [p["smem0"], p["smem1"], p["w0_elems"], p["w1_elems"]]
    if f"cam_{op}_workspace" in cam._WORKSPACE[f"cam_{op[:2]}"]:
        assert getattr(lib, f"cam_{op}_workspace")(
            cam.ctypes.addressof(geo)) > 0


def _refuses_a_halo_that_does_not_fit(device, op,
                                      dils=(1, 2, 3, 4, 5, 6)):
    case = cam_case(1, 16, 16, 163, dils, 40, seed=2, device=device)
    name, kernel, plain, args = cam_calls(case)[TILE_CALLS[op]]
    before = kernel.launches
    with pytest.raises(ValueError, match="shared memory"):
        kernel(*args)
    assert kernel.launches == before


def test_cam_f3b_refuses_a_halo_that_does_not_fit(cuda):
    _refuses_a_halo_that_does_not_fit(cuda, "f3b")


@pytest.mark.parametrize("op", ["f1b", "f2b", "f3", "f1", "f2"])
def test_cam_tile_refuses_a_halo_that_does_not_fit(cuda, op):
    """F1 takes six dilations up to 6 at C = 163 (as F1b's phase 0
    does; F1b's dx kernel does not fit there) and refuses a largest
    dilation of 8."""
    _refuses_a_halo_that_does_not_fit(
        cuda, op, (1, 2, 3, 4, 5, 8) if op == "f1" else (1, 2, 3, 4, 5, 6))


def test_cam_wrappers_refuse(cuda):
    case = cam_case(1, 8, 8, 12, (1, 2), 3, seed=1, device=cuda)
    with pytest.raises(TypeError):
        cam.cam_f1_fwd(case["x"].float(), case["kr"], case["kh"], (1, 2))
    with pytest.raises(ValueError):
        cam.cam_f1_fwd(case["x"], case["kr"], case["kh"], (1, 2, 3))
    wide = torch.zeros((1, 3, 3, 12, 41), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        cam.cam_f1_fwd(case["x"], case["kr"], wide, (1,))


def _tta_cfg():
    """A narrow 17-joint teacher (the flip swaps COCO's joint pairs)."""
    return HRNetConfig(num_joints=17,
                       stage2=StageCfg(1, 2, "BASIC", (1, 1), (8, 16)),
                       stage3=StageCfg(1, 3, "BASIC", (1, 1, 1), (8, 16, 32)),
                       stage4=StageCfg(1, 4, "BASIC", (1, 1, 1, 1),
                                       (8, 16, 32, 64)),
                       deconv_chans=(8,), deconv_num_blocks=1)


@pytest.mark.parametrize("scales", [(1.0,), (0.5, 1.0, 2.0)])
def test_tta_decode_on_the_card_equals_plain(cuda, scales):
    """Flip TTA's D=2 maps decoded on the card (the NMS + top-k and
    lockstep kernels) against the plain decode of the same maps on the
    CPU: the same people within 1e-5; ``predict`` finds as many.  The
    lockstep kernel's self-check at D=2 runs first, so that the launch
    counts hold the decode alone."""
    assert kernel_selfcheck(30, 90, 17, 2, solver="lockstep", device=cuda)
    model = init_random_(PoseHigherHRNet(_tta_cfg()), seed=6).eval()
    pred = PosePredictor(model, device=cuda, input_size=256,
                         dtype=torch.float32, with_flip=True, scales=scales)
    image = (np.random.default_rng(8).random((240, 320, 3)) * 255).astype(
        np.uint8)
    with torch.inference_mode():
        x, _, _ = pred._preprocess(image)
        hms, tags = pred._maps(x[None])
        assert hms.is_cuda and tags.shape[-1] == 34
        before = (nms_topk.launches, match_by_tag_lockstep.launches)
        got = pred.parser.parse_fused_batch(hms, tags)
        torch.cuda.synchronize()
        assert (nms_topk.launches, match_by_tag_lockstep.launches) == (
            before[0] + 1, before[1] + 1)
        want = pred.parser.parse_fused_batch(hms.cpu(), tags.cpu())
    (p_g,), (s_g,) = got
    (p_w,), (s_w,) = want
    assert len(p_g) == len(p_w) > 0
    for a, b in zip(p_g, p_w):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_g, s_w, rtol=1e-5, atol=1e-5)
    people, scores = pred.predict(image)
    assert len(people) == len(scores) == len(p_g)


# ------------------------------------------------------------------ int8

# (cout, cin, k, stride, h, w, transposed): ragged channels (3, 82),
# ragged Cout (17, 34), a pixel count not a multiple of 128, each N tile
QCONV_CASES = [(64, 3, 3, 2, 37, 29, False), (48, 48, 3, 1, 23, 19, False),
               (96, 48, 3, 2, 30, 26, False), (17, 48, 1, 1, 11, 13, False),
               (34, 48, 1, 1, 9, 7, False), (384, 192, 3, 2, 10, 12, False),
               (256, 64, 1, 1, 5, 9, False), (48, 82, 4, 2, 13, 11, True)]


def _qconv_case(key, b, dev, seed=0):
    from rtpe_tpu_torch.ops import quant
    cout, cin, k, _, h, w, tr = key
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    x[..., 0] = 127
    wq = torch.randint(-127, 128, (cin, cout, k, k) if tr else
                       (cout, cin, k, k), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    kernel, c = quant.kernel_layout(wq, tr)
    alpha = torch.rand((2, cout) if tr else (cout,), generator=gen,
                       device=dev) * 1e-3
    q = quant.QConv(kernel, torch.randn(cout, generator=gen, device=dev),
                    alpha, torch.tensor(1.0, device=dev), c, tr)
    return x.permute(0, 3, 1, 2), q


@pytest.mark.parametrize("key", QCONV_CASES)
@pytest.mark.parametrize("b", [1, 3])
def test_qconv_kernel_equals_plain(cuda, key, b):
    from rtpe_tpu_torch.ops import quant
    x, q = _qconv_case(key, b, cuda)
    stride, pad = (2, 1) if key[6] else (key[3], (key[2] - 1) // 2)
    before = quant.qconv.launches
    got = quant.qconv(x, q, stride, pad)
    torch.cuda.synchronize()
    assert quant.qconv.launches == before + 1
    assert torch.equal(got, quant.qconv_plain(x, q, stride, pad))
    cout, cin, k = key[:3]
    assert quant.qconv_plan_c(cin, cout, k, k) == \
        quant.qconv_plan(cin, cout, k, k)


def test_qconv_refuses_what_it_does_not_take(cuda):
    from rtpe_tpu_torch.ops import quant
    x, q = _qconv_case(QCONV_CASES[1], 1, cuda)
    with pytest.raises(ValueError, match="channels_last"):
        quant.qconv(x.contiguous(), q)
    with pytest.raises(ValueError, match="takes x"):
        quant.qconv(x[:, :40], q)
    with pytest.raises(ValueError, match="kernel must be"):
        quant.qconv(x, q._replace(kernel=q.kernel.cpu()))


@pytest.mark.parametrize("int8_act", [False, True])
def test_small_int8_forward_equals_plain_qconv(cuda, int8_act):
    """A small packed int8 forward on the card: bitwise equal to the same
    forward with the plain ``qconv``, every conv launched once."""
    from rtpe_tpu_torch.models import hrnet_packed as packed
    from rtpe_tpu_torch.ops import quant
    cfg = HRNetConfig(num_joints=17,
                      stage2=StageCfg(1, 2, "BASIC", (1, 1), (16, 32)),
                      stage3=StageCfg(1, 3, "BASIC", (1, 1, 1), (16, 32, 64)),
                      stage4=StageCfg(1, 4, "BASIC", (1, 1, 1, 1),
                                      (16, 32, 64, 128)),
                      deconv_chans=(16,), deconv_num_blocks=1)
    state = init_random_(PoseHigherHRNet(cfg), seed=3).state_dict()
    pk = pack_w48_params(state, cfg, torch.bfloat16, cuda)
    x = torch.randn((2, 3, 96, 128), generator=torch.Generator()
                    .manual_seed(1)).to(cuda)
    scales = packed.calibrate_act_scales(pk, [x[:1]], cfg)
    qp = packed.quantize_packed(pk, scales)
    before = quant.qconv.launches
    with torch.inference_mode():
        got = packed.packed_forward(qp, x, cfg, int8_act=int8_act)
        assert quant.qconv.launches == before + len(qp)
        real = packed.qconv
        packed.qconv = quant.qconv_plain
        try:
            want = packed.packed_forward(qp, x, cfg, int8_act=int8_act)
        finally:
            packed.qconv = real
    for g, w in zip(got, want):
        assert torch.equal(g, w)
