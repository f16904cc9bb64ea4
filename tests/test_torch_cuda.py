"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and needs an NVIDIA GPU and ``nvcc``;
without them each one
skips with that reason (decided in a fixture, never at import).  On a
machine with the card, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

They cover what ``chip_smoke.py``'s main-path shapes do not: planes whose
size is not a multiple of the NMS tile, other pooling windows, more
than one tag dimension, LAP matrices of every size the kernel takes,
NaN tags in the grouping kernels, BasicBlock chains at ragged and
narrow shapes, a small packed forward with its chains on the kernel,
and the checks the wrappers make.

Chain tolerance: the kernel and its plain version (float32 convolutions,
TF32 off) differ only in the order of each conv's float32 sum.  On
inputs whose every sum is exact in float32 (small integers times powers
of two) they must be bitwise equal.  On random inputs the order flips
some bf16 roundings (2^-8 relative) and each flip carries into the next
convs of the chain, so the worst element must lie within 2^-5 of the
output's largest magnitude (4 bf16 ulps there).
"""

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.device import set_tf32
from rtpe_tpu_torch.models.hrnet import (HRNetConfig, PoseHigherHRNet,
                                         StageCfg, init_random_)
from rtpe_tpu_torch.models.hrnet_packed import pack_w48_params, packed_forward
from rtpe_tpu_torch.ops.blocks import basicblock_chain, basicblock_chain_plain
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
                                             (3, 17, 30, 2, 30, 90)])
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
                                     ((2, 7, 9, 64), 2)])
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
