"""The port's BasicBlock chain against the JAX package's, on the CPU.

The plain version of ``csrc/basicblock_chain.cu`` (``ops/blocks.py``)
against ``rtpe_tpu.ops.pallas_blocks.basicblock_chain`` run in
interpret mode, on the same numpy inputs:

* float32 on the three shapes of ``tests/test_pallas_blocks.py``, at
  that test's tolerance (rtol 1e-4, atol 1e-5): the two sum each conv in
  another order;
* bf16 activations and weights: both accumulate each conv in float32
  and round at the same points, so they differ only where the order of
  a float32 sum flips a bf16 rounding (2^-8 relative), and such a flip
  carries into the next convs of the chain: every element within
  2^-6 (|want| + 1).

The CUDA wrapper takes the plain version for a CPU tensor, counts no
launch there, and refuses shapes the chain does not have.

The kernel's plan (``chain_plan``, the Python side of
``csrc/basicblock_chain.cu:make_plan``) is checked at every branch
shape of the W48 forward and at ragged and narrow ones: shared memory
fits a block, the N tiles and the K splits cover C and the 9C of the 9
taps once each, and the grid fills the card's 132 SMs wherever the K
steps allow.  A walk of the plan in torch (the kernel's pixel tiles,
N tiles and K steps of 64 over the tap-major flattened K, each split's
float32 partial, the partials summed in split order, then the
epilogue's roundings) equals the plain version bitwise on exact-sum
inputs and is within 2^-5 of max |plain| on random ones.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from rtpe_tpu.ops.pallas_blocks import basicblock_chain as j_chain
from rtpe_tpu_torch.ops.blocks import (basicblock_chain,
                                       basicblock_chain_plain, chain_plan)

BF16_TOL = 2.0 ** -6


def chain_inputs(shape, n, seed=0):
    """The inputs of ``tests/test_pallas_blocks.py``."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32) * 0.1
    w = rng.randn(n, 2, 3, 3, c, c).astype(np.float32) * 0.05
    b = rng.randn(n, 2, c).astype(np.float32) * 0.1
    return x, w, b


@pytest.mark.parametrize("shape,n", [((2, 16, 16, 96), 2),
                                     ((1, 8, 24, 128), 4),
                                     ((2, 12, 8, 192), 1)])
def test_plain_chain_matches_pallas_interpret(shape, n):
    x, w, b = chain_inputs(shape, n)
    want = np.asarray(j_chain(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), interpret=True))
    before = basicblock_chain.launches
    got = basicblock_chain(*(torch.from_numpy(a) for a in (x, w, b)))
    assert basicblock_chain.launches == before      # CPU: plain version
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,n", [((2, 10, 12, 32), 2),
                                     ((1, 6, 7, 64), 4)])
def test_plain_chain_matches_pallas_interpret_in_bf16(shape, n):
    rng = np.random.default_rng(1)
    c = shape[-1]
    # activations of order 1 through the chain
    xb = rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    wb = (rng.normal(size=(n, 2, 3, 3, c, c)) / np.sqrt(9 * c)).astype(
        ml_dtypes.bfloat16)
    b = (rng.normal(size=(n, 2, c)) * 0.1).astype(np.float32)
    want = np.asarray(j_chain(jnp.asarray(xb), jnp.asarray(wb),
                              jnp.asarray(b), interpret=True),
                      np.float32)
    got = basicblock_chain_plain(
        torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(wb.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert 0.5 < np.abs(want).max() < 50
    assert (np.abs(got - want) <= BF16_TOL * (np.abs(want) + 1)).all(), \
        np.abs(got - want).max()
    # most elements agree exactly: only flipped roundings differ
    assert (got == want).mean() > 0.9


def test_plain_chain_takes_a_channels_last_view():
    """The packed forward hands the chain the NHWC view of its
    channels_last NCHW activations."""
    x, w, b = (torch.from_numpy(a) for a in chain_inputs((2, 5, 6, 32), 2))
    nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    view = nchw.permute(0, 2, 3, 1)
    assert view.data_ptr() == nchw.data_ptr() and view.is_contiguous()
    assert torch.equal(basicblock_chain(view, w, b),
                       basicblock_chain(x, w, b))


def test_chain_refuses_bad_shapes_and_devices():
    x, w, b = (torch.from_numpy(a) for a in chain_inputs((1, 4, 4, 32), 2))
    with pytest.raises(ValueError):
        basicblock_chain(x, w[:, :1], b)
    with pytest.raises(ValueError):
        basicblock_chain(x, w, b[:1])
    with pytest.raises(ValueError):
        basicblock_chain(x[0], w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        basicblock_chain(x.to("meta"), w.to("meta"), b.to("meta"))


# (B, H, W, C): the W48 forward's three chain shapes at 640 x 640, then
# ragged, narrow and other channel counts the kernel takes
W48_BRANCHES = [(80, 80, 96), (40, 40, 192), (20, 20, 384)]
PLAN_SHAPES = ([(b, *hwc) for hwc in W48_BRANCHES for b in (1, 2, 8)]
               + [(2, 12, 20, 96), (1, 3, 5, 32), (2, 7, 9, 64),
                  (1, 8, 24, 128), (3, 33, 17, 160), (1, 1, 1, 96),
                  (16, 160, 160, 32), (1, 20, 20, 288)])


def split_steps(plan):
    """The K-step range [s0, s1) of each split, in split order, as
    ``basicblock_chain.cu:conv3x3_kernel`` takes split z's."""
    n, s = plan["nsteps"], plan["splits"]
    return [(k * n // s, (k + 1) * n // s) for k in range(s)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_chain_plan_covers_and_fills_the_card(shape):
    b, h, w, c = shape
    p = chain_plan(b, h, w, c)
    m = b * h * w
    assert p["smem"] <= 232448
    # N tiles: a wgmma width that tiles C exactly
    assert p["bn"] in (192, 96, 64, 32) and p["bn"] * p["tiles_n"] == c
    assert p["bn"] == max(v for v in (192, 96, 64, 32) if c % v == 0)
    # pixel tiles of 128 rows (256 where BN <= 96: two m64 tiles a
    # warpgroup) cover the flattened pixels once
    assert p["bm"] == (256 if p["bn"] <= 96 and -(-m // 256) * p["tiles_n"]
                       >= 132 else 128)
    assert (p["tiles_m"] - 1) * p["bm"] < m <= p["tiles_m"] * p["bm"]
    # K steps of 64 cover the 9 taps x C once, the splits the steps once
    assert (p["nsteps"] - 1) * 64 < 9 * c <= p["nsteps"] * 64
    ranges = split_steps(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p["nsteps"]
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    assert all(s1 - s0 >= 2 for s0, s1 in ranges) or p["splits"] == 1
    # the grid fills one wave of the card: a split only where the tiles
    # alone leave SMs idle, and as many as stay within the 132 SMs (or as
    # the steps allow)
    base = p["tiles_m"] * p["tiles_n"]
    assert p["blocks"] == base * p["splits"]
    if p["splits"] > 1:
        assert p["blocks"] <= 132
    assert (p["blocks"] >= 132 or base * (p["splits"] + 1) > 132
            or p["splits"] == max(1, p["nsteps"] // 2))
    assert p["ws_bytes"] == (4 * p["splits"] * m * c if p["splits"] > 1
                             else 0)


def test_chain_plan_at_the_w48_shapes():
    """At B=1 the pixel tiles alone leave the card idle: 50, 13 and 8
    blocks for the three branch shapes; the plan splits K 2, 10 and 16
    ways (100, 130 and 128 blocks).  At B=8: 200 tiles of 256 pixels at
    80 x 80 x 96, 100 tiles unsplit at 40 x 40 x 192, 2 splits of 50 at
    20 x 20 x 384."""
    got = [(p["bm"], p["tiles_m"] * p["tiles_n"], p["splits"])
           for p in (chain_plan(b, *hwc) for b in (1, 8)
                     for hwc in W48_BRANCHES)]
    assert got == [(128, 50, 2), (128, 13, 10), (128, 8, 16),
                   (256, 200, 1), (128, 100, 1), (128, 50, 2)]


def test_chain_plan_refuses_what_the_kernel_does_not_take():
    for shape in ((1, 4, 4, 48), (1, 4, 4, 0), (0, 4, 4, 32)):
        with pytest.raises(ValueError):
            chain_plan(*shape)


def _conv_walk(x, wt, bias, res):
    """One conv as the kernel computes it under its plan: per pixel
    tile, per N tile and per split of the K steps (tap-major, 64 at a
    time, zero past 9C), the float32 partial; the partials summed in
    split order; then the bias and one rounding to bf16, with ReLU, or
    (res given) the bf16 residual add and ReLU."""
    b, h, w, c = x.shape
    p = chain_plan(b, h, w, c)
    m, kp = b * h * w, p["nsteps"] * 64
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ty:ty + h, tx:tx + w] for ty in range(3)
                      for tx in range(3)], -1).reshape(m, 9 * c)
    a = F.pad(cols, (0, kp - 9 * c))
    bm = F.pad(wt.float().reshape(9 * c, c), (0, 0, 0, kp - 9 * c))
    acc = torch.zeros(m, c)
    for t in range(p["tiles_m"]):
        r0, r1 = t * p["bm"], min(m, (t + 1) * p["bm"])
        for j in range(p["tiles_n"]):
            n0, n1 = j * p["bn"], (j + 1) * p["bn"]
            tile = None
            for s0, s1 in split_steps(p):
                part = a[r0:r1, s0 * 64:s1 * 64] @ bm[s0 * 64:s1 * 64, n0:n1]
                tile = part if tile is None else tile + part
            acc[r0:r1, n0:n1] = tile
    y = (acc + bias.float()).reshape(b, h, w, c)
    if res is None:
        return torch.relu(y).to(torch.bfloat16)
    return torch.relu(y.to(torch.bfloat16).float()
                      + res.float()).to(torch.bfloat16)


def _chain_walk(x, weights, biases):
    cur = x
    for i in range(weights.shape[0]):
        y = _conv_walk(cur, weights[i, 0], biases[i, 0], None)
        cur = _conv_walk(y, weights[i, 1], biases[i, 1], cur)
    return cur


def _chain_case(shape, n, seed, exact):
    """bf16 chain inputs made with numpy: small integers times powers of
    two (every conv sum exact in float32), or normal ones scaled to keep
    the activations of order 1."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    if exact:
        x = rng.integers(-4, 5, shape) * 1.0
        w = rng.integers(-1, 2, (n, 2, 3, 3, c, c)) / 64.0
        b = rng.integers(-8, 9, (n, 2, c)) / 64.0
    else:
        x = rng.normal(size=shape)
        w = rng.normal(size=(n, 2, 3, 3, c, c)) / np.sqrt(3 * c)
        b = rng.normal(size=(n, 2, c)) * 0.1
    return (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(b.astype(np.float32)))


WALK_CASES = [((1, 6, 7, 96), 2), ((2, 10, 12, 32), 2), ((1, 5, 9, 192), 1),
              ((1, 4, 5, 384), 1), ((2, 9, 15, 64), 2)]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
@pytest.mark.parametrize("shape,n", WALK_CASES)
def test_chain_plan_walk_matches_plain(shape, n, exact):
    x, w, b = _chain_case(shape, n, sum(shape) + n, exact)
    p = chain_plan(*shape)
    assert p["splits"] > 1                     # the split path is walked
    got = _chain_walk(x, w, b)
    want = basicblock_chain_plain(x, w, b)
    assert got.dtype == want.dtype == torch.bfloat16
    if exact:
        assert float(want.float().abs().max()) > 2
        assert torch.equal(got, want)
    else:
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) \
            <= 2.0 ** -5 * scale
