"""F2 on ``csrc/cam_wg.cuh`` on the CPU: ``f2_wg_kernel``, the
``WG_F2`` mode of ``fwd_wg_body``, which runs F2 at every geometry (the
train step's CAMs at ``--inplanes`` 80, every wider one, six dilations
up to 8).

* The plan (``ops/cam.py:_wg_plan`` for "f2"; the C side's
  ``make_fplan``, exported by ``cam_wg.cuh:op_plan``) at the width grid of
  ``tests/test_torch_cam_wide.py``: within a block's shared memory as the
  kernel carves it (a and bnh where they fit, F1's column-sum scratch
  after the rows), its stage count as the producer warp walks it (F2b's
  products without the branch backward), at ``--inplanes`` 128 and at
  the train step's shapes x's halo staged once a tile; a largest
  dilation refused exactly where the ops' limit refuses it.
* The re-laid weights (``ops/cam.py:_wg_weights``), stage by stage in the
  order the producer warp copies them, give back kh and kt with zero
  padding, and are the prefix of F2b's before its kt[i]^T stages.
* A walk of the kernel's stages over every pixel of the tiles (the image
  zero-extended to whole 8 x 8 tiles, as the halo copies fill it) with
  its epilogue (a = bf16(relu(BN_h(bf16(c)))), t = bf16(a kt) after each
  64-column chunk, the sums of t and t^2 over each tile's pixels in the
  image, the tiles' rows summed in tile order) bitwise
  ``cam_f2_fwd_plain`` on exact sums (the halo whole and in K chunks, two
  branch slices with a and bnh out of shared memory, ragged tiles; the
  train step's widths and the first design's walk shapes), and within
  ``tests/test_torch_cam.py``'s tolerance of the interpret-mode
  ``_f2_call`` on random inputs at C = 195, hc = 48 on a ragged image,
  where leaving the padding pixels unmasked is off by more than that
  (bitwise on exact sums at the train step's widths).

On the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 17)
the kernel itself is held to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtpe_tpu.ops import pallas_cam as pc
from rtpe_tpu_torch.ops import cam
from test_torch_cam import F32_TOL, _inputs
from test_torch_cam_tile import _ints, _jx, first_design_fits
from test_torch_cam_tile import _weights as _exact_weights
from test_torch_cam_wg import TRAIN_WALKS, Reader, a_stages, x_stages
from test_torch_cam_wgb import _bn, _check_block
from test_torch_cam_wgb0 import branch_walk
from test_torch_cam_wide import GRID, WEIGHT_SHAPES, _weights

TRAIN = {"steps", "pyramid"}
TS, TP = cam.TILE_TS, cam.TILE_TP
# the smallest image of each kind of plan: the step CAMs of --inplanes
# 128 and 96 (the halo whole, a and bnh in shared memory; 9 x 10 and
# 9 x 13 pixels on ragged tiles), x in K chunks (a dilation of 12, and a
# wider branch beside an 11), the step CAM of 256 (K chunks, 128-column
# branches), and a branch of 256 columns (two slices; a and bnh out of
# shared memory); the train step's widths on small images and the first
# design's walk shapes
WALK_SHAPES = {"step128": (1, 9, 10, 259, (1, 2, 3), 64),
               "step96": (2, 9, 13, 195, (1, 2, 3), 48),
               "chunks": (1, 11, 10, 150, (1, 12), 20),
               "chunks_slices": (2, 9, 9, 100, (2, 11, 3), 44),
               "step256": (1, 9, 8, 515, (1, 2, 3), 128),
               "slices": (1, 9, 10, 16, (1, 1, 1, 1, 1, 10), 256),
               "steps": (1, 9, 10, 163, (1, 2, 3), 40),
               "pyramid": (2, 9, 13, 83, (1, 2, 3, 4), 20),
               "tile0": (2, 9, 13, 12, (1, 2, 3, 4), 3),
               "tile1": (1, 5, 30, 70, (1, 2, 3), 20),
               "tile2": (1, 11, 19, 12, (1, 9), 3),
               "tile3": (1, 9, 10, 170, (1, 2), 8)}
bf = cam._bf


def stages(p, nb):
    """The kernel's weight stages in the producer's order (``cam_wg.cuh:
    fwd_produce``): (kind, k0, kw, n, branch, slice, tap, 1x1 chunk); the
    branch convs ("br"), then per 1x1 chunk a's stages ("top"): F2b's
    (``tests/test_torch_cam_wgb0.py``) before its branch backward."""
    out = []
    for i in range(nb):
        for sl in range(p["nsl"]):
            for chunk in x_stages(p):
                for tap in range(9):
                    out += [("br", k0, kw, p["sw"], i, sl, tap, None)
                            for k0, kw in chunk]
    for ch in range(p["nch1"]):
        out += [("top", k0, kw, cam.WG_N1, None, None, None, ch)
                for k0, kw in a_stages(p)]
    return out


@pytest.mark.parametrize("name", sorted(GRID))
def test_wgf2_plan_fits_every_width(name):
    """F2 at every shape of the width grid: the wgmma plan within SMEM_MAX as
    the kernel carves it (the mbarriers, x's halo chunk, a where it fits, bnh
    where it fits, F1's column-sum scratch, FNS ring slots), its stage count as
    the producer walks it, whole branches of up to 128 columns, x's stages
    covering kc and a's knh; at --inplanes 128 (step128) and at the train
    step's shapes x's halo staged once a tile, a and bnh in shared memory."""
    b, h, w, c, dils, hc = shape = GRID[name]
    nb, nh = len(dils), len(dils) * hc
    p = cam.tile_plan("f2", *shape)
    assert p["ok"]
    assert p["wg"] and not p["dx_wg"]
    assert p["ntb"] in cam.WG_NTB and p["sw"] == 8 * p["ntb"] <= 128
    assert p["nsl"] * p["sw"] >= hc > (p["nsl"] - 1) * p["sw"]
    assert p["nsl"] == 1                        # the grid's branches whole
    kc, kq, kb, knh, hr = p["kc"], p["kq"], p["kb"], p["knh"], p["hr"]
    assert kq % 16 == 0 and kb % 16 == 0 and 0 < kb <= kq
    assert sum(kw for ch in x_stages(p) for _, kw in ch) == kc
    assert p["kqa"] % 16 == 0 and sum(kw for _, kw in a_stages(p)) == knh
    assert p["kbd"] == p["nd"] == 0             # no branch backward
    nw = max(p["sw"], cam.WG_N1)
    smem = (cam.WG_BAR + 2 * hr * kq + (2 * TP * knh if p["a_res"] else 0)
            + (4 * 4 * nh if p["rows_smem"] else 0) + 4 * cam.WG_RED
            + 2 * cam.WG_NS * max(kb, p["kqa"]) * nw)
    assert p["smem0"] == smem <= cam.SMEM_MAX
    assert p["wg_nst"] == len(stages(p, nb))
    assert p["w0_elems"] == (9 * nb * kc * p["sw"]
                             + p["nch1"] * cam.WG_N1 * knh)
    assert p["w1_elems"] == p["smem1"] == 0
    if name in TRAIN | {"step128"}:
        assert p["nq"] == 1 and kq == kc            # the halo once a tile
        assert p["a_res"] and p["rows_smem"]


def test_wgf2_plan_refuses_what_the_wide_plan_refuses():
    """Over C, branch widths and largest dilations: F2 is taken exactly
    where the first design's tile plans took it (``test_torch_cam_tile.
    py:first_design_fits``, the ops' limit), and there gets the wgmma
    plan within SMEM_MAX; at C = 163 a largest dilation of 19 is taken
    and 20 refused."""
    for c, hc in ((16, 8), (163, 40), (515, 128), (1030, 256)):
        for d in range(1, 24):
            shape = (1, 16, 16, c, (1, d), hc)
            p = cam.tile_plan("f2", *shape)
            assert bool(p["ok"]) == first_design_fits("f2", shape), \
                (c, hc, d)
            if p["ok"]:
                assert p["wg"] and p["smem0"] <= cam.SMEM_MAX
    assert cam.tile_plan("f2", 1, 16, 16, 163, (1, 19), 40)["ok"]
    assert not cam.tile_plan("f2", 1, 16, 16, 163, (1, 20), 40)["ok"]


@pytest.mark.parametrize("name", sorted(WEIGHT_SHAPES))
def test_wgf2_weights_unpad_to_the_inputs(name):
    """Each stage of ``_wg_weights("f2", ...)`` (read as the producer
    copies them, [n / 8][kw][8]) is its slice of kh[i, tap] (a branch
    slice's columns), then of kt.reshape(NH, C) (64 output columns of a
    1x1 chunk), zero past C, hc and NH; the last stage ends w0.  On F2b's
    plan F2's layout is the prefix of F2b's w0 (before its kt[i]^T
    stages)."""
    b, h, w, c, dils, hc = shape = WEIGHT_SHAPES[name]
    nb, nh = len(dils), len(dils) * hc
    p = cam.tile_plan("f2", *shape)
    assert p["wg"]
    _, kh, kt = _weights(c, nb, hc, 3)
    w0, w1 = cam._tile_weights("f2", None, kh, kt, p)
    assert w0.numel() == p["w0_elems"] and w1 is None
    rd = Reader(w0)
    ktf = kt.reshape(nh, c)
    kinds = []
    for kind, k0, kw, n, i, sl, tap, ch in stages(p, nb):
        assert kw % 16 == 0 and n % 8 == 0 and (2 * rd.off) % 16 == 0
        block = rd.take(kw, n)
        kinds.append(kind)
        if kind == "br":
            _check_block(block, kh[i, tap // 3, tap % 3], k0, sl * p["sw"])
        else:
            _check_block(block, ktf, k0, ch * cam.WG_N1)
    assert rd.off == w0.numel()
    assert kinds.count("top") == p["nch1"] * len(a_stages(p))
    pb = cam.tile_plan("f2b", *shape)
    f2 = cam._wg_weights("f2", pb, None, kh, kt)
    f2b = cam._wg_weights("f2b", pb, None, kh, kt)
    assert f2b.numel() > f2.numel()
    assert torch.equal(f2b[:f2.numel()], f2)


# ------------------------------------------------------------ the walk


def f2_walk(shape, k, masked=True):
    """F2 by f2_wg_kernel's stages over every pixel of the tile grid (the
    image zero-extended to whole tiles): the branch convs, a =
    bf16(relu(BN_h(bf16(c)))) (zero at a pixel outside the image where
    the plan restages a from its global rows, which hold only the image's
    pixels), per 1x1 chunk t over a's stages of kt, then each tile's row
    [sum t | sum t^2] over its pixels in the image (``masked``; else over
    all 64) and the rows summed in tile order.  Returns (s_t,)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    p = cam.tile_plan("f2", *shape)
    assert p["wg"]
    w0, _ = cam._tile_weights("f2", None, k["kh"], k["kt"], p)
    rd = Reader(w0)
    hp, wp = -(-h // TS) * TS, -(-w // TS) * TS
    ext = (b, hp, wp) + shape[3:]
    xe = F.pad(k["x"], (0, 0, 0, wp - w, 0, hp - h))
    cs, _ = branch_walk(ext, dict(k, x=xe), p, rd)
    inside = torch.zeros(b, hp, wp, 1)
    inside[:, :h, :w] = 1.0
    a = torch.cat([bf(torch.relu(_bn(cv, k["bnh"], i)))
                   for i, cv in enumerate(cs)], -1)
    if not p["a_res"]:
        a = a * inside
    ap = F.pad(a, (0, p["knh"] - nb * hc))
    top = []
    for _ in range(p["nch1"]):
        at = torch.zeros(b, hp, wp, cam.WG_N1)
        for k0, kw in a_stages(p):
            at += ap[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
        top.append(at)
    assert rd.off == w0.numel()
    t = bf(torch.cat(top, -1)[..., :c])
    if masked:
        t = t * inside
    # (b, tiles_y, TS, tiles_x, TS, c) -> one row a tile, image-major
    tiles = t.reshape(b, hp // TS, TS, wp // TS, TS, c)
    tiles = tiles.permute(0, 1, 3, 2, 4, 5).reshape(-1, TP, c)
    part = torch.cat([tiles.sum(1), (tiles * tiles).sum(1)], 1)
    assert part.shape[0] == p["n_tiles"]
    s_t = torch.zeros(2 * c)
    for row in part:                     # reduce_rows: in tile order
        s_t = s_t + row
    return (s_t.reshape(2, c),)


def _exact_case(shape, seed):
    """Exact-sum inputs of F2: x and kh in {-1, 0, 1} (x three quarters
    zero), kt the same with half of it zero, BN rows of integers with
    inv = scale = 1, so a and t are integers and every sum of t and of
    t^2 over the image's pixels is exact in float32 at the walk's
    shapes (the test checks it against float64)."""
    b, h, w, c, dils, hc = shape
    _, kh, kt = _exact_weights(shape, seed)
    rng = np.random.default_rng(seed + 1)
    x = _ints(rng, -1, 2, b, h, w, c) * (_ints(rng, 0, 4, b, h, w, c) == 0)
    kt = kt * (_ints(rng, 0, 2, *kt.shape) == 0)
    rows = []
    for _ in dils:
        rows += [_ints(rng, -2, 3, hc), torch.ones(hc), torch.ones(hc),
                 _ints(rng, -1, 2, hc)]
    return {"x": x.to(torch.bfloat16), "kh": kh, "kt": kt.to(torch.bfloat16),
            "bnh": torch.stack(rows)}


@pytest.mark.parametrize("name", sorted(WALK_SHAPES))
def test_wgf2_walk_matches_the_plain_forward(name):
    """The walk on exact-sum inputs: s_t bitwise ``cam_f2_fwd_plain``'s,
    at plans with x's halo whole (step128, step96), in K chunks (chunks,
    chunks_slices, step256) and two branch slices with a and bnh out of
    shared memory (slices), each on ragged tiles (an image side not a
    multiple of 8), whose padding pixels the walk masks: where the plan
    keeps a in shared memory their t is not zero, and the walk without
    the mask is not the plain version's."""
    b, h, w, c, dils, hc = shape = WALK_SHAPES[name]
    p = cam.tile_plan("f2", *shape)
    assert p["wg"]
    assert h % TS or w % TS
    if name in ("step128", "step96"):
        assert p["nq"] == 1 and p["a_res"] and p["rows_smem"]
    if name in ("chunks", "chunks_slices", "step256"):
        assert p["nq"] > 1
    if name == "slices":
        assert p["nsl"] == 2 and not (p["a_res"] or p["rows_smem"])
    k = _exact_case(shape, 12)
    args = (k["x"], k["kh"], k["kt"], k["bnh"], dils)
    want = cam.cam_f2_fwd_plain(*args)
    assert torch.equal(want.double(),
                       cam.cam_f2_fwd_plain(*args, dtype=torch.float64))
    got = f2_walk(shape, k)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool((want != 0).all())
    assert torch.equal(got, want)
    if p["a_res"]:
        assert not torch.equal(f2_walk(shape, k, masked=False)[0], want)


def test_wgf2_walk_matches_pallas_interpret():
    """The walk against the TPU kernel it replaces (``pallas_cam.py:
    _f2_call``, interpret mode) on random inputs at C = 195, hc = 48
    (--inplanes 96's step CAM; one whole 48-column branch a wgmma) on a
    ragged image (13 x 11: 40 % of the tile grid's pixels outside it):
    s_t within 1e-5 of its largest magnitude (``tests/test_torch_cam.py``'s
    tolerance for F2).  A padding pixel's t is not zero (its BN bias and
    dilated taps reach into the image): the same walk with them unmasked
    is off by more than that."""
    shape = (2, 13, 11, 195, (1, 2, 3), 48)
    assert cam.tile_plan("f2", *shape)["wg"]
    inp = _inputs(*shape, seed=sum(shape[:4]) + 7)
    k = {n: torch.from_numpy(inp[n]) for n in ("x", "kh", "kt", "bnh")}
    for n in ("x", "kh", "kt"):
        k[n] = k[n].to(torch.bfloat16)
    got = f2_walk(shape, k)[0]
    want = pc._f2_call(*[_jx(k[n]) for n in ("x", "kh", "kt", "bnh")],
                       shape[4])
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= F32_TOL * scale
    unmasked = f2_walk(shape, k, masked=False)[0]
    assert float((unmasked - want).abs().max()) > F32_TOL * scale


@pytest.mark.parametrize("name", sorted(TRAIN_WALKS))
def test_wgf2_walk_matches_pallas_interpret_at_train_widths(name):
    """The walk against ``_f2_call`` (interpret mode) at the train step's
    widths (C = 163, hc = 40; C = 83, hc = 20) on a ragged image, on
    exact-sum inputs: s_t bitwise."""
    shape = TRAIN_WALKS[name]
    assert cam.tile_plan("f2", *shape)["wg"]
    k = _exact_case(shape, 13)
    got = f2_walk(shape, k)[0]
    want = pc._f2_call(*[_jx(k[n]) for n in ("x", "kh", "kt", "bnh")],
                       shape[4])
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape and bool((want != 0).any())
    assert torch.equal(got, want)
