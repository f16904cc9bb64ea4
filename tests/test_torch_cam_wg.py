"""The wgmma forwards F1 and F3 (``csrc/cam_wg.cuh``) on the CPU: the
kernels that run F1 and F3 at every geometry (the train step's CAMs at
``--inplanes`` 80, every wider one, six dilations up to 8).

* The plan (``ops/cam.py:_wg_plan``, the C side's ``make_fplan``) at the
  width grid of ``tests/test_torch_cam_wide.py``: within a block's
  shared memory, whole branches (up to 128 columns) a slice, the x halo
  in as few K chunks as fit (one at the train step's shapes and at
  ``--inplanes`` 128: staged once a tile), a and the BN rows in shared
  memory there.
* The re-laid weights (``ops/cam.py:_wg_weights``), stage by stage in
  the order the producer warp copies them (a model of
  ``cam_wg.cuh:fwd_produce``), give back kr, kh and kt with zero
  padding, each stage in wgmma's N-major core matrices.
* A walk of the kernels' stages over every pixel (whole-branch N, the
  halo's K chunks and their stages, the taps, then the 1x1 convs from x
  and from a) with the kernels' epilogues, bitwise the plain versions on
  exact sums (the halo at full depth and in chunks, branch slices, a
  and the rows out of shared memory; the train step's widths, C = 163,
  hc = 40 and C = 83, hc = 20, and the first design's walk shapes: small
  C and hc, a dilation of 9 past a tile side), and within ``tests/
  test_torch_cam.py``'s tolerances of the interpret-mode ``_f1_call`` /
  ``_f3_call`` on random inputs at C = 195, hc = 48 and at the train
  step's widths.

On the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 17)
the kernels themselves are held to the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtpe_tpu.ops import pallas_cam as pc
from rtpe_tpu_torch.ops import cam
from test_torch_cam import BF16_TOL, F32_TOL, _inputs
from test_torch_cam_tile import _forward_args, _forward_case, _jx
from test_torch_cam_wide import GRID, WEIGHT_SHAPES

OPS = ("f1", "f3")
TRAIN = {"steps", "pyramid"}
# the smallest image of each kind of plan: the step CAM of --inplanes 128
# (halo at full depth, a in shared memory), 96, x in K chunks (a dilation
# of 12), the step CAM of 256 (K chunks, 128-column branches), and a
# branch of 256 columns (two slices; F3 keeps a and the BN rows out of
# shared memory); the train step's widths (hc 40: 48 columns, hc 20: 32,
# a slice's n8 tiles 6 and 4) on small images, and the first design's
# walk shapes (C = 12, hc = 3 at four dilations and beside a dilation of
# 9; C = 70, 170)
WALK_SHAPES = {"step128": (1, 9, 10, 259, (1, 2, 3), 64),
               "step96": (2, 9, 13, 195, (1, 2, 3), 48),
               "chunks": (1, 11, 10, 150, (1, 12), 20),
               "step256": (1, 9, 8, 515, (1, 2, 3), 128),
               "slices": (1, 9, 10, 16, (1, 1, 1, 1, 1, 10), 256),
               "steps": (1, 9, 10, 163, (1, 2, 3), 40),
               "pyramid": (2, 9, 13, 83, (1, 2, 3, 4), 20),
               "tile0": (2, 9, 13, 12, (1, 2, 3, 4), 3),
               "tile1": (1, 5, 30, 70, (1, 2, 3), 20),
               "tile2": (1, 11, 19, 12, (1, 9), 3),
               "tile3": (1, 9, 10, 170, (1, 2), 8)}
# the train step's widths on small ragged images, against Pallas
TRAIN_WALKS = {"steps": (1, 9, 11, 163, (1, 2, 3), 40),
               "pyramid": (1, 9, 11, 83, (1, 2, 3, 4), 20)}


def by_op(names, ops=OPS):
    return [pytest.param(op, n, id=f"{op}-{n}") for op in ops for n in names]


def x_stages(p):
    """x's K stages in the kernels' order, per chunk of kq: (first k,
    width), each at most kb wide."""
    kc, kq, kb = p["kc"], p["kq"], p["kb"]
    out = []
    for q in range(-(-kc // kq)):
        wq = min(kq, kc - q * kq)
        out.append([(q * kq + u, min(kb, wq - u)) for u in range(0, wq, kb)])
    return out


def a_stages(p):
    return [(v, min(p["kqa"], p["knh"] - v))
            for v in range(0, p["knh"], p["kqa"])]


def stages(op, p, nb):
    """Every weight stage of a tile in the producer's order: (kind, k0,
    kw, n, branch, slice, tap, 1x1 chunk)."""
    out = []
    for i in range(nb):
        for sl in range(p["nsl"]):
            for chunk in x_stages(p):
                for tap in range(9):
                    out += [("br", k0, kw, p["sw"], i, sl, tap, None)
                            for k0, kw in chunk]
    for ch in range(p["nch1"]):
        out += [("res", k0, kw, cam.WG_N1, None, None, None, ch)
                for chunk in x_stages(p) for k0, kw in chunk]
        if op == "f3":
            out += [("top", k0, kw, cam.WG_N1, None, None, None, ch)
                    for k0, kw in a_stages(p)]
    return out


class Reader:
    """Reads w0 stage after stage as the bulk copies do: a stage of kw x n
    is the next kw n elements, [n / 8][kw][8]."""

    def __init__(self, w0):
        self.w0, self.off = w0, 0

    def take(self, kw, n):
        blk = self.w0[self.off:self.off + kw * n]
        self.off += kw * n
        return blk.reshape(n // 8, kw, 8).transpose(0, 1).reshape(kw, n)


@pytest.mark.parametrize("op,name", by_op(GRID))
def test_wg_plan_fits_every_width(op, name):
    """F1 and F3 at every shape of the width grid: the wgmma plan within
    SMEM_MAX, its shared memory and stage count as the kernels carve and
    walk them, whole branches of up to 128 columns, x's K chunks and
    stages covering kc; at the train step's shapes and at --inplanes 128
    (step128) the halo staged once at full depth, a and the BN rows in
    shared memory."""
    b, h, w, c, dils, hc = shape = GRID[name]
    nb = len(dils)
    p = cam.tile_plan(op, *shape)
    assert p["ok"]
    assert p["wg"] and p["smem0"] <= cam.SMEM_MAX
    assert p["ntb"] in cam.WG_NTB and p["sw"] == 8 * p["ntb"] <= 128
    assert p["nsl"] * p["sw"] >= hc > (p["nsl"] - 1) * p["sw"]
    assert p["nsl"] == 1                        # the grid's branches whole
    kc, kq, kb, knh = p["kc"], p["kq"], p["kb"], p["knh"]
    assert kq % 16 == 0 and kb % 16 == 0 and 0 < kb <= kq
    assert sum(kw for ch in x_stages(p) for _, kw in ch) == kc
    nw = max(p["sw"], cam.WG_N1)
    hr = p["hr"]
    rows = 4 * (9 * c + 4 * nb * hc) if op == "f3" and p["rows_smem"] else 0
    smem = (cam.WG_BAR + 2 * hr * kq
            + (2 * 64 * knh if p["a_res"] else 0)
            + (rows if op == "f3" else 4 * cam.WG_RED)
            + 2 * cam.WG_NS * max(kb, p["kqa"]) * nw)
    assert p["smem0"] == smem
    assert p["wg_nst"] == len(stages(op, p, nb))
    if op == "f3":
        assert p["kqa"] % 16 == 0 and sum(kw for _, kw in a_stages(p)) == knh
    else:
        assert p["kqa"] == 0 and not p["a_res"] and not p["rows_smem"]
    if name in TRAIN | {"step128"}:
        assert p["nq"] == 1 and kq == kc            # the halo once a tile
        assert p["a_res"] == p["rows_smem"] == (op == "f3")


@pytest.mark.parametrize("op,name", by_op(WEIGHT_SHAPES))
def test_wg_weights_unpad_to_the_inputs(op, name):
    """Each stage of ``_wg_weights`` (read as the producer copies them)
    is its slice of kh[i, tap] (the branch's slice columns), kr or
    kt.reshape(NH, C) (64 output columns of a 1x1 chunk), with zeros past
    C, hc and NH; the last stage ends w0."""
    b, h, w, c, dils, hc = shape = WEIGHT_SHAPES[name]
    nb, nh = len(dils), len(dils) * hc
    p = cam.tile_plan(op, *shape)
    assert p["wg"]
    rng = np.random.default_rng(3)

    def draw(*s):
        return torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).to(torch.bfloat16)

    kr, kh, kt = draw(c, c), draw(nb, 3, 3, c, hc), draw(nb, hc, c)
    w0, w1 = cam._tile_weights(op, kr, kh, kt if op == "f3" else None, p)
    assert w1 is None and w0.numel() == p["w0_elems"]
    rd = Reader(w0)

    def check(block, src, k0, n0):
        """block (kw, n) against src[k0:, n0:] where it lies inside src,
        zero elsewhere."""
        want = torch.zeros_like(block)
        part = src[k0:k0 + block.shape[0], n0:n0 + block.shape[1]]
        want[:part.shape[0], :part.shape[1]] = part
        assert torch.equal(block, want)

    ktf = kt.reshape(nh, c)
    for kind, k0, kw, n, i, sl, tap, ch in stages(op, p, nb):
        assert kw % 16 == 0 and n % 8 == 0 and (2 * rd.off) % 16 == 0
        block = rd.take(kw, n)
        if kind == "br":
            check(block, kh[i, tap // 3, tap % 3], k0, sl * p["sw"])
        else:
            check(block, kr if kind == "res" else ktf, k0, ch * cam.WG_N1)
    assert rd.off == w0.numel()


def wg_walk(op, shape, k):
    """F1's (s_r, s_h, gap) or F3's (out,) by the kernels' stages over
    every pixel: per branch slice, acc += (x shifted by the tap, K stage)
    . the stage's weights over x's chunks, taps and stages; per 1x1 chunk
    the same over x's stages (kr) and a's (kt); then the epilogues
    (bf16 of each conv; F1 its masked sums, F3 a = bf16(relu(BN_h)),
    relu(relu(BN_r) + relu(BN_t) gate))."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    p = cam.tile_plan(op, *shape)
    assert p["wg"]
    w0, _ = cam._tile_weights(op, k["kr"], k["kh"],
                              k["kt"] if op == "f3" else None, p)
    rd = Reader(w0)
    bf = cam._bf
    dm, kc = max(dils), p["kc"]
    x = F.pad(k["x"].float(), (0, kc - c))
    xh = F.pad(x, (0, 0, dm, dm, dm, dm))
    convs = []
    for i, d in enumerate(dils):
        cols = []
        for _ in range(p["nsl"]):
            acc = torch.zeros(b, h, w, p["sw"])
            for chunk in x_stages(p):
                for tap in range(9):
                    y0, x0 = dm + (tap // 3 - 1) * d, dm + (tap % 3 - 1) * d
                    sh = xh[:, y0:y0 + h, x0:x0 + w]
                    for k0, kw in chunk:
                        acc += sh[..., k0:k0 + kw] @ rd.take(
                            kw, p["sw"]).float()
            cols.append(acc)
        convs.append(bf(torch.cat(cols, -1)[..., :hc]))
    if op == "f3":
        mean, inv, scale, bias = (k["bnh"][j::4] for j in range(4))
        a = torch.cat([bf(torch.relu((cv - mean[i]) * inv[i] * scale[i]
                                     + bias[i]))
                       for i, cv in enumerate(convs)], -1)
        a = F.pad(a, (0, p["knh"] - nb * hc))
    res, top = [], []
    for _ in range(p["nch1"]):
        acr = torch.zeros(b, h, w, cam.WG_N1)
        for chunk in x_stages(p):
            for k0, kw in chunk:
                acr += x[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
        res.append(acr)
        if op == "f3":
            at = torch.zeros(b, h, w, cam.WG_N1)
            for k0, kw in a_stages(p):
                at += a[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
            top.append(at)
    assert rd.off == w0.numel()
    res = bf(torch.cat(res, -1)[..., :c])

    def sums(v):
        return torch.stack([v.sum((0, 1, 2)), (v * v).sum((0, 1, 2))])

    if op == "f1":
        return (sums(res), torch.cat([sums(cv) for cv in convs]),
                k["x"].float().sum((1, 2)))
    top = bf(torch.cat(top, -1)[..., :c])

    def bn_relu(v, rows):
        return torch.relu((v - rows[0]) * rows[1] * rows[2] + rows[3])

    pre = bn_relu(res, k["bnr"]) \
        + bn_relu(top, k["bnt"]) * k["gate"][:, None, None, :]
    return (torch.relu(pre).to(torch.bfloat16),)


PLAIN = {"f1": cam.cam_f1_fwd_plain, "f3": cam.cam_f3_fwd_plain}


@pytest.mark.parametrize("op,name", by_op(WALK_SHAPES))
def test_wg_walk_matches_the_plain_forwards(op, name):
    """The walk on exact-sum inputs: ``cam_f1_fwd_plain``'s (s_r, s_h,
    gap) and ``cam_f3_fwd_plain``'s out bitwise, at a plan with the halo
    at full depth, in K chunks, with branch slices and (F3) with a and
    the BN rows out of shared memory."""
    shape = WALK_SHAPES[name]
    p = cam.tile_plan(op, *shape)
    if name == "slices":
        assert p["nsl"] == 2
        assert op == "f1" or not (p["a_res"] or p["rows_smem"])
    if name in ("chunks", "step256"):
        assert p["nq"] > 1
    k = _forward_case(shape, 12)
    got = wg_walk(op, shape, k)
    want = PLAIN[op](*_forward_args(op, k, shape[4]))
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape, i
        assert bool((w_ != 0).any()), i
        assert torch.equal(g_, w_), i


@pytest.mark.parametrize("op", OPS)
def test_wg_walk_matches_pallas_interpret(op):
    """The walk against the TPU kernel it replaces (``pallas_cam.py:
    _f1_call`` / ``_f3_call``, interpret mode) on random inputs at C = 195,
    hc = 48 (--inplanes 96's step CAM; one whole 48-column branch a
    wgmma) on a ragged image: float32 sums within 1e-5 and the bf16
    output within 2^-8 of their largest magnitude
    (``tests/test_torch_cam.py``'s tolerances)."""
    shape = (1, 9, 11, 195, (1, 2, 3), 48)
    assert cam.tile_plan(op, *shape)["wg"]
    inp = _inputs(*shape, seed=sum(shape[:4]))
    k = {n: torch.from_numpy(inp[n]) for n in inp}
    for n in ("x", "kr", "kh", "kt"):
        k[n] = k[n].to(torch.bfloat16)
    got = wg_walk(op, shape, k)
    fn = {"f1": pc._f1_call, "f3": pc._f3_call}[op]
    args = _forward_args(op, k, shape[4])
    want = fn(*[_jx(t) for t in args[:-1]], shape[4])
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        w_ = np.asarray(jnp.asarray(w_, jnp.float32))
        g_ = g_.float().numpy()
        assert g_.shape == w_.shape, i
        tol = BF16_TOL if op == "f3" else F32_TOL
        scale = max(float(np.abs(w_).max()), 1e-6)
        assert float(np.abs(g_ - w_).max()) <= tol * scale, (i, op)


@pytest.mark.parametrize("op,name", by_op(TRAIN_WALKS))
def test_wg_walk_matches_pallas_interpret_at_train_widths(op, name):
    """The walk against ``_f1_call`` / ``_f3_call`` (interpret mode) at
    the train step's widths (C = 163, hc = 40: a 48-column slice; C = 83,
    hc = 20: 32 columns, 12 of them padding) on a ragged image, on
    exact-sum inputs: bitwise."""
    shape = TRAIN_WALKS[name]
    p = cam.tile_plan(op, *shape)
    assert p["wg"] and p["sw"] == {40: 48, 20: 32}[shape[5]]
    k = _forward_case(shape, 21)
    got = wg_walk(op, shape, k)
    fn = {"f1": pc._f1_call, "f3": pc._f3_call}[op]
    args = _forward_args(op, k, shape[4])
    want = fn(*[_jx(t) for t in args[:-1]], shape[4])
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        w_ = torch.from_numpy(np.array(w_.astype(jnp.float32)))
        assert g_.shape == w_.shape, i
        assert bool((w_ != 0).any()), i
        assert torch.equal(g_.float(), w_), i
