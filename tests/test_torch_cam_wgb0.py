"""F1b's and F2b's phase 0 on ``csrc/cam_wg.cuh`` on the CPU:
``f1b_wg_kernel`` and ``f2b_wg_kernel``, two more modes of
``fwd_wg_body``, which run at every geometry (the train step's CAMs at
``--inplanes`` 80, every wider one, six dilations up to 8).

* The plans (``ops/cam.py:_wg_plan`` for "f1b" and "f2b"; the C side's
  ``make_fplan``, exported by ``cam_wg.cuh:op_plan``) at the width grid of
  ``tests/test_torch_cam_wide.py``: within a block's shared memory as the
  kernels carve it (F1b's dsr and dsh, F2b's dst and bnh where they fit),
  their stage counts as the producer warp walks them (F1b F1's products,
  F2b no x kr^T), at ``--inplanes`` 128 and at the train step's shapes
  x's halo staged once a tile.
* The re-laid weights (``ops/cam.py:_wg_weights``), stage by stage in the
  order the producer warp copies them, give back kr, kh and kt with zero
  padding (F1b: F1's layout; F2b: F3b's without the kr stages).
* A walk of each kernel's stages over every pixel with its epilogue (F1b:
  dc after each branch slice, dr after each 1x1 chunk; F2b: a, t in
  chunks of 64 columns, dt, then the branch backward over dt's stages),
  with dx, the weight gradients and F2b's statistics formed from what it
  leaves (``tests/test_torch_cam_wgb.py``'s ``dx_walk``), bitwise
  ``cam_f1_bwd_plain`` / ``cam_f2_bwd_plain`` on exact sums (the halo
  whole and in K chunks, two branch slices, F2b's a and rows out of
  shared memory and dt in chunks; the train step's widths and the first
  design's walk shapes), and within ``tests/test_torch_cam.py``'s
  tolerances of the interpret-mode ``_f1b_call`` / ``_f2b_call`` on random
  inputs at C = 195, hc = 48 and at the train step's widths.

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
from test_torch_cam import BF16_TOL, _grad_close, _inputs
from test_torch_cam_tile import _dyadic, _forward_case, _jx
from test_torch_cam_wg import TRAIN_WALKS, Reader, a_stages, x_stages
from test_torch_cam_wgb import (WALK_SHAPES, _bn, _check_block, dt_stages,
                                dx_walk)
from test_torch_cam_wide import GRID, WEIGHT_SHAPES, _weights

OPS = ("f1b", "f2b")
TRAIN = {"steps", "pyramid"}
# tests/test_torch_cam_wgb.py's walk shapes, but F2b's dt in chunks needs
# a wider C than F3b's (no x kr^T stages or BN rows beside its halo)
WALK_SHAPES = dict(WALK_SHAPES, dt_chunks=(1, 9, 10, 344, (1, 2, 3), 256))
TP = cam.TILE_TP
bf = cam._bf


def by_op(names, ops=OPS):
    return [pytest.param(op, n, id=f"{op}-{n}") for op in ops for n in names]


def stages(op, p, nb):
    """The kernel's weight stages in the producer's order (``cam_wg.cuh:
    fwd_produce``): (kind, k0, kw, n, branch, slice, tap, 1x1 chunk); the
    branch convs, per 1x1 chunk x's stages (F1b, "res") or a's (F2b,
    "top"), then F2b's branch backward over dt's stages ("bb")."""
    out = []
    for i in range(nb):
        for sl in range(p["nsl"]):
            for chunk in x_stages(p):
                for tap in range(9):
                    out += [("br", k0, kw, p["sw"], i, sl, tap, None)
                            for k0, kw in chunk]
    for ch in range(p["nch1"]):
        if op == "f1b":
            out += [("res", k0, kw, cam.WG_N1, None, None, None, ch)
                    for chunk in x_stages(p) for k0, kw in chunk]
        else:
            out += [("top", k0, kw, cam.WG_N1, None, None, None, ch)
                    for k0, kw in a_stages(p)]
    if op == "f2b":
        for i in range(nb):
            for sl in range(p["nsl"]):
                out += [("bb", k0, kw, p["sw"], i, sl, None, None)
                        for k0, kw in dt_stages(p)]
    return out


@pytest.mark.parametrize("op,name", by_op(GRID))
def test_wgb0_plans_fit_every_width(op, name):
    """F1b's and F2b's phase 0 at every shape of the width grid: the wgmma plan
    within SMEM_MAX as the kernel carves it (the mbarriers, x's halo chunk,
    F2b's a where it fits, the epilogues' rows: F1b's dsr and dsh always, F2b's
    dst and bnh where they fit; F2b's column-sum scratch; FNS ring slots), its
    stage count as the producer walks it, whole branches of up to 128 columns,
    x's stages covering kc (and F2b's a's covering knh, dt's chunks the halo's
    buffer); at --inplanes 128 (step128) x's halo staged once a tile, F2b's a,
    rows and dt whole in shared memory, and so at the train step's shapes."""
    b, h, w, c, dils, hc = shape = GRID[name]
    nb, nh = len(dils), len(dils) * hc
    p = cam.tile_plan(op, *shape)
    assert p["ok"]
    assert p["wg"] and p["dx_wg"]
    assert p["ntb"] in cam.WG_NTB and p["sw"] == 8 * p["ntb"] <= 128
    assert p["nsl"] * p["sw"] >= hc > (p["nsl"] - 1) * p["sw"]
    assert p["nsl"] == 1                        # the grid's branches whole
    kc, kq, kb, knh, hr = p["kc"], p["kq"], p["kb"], p["knh"], p["hr"]
    assert kq % 16 == 0 and kb % 16 == 0 and 0 < kb <= kq
    assert sum(kw for ch in x_stages(p) for _, kw in ch) == kc
    nw = max(p["sw"], cam.WG_N1)
    if op == "f1b":
        assert p["kqa"] == p["kbd"] == 0 and not p["a_res"]
        assert p["rows_smem"]
        rows = 4 * (2 * c + 2 * nh)
        scratch = 0
    else:
        assert p["kqa"] % 16 == 0 and sum(kw for _, kw in a_stages(p)) == knh
        assert TP * p["kdq"] <= hr * kq and p["kdq"] % 16 == 0
        assert sum(kw for _, kw in dt_stages(p)) == kc
        rows = 4 * (2 * c + 4 * nh) if p["rows_smem"] else 0
        scratch = 4 * cam.WG_RED3
    smem = (cam.WG_BAR + 2 * hr * kq + (2 * TP * knh if p["a_res"] else 0)
            + rows + scratch
            + 2 * cam.WG_NS * max(kb, p["kqa"], p["kbd"]) * nw)
    assert p["smem0"] == smem <= cam.SMEM_MAX
    assert p["wg_nst"] == len(stages(op, p, nb))
    res, top, bb = cam.TILE_OPS[op]
    assert p["w0_elems"] == (9 * nb * kc * p["sw"]
                             + p["nch1"] * cam.WG_N1 * (res * kc + top * knh)
                             + bb * nb * kc * p["sw"])
    if name in TRAIN | {"step128"}:
        assert p["nq"] == 1 and kq == kc            # the halo once a tile
        if op == "f2b":
            assert p["a_res"] and p["rows_smem"] and p["nd"] == 1


@pytest.mark.parametrize("op,name", by_op(WEIGHT_SHAPES))
def test_wgb0_weights_unpad_to_the_inputs(op, name):
    """Each stage of ``_wg_weights`` (read as the producer copies them,
    [n / 8][kw][8]) is its slice of kh[i, tap] (a branch slice's
    columns), kr (F1b) or kt.reshape(NH, C) (F2b; 64 output columns of a
    1x1 chunk), then of kt[i]^T (F2b's dt stages, a branch slice's
    columns), zero past C, hc and NH; the last stage ends w0.  F1b's
    layout is F1's."""
    b, h, w, c, dils, hc = shape = WEIGHT_SHAPES[name]
    nb, nh = len(dils), len(dils) * hc
    res, top, _ = cam.TILE_OPS[op]
    p = cam.tile_plan(op, *shape)
    assert p["wg"]
    kr, kh, kt = _weights(c, nb, hc, 8)
    w0, w1 = cam._tile_weights(op, kr if res else None, kh,
                               kt if top else None, p)
    assert w0.numel() == p["w0_elems"] and w1.numel() == p["w1_elems"]
    rd = Reader(w0)
    ktf = kt.reshape(nh, c)
    kinds = []
    for kind, k0, kw, n, i, sl, tap, ch in stages(op, p, nb):
        assert kw % 16 == 0 and n % 8 == 0 and (2 * rd.off) % 16 == 0
        block = rd.take(kw, n)
        kinds.append(kind)
        if kind == "br":
            _check_block(block, kh[i, tap // 3, tap % 3], k0, sl * p["sw"])
        elif kind == "bb":
            _check_block(block, kt[i].t(), k0, sl * p["sw"])
        else:
            _check_block(block, kr if kind == "res" else ktf, k0,
                         ch * cam.WG_N1)
    assert rd.off == w0.numel()
    if op == "f1b":
        assert "bb" not in kinds
        assert torch.equal(w0, cam._wg_weights("f1", p, kr, kh, None))
    else:
        assert kinds.count("bb") == nb * p["nsl"] * len(dt_stages(p))


# ------------------------------------------------------------ the walks


def branch_walk(shape, k, p, rd):
    """The branch convs by the kernel's stages: per branch and slice,
    acc += (x shifted by the tap, K stage) . the stage's weights over x's
    chunks, taps and stages; bf16(c_i) (B, H, W, hc) per branch."""
    b, h, w, c, dils, hc = shape
    dm, kc, sw = max(dils), p["kc"], p["sw"]
    x = F.pad(k["x"].float(), (0, kc - c))
    xh = F.pad(x, (0, 0, dm, dm, dm, dm))
    cs = []
    for i, d in enumerate(dils):
        cols = []
        for _ in range(p["nsl"]):
            acc = torch.zeros(b, h, w, sw)
            for chunk in x_stages(p):
                for tap in range(9):
                    y0, x0 = dm + (tap // 3 - 1) * d, dm + (tap % 3 - 1) * d
                    sh = xh[:, y0:y0 + h, x0:x0 + w]
                    for k0, kw in chunk:
                        acc += sh[..., k0:k0 + kw] @ rd.take(kw, sw).float()
            cols.append(acc)
        cs.append(bf(torch.cat(cols, -1)[..., :hc]))
    return cs, x


def f1b_walk(shape, k, dsr, dsh):
    """F1b's phase 0 by f1b_wg_kernel's stages over every pixel: F1's
    products (the branch convs, then per 1x1 chunk x's stages of kr) with
    f1b_tile_kernel's epilogues, dc_i = bf16(dsh[2i] + 2 bf16(c_i)
    dsh[2i+1]) and dr = bf16(dsr[0] + 2 bf16(x kr) dsr[1]).  Returns (dr,
    dcs (B, H, W, nb, hc))."""
    c = shape[3]
    p = cam.tile_plan("f1b", *shape)
    assert p["wg"]
    w0, _ = cam._tile_weights("f1b", k["kr"], k["kh"], None, p)
    rd = Reader(w0)
    cs, x = branch_walk(shape, k, p, rd)
    dcs = [bf(dsh[2 * i] + 2.0 * cv * dsh[2 * i + 1])
           for i, cv in enumerate(cs)]
    res = []
    for _ in range(p["nch1"]):
        acr = torch.zeros(*x.shape[:3], cam.WG_N1)
        for chunk in x_stages(p):
            for k0, kw in chunk:
                acr += x[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
        res.append(acr)
    assert rd.off == w0.numel()
    rb = bf(torch.cat(res, -1)[..., :c])
    return bf(dsr[0] + 2.0 * rb * dsr[1]), torch.stack(dcs, 3)


def f2b_walk(shape, k, dst):
    """F2b's phase 0 by f2b_wg_kernel's stages over every pixel: the
    branch convs, a = bf16(relu(BN_h(c))), per 1x1 chunk t over a's
    stages of kt and dt = bf16(dst[0] + 2 bf16(t) dst[1]), then per
    branch slice da = dt's stages . kt[i]^T, dz = (z > 0) da, dc =
    bf16(dz scale inv) and dS_h.  Returns (dt, a, dcs (B, H, W, nb, hc),
    dS (2 nb, hc))."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    p = cam.tile_plan("f2b", *shape)
    assert p["wg"]
    w0, _ = cam._tile_weights("f2b", None, k["kh"], k["kt"], p)
    rd = Reader(w0)
    rows = k["bnh"]
    cs, _ = branch_walk(shape, k, p, rd)
    zs = [_bn(cv, rows, i) for i, cv in enumerate(cs)]
    a = torch.cat([bf(torch.relu(z)) for z in zs], -1)
    ap = F.pad(a, (0, p["knh"] - nb * hc))
    top = []
    for _ in range(p["nch1"]):
        at = torch.zeros(b, h, w, cam.WG_N1)
        for k0, kw in a_stages(p):
            at += ap[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
        top.append(at)
    tb = bf(torch.cat(top, -1)[..., :c])
    dt = bf(dst[0] + 2.0 * tb * dst[1])
    dtp = F.pad(dt, (0, p["kc"] - c))
    dcs, sums = [], []
    for i in range(nb):
        cols = []
        for _ in range(p["nsl"]):
            acc = torch.zeros(b, h, w, p["sw"])
            for k0, kw in dt_stages(p):
                acc += dtp[..., k0:k0 + kw] @ rd.take(kw, p["sw"]).float()
            cols.append(acc)
        da = torch.cat(cols, -1)[..., :hc]
        dz = torch.where(zs[i] > 0, da, torch.zeros_like(da))
        dcs.append(bf(dz * (rows[4 * i + 2] * rows[4 * i + 1])))
        sums += [dz.sum((0, 1, 2)),
                 (dz * (cs[i] - rows[4 * i])).sum((0, 1, 2))]
    assert rd.off == w0.numel()
    return dt, a, torch.stack(dcs, 3), torch.stack(sums)


def f1b_outputs(shape, k, dsr, dsh, dgap):
    """F1b's (dx, dkr, dkh) from the walk: dx by ``dx_walk`` over its dr
    and dc, the weight gradients from them as the plain version forms
    them."""
    dils = shape[4]
    dr, dcs = f1b_walk(shape, k, dsr, dsh)
    x32 = k["x"].float()
    dx = dx_walk("f1b", shape, k["kr"], k["kh"], dr, dcs, dgap)
    dkr = torch.einsum("bhwc,bhwn->cn", x32, dr)
    dkh = torch.stack([cam._wgrad(x32, dcs[..., i, :], d)
                       for i, d in enumerate(dils)])
    return dx, dkr, dkh


def f2b_outputs(shape, k, dst):
    """F2b's (dx, dkh, dkt, dS) from the walk, as :func:`f1b_outputs`."""
    dils, hc = shape[4], shape[5]
    dt, a, dcs, ds = f2b_walk(shape, k, dst)
    x32 = k["x"].float()
    dx = dx_walk("f2b", shape, None, k["kh"], None, dcs)
    dkh = torch.stack([cam._wgrad(x32, dcs[..., i, :], d)
                       for i, d in enumerate(dils)])
    dkt = torch.stack([torch.einsum("bhwj,bhwc->jc",
                                    a[..., i * hc:(i + 1) * hc], dt)
                       for i in range(len(dils))])
    return dx, dkh, dkt, ds


@pytest.mark.parametrize("op,name", by_op(WALK_SHAPES))
def test_wgb0_walk_matches_the_plain_backwards(op, name):
    """The walks on exact-sum inputs (``tests/test_torch_cam_tile.py``'s,
    dyadic cotangents): all of F1b's and F2b's outputs bitwise
    ``cam_f1_bwd_plain`` / ``cam_f2_bwd_plain``, at plans with x's halo
    whole (step128, step96) and in K chunks (step256), two branch slices
    (slices; F2b's a and rows out of shared memory there) and F2b's dt
    in chunks (dt_chunks), and at the train step's widths."""
    b, h, w, c, dils, hc = shape = WALK_SHAPES[name]
    nb = len(dils)
    p = cam.tile_plan(op, *shape)
    assert p["wg"]
    if name in ("step128", "step96"):
        assert p["nq"] == 1
    if name == "step256":
        assert p["nq"] > 1
    if name == "slices":
        assert p["nsl"] == 2
        assert op == "f1b" or not (p["a_res"] or p["rows_smem"])
    if name == "dt_chunks" and op == "f2b":
        assert p["nd"] > 1
    k = _forward_case(shape, 23)
    rng = np.random.default_rng(29)
    if op == "f1b":
        dsr, dsh, dgap = (_dyadic(rng, 2, c), _dyadic(rng, 2 * nb, hc),
                          _dyadic(rng, b, c))
        got = f1b_outputs(shape, k, dsr, dsh, dgap)
        want = cam.cam_f1_bwd_plain(k["x"], k["kr"], k["kh"], dsr, dsh,
                                    dgap, dils)
    else:
        dst = _dyadic(rng, 2, c)
        got = f2b_outputs(shape, k, dst)
        want = cam.cam_f2_bwd_plain(k["x"], k["kh"], k["kt"], k["bnh"], dst,
                                    dils)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape, i
        assert bool((w_ != 0).any()), i
        assert torch.equal(g_, w_), i


@pytest.mark.parametrize("op", OPS)
def test_wgb0_walk_matches_pallas_interpret(op):
    """The walks against the TPU kernels they stand for
    (``pallas_cam.py:_f1b_call`` / ``_f2b_call``, interpret mode) on
    random inputs at C = 195, hc = 48 (--inplanes 96's step CAM) on a
    ragged image, with ``tests/test_torch_cam.py``'s tolerances: the bf16
    dx within 2^-8 of its largest magnitude; the float32 weight gradients
    and F2b's statistics, sums over the pixels' bf16 cotangents, as its
    gradients through bf16 roundings (within 2^-5 of the largest
    magnitude and cosine > 0.999: the walk adds a conv's K stages and
    taps in another order than XLA, so a recomputed conv can round to the
    neighbouring bf16 value and flip a mask or move a cotangent)."""
    _vs_pallas(op, (2, 9, 11, 195, (1, 2, 3), 48))


@pytest.mark.parametrize("op,name", by_op(TRAIN_WALKS))
def test_wgb0_walk_matches_pallas_interpret_at_train_widths(op, name):
    """The same at the train step's widths (C = 163, hc = 40; C = 83,
    hc = 20) on a small ragged image, with the same tolerances."""
    b, h, w, c, dils, hc = TRAIN_WALKS[name]
    _vs_pallas(op, (2, h, w, c, dils, hc))


def _vs_pallas(op, shape):
    b, h, w, c, dils, hc = shape
    assert cam.tile_plan(op, *shape)["wg"]
    inp = _inputs(*shape, seed=sum(shape[:4]) + 5)
    k = {n: torch.from_numpy(inp[n]) for n in inp}
    for n in ("x", "kr", "kh", "kt"):
        k[n] = k[n].to(torch.bfloat16)
    if op == "f1b":
        got = f1b_outputs(shape, k, k["dsr"], k["dsh"], k["dgap"])
        want = pc._f1b_call(*[_jx(k[n]) for n in (
            "x", "kr", "kh", "dsr", "dsh", "dgap")], dils)
    else:
        got = f2b_outputs(shape, k, k["dst"])
        want = pc._f2b_call(*[_jx(k[n]) for n in (
            "x", "kh", "kt", "bnh", "dst")], dils)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        w_ = torch.from_numpy(np.array(jnp.asarray(w_, jnp.float32)))
        assert g_.shape == w_.shape, i
        if g_.dtype == torch.bfloat16:
            scale = max(float(w_.abs().max()), 1e-6)
            assert float((g_.float() - w_).abs().max()) <= BF16_TOL * scale
        else:
            _grad_close(g_, w_, f"{op}[{i}]")
