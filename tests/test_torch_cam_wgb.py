"""The backwards' wgmma kernels (``csrc/cam_wg.cuh``) on the CPU:
``f3b_wg_kernel`` (F3b's phase 0) and ``dx_wg_kernel`` (phase 1, dx, of
F1b, F2b and F3b), which run at every geometry (the train step's CAMs at
``--inplanes`` 80, every wider one, six dilations up to 8).

* The plans (``ops/cam.py:_wg_plan`` for F3b, ``_dx_plan``; the C side's
  ``make_fplan`` / ``make_dplan``, exported by ``cam_wg.cuh:op_plan``) at
  the width grid of ``tests/test_torch_cam_wide.py``: within a block's
  shared memory as the kernels carve it, their stage counts as the
  producer warps walk them, all of dx's output columns in one block, at
  ``--inplanes`` 128 and at the train step's shapes the dc halo and
  F3b's x halo staged once a tile.  Every geometry the ops' limit lets
  through gets both plans, so the ops refuse what they refused before (a
  largest dilation of 19 at C = 163 for F1b and F3b, 20 for F2b).
* The re-laid weights (``ops/cam.py:_wg_weights`` for F3b,
  ``_dx_weights``), stage by stage in the order the producer warps copy
  them, give back kr, kh and kt with zero padding, each stage in wgmma's
  N-major core matrices.
* A walk of each kernel's stages over every pixel with its epilogue (F3b:
  F3's products, then dr, dt and the five column sums, then the branch
  backward over dt's stages; dx: per column pass dr's stages, then per
  branch, halo chunk, tap and stage the transposed tap of dc), bitwise
  ``cam_f{1,2,3}_bwd_plain`` on exact sums (the halo whole, in two branch
  buffers and in K chunks, column passes, dr a stage at a time, F3b's a
  and rows out of shared memory, dt in chunks; the train step's widths
  and the first design's walk shapes), and within
  ``tests/test_torch_cam.py``'s tolerances of the interpret-mode
  ``_f1b_call`` / ``_f2b_call`` / ``_f3b_call`` on random inputs at
  C = 195, hc = 48 and at the train step's widths (F3b's dx on image 0
  only: the TPU kernel's phase 1 reads image 0's gate,
  ``pallas_cam.py:507``).

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
from test_torch_cam_tile import (_dyadic, _forward_case, _ints, _jx,
                                 first_design_fits)
from test_torch_cam_wg import TRAIN_WALKS, Reader, a_stages, x_stages
from test_torch_cam_wide import GRID, WEIGHT_SHAPES, _weights

OPS = ("f3b", "f1b", "f2b")
TRAIN = {"steps", "pyramid"}
TP = cam.TILE_TP
# the smallest images of each kind of plan: the step CAM of --inplanes
# 128 (dx: the dc halo in two branch buffers; F3b: x's halo and dt whole,
# a and the rows in shared memory), 96 (dx: the dc halo whole), 256 (two
# column passes, branches in K chunks; F3b's x halo in K chunks), a
# dilation of 18 at C = 700 (dr a stage at a time, three passes), a
# branch of 256 columns (two slices; F3b's a and rows out of shared
# memory) and C = 300 with 256-column branches (F3b's dt in two chunks);
# the train step's widths (dx: 12 and 8 n8 tiles a warpgroup) on small
# images and the first design's walk shapes
WALK_SHAPES = {"step128": (1, 9, 10, 259, (1, 2, 3), 64),
               "step96": (2, 9, 13, 195, (1, 2, 3), 48),
               "step256": (1, 9, 8, 515, (1, 2, 3), 128),
               "dr_stages": (1, 9, 10, 700, (1, 18), 8),
               "slices": (1, 9, 10, 16, (1, 1, 1, 1, 1, 10), 256),
               "dt_chunks": (1, 9, 10, 300, (1, 2, 3), 256),
               "steps": (1, 9, 10, 163, (1, 2, 3), 40),
               "pyramid": (2, 9, 13, 83, (1, 2, 3, 4), 20),
               "tile0": (2, 9, 13, 12, (1, 2, 3, 4), 3),
               "tile1": (1, 5, 30, 70, (1, 2, 3), 20),
               "tile2": (1, 11, 19, 12, (1, 9), 3),
               "tile3": (1, 9, 10, 170, (1, 2), 8)}
# the largest dilation each backward takes at C = 163, hc = 40 (F2b has
# no dr rows: one more)
DIL_LAST = {"f3b": 18, "f1b": 18, "f2b": 19}


def by_op(names, ops=OPS):
    return [pytest.param(op, n, id=f"{op}-{n}") for op in ops for n in names]


def _stages(k: int, width: int):
    return [(k0, min(width, k - k0)) for k0 in range(0, k, width)]


def dt_stages(p):
    """F3b's dt stages of its branch backward: per chunk of kdq held in
    the halo's buffer, stages of kbd; (first k, width)."""
    return [(q + u, kw) for q, wd in _stages(p["kc"], p["kdq"])
            for u, kw in _stages(wd, p["kbd"])]


def f3b_stages(p, nb):
    """f3b_wg_kernel's weight stages in the producer's order: (kind, k0,
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
        out += [("top", k0, kw, cam.WG_N1, None, None, None, ch)
                for k0, kw in a_stages(p)]
    for i in range(nb):
        for sl in range(p["nsl"]):
            out += [("bb", k0, kw, p["sw"], i, sl, None, None)
                    for k0, kw in dt_stages(p)]
    return out


def dx_stages(op, p, nb):
    """dx_wg_kernel's weight stages in the producer's order: (kind, k0,
    kw, column pass, branch, tap); kind "res" (dr's K stages over kc,
    F1b and F3b) or "br" (per branch, halo chunk of kq and tap, the
    chunk's stages, k0 within the branch)."""
    res = cam.TILE_OPS[op][0]
    out = []
    for pc_ in range(p["dx_npass"]):
        if res:
            out += [("res", k0, kw, pc_, None, None)
                    for k0, kw in _stages(p["kc"], p["dx_kbr"])]
        for i in range(nb):
            for q, wq in _stages(p["khc"], p["dx_kq"]):
                for tap in range(9):
                    out += [("br", q + u, kw, pc_, i, tap)
                            for u, kw in _stages(wq, p["dx_kb"])]
    return out


@pytest.mark.parametrize("op,name", by_op(GRID))
def test_wgb_plans_fit_every_width(op, name):
    """F1b, F2b and F3b at every shape of the width grid: dx_wg_kernel's
    plan (and F3b's f3b_wg_kernel plan; F1b's and F2b's phase 0 are
    ``tests/test_torch_cam_wgb0.py``'s), within SMEM_MAX as the kernels
    carve it: the dc
    halo (whole or two chunk buffers), dr's rows (whole or a stage), the
    ring of FNS slots of a pass's 16 ntw columns; its stage count as the
    producer walks it; every output column in one block (column passes
    of two warpgroups' n8 tiles); at --inplanes 128 (step128) one pass,
    each branch of the dc halo staged once, stages 64 wide, and F3b's x
    halo and dt whole, a and the rows in shared memory; at the train
    step's shapes one pass of 12 (C = 163) or 8 (C = 83) n8 tiles a
    warpgroup, the dc halo and dr's rows whole, F3b's x halo and dt
    whole."""
    b, h, w, c, dils, hc = shape = GRID[name]
    nb = len(dils)
    res = cam.TILE_OPS[op][0]
    p = cam.tile_plan(op, *shape)
    assert p["ok"]
    assert p["dx_wg"] and p["wg"]
    ntw, npass, np_ = p["dx_ntw"], p["dx_npass"], p["dx_np"]
    assert ntw in cam.DX_NTW and np_ == 16 * ntw
    assert npass * np_ >= c > (npass - 1) * np_
    kq, nq, kc, khc, hr = p["dx_kq"], p["dx_nq"], p["kc"], p["khc"], p["hr"]
    assert kq % 16 == 0 and (nq - 1) * kq < khc <= nq * kq
    assert not p["dx_hres"] or nq == 1
    kbr, kb = p["dx_kbr"], p["dx_kb"]
    assert kb % 16 == 0 and 0 < kb <= kq and (kbr > 0) == res
    dr_res = res and p["dx_dr_res"]
    smem1 = (cam.WG_BAR + 2 * hr * (p["ldc"] if p["dx_hres"] else 2 * kq)
             + (2 * TP * kc if dr_res else 0)
             + 2 * cam.WG_NS * max(kbr, kb) * np_
             + (2 * TP * kbr if res and not dr_res else 0))
    assert p["smem1"] == smem1 <= cam.SMEM_MAX
    assert p["dx_nst"] == len(dx_stages(op, p, nb))
    assert p["w1_elems"] == npass * np_ * (res * kc + 9 * nb * khc)
    if op == "f3b":
        knh, sw = p["knh"], p["sw"]
        nw = max(sw, cam.WG_N1)
        rows = 4 * (9 * c + 4 * nb * hc) if p["rows_smem"] else 0
        smem0 = (cam.WG_BAR + 2 * hr * p["kq"]
                 + (2 * TP * knh if p["a_res"] else 0) + rows
                 + 4 * cam.WG_RED3
                 + 2 * cam.WG_NS * max(p["kb"], p["kqa"], p["kbd"]) * nw)
        assert p["smem0"] == smem0 <= cam.SMEM_MAX
        assert p["wg_nst"] == len(f3b_stages(p, nb))
        # dt's chunks fit the halo's buffer, 64 rows a plane
        assert TP * p["kdq"] <= hr * p["kq"] and p["kdq"] % 16 == 0
        assert sum(kw for _, kw in dt_stages(p)) == kc
    if name in TRAIN:
        assert (npass, ntw) == (1, {163: 12, 83: 8}[c])
        assert p["dx_hres"] and nq == 1 and (p["dx_dr_res"] or not res)
        if op == "f3b":
            assert p["nq"] == 1 and p["nd"] == 1
    if name == "step128":
        assert npass == 1 and nq == 1 and kb == 64
        assert not res or p["dx_dr_res"]
        if op == "f3b":
            assert p["nq"] == 1 and p["kq"] == kc and p["nd"] == 1
            assert p["a_res"] and p["rows_smem"]


@pytest.mark.parametrize("op", OPS)
def test_wgb_plans_refuse_what_the_wide_plan_refuses(op):
    """Over C, branch widths and largest dilations: a geometry is taken
    exactly where the first design's tile plans took it (its whole-depth
    plan, or its x halo of one 16-channel chunk with the ring and its
    phase 1's dc halo with its slots: ``test_torch_cam_tile.py:
    first_design_fits``, the ops' limit), and there it gets
    dx_wg_kernel's plan and its phase 0's within SMEM_MAX; at
    C = 163 F1b and F3b take a largest dilation of 18 and refuse 19,
    F2b takes 19 and refuses 20."""
    for c, hc in ((16, 8), (163, 40), (515, 128), (1030, 256)):
        for d in range(1, 24):
            shape = (1, 16, 16, c, (1, d), hc)
            p = cam.tile_plan(op, *shape)
            limit = first_design_fits(op, shape)
            assert bool(p["ok"]) == limit, (c, hc, d)
            if limit:
                assert p["dx_wg"] and p["wg"]
                assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX
    d = DIL_LAST[op]
    assert cam.tile_plan(op, 1, 16, 16, 163, (1, d), 40)["ok"]
    assert not cam.tile_plan(op, 1, 16, 16, 163, (1, d + 1), 40)["ok"]


def _check_block(block, src, k0, n0):
    """block (kw, n) against src[k0:, n0:] where it lies inside src, zero
    elsewhere."""
    want = torch.zeros_like(block)
    part = src[k0:k0 + block.shape[0], n0:n0 + block.shape[1]]
    want[:part.shape[0], :part.shape[1]] = part
    assert torch.equal(block, want)


@pytest.mark.parametrize("op,name", by_op(WEIGHT_SHAPES))
def test_dx_weights_unpad_to_the_inputs(op, name):
    """Each stage of ``_dx_weights`` (read as the producer copies them,
    [np / 8][kw][8]) is its column pass's slice of kr^T (dr's stages: B
    [k][n] = kr[n][k]) or kh[i, tap]^T (the chunk's stages), zero past C
    and hc; the last stage ends w1."""
    b, h, w, c, dils, hc = shape = WEIGHT_SHAPES[name]
    nb = len(dils)
    res, top, _ = cam.TILE_OPS[op]
    p = cam.tile_plan(op, *shape)
    assert p["dx_wg"]
    kr, kh, kt = _weights(c, nb, hc, 5)
    _, w1 = cam._tile_weights(op, kr if res else None, kh,
                              kt if top else None, p)
    assert w1.numel() == p["w1_elems"]
    rd = Reader(w1)
    np_ = p["dx_np"]
    for kind, k0, kw, pc_, i, tap in dx_stages(op, p, nb):
        assert kw % 16 == 0 and (2 * rd.off) % 16 == 0
        block = rd.take(kw, np_)
        src = kr.t() if kind == "res" else kh[i, tap // 3, tap % 3].t()
        _check_block(block, src, k0, pc_ * np_)
    assert rd.off == w1.numel()


@pytest.mark.parametrize("name", sorted(WEIGHT_SHAPES))
def test_f3b_weights_unpad_to_the_inputs(name):
    """Each stage of F3b's ``_wg_weights`` (read as the producer copies
    them) is its slice of kh[i, tap] (a branch slice's columns), kr or
    kt.reshape(NH, C) (64 output columns of a 1x1 chunk), F3's stages,
    then of kt[i]^T (dt's stages, a branch slice's columns), with zeros
    past C, hc and NH; the last stage ends w0."""
    b, h, w, c, dils, hc = shape = WEIGHT_SHAPES[name]
    nb, nh = len(dils), len(dils) * hc
    p = cam.tile_plan("f3b", *shape)
    assert p["wg"]
    kr, kh, kt = _weights(c, nb, hc, 6)
    w0, _ = cam._tile_weights("f3b", kr, kh, kt, p)
    assert w0.numel() == p["w0_elems"]
    rd = Reader(w0)
    ktf = kt.reshape(nh, c)
    kinds = []
    for kind, k0, kw, n, i, sl, tap, ch in f3b_stages(p, nb):
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
    assert kinds.count("bb") == nb * p["nsl"] * len(dt_stages(p))


# ------------------------------------------------------------ the walks

bf = cam._bf


def _bn(v, rows, i=0):
    return (v - rows[4 * i]) * rows[4 * i + 1] * rows[4 * i + 2] \
        + rows[4 * i + 3]


def dx_walk(op, shape, kr, kh, dr, dcs, dgap=None):
    """dx by dx_wg_kernel's stages over every pixel: per column pass, acc
    += dr's K stage . the stage's weights (F1b, F3b), then per branch,
    halo chunk, tap and stage acc += dc_i at p minus the tap's offset .
    the stage's weights; dx = bf16(acc (+ dgap / (H W))).  dr (B, H, W,
    C) and dcs (B, H, W, nb, hc) as bf16-exact float32."""
    b, h, w, c, dils, hc = shape
    res = cam.TILE_OPS[op][0]
    p = cam.tile_plan(op, *shape)
    assert p["dx_wg"]
    rd = Reader(cam._dx_weights(op, p, kr if res else None, kh))
    kc, khc, np_, dm = p["kc"], p["khc"], p["dx_np"], max(dils)
    drp = F.pad(dr, (0, kc - c)) if res else None
    dch = F.pad(F.pad(dcs, (0, khc - hc)), (0, 0, 0, 0, dm, dm, dm, dm))
    cols = []
    for _ in range(p["dx_npass"]):
        acc = torch.zeros(b, h, w, np_)
        if res:
            for k0, kw in _stages(kc, p["dx_kbr"]):
                acc += drp[..., k0:k0 + kw] @ rd.take(kw, np_).float()
        for i, d in enumerate(dils):
            for q, wq in _stages(khc, p["dx_kq"]):
                for tap in range(9):
                    y0 = dm - (tap // 3 - 1) * d
                    x0 = dm - (tap % 3 - 1) * d
                    sh = dch[:, y0:y0 + h, x0:x0 + w, i]
                    for u, kw in _stages(wq, p["dx_kb"]):
                        acc += sh[..., q + u:q + u + kw] @ rd.take(
                            kw, np_).float()
        cols.append(acc)
    assert rd.off == rd.w0.numel()
    acc = torch.cat(cols, -1)[..., :c]
    if dgap is not None:
        acc = acc + dgap[:, None, None, :] * (1.0 / (h * w))
    return acc.to(torch.bfloat16)


def f3b_walk(shape, k, g):
    """F3b's phase 0 by f3b_wg_kernel's stages over every pixel: F3's
    products (per branch slice, x's chunks, taps and stages; per 1x1
    chunk x's stages (kr) and a's (kt)), the epilogue's do, dr, dt and
    column sums (cam_f3.cu's rounding points and order), then per branch
    slice da = dt's stages . kt[i]^T and dz, dc, dS_h.  Returns (dr, dt,
    a, dcs (B, H, W, nb, hc), the four statistic sums [dSr | dSt | dS_h],
    dgate)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    p = cam.tile_plan("f3b", *shape)
    assert p["wg"]
    w0, _ = cam._tile_weights("f3b", k["kr"], k["kh"], k["kt"], p)
    rd = Reader(w0)
    dm, kc, sw = max(dils), p["kc"], p["sw"]
    x = F.pad(k["x"].float(), (0, kc - c))
    xh = F.pad(x, (0, 0, dm, dm, dm, dm))
    cs, zs = [], []
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
        zs.append(_bn(cs[-1], k["bnh"], i))
    a = torch.cat([bf(torch.relu(z)) for z in zs], -1)
    ap = F.pad(a, (0, p["knh"] - nb * hc))
    res, top = [], []
    for _ in range(p["nch1"]):
        acr = torch.zeros(b, h, w, cam.WG_N1)
        for chunk in x_stages(p):
            for k0, kw in chunk:
                acr += x[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
        at = torch.zeros(b, h, w, cam.WG_N1)
        for k0, kw in a_stages(p):
            at += ap[..., k0:k0 + kw] @ rd.take(kw, cam.WG_N1).float()
        res.append(acr)
        top.append(at)
    rb = bf(torch.cat(res, -1)[..., :c])
    tb = bf(torch.cat(top, -1)[..., :c])
    bnr, bnt, gt = k["bnr"], k["bnt"], k["gate"][:, None, None, :]
    zr, zt = _bn(rb, bnr), _bn(tb, bnt)
    y = torch.relu(zt)
    pre = torch.relu(zr) + y * gt
    zero = torch.zeros_like(pre)
    d_o = torch.where(pre > 0, g.float(), zero)
    dzr = torch.where(zr > 0, d_o, zero)
    dr = bf(dzr * (bnr[2] * bnr[1]))
    dzt = torch.where(zt > 0, d_o * gt, zero)
    dt = bf(dzt * (bnt[2] * bnt[1]))
    sums = [dzr.sum((0, 1, 2)), (dzr * (rb - bnr[0])).sum((0, 1, 2)),
            dzt.sum((0, 1, 2)), (dzt * (tb - bnt[0])).sum((0, 1, 2))]
    dtp = F.pad(dt, (0, kc - c))
    dcs = []
    for i in range(nb):
        cols = []
        for _ in range(p["nsl"]):
            acc = torch.zeros(b, h, w, sw)
            for k0, kw in dt_stages(p):
                acc += dtp[..., k0:k0 + kw] @ rd.take(kw, sw).float()
            cols.append(acc)
        da = torch.cat(cols, -1)[..., :hc]
        dz = torch.where(zs[i] > 0, da, torch.zeros_like(da))
        rows = k["bnh"]
        dcs.append(bf(dz * (rows[4 * i + 2] * rows[4 * i + 1])))
        sums += [dz.sum((0, 1, 2)), (dz * (cs[i] - rows[4 * i])).sum(
            (0, 1, 2))]
    assert rd.off == w0.numel()
    return (dr, dt, a, torch.stack(dcs, 3), torch.cat(sums),
            (d_o * y).sum((1, 2)))


def _f1b_cotangents(shape, k, dsr, dsh):
    """F1b's phase-0 cotangents as its epilogue rounds them: dr =
    bf16(dsr[0] + 2 bf16(x kr) dsr[1]), dc_i = bf16(dsh[2i] + 2 c_i
    dsh[2i+1])."""
    dils = shape[4]
    x32 = k["x"].float()
    rc = bf(x32 @ k["kr"].float())
    dr = bf(dsr[0] + 2.0 * rc * dsr[1])
    dcs = [bf(dsh[2 * i] + 2.0 * bf(cam._conv(x32, k["kh"][i], d))
              * dsh[2 * i + 1]) for i, d in enumerate(dils)]
    return dr, torch.stack(dcs, 3)


def _f2b_cotangents(shape, k, dst):
    """F2b's: dt = bf16(dst[0] + 2 t dst[1]), dc_i = bf16((z_i > 0) dt
    kt[i]^T scale inv)."""
    dils, hc = shape[4], shape[5]
    x32 = k["x"].float()
    zs = [_bn(bf(cam._conv(x32, k["kh"][i], d)), k["bnh"], i)
          for i, d in enumerate(dils)]
    a = torch.cat([bf(torch.relu(z)) for z in zs], -1)
    t = bf(a @ k["kt"].float().reshape(-1, shape[3]))
    dt = bf(dst[0] + 2.0 * t * dst[1])
    dcs = []
    for i, z in enumerate(zs):
        da = dt @ k["kt"][i].float().t()
        dz = torch.where(z > 0, da, torch.zeros_like(da))
        rows = k["bnh"]
        dcs.append(bf(dz * (rows[4 * i + 2] * rows[4 * i + 1])))
    return torch.stack(dcs, 3)


def _f3b_outputs(shape, k, g):
    """F3b's eight outputs from the walks: dx from dx_walk over
    f3b_walk's dr and dc, the weight gradients from their scratch as
    the plain version forms them, the statistics and dgate as summed."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    dr, dt, a, dcs, sums, dgate = f3b_walk(shape, k, g)
    dx = dx_walk("f3b", shape, k["kr"], k["kh"], dr, dcs)
    x32 = k["x"].float()
    dkr = torch.einsum("bhwc,bhwn->cn", x32, dr)
    dkt = torch.stack([torch.einsum("bhwj,bhwc->jc",
                                    a[..., i * hc:(i + 1) * hc], dt)
                       for i in range(nb)])
    dkh = torch.stack([cam._wgrad(x32, dcs[..., i, :], d)
                       for i, d in enumerate(dils)])
    dsr, dst = sums[:2 * c].reshape(2, c), sums[2 * c:4 * c].reshape(2, c)
    dsh = sums[4 * c:].reshape(2 * nb, hc)
    return dx, dkr, dkh, dkt, dsr, dsh, dst, dgate


def _exact_case(op, shape, seed):
    """Exact-sum inputs of op (``test_torch_cam_tile.py``'s, with dyadic
    cotangents): (walk outputs, plain outputs)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    k = _forward_case(shape, seed)
    rng = np.random.default_rng(seed + 3)
    if op == "f1b":
        dsr, dsh, dgap = (_dyadic(rng, 2, c), _dyadic(rng, 2 * nb, hc),
                          _dyadic(rng, b, c))
        dr, dcs = _f1b_cotangents(shape, k, dsr, dsh)
        got = (dx_walk(op, shape, k["kr"], k["kh"], dr, dcs, dgap),)
        want = cam.cam_f1_bwd_plain(k["x"], k["kr"], k["kh"], dsr, dsh,
                                    dgap, dils)[:1]
    elif op == "f2b":
        dst = _dyadic(rng, 2, c)
        dcs = _f2b_cotangents(shape, k, dst)
        got = (dx_walk(op, shape, None, k["kh"], None, dcs),)
        want = cam.cam_f2_bwd_plain(k["x"], k["kh"], k["kt"], k["bnh"], dst,
                                    dils)[:1]
    else:
        g = _ints(rng, -2, 3, b, h, w, c).to(torch.bfloat16)
        got = _f3b_outputs(shape, k, g)
        want = cam.cam_f3_bwd_plain(k["x"], k["kr"], k["kh"], k["kt"],
                                    k["bnr"], k["bnh"], k["bnt"], k["gate"],
                                    g, dils)
    return got, want


@pytest.mark.parametrize("op,name", by_op(WALK_SHAPES))
def test_wgb_walk_matches_the_plain_backwards(op, name):
    """The walks on exact-sum inputs: F1b's and F2b's dx, and all eight
    of F3b's outputs (dx; dkr, dkh and dkt from the walk's scratch; dSr,
    dSh, dSt and dgate from its column sums), bitwise
    ``cam_f1_bwd_plain`` / ``cam_f2_bwd_plain`` / ``cam_f3_bwd_plain``
    at plans with the dc halo whole, in two branch buffers and in K
    chunks, two and three column passes, dr a stage at a time, F3b's x
    halo in K chunks, branch slices with a and the rows out of shared
    memory, and dt in chunks, and at the train step's widths."""
    shape = WALK_SHAPES[name]
    p = cam.tile_plan(op, *shape)
    if name == "step128":       # F2b has no dr rows: its halo fits whole
        assert p["dx_hres"] == (op == "f2b") and p["dx_nq"] == 1
    if name == "step96":
        assert p["dx_hres"]
    if name == "step256":
        assert p["dx_npass"] == 2 and p["dx_nq"] > 1
        assert op != "f3b" or p["nq"] > 1
    if name == "dr_stages":
        assert op == "f2b" or not p["dx_dr_res"]
    if name == "slices" and op == "f3b":
        assert p["nsl"] == 2 and not (p["a_res"] or p["rows_smem"])
    if name == "dt_chunks" and op == "f3b":
        assert p["nd"] > 1
    got, want = _exact_case(op, shape, 17)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape, i
        assert bool((w_ != 0).any()), i
        assert torch.equal(g_, w_), i


@pytest.mark.parametrize("op", OPS)
def test_wgb_walk_matches_pallas_interpret(op):
    """The walks against the TPU kernels they stand for
    (``pallas_cam.py:_f1b_call`` / ``_f2b_call`` / ``_f3b_call``,
    interpret mode) on random inputs at C = 195, hc = 48 (--inplanes 96's
    step CAM) on a ragged image, with ``tests/test_torch_cam.py``'s
    tolerances: the bf16 dx within 2^-8 of its largest magnitude (a
    rounding on the other side of a tie); F3b's float32 outputs, the
    weight gradients and statistics summed over the pixels' bf16
    cotangents, as its gradients through bf16 roundings (within 2^-5 of
    the largest magnitude and cosine > 0.999): the walk adds a conv's K
    stages and taps in another order than XLA, so a recomputed conv
    (hence c, a mask, dc) can round to the neighbouring bf16 value, and
    one such dc moves a dkh element by 8e-5 of dkh's largest here.
    F3b's dx on image 0 only, its other outputs whole."""
    _vs_pallas(op, (2, 9, 11, 195, (1, 2, 3), 48))


@pytest.mark.parametrize("op,name", by_op(TRAIN_WALKS))
def test_wgb_walk_matches_pallas_interpret_at_train_widths(op, name):
    """The same at the train step's widths (C = 163, hc = 40; C = 83,
    hc = 20) on a small ragged image, with the same tolerances."""
    b, h, w, c, dils, hc = TRAIN_WALKS[name]
    _vs_pallas(op, (2, h, w, c, dils, hc))


def _vs_pallas(op, shape):
    b, h, w, c, dils, hc = shape
    assert cam.tile_plan(op, *shape)["dx_wg"]
    inp = _inputs(*shape, seed=sum(shape[:4]) + 1)
    k = {n: torch.from_numpy(inp[n]) for n in inp}
    for n in ("x", "kr", "kh", "kt", "g"):
        k[n] = k[n].to(torch.bfloat16)
    if op == "f1b":
        dr, dcs = _f1b_cotangents(shape, k, k["dsr"], k["dsh"])
        got = (dx_walk(op, shape, k["kr"], k["kh"], dr, dcs, k["dgap"]),)
        want = pc._f1b_call(*[_jx(k[n]) for n in (
            "x", "kr", "kh", "dsr", "dsh", "dgap")], dils)[:1]
    elif op == "f2b":
        dcs = _f2b_cotangents(shape, k, k["dst"])
        got = (dx_walk(op, shape, None, k["kh"], None, dcs),)
        want = pc._f2b_call(*[_jx(k[n]) for n in (
            "x", "kh", "kt", "bnh", "dst")], dils)[:1]
    else:
        got = _f3b_outputs(shape, k, k["g"])
        want = pc._f3b_call(*[_jx(k[n]) for n in (
            "x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate", "g")], dils)
        got = (got[0][:1],) + tuple(got[1:])
        want = (want[0][:1],) + tuple(want[1:])
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        w_ = torch.from_numpy(np.array(jnp.asarray(w_, jnp.float32)))
        assert g_.shape == w_.shape, i
        if g_.dtype == torch.bfloat16:
            scale = max(float(w_.abs().max()), 1e-6)
            assert float((g_.float() - w_).abs().max()) <= BF16_TOL * scale
        else:
            _grad_close(g_, w_, f"{op}[{i}]")
