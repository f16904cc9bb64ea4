"""The Python side of the fused-CAM tile kernels (``csrc/cam_tile.cuh``:
the backwards F1b, F2b and F3b and the forwards F1, F2 and F3), on the
CPU:
the plan (tiles, padded widths, pitches, shared memory), the tile order,
and the weights re-laid once per call.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them against the plain versions there).  Here the layout contract
they rely on is checked for each op: every staged row is 16-byte
aligned, both kernels fit a block's shared memory at the train step's
CAM shapes and the card tests' shapes, the tiles cover each pixel once
with each image's tiles contiguous, the re-laid weights give back kr, kh
and kt with zero padding, and a walk over the tiles that multiplies
exactly what the kernels stage (each tap's rows gathered from one halo,
each stage's weights sliced out of the re-laid buffers at the stage's
offset) gives the plain version's products bitwise on exact-sum inputs;
for F1b and F2b the walk through both phases, with the kernels' epilogues,
gives the plain version's dx bitwise, and for F1, F2 and F3 the walk with
their epilogues (F1's and F2's masked per-tile sums, F3's output) gives
the plain version's outputs and the interpret-mode Pallas kernel's
bitwise (F2 on random inputs within 2^-8, and only with its ragged
tile's padding pixels masked).  A forward's plan is its backward's phase
0 without the branch backward: F1's re-laid weights are F1b's, F2's and
F3's a prefix of F2b's and F3b's, and in the whole-depth plan a forward
needs no more shared memory than its backward.  Geometries whose
whole-depth halo does not fit (six dilations up to 6 or 8 at C = 163)
take the wide plan (``tests/test_torch_cam_wide.py``), within shared
memory; every op refuses only a largest dilation past the wide plan's
(20 at C = 163), by name.

The parametrised tests keep F3b's cases under their first ids (shape0,
...) and add the other ops' as f1b-shape0, ..., f2b-shape0, ...,
f1-shape0, ..., f3-shape0, ....
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtpe_tpu.ops import pallas_cam as pc
from rtpe_tpu_torch.ops import cam

# (B, H, W, C, dilations, hc): the train step's two CAM shapes, the card
# tests' shapes (ragged tiles, a side smaller than a tile, a dilation
# larger than a tile side), and C > 168 (two dx channel chunks)
STEPS_CAM = (16, 113, 113, 163, (1, 2, 3), 40)
PYRAMID_CAM = (16, 113, 113, 83, (1, 2, 3, 4), 20)
SHAPES = [STEPS_CAM, PYRAMID_CAM,
          (2, 21, 21, 12, (1, 2, 3), 3), (3, 29, 21, 83, (1, 2, 3, 4), 20),
          (2, 17, 23, 163, (1, 2, 3), 40), (2, 9, 13, 83, (1, 2, 3, 4), 20),
          (1, 5, 30, 163, (1, 2, 3), 40), (1, 30, 5, 83, (1, 2, 3, 4), 20),
          (1, 11, 19, 12, (1, 9), 3), (1, 9, 10, 170, (1, 2), 8)]
WALK_SHAPES = [(2, 9, 13, 12, (1, 2, 3, 4), 3), (1, 5, 30, 70, (1, 2, 3), 20),
               (1, 11, 19, 12, (1, 9), 3), (1, 9, 10, 170, (1, 2), 8)]
BWD_OPS = ("f3b", "f1b", "f2b")
OPS = BWD_OPS + ("f1", "f3", "f2")
FWD_OPS = ("f1", "f3", "f2")
NC = cam.TILE_NC
TS = cam.TILE_TS


def by_op(shapes, ops=OPS):
    """(op, shape) cases, F3b's with the ids its cases had before the
    other ops shared these tests."""
    return [pytest.param(op, s, id=f"shape{k}" if op == "f3b"
                         else f"{op}-shape{k}")
            for op in ops for k, s in enumerate(shapes)]


def f3b_tiles(b, h, w):
    """(image, y0, x0) of each tile in the kernels' order
    (``cam_tile.cuh:tile_pos``: image-major, then row-major)."""
    tx, tpi = -(-w // TS), -(-w // TS) * -(-h // TS)
    return [(t // tpi, (t % tpi) // tx * TS, (t % tpi) % tx * TS)
            for t in range(b * tpi)]


def stage0(p, nb, s, op="f3b"):
    """(offset in w0, rows, k width) of phase-0 weight stage s of ``op``,
    as ``cam_tile.cuh:stage0`` computes it: the branch taps (nb x 9 of
    [brows][kc]), then per chunk of NC output channels [NC][kc] (f1, f3,
    f1b, f3b) and [NC][knh] (f2, f3, f2b, f3b), then per branch [brows][kc]
    (f2b, f3b)."""
    res, top, _ = cam.TILE_OPS[op]
    per = res + top
    wb = p["brows"] * p["kc"]
    pair = NC * (p["kc"] * res + p["knh"] * top)
    if s < 9 * nb:
        return s * wb, p["brows"], p["kc"]
    s -= 9 * nb
    if s < per * p["nchr"]:
        q, u = divmod(s, 2) if per == 2 else (s, int(top))
        return (9 * nb * wb + q * pair + u * res * NC * p["kc"], NC,
                p["knh"] if u else p["kc"])
    return (9 * nb * wb + p["nchr"] * pair + (s - per * p["nchr"]) * wb,
            p["brows"], p["kc"])


# the kernels' shared memory at the train step's shapes, bytes
SMEM = {("f3b", STEPS_CAM): (204588, 139584),
        ("f3b", PYRAMID_CAM): (132780, 104064),
        ("f1b", STEPS_CAM): (136216, 139584),
        ("f1b", PYRAMID_CAM): (89496, 104064),
        ("f2b", STEPS_CAM): (200024, 116032),
        ("f2b", PYRAMID_CAM): (130456, 90752),
        ("f1", STEPS_CAM): (133952, 0),
        ("f1", PYRAMID_CAM): (88192, 0),
        ("f3", STEPS_CAM): (159148, 0),
        ("f3", PYRAMID_CAM): (103724, 0),
        ("f2", STEPS_CAM): (153280, 0),
        ("f2", PYRAMID_CAM): (100736, 0)}


@pytest.mark.parametrize("op,shape", by_op(SHAPES))
def test_f3b_plan_rows_are_16_byte_aligned(op, shape):
    p = cam.tile_plan(op, *shape)
    nb, hc = len(shape[4]), shape[5]
    # shared pitches: the x and dr rows, sA/sCb, the dc halo, the weights
    pitches = [p["xp"], p["nhp"], p["cp"], p["khc"] + 8, p["kw0"] + 8]
    # global rows the kernels copy: padded x and dr, dc, each weight row
    rows = [p["kc"], p["ldc"], p["knh"], p["khc"]]
    branch_offsets = [i * p["khc"] for i in range(nb)]
    for v in pitches + rows + branch_offsets:
        assert (2 * v) % 16 == 0, (v, p)
    # odd 16-byte pitches: the 8 rows of an ldmatrix hit 8 bank groups
    for v in pitches:
        assert (2 * v // 16) % 2 == 1, v
    assert p["kc"] >= shape[3] and p["khc"] >= hc and p["brows"] >= hc
    assert p["knh"] >= nb * hc and p["nxr"] % 8 == 0
    for s in range(p["nst0"]):
        off, rows_, kw = stage0(p, nb, s, op)
        assert (2 * off) % 16 == 0 and kw % 16 == 0 and rows_ % 8 == 0
        assert kw <= p["kw0"] and rows_ <= NC
    assert off + rows_ * kw == p["w0_elems"]      # the last stage ends w0


@pytest.mark.parametrize("op,shape", by_op(SHAPES))
def test_f3b_shared_memory_fits(op, shape):
    p = cam.tile_plan(op, *shape)
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX == 232448
    if (op, shape) in SMEM:
        assert (p["smem0"], p["smem1"]) == SMEM[op, shape]


def test_f3b_refuses_what_does_not_fit():
    """Six dilations up to 6 at C = 163, which F3b once refused (its
    whole-depth halo alone is 147 KB, beside the whole-depth plan's
    staged rows): the wide plan takes them, F3b's phase 0 on
    ``cam_wg.cuh``'s f3b_wg_kernel with x's halo once a tile at full
    depth (the mma.sync wide plan took three K chunks), within a block's
    shared memory."""
    p = cam.tile_plan("f3b", 1, 32, 32, 163, (1, 2, 3, 4, 5, 6), 40)
    assert p["ok"] and p["wide"] and p["wg"] and p["nq"] == 1
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX


@pytest.mark.parametrize("op", ["f1b", "f2b", "f1", "f3", "f2"])
def test_tile_refuses_what_does_not_fit(op):
    """The same geometry for F1b (its dx kernel's whole-depth dr rows and
    dc halo, 231 KB, once did not fit), F2b, F3 and F2 (their whole-depth
    phase 0), and a largest dilation of 8 for F1 (212 KB of halo): the
    wide plan takes them all; F1 keeps the whole-depth plan at dilations
    up to 6 (its halo and weight ring, 209 KB, fit)."""
    dils = (1, 2, 3, 4, 5, 8) if op == "f1" else (1, 2, 3, 4, 5, 6)
    p = cam.tile_plan(op, 1, 32, 32, 163, dils, 40)
    assert p["ok"] and p["wide"]
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX
    if op == "f1":
        assert not cam.tile_plan(op, 1, 32, 32, 163, (1, 2, 3, 4, 5, 6),
                                 40)["wide"]


# the largest dilation every op takes at every width (the wide plan's
# halo of one 16-channel chunk, double-buffered, and its ring), and one
# past it that none takes at C = 163
DIL_TAKEN, DIL_REFUSED = 18, 20


@pytest.mark.parametrize("op", OPS)
def test_tile_refuses_a_dilation_past_the_limit(op):
    for c, hc, nb in ((163, 40, 2), (515, 128, 3), (83, 20, 4)):
        dils = (1,) * (nb - 1) + (DIL_TAKEN,)
        p = cam.tile_plan(op, 1, 32, 32, c, dils, hc)
        assert p["ok"] and max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX
    p = cam.tile_plan(op, 1, 32, 32, 163, (1, DIL_REFUSED), 40)
    assert not p["ok"]
    x = torch.zeros((1, 32, 32, 163), dtype=torch.bfloat16)
    kh = torch.zeros((2, 3, 3, 163, 40), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"largest dilation {DIL_REFUSED}"):
        cam._tile_call(op, op, x, None, kh, None, (1, DIL_REFUSED))


# once refused (the whole-depth halo did not fit); the wide plan takes them
REFUSED = [(1, 32, 32, 163, (1, 2, 3, 4, 5, 6), 40),
           (1, 32, 32, 163, (1, 2, 3, 4, 5, 8), 40)]


@pytest.mark.parametrize("op,shape", by_op(SHAPES + REFUSED, FWD_OPS))
def test_forward_fits_where_its_backward_does(op, shape):
    """A forward and its backward both fit a block's shared memory (the
    training path needs both); in the whole-depth plan a forward needs at
    most its backward's (the larger of its two phases)."""
    fwd, bwd = cam.tile_plan(op, *shape), cam.tile_plan(op + "b", *shape)
    assert fwd["smem1"] == fwd["w1_elems"] == 0
    assert fwd["ok"] and bwd["ok"]
    assert max(fwd["smem0"], bwd["smem0"], bwd["smem1"]) <= cam.SMEM_MAX
    if not (fwd["wide"] or bwd["wide"]):
        assert fwd["smem0"] <= max(bwd["smem0"], bwd["smem1"])


BHW = [(16, 113, 113), (16, 57, 57), (16, 29, 29), (3, 29, 21), (1, 5, 30),
       (2, 9, 13), (1, 8, 8)]


@pytest.mark.parametrize("op,bhw", [
    pytest.param(op, bhw, id=f"bhw{k}" if op == "f3b" else f"{op}-bhw{k}")
    for op in ("f3b",) + FWD_OPS for k, bhw in enumerate(BHW)])
def test_f3b_tiles_cover_each_pixel_once(op, bhw):
    b, h, w = bhw
    tiles = f3b_tiles(b, h, w)
    p = cam.tile_plan(op, b, h, w, 8, (1,), 8)
    assert len(tiles) == p["n_tiles"] == b * p["tpi"]
    seen = np.zeros((b, h, w), np.int64)
    for t, (img, y0, x0) in enumerate(tiles):
        assert img == t // p["tpi"]            # image-major, contiguous
        assert y0 < h and x0 < w               # no tile is all outside
        seen[img, y0:y0 + 8, x0:x0 + 8] += 1
    assert (seen == 1).all()
    if (h, w) == (113, 113):                   # the ragged waste stated
        assert p["tpi"] * 64 / (h * w) - 1 == pytest.approx(0.1278, 1e-3)


def _weights(shape, seed, exact=True):
    _, _, _, c, dils, hc = shape
    nb = len(dils)
    rng = np.random.default_rng(seed)

    def draw(*s):
        v = rng.integers(-1, 2, s) if exact else rng.normal(size=s)
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)

    return draw(c, c), draw(nb, 3, 3, c, hc), draw(nb, hc, c)


def _op_weights(op, kr, kh, kt):
    """The weights ``op`` takes (the wrappers pass None for the others)."""
    res, top, _ = cam.TILE_OPS[op]
    return kr if res else None, kh, kt if top else None


@pytest.mark.parametrize("op,shape", by_op(SHAPES))
def test_f3b_weights_unpad_to_the_inputs(op, shape):
    _, _, _, c, dils, hc = shape
    nb, nh = len(dils), len(dils) * hc
    res, top, bb = cam.TILE_OPS[op]
    kr, kh, kt = _weights(shape, 3, exact=False)
    w0, w1 = cam._tile_weights(op, *_op_weights(op, kr, kh, kt))
    p = cam.tile_plan(op, *shape)
    assert w0.dtype == torch.bfloat16 and w0.numel() == p["w0_elems"]

    def stage(s):
        off, rows, kw = stage0(p, nb, s, op)
        return w0[off:off + rows * kw].reshape(rows, kw), rows, kw

    def check(block, want):
        n, k = want.shape
        assert torch.equal(block[:n, :k], want)
        assert not block[n:].any() and not block[:, k:].any()

    per = res + top
    for i in range(nb):
        for tap in range(9):
            block, _, _ = stage(9 * i + tap)
            check(block, kh[i, tap // 3, tap % 3].t())
        if bb:
            block, _, _ = stage(9 * nb + per * p["nchr"] + i)
            check(block, kt[i])
    ktf = kt.reshape(nh, c)
    for ch in range(p["nchr"]):
        n0, n1 = ch * NC, min(c, (ch + 1) * NC)
        s = 9 * nb + per * ch
        if res:
            check(stage(s)[0], kr[:, n0:n1].t())
        if top:
            check(stage(s + res)[0], ktf[:, n0:n1].t())
    if not op.endswith("b"):
        assert w1 is None and p["w1_elems"] == 0
        return
    assert w1.dtype == torch.bfloat16 and w1.numel() == p["w1_elems"]
    nxr, khc = p["nxr"], p["khc"]
    st = w1.reshape(p["nchx"], p["nst1"], nxr, khc)
    assert p["nksr"] == (-(-p["kc"] // khc) if res else 0)
    for ch in range(p["nchx"]):
        n0, n1 = ch * nxr, min(c, (ch + 1) * nxr)
        if res:
            krs = torch.cat(list(st[ch, :p["nksr"]]), 1)
            check(krs, kr[n0:n1])
        for i in range(nb):
            for tap in range(9):
                check(st[ch, p["nksr"] + 9 * i + tap],
                      kh[i, tap // 3, tap % 3, n0:n1])


def _halo(img, y0, x0, dm, hs):
    """The (hs, hs, width) window whose (dm, dm) is pixel (y0, x0), zero
    outside the image."""
    pad = F.pad(img, (0, 0, dm, hs, dm, hs))
    return pad[y0:y0 + hs, x0:x0 + hs]


def _tile_rows(t, y0, x0):
    """The tile's 64 pixel rows of t (H, W, width), zero outside it."""
    hy, hx = t.shape[0] - y0, t.shape[1] - x0
    return F.pad(t[y0:y0 + 8, x0:x0 + 8],
                 (0, 0, 0, max(0, 8 - hx), 0, max(0, 8 - hy))).reshape(64, -1)


def _put(out, img, y0, x0, rows):
    """Write a tile's 64 rows of a product back into out (B, H, W, n)."""
    hy, hx = min(8, out.shape[1] - y0), min(8, out.shape[2] - x0)
    n = out.shape[3]
    out[img, y0:y0 + hy, x0:x0 + hx] = rows.reshape(8, 8, -1)[:hy, :hx, :n]


def _phase0_walk(op, shape, x, w0, a=None, acts=None):
    """The products ``op``'s phase-0 kernel takes before its branch
    backward, tile by tile as it stages them: one halo of x (padded to
    kc) per tile, each tap's 8 x 8 rows gathered from it, each stage's
    weights sliced from w0 at its offset.  float32: the branch convs "c"
    (B, H, W, nb, hc); x kr "res" (f1, f3, f1b, f3b); a kt "top" (f3,
    f2b, f3b; a (B, H, W, NH) given, or acts(c)).  For f1 also "part",
    F1's epilogue: per tile the row [S_r (2C) | S_h (2 NH) | sum of x
    (C)], the sums of bf16(x kr) and of each bf16(c) and their squares
    over the tile's rows in the image (a row outside it is masked: its
    taps can reach into the image), and x summed over the halo's 64
    centre rows; for f2 "part" is F2's epilogue, per tile the row [S_t
    (2C)] of bf16(a kt), masked the same way."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    res, top, _ = cam.TILE_OPS[op]
    p = cam.tile_plan(op, *shape)
    kc, dm, hs, per = p["kc"], p["dmax"], p["hs"], res + top
    xpad = F.pad(x, (0, kc - c))
    sums = op in ("f1", "f2")
    sum_of = {"f1": "res", "f2": "top"}.get(op)     # the 1x1 conv summed
    nh = nb * hc

    def weight(s):
        off, n, kw = stage0(p, nb, s, op)
        return w0[off:off + n * kw].float().reshape(n, kw)

    def colsums(t, col_sum, col_sq, rows, y0, x0):
        inside = torch.tensor([y0 + r // 8 < h and x0 + r % 8 < w
                               for r in range(64)])
        v = torch.where(inside[:, None], cam._bf(rows), torch.zeros(()))
        part[t, col_sum:col_sum + v.shape[1]] = v.sum(0)
        part[t, col_sq:col_sq + v.shape[1]] = (v * v).sum(0)

    conv = torch.zeros(b, h, w, nb, hc)
    out = {"c": conv}
    tiles = f3b_tiles(b, h, w)
    part = torch.zeros(len(tiles), 3 * c + 2 * nh if op == "f1" else 2 * c)
    for t, (img, y0, x0) in enumerate(tiles):
        hx_ = _halo(xpad[img], y0, x0, dm, hs)
        for i, d in enumerate(dils):
            acc = torch.zeros(64, p["brows"])
            for tap in range(9):
                dy, dx = (tap // 3 - 1) * d, (tap % 3 - 1) * d
                rows = hx_[dm + dy:dm + dy + 8, dm + dx:dm + dx + 8]
                acc = acc + rows.reshape(64, -1) @ weight(9 * i + tap).t()
            _put(conv[..., i, :], img, y0, x0, acc[:, :hc])
            if op == "f1":
                colsums(t, 2 * c + 2 * i * hc, 2 * c + (2 * i + 1) * hc,
                        acc[:, :hc], y0, x0)
        if op == "f1":
            centre = hx_[dm:dm + 8, dm:dm + 8].reshape(64, -1)
            part[t, 2 * c + 2 * nh:] = centre[:, :c].sum(0)
    if top and a is None:
        a = acts(conv)
    for name, on, src, k in (("res", res, xpad, 0),
                             ("top", top, a, 1)):
        if not on:
            continue
        srcp = F.pad(src, (0, (kc if k == 0 else p["knh"]) - src.shape[3]))
        prod = torch.zeros(b, h, w, c)
        for t, (img, y0, x0) in enumerate(tiles):
            rows = _tile_rows(srcp[img], y0, x0)
            for ch in range(p["nchr"]):
                s = 9 * nb + per * ch + (k if res else 0)
                n0 = ch * NC
                prod_rows = rows @ weight(s).t()
                n1 = min(c, n0 + NC)
                _put(prod[..., n0:n1], img, y0, x0, prod_rows[:, :n1 - n0])
                if name == sum_of:
                    colsums(t, n0, c + n0, prod_rows[:, :n1 - n0], y0, x0)
        out[name] = prod
    if sums:
        out["part"] = part
    return out, p


def _branch_backward_walk(op, shape, p, dt, w0):
    """da (B, H, W, nb, hc): dt (padded to kc) . kt[i] from the branch
    backward's stages, tile by tile."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    dtp = F.pad(dt, (0, p["kc"] - c))
    da = torch.zeros(b, h, w, nb, hc)
    for img, y0, x0 in f3b_tiles(b, h, w):
        rows = _tile_rows(dtp[img], y0, x0)
        for i in range(nb):
            off, n, kw = stage0(p, nb, p["nst0"] - nb + i, op)
            wt = w0[off:off + n * kw].float().reshape(n, kw)
            _put(da[..., i, :], img, y0, x0, (rows @ wt.t())[:, :hc])
    return da


def _dx_walk(op, shape, dr, dcp, w1):
    """The dx kernel's sum, tile by tile: the tile's dr rows (f1b, f3b;
    padded to kc) against the nksr kr slices, then one halo of dc (each
    branch padded to khc) per tile, each transposed tap's rows gathered
    from it against kh[i, tap].  float32 (B, H, W, C), before rounding."""
    b, h, w, c, dils, hc = shape
    res = cam.TILE_OPS[op][0]
    p = cam.tile_plan(op, *shape)
    kc, khc, dm, hs = p["kc"], p["khc"], p["dmax"], p["hs"]
    dx = torch.zeros(b, h, w, c)
    w1s = w1.float().reshape(p["nchx"], p["nst1"], p["nxr"], khc)
    for img, y0, x0 in f3b_tiles(b, h, w):
        hc_ = _halo(dcp[img], y0, x0, dm, hs)
        for ch in range(p["nchx"]):
            acc = torch.zeros(64, p["nxr"])
            if res:
                r = _tile_rows(F.pad(dr[img], (0, kc - c)), y0, x0)
                for s in range(p["nksr"]):
                    k0 = s * khc
                    kw = min(khc, kc - k0)
                    acc = acc + r[:, k0:k0 + kw] @ w1s[ch, s, :, :kw].t()
            for i, d in enumerate(dils):
                for tap in range(9):
                    dy, dxx = -(tap // 3 - 1) * d, -(tap % 3 - 1) * d
                    a = hc_[dm + dy:dm + dy + 8,
                            dm + dxx:dm + dxx + 8].reshape(64, -1)
                    acc = acc + a[:, i * khc:(i + 1) * khc] \
                        @ w1s[ch, p["nksr"] + 9 * i + tap].t()
            n0 = ch * p["nxr"]
            n1 = min(c, n0 + p["nxr"])
            _put(dx[..., n0:n1], img, y0, x0, acc[:, :n1 - n0])
    return dx


def _pad_dc(dc, p):
    """dc (B, H, W, nb, hc) -> (B, H, W, nb khc), each branch padded."""
    b, h, w = dc.shape[:3]
    return F.pad(dc, (0, p["khc"] - dc.shape[4])).reshape(b, h, w, p["ldc"])


def _ints(rng, lo, hi, *shape):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


@pytest.mark.parametrize("op,shape", by_op(WALK_SHAPES, BWD_OPS))
def test_f3b_tile_walk_matches_plain_on_exact_sums(op, shape):
    """Exact-sum inputs: the walk's float32 products equal the plain
    convolutions bitwise, so the halo gathers, the tap shifts (forward
    and transposed), the stage order and the padding are the plain
    version's: the branch convs (dc of F1b, a of F2b and F3b), x kr (dr
    of F1b and F3b), a kt (dt of F2b and F3b), dt kt[i]^T (dc of F2b and
    F3b) and dx."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    res, top, _ = cam.TILE_OPS[op]
    kr, kh, kt = _weights(shape, 5)
    rng = np.random.default_rng(6)
    x = _ints(rng, -1, 2, b, h, w, c)
    a = _ints(rng, -2, 3, b, h, w, nb * hc)
    dt = _ints(rng, -2, 3, b, h, w, c)
    dr = _ints(rng, -2, 3, b, h, w, c)
    dc = _ints(rng, -2, 3, b, h, w, nb, hc)
    w0, w1 = cam._tile_weights(op, *_op_weights(op, kr, kh, kt))
    out, p = _phase0_walk(op, shape, x, w0, a=a)
    for i, d in enumerate(dils):
        assert torch.equal(out["c"][..., i, :], cam._conv(x, kh[i], d)), i
    if res:
        assert torch.equal(out["res"], x @ kr.float())
    if top:
        assert torch.equal(out["top"], a @ kt.float().reshape(nb * hc, c))
        da = _branch_backward_walk(op, shape, p, dt, w0)
        for i in range(nb):
            assert torch.equal(da[..., i, :], dt @ kt[i].float().t()), i
    got = _dx_walk(op, shape, dr, _pad_dc(dc, p), w1)
    want = dr @ kr.float().t() if res else torch.zeros(b, h, w, c)
    for i, d in enumerate(dils):
        want = want + cam._conv_t(dc[..., i, :].contiguous(), kh[i], d)
    assert torch.equal(got, want)


def _dyadic(rng, *shape):
    return torch.from_numpy((rng.integers(-4, 5, shape) / 8.0).astype(
        np.float32))


def _bn_rows_exact(rng, nb, hc):
    """BN rows [mean, inv, scale, bias] per branch, each exact in bf16 and
    every product with them exact in float32."""
    rows = []
    for _ in range(nb):
        rows += [torch.from_numpy(rng.integers(-2, 3, hc).astype(np.float32)),
                 torch.full((hc,), 0.25),
                 torch.from_numpy(0.5 * rng.integers(1, 3, hc).astype(
                     np.float32)),
                 _dyadic(rng, hc)]
    return torch.stack(rows)


@pytest.mark.parametrize("op,shape", by_op(WALK_SHAPES, ("f1b", "f2b")))
def test_tile_dx_walk_matches_the_plain_backwards(op, shape):
    """Both phases of F1b (dx kernel with HAS_DR and HAS_GAP) and F2b
    (without HAS_DR) walked on exact-sum inputs, each phase-0 epilogue as
    the kernel writes it (bf16 roundings, the _rn order): the dx rounded
    once to bf16 equals ``cam_f1_bwd_plain``'s / ``cam_f2_bwd_plain``'s
    bitwise."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    kr, kh, kt = _weights(shape, 8)
    rng = np.random.default_rng(9)
    xb = _ints(rng, -1, 2, b, h, w, c).to(torch.bfloat16)
    x = xb.float()
    w0, w1 = cam._tile_weights(op, *_op_weights(op, kr, kh, kt))
    bf = cam._bf
    if op == "f1b":
        dsr, dsh, dgap = (_dyadic(rng, 2, c), _dyadic(rng, 2 * nb, hc),
                          _dyadic(rng, b, c))
        out, p = _phase0_walk(op, shape, x, w0)
        cb = bf(out["c"])
        dc = bf(dsh[0::2] + 2.0 * cb * dsh[1::2])
        dr = bf(dsr[0] + 2.0 * bf(out["res"]) * dsr[1])
        acc = _dx_walk(op, shape, dr, _pad_dc(dc, p), w1)
        got = (acc + dgap[:, None, None, :] * (1.0 / (h * w))).to(
            torch.bfloat16)
        want = cam.cam_f1_bwd_plain(xb, kr, kh, dsr, dsh, dgap, dils)[0]
    else:
        bnh, dst = _bn_rows_exact(rng, nb, hc), _dyadic(rng, 2, c)
        mean, inv, scale, bias = (bnh[k::4] for k in range(4))

        def acts(conv):
            z = (bf(conv) - mean) * inv * scale + bias
            return bf(torch.relu(z)).reshape(b, h, w, nb * hc)

        out, p = _phase0_walk(op, shape, x, w0, acts=acts)
        z = (bf(out["c"]) - mean) * inv * scale + bias
        dt = bf(dst[0] + 2.0 * bf(out["top"]) * dst[1])
        da = _branch_backward_walk(op, shape, p, dt, w0)
        dc = bf(torch.where(z > 0.0, da, torch.zeros_like(da))
                * (scale * inv))
        got = _dx_walk(op, shape, None, _pad_dc(dc, p), w1).to(
            torch.bfloat16)
        want = cam.cam_f2_bwd_plain(xb, kh, kt, bnh, dst, dils)[0]
    assert bool((want != 0).any())
    assert torch.equal(got, want)


def _forward_case(shape, seed):
    """Exact-sum inputs of F1 and F3: x and the weights in {-1, 0, 1},
    BN rows exact in bf16 with exact products, dyadic gates of both
    signs."""
    b, h, w, c, dils, hc = shape
    kr, kh, kt = _weights(shape, seed)
    rng = np.random.default_rng(seed + 1)
    return {"x": _ints(rng, -1, 2, b, h, w, c).to(torch.bfloat16),
            "kr": kr, "kh": kh, "kt": kt,
            "bnr": _bn_rows_exact(rng, 1, c),
            "bnh": _bn_rows_exact(rng, len(dils), hc),
            "bnt": _bn_rows_exact(rng, 1, c), "gate": _dyadic(rng, b, c)}


def _forward_walk(op, shape, k):
    """F1's (s_r, s_h, gap) from its per-tile rows summed over the tiles
    (gap per image: its tiles are contiguous), F2's (s_t,) the same way,
    or F3's (out,) from the products with the kernel's epilogue,
    bf16(relu(relu(BN_r(bf16 res)) + relu(BN_t(bf16 top)) gate[b]))."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    w0, w1 = cam._tile_weights(op, *_op_weights(op, k.get("kr"), k["kh"],
                                                k["kt"]))
    assert w1 is None
    x = k["x"].float()
    bf = cam._bf
    if op == "f1":
        out, p = _phase0_walk(op, shape, x, w0)
        part = out["part"]
        return (part[:, :2 * c].sum(0).reshape(2, c),
                part[:, 2 * c:2 * c + 2 * nb * hc].sum(0).reshape(2 * nb, hc),
                part[:, 2 * c + 2 * nb * hc:].reshape(b, p["tpi"], c).sum(1))
    mean, inv, scale, bias = (k["bnh"][j::4] for j in range(4))

    def acts(conv):
        z = (bf(conv) - mean) * inv * scale + bias
        return bf(torch.relu(z)).reshape(b, h, w, nb * hc)

    def bn_relu(v, rows):
        return torch.relu((bf(v) - rows[0]) * rows[1] * rows[2] + rows[3])

    out, _ = _phase0_walk(op, shape, x, w0, acts=acts)
    if op == "f2":
        return (out["part"].sum(0).reshape(2, c),)
    pre = bn_relu(out["res"], k["bnr"]) \
        + bn_relu(out["top"], k["bnt"]) * k["gate"][:, None, None, :]
    return (torch.relu(pre).to(torch.bfloat16),)


def _forward_args(op, k, dils):
    names = {"f1": ("x", "kr", "kh"), "f2": ("x", "kh", "kt", "bnh"),
             "f3": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate")}[op]
    return [k[n] for n in names] + [dils]


PLAIN_FWD = {"f1": cam.cam_f1_fwd_plain, "f3": cam.cam_f3_fwd_plain,
             "f2": cam.cam_f2_fwd_plain}


@pytest.mark.parametrize("op,shape", by_op(WALK_SHAPES, FWD_OPS))
def test_tile_forward_walk_matches_the_plain_forwards(op, shape):
    """F1, F2 and F3 walked tile by tile on exact-sum inputs, each with its
    kernel's epilogue (F1's and F2's per-tile sums masked to the image's
    rows and reduced over the tiles, F3's output with the bf16 roundings
    and the BN and gate order): equal to ``cam_f1_fwd_plain``'s (s_r,
    s_h, gap), ``cam_f2_fwd_plain``'s s_t and ``cam_f3_fwd_plain``'s out
    bitwise."""
    k = _forward_case(shape, 12)
    got = _forward_walk(op, shape, k)
    plain = PLAIN_FWD[op]
    want = plain(*_forward_args(op, k, shape[4]))
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape, i
        assert bool((w_ != 0).any()), i
        assert torch.equal(g_, w_), i


def _jx(t):
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(dt)


@pytest.mark.parametrize("op", ["f1", "f3", "f2"])
def test_tile_forward_walk_matches_pallas_interpret(op):
    """The same walks against the TPU kernels they replace
    (``pallas_cam.py:_f1_call`` / ``_f3_call`` / ``_f2_call``, interpret
    mode) on a
    ragged exact-sum shape whose largest dilation (9) is larger than a
    tile side: bitwise."""
    shape = (1, 11, 19, 12, (1, 9), 3)
    k = _forward_case(shape, 21)
    got = _forward_walk(op, shape, k)
    fn = {"f1": pc._f1_call, "f3": pc._f3_call, "f2": pc._f2_call}[op]
    args = _forward_args(op, k, shape[4])
    want = fn(*[_jx(t) for t in args[:-1]], shape[4])
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        w_ = torch.from_numpy(np.array(w_.astype(jnp.float32)))
        assert g_.shape == w_.shape, i
        assert bool((w_ != 0).any()), i
        assert torch.equal(g_.float(), w_), i


@pytest.mark.parametrize("op,shape", by_op(SHAPES, FWD_OPS))
def test_forward_weights_are_the_backwards_phase0_weights(op, shape):
    """F1's re-laid w0 is F1b's; F2's and F3's are F2b's and F3b's before
    their last nb stages (kt[i], the branch backward's), so their stage
    offsets are their backwards'."""
    kr, kh, kt = _weights(shape, 4, exact=False)
    w0, w1 = cam._tile_weights(op, *_op_weights(op, kr, kh, kt))
    wb0, _ = cam._tile_weights(op + "b", *_op_weights(op + "b", kr, kh, kt))
    assert w1 is None
    nb = len(shape[4])
    pf, pb = cam.tile_plan(op, *shape), cam.tile_plan(op + "b", *shape)
    assert pf["nst0"] == pb["nst0"] - nb * cam.TILE_OPS[op + "b"][2]
    assert torch.equal(w0, wb0[:w0.numel()])
    assert w0.numel() == (wb0.numel() if op == "f1"
                          else stage0(pb, nb, pb["nst0"] - nb, op + "b")[0])
    for s_ in range(pf["nst0"]):
        assert stage0(pf, nb, s_, op) == stage0(pb, nb, s_, op + "b")


def _f2_random_case(shape, seed):
    """Random F2 inputs made with numpy: x in [0, 1), weights N(0,
    1/fan_in), BN rows from the batch statistics of the branch convs (as
    the train step's F1 gives them), scale near 1, bias N(0, 0.1)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    x = bf(rng.random((b, h, w, c)))
    kh = bf(rng.normal(size=(nb, 3, 3, c, hc)) / np.sqrt(9 * c))
    kt = bf(rng.normal(size=(nb, hc, c)) / np.sqrt(nb * hc))
    s_h = cam.cam_f1_fwd_plain(x, torch.zeros(c, c, dtype=torch.bfloat16),
                               kh, dils)[1]
    n = b * h * w
    mean = s_h[0::2] / n
    var = (s_h[1::2] / n - mean * mean).clamp(min=0)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=mean.shape))
    bias = torch.from_numpy(0.1 * rng.normal(size=mean.shape))
    bnh = torch.stack([mean, torch.rsqrt(var + 1e-5), scale.float(),
                       bias.float()], 1).reshape(4 * nb, hc)
    return {"x": x, "kh": kh, "kt": kt, "bnh": bnh.contiguous()}


def test_f2_tile_walk_masks_the_ragged_tiles():
    """F2 walked on random inputs at a ragged shape (29 x 21: 22 % of the
    tile grid's pixels lie outside the image): s_t within 2^-8 of max
    |plain| of ``cam_f2_fwd_plain`` and of the interpret-mode
    ``_f2_call``.  A padding pixel's t is not zero (its BN bias and its
    dilated taps reach into the image): the same walk over the tile
    grid's pixels, none masked (the image zero-extended to whole tiles),
    is off by more than that."""
    shape = (3, 29, 21, 83, (1, 2, 3, 4), 20)
    k = _f2_random_case(shape, 31)
    dils = shape[4]
    got = _forward_walk("f2", shape, k)[0]
    want = cam.cam_f2_fwd_plain(k["x"], k["kh"], k["kt"], k["bnh"], dils)
    jwant = torch.from_numpy(np.array(pc._f2_call(
        *[_jx(k[n]) for n in ("x", "kh", "kt", "bnh")], dils)))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** -8 * scale
    assert float((got - jwant).abs().max()) <= 2.0 ** -8 * scale
    b, h, w = shape[:3]
    ext = dict(k, x=F.pad(k["x"], (0, 0, 0, -w % TS, 0, -h % TS)))
    unmasked = _forward_walk("f2", (b, h + -h % TS, w + -w % TS,
                                    *shape[3:]), ext)[0]
    assert float((unmasked - want).abs().max()) > 2.0 ** -8 * scale
