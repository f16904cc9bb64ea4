"""The Python side of F3b's tile kernels (``csrc/cam_tile.cuh``), on the
CPU: the plan (tiles, padded widths, pitches, shared memory), the tile
order, and the weights re-laid once per call.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them against the plain version there).  Here the layout contract
they rely on is checked: every staged row is 16-byte aligned, both
kernels fit a block's shared memory at the train step's CAM shapes and
the card tests' shapes, the tiles cover each pixel once with each
image's tiles contiguous, the re-laid weights give back kr, kh and kt
with zero padding, and a walk over the tiles that multiplies exactly
what the kernels stage (each tap's rows gathered from one halo, each
stage's weights sliced out of the re-laid buffers at the stage's offset)
gives the plain version's products bitwise on exact-sum inputs.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
NC = cam.F3B_NC
TS = cam.F3B_TS


def f3b_tiles(b, h, w):
    """(image, y0, x0) of each tile in the kernels' order
    (``cam_tile.cuh:tile_pos``: image-major, then row-major)."""
    tx, tpi = -(-w // TS), -(-w // TS) * -(-h // TS)
    return [(t // tpi, (t % tpi) // tx * TS, (t % tpi) % tx * TS)
            for t in range(b * tpi)]


def stage0(p, nb, s):
    """(offset in w0, rows, k width) of phase-0 weight stage s, as
    ``cam_tile.cuh:stage0`` computes it: the branch taps (nb x 9 of
    [brows][kc]), then per chunk of NC output channels [NC][kc] and
    [NC][knh], then per branch [brows][kc]."""
    wb, pair = p["brows"] * p["kc"], NC * (p["kc"] + p["knh"])
    if s < 9 * nb:
        return s * wb, p["brows"], p["kc"]
    s -= 9 * nb
    if s < 2 * p["nchr"]:
        return (9 * nb * wb + s // 2 * pair + (s % 2) * NC * p["kc"], NC,
                p["knh"] if s % 2 else p["kc"])
    return (9 * nb * wb + p["nchr"] * pair + (s - 2 * p["nchr"]) * wb,
            p["brows"], p["kc"])


# the kernels' shared memory at the train step's shapes, bytes
SMEM = {STEPS_CAM: (204588, 139584), PYRAMID_CAM: (132780, 104064)}


@pytest.mark.parametrize("shape", SHAPES)
def test_f3b_plan_rows_are_16_byte_aligned(shape):
    p = cam.f3b_plan(*shape)
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
        off, rows_, kw = stage0(p, nb, s)
        assert (2 * off) % 16 == 0 and kw % 16 == 0 and rows_ % 8 == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_f3b_shared_memory_fits(shape):
    p = cam.f3b_plan(*shape)
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX == 232448
    if shape in SMEM:
        assert (p["smem0"], p["smem1"]) == SMEM[shape]


def test_f3b_refuses_what_does_not_fit():
    """Six dilations up to 6 at C = 163: the halo alone is 147 KB."""
    p = cam.f3b_plan(1, 32, 32, 163, (1, 2, 3, 4, 5, 6), 40)
    assert p["smem0"] > cam.SMEM_MAX


@pytest.mark.parametrize("bhw", [(16, 113, 113), (16, 57, 57),
                                 (16, 29, 29), (3, 29, 21), (1, 5, 30),
                                 (2, 9, 13), (1, 8, 8)])
def test_f3b_tiles_cover_each_pixel_once(bhw):
    b, h, w = bhw
    tiles = f3b_tiles(b, h, w)
    p = cam.f3b_plan(b, h, w, 8, (1,), 8)
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


@pytest.mark.parametrize("shape", SHAPES)
def test_f3b_weights_unpad_to_the_inputs(shape):
    _, _, _, c, dils, hc = shape
    nb, nh = len(dils), len(dils) * hc
    kr, kh, kt = _weights(shape, 3, exact=False)
    w0, w1 = cam._f3b_weights(kr, kh, kt)
    p = cam.f3b_plan(*shape)
    assert w0.dtype == w1.dtype == torch.bfloat16
    assert w0.numel() == p["w0_elems"] and w1.numel() == p["w1_elems"]

    def stage(s):
        off, rows, kw = stage0(p, nb, s)
        return w0[off:off + rows * kw].reshape(rows, kw), rows, kw

    def check(block, want):
        n, k = want.shape
        assert torch.equal(block[:n, :k], want)
        assert not block[n:].any() and not block[:, k:].any()

    for i in range(nb):
        for tap in range(9):
            block, _, _ = stage(9 * i + tap)
            check(block, kh[i, tap // 3, tap % 3].t())
        block, _, _ = stage(10 * nb - nb + 2 * p["nchr"] + i)
        check(block, kt[i])
    ktf = kt.reshape(nh, c)
    for ch in range(p["nchr"]):
        n0, n1 = ch * NC, min(c, (ch + 1) * NC)
        check(stage(9 * nb + 2 * ch)[0], kr[:, n0:n1].t())
        check(stage(9 * nb + 2 * ch + 1)[0], ktf[:, n0:n1].t())
    nxr, khc = p["nxr"], p["khc"]
    st = w1.reshape(p["nchx"], p["nst1"], nxr, khc)
    for ch in range(p["nchx"]):
        n0, n1 = ch * nxr, min(c, (ch + 1) * nxr)
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


def _tile_walk(shape, x, dr, dcp, w0, w1):
    """The products F3b's tile kernels take, walked tile by tile as they
    stage them: per tile one halo of x (padded to kc) and of dc (each
    branch padded to khc), each tap's 8 x 8 rows gathered from it, each
    stage's weights sliced from w0 / w1.  float32; returns the branch
    convs c (B, H, W, nb, hc), x kr and dx (B, H, W, C)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    p = cam.f3b_plan(*shape)
    kc, khc, dm, hs = p["kc"], p["khc"], p["dmax"], p["hs"]
    xpad = F.pad(x, (0, kc - c))
    conv = torch.zeros(b, h, w, nb, hc)
    res = torch.zeros(b, h, w, c)
    dx = torch.zeros(b, h, w, c)
    w1s = w1.float().reshape(p["nchx"], p["nst1"], p["nxr"], khc)
    for img, y0, x0 in f3b_tiles(b, h, w):
        hy, hx = min(8, h - y0), min(8, w - x0)
        hx_ = _halo(xpad[img], y0, x0, dm, hs)
        hc_ = _halo(dcp[img], y0, x0, dm, hs)

        def rows(halo, dy, dxx):
            return halo[dm + dy:dm + dy + 8,
                        dm + dxx:dm + dxx + 8].reshape(64, -1)

        for i, d in enumerate(dils):
            acc = torch.zeros(64, p["brows"])
            for tap in range(9):
                off, n, kw = stage0(p, nb, 9 * i + tap)
                wt = w0[off:off + n * kw].float().reshape(n, kw)
                a = rows(hx_, (tap // 3 - 1) * d, (tap % 3 - 1) * d)
                acc = acc + a @ wt.t()
            conv[img, y0:y0 + hy, x0:x0 + hx, i] = \
                acc.reshape(8, 8, -1)[:hy, :hx, :hc]
        for ch in range(p["nchr"]):
            off, n, kw = stage0(p, nb, 9 * nb + 2 * ch)
            wt = w0[off:off + n * kw].float().reshape(n, kw)
            n0 = ch * NC
            n1 = min(c, n0 + NC)
            out = (rows(hx_, 0, 0) @ wt.t()).reshape(8, 8, -1)
            res[img, y0:y0 + hy, x0:x0 + hx, n0:n1] = \
                out[:hy, :hx, :n1 - n0]
        for ch in range(p["nchx"]):
            acc = torch.zeros(64, p["nxr"])
            r = F.pad(dr[img, y0:y0 + 8, x0:x0 + 8],
                      (0, 0, 0, 8 - hx, 0, 8 - hy)).reshape(64, kc)
            for s in range(p["nksr"]):
                k0 = s * khc
                kw = min(khc, kc - k0)
                acc = acc + r[:, k0:k0 + kw] @ w1s[ch, s, :, :kw].t()
            for i, d in enumerate(dils):
                for tap in range(9):
                    a = rows(hc_, -(tap // 3 - 1) * d, -(tap % 3 - 1) * d)
                    acc = acc + a[:, i * khc:(i + 1) * khc] \
                        @ w1s[ch, p["nksr"] + 9 * i + tap].t()
            n0 = ch * p["nxr"]
            n1 = min(c, n0 + p["nxr"])
            dx[img, y0:y0 + hy, x0:x0 + hx, n0:n1] = \
                acc.reshape(8, 8, -1)[:hy, :hx, :n1 - n0]
    return conv, res, dx


@pytest.mark.parametrize("shape", [(2, 9, 13, 12, (1, 2, 3, 4), 3),
                                   (1, 5, 30, 70, (1, 2, 3), 20),
                                   (1, 11, 19, 12, (1, 9), 3),
                                   (1, 9, 10, 170, (1, 2), 8)])
def test_f3b_tile_walk_matches_plain_on_exact_sums(shape):
    """Exact-sum inputs: the walk's float32 products equal the plain
    convolutions bitwise, so the halo gathers, the tap shifts (forward
    and transposed), the stage order and the padding are the plain
    version's."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    kr, kh, kt = _weights(shape, 5)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-1, 2, (b, h, w, c)).astype(
        np.float32))
    dr = torch.from_numpy(rng.integers(-2, 3, (b, h, w, c)).astype(
        np.float32))
    dc = torch.from_numpy(rng.integers(-2, 3, (b, h, w, nb, hc)).astype(
        np.float32))
    p = cam.f3b_plan(*shape)
    drp = F.pad(dr, (0, p["kc"] - c))
    dcp = F.pad(dc, (0, p["khc"] - hc)).reshape(b, h, w, p["ldc"])
    w0, w1 = cam._f3b_weights(kr, kh, kt)
    conv, res, dx = _tile_walk(shape, x, drp, dcp, w0, w1)
    for i, d in enumerate(dils):
        assert torch.equal(conv[..., i, :], cam._conv(x, kh[i], d)), i
    assert torch.equal(res, x @ kr.float())
    want = dr @ kr.float().t()
    for i, d in enumerate(dils):
        want = want + cam._conv_t(dc[..., i, :].contiguous(), kh[i], d)
    assert torch.equal(dx, want)
