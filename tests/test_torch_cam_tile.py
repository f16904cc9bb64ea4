"""The plan and the re-laid weights the fused-CAM kernels share
(``csrc/cam_wg.cuh``: the backwards F1b, F2b and F3b and the forwards F1,
F2 and F3), on the CPU, at the train step's two CAM shapes and the card
tests' shapes.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them against the plain versions there).  Here the layout contract
they rely on is checked for each op: every global row the kernels copy
is 16-byte aligned and every weight stage (as the producer warps copy
them, ``cam_wg.cuh:fwd_produce`` / ``dx_produce``) is one bulk copy of
whole wgmma core matrices at a 16-byte offset, ending the re-laid
buffers; both phases fit a block's shared memory (pinned at the train
step's shapes); the tiles cover each pixel once with each image's tiles
contiguous; the weights gathered once a call (``ops/cam.py:
_tile_weights``: one ``index_select`` over [0, kr, kh, kt] by an index
built once a plan geometry) are bitwise the layout code's
(``_wg_weights``, ``_dx_weights``) and give back kr, kh and kt stage by
stage with zero padding; a forward's weights are its backward's phase-0
prefix.  Geometries past the ops' limit (a largest dilation of 20 at
C = 163) are refused, by name, and six dilations up to 6 or 8 are taken.
The walks of the kernels' stages against the plain versions and the
interpret-mode Pallas kernels are ``tests/test_torch_cam_wg.py`` (F1,
F3), ``_wgf2.py`` (F2), ``_wgb.py`` (F3b's phase 0, every dx) and
``_wgb0.py`` (F1b's and F2b's phase 0), the train step's widths among
their cases.

The parametrised tests keep F3b's cases under their first ids (shape0,
...) and add the other ops' as f1b-shape0, ..., f2b-shape0, ...,
f1-shape0, ..., f3-shape0, ....
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtpe_tpu_torch.ops import cam

# (B, H, W, C, dilations, hc): the train step's two CAM shapes, the card
# tests' shapes (ragged tiles, a side smaller than a tile, a dilation
# larger than a tile side), and C > 168
STEPS_CAM = (16, 113, 113, 163, (1, 2, 3), 40)
PYRAMID_CAM = (16, 113, 113, 83, (1, 2, 3, 4), 20)
SHAPES = [STEPS_CAM, PYRAMID_CAM,
          (2, 21, 21, 12, (1, 2, 3), 3), (3, 29, 21, 83, (1, 2, 3, 4), 20),
          (2, 17, 23, 163, (1, 2, 3), 40), (2, 9, 13, 83, (1, 2, 3, 4), 20),
          (1, 5, 30, 163, (1, 2, 3), 40), (1, 30, 5, 83, (1, 2, 3, 4), 20),
          (1, 11, 19, 12, (1, 9), 3), (1, 9, 10, 170, (1, 2), 8)]
BWD_OPS = ("f3b", "f1b", "f2b")
OPS = BWD_OPS + ("f1", "f3", "f2")
FWD_OPS = ("f1", "f3", "f2")
TS = cam.TILE_TS
N1 = cam.WG_N1


def by_op(shapes, ops=OPS):
    """(op, shape) cases, F3b's with the ids its cases had before the
    other ops shared these tests."""
    return [pytest.param(op, s, id=f"shape{k}" if op == "f3b"
                         else f"{op}-shape{k}")
            for op in ops for k, s in enumerate(shapes)]


def f3b_tiles(b, h, w):
    """(image, y0, x0) of each tile in the kernels' order
    (``cam_wg.cuh:tile_pos``: image-major, then row-major)."""
    tx, tpi = -(-w // TS), -(-w // TS) * -(-h // TS)
    return [(t // tpi, (t % tpi) // tx * TS, (t % tpi) % tx * TS)
            for t in range(b * tpi)]


def _stages(k, width):
    return [(k0, min(width, k - k0)) for k0 in range(0, k, width)]


def w0_stages(op, p, nb):
    """Phase 0's weight stages in the producer's order
    (``cam_wg.cuh:fwd_produce``): (kind, k0, kw, n, branch, slice, tap,
    1x1 chunk); kind "br" (per branch, slice, x's K chunk of kq and tap,
    the chunk's stages of kb), "res" / "top" (per 1x1 chunk of N1 columns
    x's stages, then a's over knh) or "bb" (per branch and slice, dt's
    chunks of kdq in stages of kbd)."""
    res, top, bb = cam.TILE_OPS[op]
    xs = [(q + u, kw) for q, wq in _stages(p["kc"], p["kq"])
          for u, kw in _stages(wq, p["kb"])]
    out = []
    for i in range(nb):
        for sl in range(p["nsl"]):
            for q, wq in _stages(p["kc"], p["kq"]):
                for tap in range(9):
                    out += [("br", q + u, kw, p["sw"], i, sl, tap, None)
                            for u, kw in _stages(wq, p["kb"])]
    for ch in range(p["nch1"]):
        if res:
            out += [("res", k0, kw, N1, None, None, None, ch)
                    for k0, kw in xs]
        if top:
            out += [("top", k0, kw, N1, None, None, None, ch)
                    for k0, kw in _stages(p["knh"], p["kqa"])]
    if bb:
        for i in range(nb):
            for sl in range(p["nsl"]):
                out += [("bb", q + u, kw, p["sw"], i, sl, None, None)
                        for q, wd in _stages(p["kc"], p["kdq"])
                        for u, kw in _stages(wd, p["kbd"])]
    return out


def w1_stages(op, p, nb):
    """dx's weight stages in the producer's order (``cam_wg.cuh:
    dx_produce``): (kind, k0, kw, n, column pass, branch, tap); per pass
    dr's stages over kc (F1b, F3b: "res"), then per branch, halo chunk of
    dx_kq and tap the chunk's stages ("br", k0 within the branch)."""
    res = cam.TILE_OPS[op][0]
    out = []
    for pc_ in range(p["dx_npass"]):
        if res:
            out += [("res", k0, kw, p["dx_np"], pc_, None, None)
                    for k0, kw in _stages(p["kc"], p["dx_kbr"])]
        for i in range(nb):
            for q, wq in _stages(p["khc"], p["dx_kq"]):
                for tap in range(9):
                    out += [("br", q + u, kw, p["dx_np"], pc_, i, tap)
                            for u, kw in _stages(wq, p["dx_kb"])]
    return out


@pytest.mark.parametrize("op,shape", by_op(SHAPES))
def test_f3b_plan_rows_are_16_byte_aligned(op, shape):
    """The global rows the kernels copy 16 bytes at a time (padded x and
    dr, dt, a, each branch's dc) are 16-byte aligned; each weight stage is
    whole core matrices (K a multiple of 16, N of 8), one bulk copy of a
    multiple of 16 bytes at a 16-byte offset that fits a ring slot, and
    the stages, as many as the plan counts, end the re-laid buffers."""
    p = cam.tile_plan(op, *shape)
    nb, hc = len(shape[4]), shape[5]
    rows = [p["kc"], p["ldc"], p["knh"], p["khc"]]
    branch_offsets = [i * p["khc"] for i in range(nb)]
    for v in rows + branch_offsets:
        assert (2 * v) % 16 == 0, (v, p)
    assert p["kc"] >= shape[3] and p["khc"] >= hc and p["sw"] >= hc
    assert p["knh"] >= nb * hc
    walks = [(w0_stages(op, p, nb), p["slot"], p["w0_elems"], p["wg_nst"])]
    if op.endswith("b"):
        walks.append((w1_stages(op, p, nb), p["dx_slot"], p["w1_elems"],
                      p["dx_nst"]))
    else:
        assert p["w1_elems"] == p["smem1"] == 0
    for st, slot, total, nst in walks:
        off = 0
        for kind, k0, kw, n, *_ in st:
            assert kw % 16 == 0 and n % 8 == 0 and kw * n <= slot, kind
            assert (2 * off) % 16 == 0
            off += kw * n
        assert off == total and len(st) == nst


# the kernels' shared memory at the train step's shapes, bytes: phase 0,
# a backward's dx
SMEM = {("f3b", STEPS_CAM): (188524, 226560),
        ("f3b", PYRAMID_CAM): (118060, 176256),
        ("f1b", STEPS_CAM): (161496, 226560),
        ("f1b", PYRAMID_CAM): (99736, 176256),
        ("f2b", STEPS_CAM): (183960, 130304),
        ("f2b", PYRAMID_CAM): (115736, 98432),
        ("f1", STEPS_CAM): (163328, 0),
        ("f1", PYRAMID_CAM): (102528, 0),
        ("f3", STEPS_CAM): (183404, 0),
        ("f3", PYRAMID_CAM): (112940, 0),
        ("f2", STEPS_CAM): (181632, 0),
        ("f2", PYRAMID_CAM): (114048, 0)}


@pytest.mark.parametrize("op,shape", by_op(SHAPES))
def test_f3b_shared_memory_fits(op, shape):
    """Both phases within a block's shared memory; at the train step's
    shapes x's halo whole (staged once a tile), one slice a branch, and
    a and the epilogues' rows in shared memory (F1b's rows always, F1
    none), dx's dc halo and dr's rows whole in one column pass."""
    p = cam.tile_plan(op, *shape)
    assert p["ok"] and p["wg"]
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX == 232448
    if (op, shape) in SMEM:
        assert (p["smem0"], p["smem1"]) == SMEM[op, shape]
        top = cam.TILE_OPS[op][1]
        assert p["nq"] == p["nsl"] == 1 and p["kq"] == p["kc"]
        assert p["a_res"] == top and p["rows_smem"] == (op != "f1")
        if op.endswith("b"):
            assert p["dx_npass"] == 1 and p["dx_hres"] and p["dx_dr_res"]


def test_f3b_refuses_what_does_not_fit():
    """Six dilations up to 6 at C = 163, which F3b once refused (its
    whole-depth halo alone is 147 KB): F3b's phase 0 takes them with x's
    halo once a tile at full depth, within a block's shared memory."""
    p = cam.tile_plan("f3b", 1, 32, 32, 163, (1, 2, 3, 4, 5, 6), 40)
    assert p["ok"] and p["wg"] and p["dx_wg"] and p["nq"] == 1
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX


@pytest.mark.parametrize("op", ["f1b", "f2b", "f1", "f3", "f2"])
def test_tile_refuses_what_does_not_fit(op):
    """The same geometry for F1b, F2b, F3 and F2, and a largest dilation
    of 8 for F1 (212 KB of halo at full depth for the first design): every
    op takes them, within a block's shared memory, on the kernels' plan
    (a backward's dx too); F1 at dilations up to 6 as well."""
    dils = (1, 2, 3, 4, 5, 8) if op == "f1" else (1, 2, 3, 4, 5, 6)
    p = cam.tile_plan(op, 1, 32, 32, 163, dils, 40)
    assert p["ok"] and p["wg"] and p["dx_wg"] == op.endswith("b")
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX
    if op == "f1":
        assert cam.tile_plan(op, 1, 32, 32, 163, (1, 2, 3, 4, 5, 6),
                             40)["ok"]


def first_design_fits(op, shape):
    """Whether the first design's mma.sync tile plans took ``shape`` (the
    ops' limit, modelled here from that design's carve): its whole-depth
    plan (a branch of at most 40 columns; phase 0: the x halo at full
    depth with 8 bf16 of pitch padding, three weight buffers of 56 rows of
    the widest K, sA, the branch backward's sCb and sD, the epilogues' f32
    rows and four warps' five column sums of 56; dx: dr's 64 rows, the dc
    halo, three buffers of up to 168 rows of khc), or else its K-chunked
    plan: a 16-channel chunk of the x halo, double-buffered, and three
    slots of 56 weight and 64 A rows (all of pitch chunk + 8), beside the
    column sums; for a backward also the dc halo's chunk and three slots
    of up to 168 weight and 64 dr rows."""
    b, h, w, c, dils, hc = shape
    res, top, bb = cam.TILE_OPS[op]
    bwd = op.endswith("b")
    nb = len(dils)
    nh = nb * hc
    kc, khc, knh = -(-c // 16) * 16, -(-hc // 16) * 16, -(-nh // 16) * 16
    hr = (8 + 2 * max(dils)) ** 2
    nxr = min(168, -(-c // 8) * 8)
    red = 4 * 5 * 56 if bb else 0
    rows = {"f1b": 2 * c + 2 * nh, "f2b": 2 * c + 4 * nh,
            "f3b": 9 * c + 4 * nh, "f1": 0, "f3": 9 * c + 4 * nh,
            "f2": 4 * nh}[op]
    el = hr * (kc + 8) + 3 * 56 * ((max(kc, knh) if top else kc) + 8)
    el += 64 * (knh + 8) * (top + bb) + 64 * (kc + 8) * bb
    smem0 = 2 * el + 4 * (rows + red)
    smem1 = 2 * (64 * (kc + 8) * res + hr * (nb * khc + 8)
                 + 3 * nxr * (khc + 8)) if bwd else 0
    if hc <= 40 and max(smem0, smem1) <= cam.SMEM_MAX:
        return True

    def chunk_fits(slot, fixed):
        per = 2 * (2 * hr + 3 * slot) * (16 + 8)
        return per + fixed <= cam.SMEM_MAX

    return chunk_fits(56 + 64, 4 * red) and (
        not bwd or chunk_fits(nxr + res * 64, 0))


# the largest dilation every op takes at every width (the ops' limit),
# and one past it that none takes at C = 163
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


# once refused (the whole-depth halo did not fit); the ops take them
REFUSED = [(1, 32, 32, 163, (1, 2, 3, 4, 5, 6), 40),
           (1, 32, 32, 163, (1, 2, 3, 4, 5, 8), 40)]


@pytest.mark.parametrize("op,shape", by_op(SHAPES + REFUSED, FWD_OPS))
def test_forward_fits_where_its_backward_does(op, shape):
    """A forward and its backward both fit a block's shared memory (the
    training path needs both)."""
    fwd, bwd = cam.tile_plan(op, *shape), cam.tile_plan(op + "b", *shape)
    assert fwd["smem1"] == fwd["w1_elems"] == 0
    assert fwd["ok"] and bwd["ok"]
    assert max(fwd["smem0"], bwd["smem0"], bwd["smem1"]) <= cam.SMEM_MAX


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


def _block(flat, off, kw, n):
    """The stage at ``off`` of a re-laid buffer, [n / 8][kw][8] (wgmma's
    N-major core matrices), as a (kw, n) matrix."""
    blk = flat[off:off + kw * n].reshape(n // 8, kw, 8)
    return blk.transpose(0, 1).reshape(kw, n)


def _want(src, k0, kw, n0, n):
    """src[k0:k0 + kw, n0:n0 + n] zero-padded to (kw, n)."""
    out = torch.zeros(kw, n, dtype=src.dtype)
    part = src[k0:k0 + kw, n0:n0 + n]
    out[:part.shape[0], :part.shape[1]] = part
    return out


@pytest.mark.parametrize("op,shape", by_op(SHAPES))
def test_f3b_weights_unpad_to_the_inputs(op, shape):
    """The weights gathered for a call (one ``index_select`` by the
    plan's cached index) are bitwise ``_wg_weights`` / ``_dx_weights``'
    layout; read stage by stage as the producers copy them, each stage is
    its slice of kh[i, tap] (a branch slice's columns), kr (a 1x1 chunk's
    columns over x's K stage), kt as (NH, C) (over a's), kt[i]^T (the
    branch backward's, over dt's) or, for dx, kr^T and kh[i, tap]^T (a
    column pass's C columns), zero outside the weights."""
    _, _, _, c, dils, hc = shape
    nb = len(dils)
    kr, kh, kt = _op_weights(op, *_weights(shape, 3, exact=False))
    p = cam.tile_plan(op, *shape)
    w0, w1 = cam._tile_weights(op, kr, kh, kt, p)
    assert w0.dtype == torch.bfloat16 and w0.numel() == p["w0_elems"]
    assert torch.equal(w0, cam._wg_weights(op, p, kr, kh, kt))
    ktf = kt.reshape(nb * hc, c) if kt is not None else None
    off = 0
    for kind, k0, kw, n, i, sl, tap, ch in w0_stages(op, p, nb):
        if kind == "br":
            want = _want(kh[i, tap // 3, tap % 3], k0, kw, sl * p["sw"], n)
        elif kind == "res":
            want = _want(kr, k0, kw, ch * N1, n)
        elif kind == "top":
            want = _want(ktf, k0, kw, ch * N1, n)
        else:
            want = _want(kt[i].t(), k0, kw, sl * p["sw"], n)
        assert torch.equal(_block(w0, off, kw, n), want), (kind, k0, i)
        off += kw * n
    if not op.endswith("b"):
        assert w1 is None and p["w1_elems"] == 0
        return
    assert w1.dtype == torch.bfloat16 and w1.numel() == p["w1_elems"]
    assert torch.equal(w1, cam._dx_weights(op, p, kr, kh))
    off = 0
    for kind, k0, kw, n, pc_, i, tap in w1_stages(op, p, nb):
        # B[k][n] = kr[n][k] (dr kr^T), kh[i, tap][n][k] (dc kh[i, tap]^T)
        src = kr.t() if kind == "res" else kh[i, tap // 3, tap % 3].t()
        want = _want(src, k0, kw, pc_ * n, n)
        assert torch.equal(_block(w1, off, kw, n), want), (kind, k0, pc_)
        off += kw * n


@pytest.mark.parametrize("op,shape", by_op(SHAPES, FWD_OPS))
def test_forward_weights_are_the_backwards_phase0_weights(op, shape):
    """On the backward's plan F1's re-laid w0 is F1b's, and F2's and
    F3's are F2b's and F3b's before their branch backward's kt[i]^T
    stages, so their stage offsets are their backwards'; the forward's
    own plan counts its own walk."""
    kr, kh, kt = _weights(shape, 4, exact=False)
    nb = len(shape[4])
    pf, pb = cam.tile_plan(op, *shape), cam.tile_plan(op + "b", *shape)
    fw = cam._wg_weights(op, pb, *_op_weights(op, kr, kh, kt))
    bw = cam._wg_weights(op + "b", pb, *_op_weights(op + "b", kr, kh, kt))
    fst, bst = w0_stages(op, pb, nb), w0_stages(op + "b", pb, nb)
    assert bst[:len(fst)] == fst
    assert all(s[0] == "bb" for s in bst[len(fst):])
    dt_st = [u for _, wd in _stages(pb["kc"], pb["kdq"] or pb["kc"])
             for u in _stages(wd, pb["kbd"] or wd)]
    assert len(bst) - len(fst) == (0 if op == "f1"
                                   else nb * pb["nsl"] * len(dt_st))
    assert torch.equal(fw, bw[:fw.numel()])
    assert fw.numel() == sum(s[2] * s[3] for s in fst)
    assert len(w0_stages(op, pf, nb)) == pf["wg_nst"]


def _ints(rng, lo, hi, *shape):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


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


def _forward_args(op, k, dils):
    names = {"f1": ("x", "kr", "kh"), "f2": ("x", "kh", "kt", "bnh"),
             "f3": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate")}[op]
    return [k[n] for n in names] + [dils]


def _jx(t):
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(dt)
