"""The fused-CAM backwards' weight-gradient kernels
(``csrc/cam_core.cuh``: ``wgrad_taps_kernel`` for dkh,
``wgrad_plain_kernel`` for dkr and dkt), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds
them against a float64 product there, and this module's model of their
plan against the C one, ``cam_wgrad_plan`` and ``cam_f{1,2,3}b_workspace``).
Here that model (:func:`wgrad_plan`, after ``cam_core.cuh:wg_plan``) is
checked for each backward: every staged row is 16-byte aligned, the ring
fits a block's shared memory at the train step's CAM shapes and the
card tests' shapes, the tiles cover each pixel once, the walk gives
every combo its blocks and every (combo, partial row) one writer, and
the workspace holds the partial rows.  A walk that multiplies exactly
what the kernels stage (each tap's shifted window of the V window, each
K and N slice, each ring item, the never-staged columns poisoned with
NaN, the partial rows summed in ``reduce_rows_kernel``'s order) gives
``_wgrad``'s dkh and the plain dkr / dkt bitwise on exact-sum inputs.
The plain version of ``cam_wgrad`` is held to JAX's ``pallas_cam._mmT``
over the same shifted operands.
"""

from typing import Dict, Sequence, Tuple

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.ops import cam

STEPS_CAM = (16, 113, 113, 163, (1, 2, 3), 40)
PYRAMID_CAM = (16, 113, 113, 83, (1, 2, 3, 4), 20)
# the train step's shapes, the card tests' shapes and the wide students'
# step CAMs (inplanes 96, 128, 256: dkh in N slices of 24, 32, 32)
SHAPES = [STEPS_CAM, PYRAMID_CAM,
          (2, 21, 21, 12, (1, 2, 3), 3), (3, 29, 21, 83, (1, 2, 3, 4), 20),
          (2, 17, 23, 163, (1, 2, 3), 40), (2, 9, 13, 83, (1, 2, 3, 4), 20),
          (1, 5, 30, 163, (1, 2, 3), 40), (1, 30, 5, 83, (1, 2, 3, 4), 20),
          (1, 11, 19, 12, (1, 9), 3), (1, 9, 10, 170, (1, 2), 8),
          (16, 113, 113, 195, (1, 2, 3), 48),
          (16, 113, 113, 259, (1, 2, 3), 64),
          (16, 113, 113, 515, (1, 2, 3), 128)]
# small enough to walk: several K slices (C = 163), two N slices of a
# plain product (C = 200), a dilation wider than a tile, ragged edges,
# dkh in N slices (hc = 48: 2 x 24; 68: 40 and 28)
WALK_SHAPES = [(1, 19, 13, 40, (1, 3), 12), (2, 9, 13, 12, (1, 2, 3, 4), 3),
               (1, 11, 19, 12, (1, 9), 3), (1, 6, 9, 163, (1, 2), 40),
               (1, 5, 7, 200, (2,), 8), (1, 6, 9, 40, (1, 2), 48),
               (1, 5, 6, 24, (3,), 68)]
# more items than WG_BLOCKS: blocks walk uneven shares of several tiles
# (every launch at the first shape; dkh at the others)
SPLIT_SHAPES = [(6, 64, 48, 12, (1,), 3), (1, 48, 64, 163, (1, 2), 40),
                (3, 48, 40, 12, (1, 2, 3, 4), 3)]
BWD = ("f1b", "f2b", "f3b")


# ------------------------------------------------------------ the plan
#
# A model of cam_core.cuh:wg_plan / wg_range (the C plan is the kernels';
# test_torch_cuda.py holds this one to it on the card): a grid of
# WG_BLOCKS blocks, each walking its share of one combo's pixel tiles
# (wg_range), combo = (job, K slice, N slice); a job is one product, U
# (shifted by a tap) against V summed over pixels.  wgrad_launches gives
# the launches of each backward, bwd_workspace_bytes its workspace
# (carve_f1b / carve_f2b / carve_f3b).

WG_BLOCKS = 132      # one block an SM
WG_TX = 8            # tile width, pixels
WG_NT_TAPS = 5       # taps: n8 tiles of an N slice at most
WG_NSW = 24          # plain: n8 tiles of an N slice
WG_NS_MAX = 6        # ring stages at most
WG_SMEM_EXTRA = 1024 + 64   # 1024-byte alignment and the mbarriers


def wg_range(p: Dict, k: int) -> Tuple[int, int, int, int]:
    """Block k's share of the walk of plan ``p`` (cam_core.cuh:wg_range):
    (combo, split s, first tile, end tile): combo k % ncombo, the combo's
    blocks splitting its tiles evenly; its sums go to partial row s."""
    nc = len(p["combos"])
    c, s = k % nc, k // nc
    splits = (p["blocks"] - c + nc - 1) // nc
    return (c, s, s * p["n_tiles"] // splits,
            (s + 1) * p["n_tiles"] // splits)


def wgrad_plan(b: int, h: int, w: int, jobs: Sequence[Dict], taps: int):
    """The plan of one weight-gradient launch over images (b, h, w):
    ``jobs`` are dicts of K, N, d (0 for a plain product), ldu, u0, ldv,
    v0 (pitches and offsets in bf16 elements); ``taps`` 9 or 1.  Returns
    the tiling (mt m16 tiles a K slice, nt n8 tiles of the wgmma, ty tile
    rows, ns ring stages, vrows rows of a V plane, stage sizes in bf16,
    shared memory in bytes), the walk (n_tiles, combos as (job, K slice,
    N slice), items, blocks, slots: partial rows) and each job's c0 /
    nks / nns; None where the kernels refuse."""
    if not 1 <= len(jobs) <= cam.NB_MAX or taps not in (1, 9) or min(b, h, w) < 1:
        return None
    n8max = dmax = 0
    for j in jobs:
        n8 = -(-j["N"] // 8)
        if (j["K"] < 1 or j["N"] < 1 or j["ldu"] % 8 or j["u0"] % 8
                or j["ldv"] % 8 or j["v0"] % 8
                or j["u0"] + cam._up(j["K"], 8) > j["ldu"]
                or j["v0"] + 8 * n8 > j["ldv"] or (taps == 9) != (j["d"] > 0)):
            return None
        n8max = max(n8max, n8 if taps == 9 else min(n8, WG_NSW))
        dmax = max(dmax, j["d"])
    # taps: one m64 (the warpgroups take 3 taps each), the widest job's n8
    # tiles in even N slices of at most WG_NT_TAPS; plain: one m64 a
    # warpgroup, the N slice in one wgmma of 8, 16 or 24 n8 tiles
    mt = 4 if taps == 9 else 12
    nt = -(-n8max // -(-n8max // WG_NT_TAPS)) if taps == 9 \
        else cam._up(n8max, 8)
    nsw = nt if taps == 9 else WG_NSW
    found = None
    for ty in (16, 8):
        for ns in range(WG_NS_MAX, 0, -1):
            us = mt // 4 * ty * WG_TX * 64
            # a V plane's rows to a multiple of 8 (128-byte TMA writes)
            vr = cam._up((ty + 2 * dmax) * (WG_TX + 2 * dmax), 8)
            vs = nt * vr * 8
            if ty + 2 * dmax <= 256 and \
                    2 * ns * (us + vs) + WG_SMEM_EXTRA <= cam.SMEM_MAX:
                found = (ty, ns, vr, us, vs)
                break
        if found:
            break
    if found is None:
        return None
    ty, ns, vrows, us, vs = found
    tiles_x = -(-w // WG_TX)
    tpi = tiles_x * -(-h // ty)
    n_tiles = b * tpi
    combos, out_jobs = [], []
    for k, j in enumerate(jobs):
        nks = -(-(-(-j["K"] // 16)) // mt)
        nns = -(-(-(-j["N"] // 8)) // nsw)
        out_jobs.append(dict(j, c0=len(combos), nks=nks, nns=nns))
        combos += [(k, ks, nsl) for ks in range(nks) for nsl in range(nns)]
    items = len(combos) * n_tiles
    # one SM a block, every combo at least one, no more blocks than items
    blocks = min(max(WG_BLOCKS, len(combos)), items)
    slots = -(-blocks // len(combos))
    return dict(taps=taps, b=b, h=h, w=w, mt=mt, ty=ty, ns=ns, nt=nt,
                nsw=nsw, vrows=vrows, ustage=us, vstage=vs,
                smem=2 * ns * (us + vs) + WG_SMEM_EXTRA,
                tiles_x=tiles_x, tpi=tpi,
                n_tiles=n_tiles, combos=combos, items=items, blocks=blocks,
                slots=slots, jobs=out_jobs)


def wgrad_launches(op: str, b: int, h: int, w: int, c: int,
                   dils: Sequence[int], hc: int) -> list:
    """The weight-gradient launches of backward ``op`` ("f1b", "f2b",
    "f3b") as (name, plan, total floats): "dkh" (x at each branch's 9
    taps against its dc columns), then "dkr" (x, dr), "dkt" (a, dt) or
    "dkr_dkt" (both in one walk, dkr's outputs first).  Each job also
    names its operands ("x", "dc", "dr", "a", "dt") and its out_off."""
    nb = len(dils)
    nh, kc, khc, knh = nb * hc, cam._up(c, 16), cam._up(hc, 16), cam._up(nb * hc, 16)
    dkh = [dict(u="x", v="dc", K=c, N=hc, d=d, ldu=kc, u0=0, ldv=nb * khc,
                v0=i * khc, out_off=i * 9 * c * hc)
           for i, d in enumerate(dils)]
    dkr = dict(u="x", v="dr", K=c, N=c, d=0, ldu=kc, u0=0, ldv=kc, v0=0,
               out_off=0)
    dkt = dict(u="a", v="dt", K=nh, N=c, d=0, ldu=knh, u0=0, ldv=kc, v0=0,
               out_off=0)
    out = [("dkh", wgrad_plan(b, h, w, dkh, 9), 9 * nh * c)]
    if op == "f1b":
        out.append(("dkr", wgrad_plan(b, h, w, [dkr], 1), c * c))
    elif op == "f2b":
        out.append(("dkt", wgrad_plan(b, h, w, [dkt], 1), nh * c))
    else:
        both = [dkr, dict(dkt, out_off=c * c)]
        out.append(("dkr_dkt", wgrad_plan(b, h, w, both, 1),
                    c * c + nh * c))
    return out


def bwd_workspace_bytes(op: str, b: int, h: int, w: int, c: int,
                        dils: Sequence[int], hc: int) -> int:
    """Bytes of backward ``op``'s workspace (cam_f1b_workspace,
    cam_f2b_workspace, cam_f3b_workspace): its bf16 scratch rows (dr and
    dt of pitch kc, a of pitch knh, dc of pitch nb khc), the per-tile
    partial rows, then each weight-gradient launch's partial rows (slots
    x total floats), each region 256-byte aligned, and c (F2b, F3b: pitch
    knh) last; -1 where refused."""
    p = cam.tile_plan(op, b, h, w, c, dils, hc)
    if not p["ok"]:
        return -1
    m, nh = b * h * w, len(dils) * hc
    bf = {"f1b": [p["kc"], p["ldc"]],
          "f2b": [p["knh"], p["kc"], p["ldc"]],
          "f3b": [p["kc"], p["knh"], p["kc"], p["ldc"]]}[op]
    regions = [2 * m * pitch for pitch in bf]
    rows = {"f1b": 0, "f2b": 2 * nh, "f3b": 5 * c + 2 * nh}[op]
    if rows:
        regions.append(4 * p["n_tiles"] * rows)
    for _, plan, total in wgrad_launches(op, b, h, w, c, dils, hc):
        if plan is None:
            return -1
        regions.append(4 * plan["slots"] * total)
    if op != "f1b":                 # c, the branch backward's rows
        regions.append(2 * m * p["knh"])
    return sum(cam._up(r, 256) for r in regions)


def cases(shapes):
    return [pytest.param(op, s, id=f"{op}-shape{k}")
            for op in BWD for k, s in enumerate(shapes)]


@pytest.mark.parametrize("op,shape", cases(SHAPES))
def test_wgrad_plan_rows_are_16_byte_aligned_and_fit(op, shape):
    for name, p, total in wgrad_launches(op, *shape):
        assert p is not None, name
        taps = p["taps"] == 9
        assert p["smem"] == 2 * p["ns"] * (p["ustage"] + p["vstage"]) \
            + WG_SMEM_EXTRA <= cam.SMEM_MAX == 232448
        assert 1 <= p["ns"] <= WG_NS_MAX and p["ty"] in (8, 16)
        # U: 128-byte x rows in TMA's 128-byte swizzle, a stage whole
        # 1024-byte atoms (one m64 for taps, three for a plain product);
        # V: n8 planes of 16-byte rows, each 128-byte aligned; TMA boxes
        # of <= 256 rows
        assert p["mt"] == (4 if taps else 12)
        assert p["ustage"] == p["mt"] // 4 * p["ty"] * 8 * 64
        assert (2 * p["ustage"]) % 1024 == 0
        dmax = max(shape[4]) if taps else 0
        rows = (p["ty"] + 2 * dmax) * (8 + 2 * dmax)
        assert p["vrows"] == -(-rows // 8) * 8
        assert p["ty"] + 2 * dmax <= 256
        assert p["vstage"] == p["nt"] * p["vrows"] * 8
        # the wgmma's N: a tap job's n8 tiles in even slices of at most 5
        # (hc = 48: 2 x 3, 64: 2 x 4, 128: 4 x 4), a plain slice's rounded
        # up to 8, 16 or 24
        n8 = max(min(-(-j["N"] // 8), 1 << 30 if taps else WG_NSW)
                 for j in p["jobs"])
        assert p["nt"] == (-(-n8 // -(-n8 // 5)) if taps
                           else -(-n8 // 8) * 8)
        assert p["nt"] in ((1, 2, 3, 4, 5) if taps else (8, 16, 24))
        for j in p["jobs"]:
            for v in (j["ldu"], j["u0"], j["ldv"], j["v0"]):
                assert v % 8 == 0, (name, j)
            # the staged chunks lie inside each row
            assert j["u0"] + -(-j["K"] // 8) * 8 <= j["ldu"]
            assert j["v0"] + -(-j["N"] // 8) * 8 <= j["ldv"]
        assert max(j["out_off"] + p["taps"] * j["K"] * j["N"]
                   for j in p["jobs"]) == total


@pytest.mark.parametrize("shape", [STEPS_CAM, PYRAMID_CAM])
def test_wgrad_plan_fills_the_card_at_the_train_shapes(shape):
    """132 blocks, each walking an equal share of the items, one block an
    SM (the ring of 3 stages takes most of its shared memory)."""
    for op in BWD:
        for name, p, _ in wgrad_launches(op, *shape):
            assert p["blocks"] == 132 and p["items"] >= 132 * 8, name
            # a TMA ring of 5 (dkh at C = 163), 6 (dkh at C = 83) or 2
            # (the plain products: 3 m64s and 24 n8 planes a stage)
            assert (p["ty"], p["ns"]) == (16, (5 if shape[3] == 163 else 6)
                                          if name == "dkh" else 2), name
            assert p["smem"] > cam.SMEM_MAX // 2, name
    dkh = wgrad_launches("f1b", *shape)[0][1]
    # a K slice is one m64: 3 slices a branch at C = 163, 2 at C = 83
    assert (dkh["mt"], len(dkh["combos"])) == (
        (4, 9) if shape[3] == 163 else (4, 8))


@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_tiles_cover_every_pixel_once(shape):
    b, h, w = shape[:3]
    for name, p, _ in wgrad_launches("f3b", *shape):
        seen = np.zeros((b, h, w), np.int64)
        for t in range(p["n_tiles"]):
            img, u = divmod(t, p["tpi"])
            y0 = u // p["tiles_x"] * p["ty"]
            x0 = u % p["tiles_x"] * WG_TX
            seen[img, y0:y0 + p["ty"], x0:x0 + WG_TX] += 1
        assert (seen == 1).all(), name


@pytest.mark.parametrize("shape", SHAPES + WALK_SHAPES + SPLIT_SHAPES)
def test_wgrad_walk_gives_each_partial_row_one_writer(shape):
    """Block k takes combo k % ncombo and its split's tiles: every combo
    has a block, its blocks' tile ranges partition its tiles in order,
    and each (combo, partial row) has one writer below the slot count.
    Few items give a block an item each (blocks = items)."""
    for op in BWD:
        for name, p, _ in wgrad_launches(op, *shape):
            nc = len(p["combos"])
            assert p["blocks"] == min(max(WG_BLOCKS, nc), p["items"])
            ranges = {}
            for k in range(p["blocks"]):
                c, row, t0, t1 = wg_range(p, k)
                assert 0 <= row < p["slots"] and (c, row) not in ranges
                ranges[c, row] = (t0, t1)
            for c in range(nc):
                rows = sorted(r for c_, r in ranges if c_ == c)
                assert rows == list(range(len(rows))) and rows
                tiles = [t for r in rows for t in range(*ranges[c, r])]
                assert tiles == list(range(p["n_tiles"])), (name, c)


@pytest.mark.parametrize("op,shape", cases([STEPS_CAM, PYRAMID_CAM]))
def test_wgrad_partials_fit_the_workspace(op, shape):
    b, h, w, c, dils, hc = shape
    m, nb = b * h * w, len(dils)
    p = cam.tile_plan(op, *shape)
    # the bf16 scratch rows, F2b's and F3b's c (pitch knh) among them
    scratch = {"f1b": p["kc"] + p["ldc"],
               "f2b": p["knh"] + p["kc"] + p["ldc"] + p["knh"],
               "f3b": p["kc"] + p["knh"] + p["kc"] + p["ldc"]
               + p["knh"]}[op] * 2 * m
    parts = sum(4 * q["slots"] * total
                for _, q, total in wgrad_launches(op, *shape))
    got = bwd_workspace_bytes(op, *shape)
    assert scratch + parts <= got < scratch + parts + 256 * 8 \
        + 4 * p["n_tiles"] * (5 * c + 2 * nb * hc)


# ------------------------------------------------------------ the walk

def _operands(shape, seed):
    """The backwards' weight-gradient operands at their pitches, small
    integers (every sum exact in float32); columns past the real ones
    hold NaN (the kernels leave dt's and a's unwritten and only outputs
    k < K, n < N are kept, so none may reach a kept output)."""
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    p = cam.tile_plan("f3b", *shape)
    rng = np.random.default_rng(seed)

    def rows(pitch, real):
        t = rng.integers(-2, 3, (b, h, w, pitch)).astype(np.float32)
        cols = np.zeros(pitch, bool)
        cols[real] = True
        t[..., ~cols] = np.nan
        return torch.from_numpy(t)

    dc_cols = np.concatenate([np.arange(i * p["khc"], i * p["khc"] + hc)
                              for i in range(nb)])
    return {"x": rows(p["kc"], np.arange(c)), "dr": rows(p["kc"],
                                                         np.arange(c)),
            "dt": rows(p["kc"], np.arange(c)),
            "a": rows(p["knh"], np.arange(nb * hc)),
            "dc": rows(p["ldc"], dc_cols)}


def _rows(src, y0, x0, d, ty, h, w):
    """The (ty + 2d) x (8 + 2d) pixel rows around the tile at (y0, x0)
    (d = 0: the tile) of one image, zero outside it, as the copies stage
    them."""
    tx = WG_TX
    out = torch.zeros((ty + 2 * d, tx + 2 * d, src.shape[-1]))
    ya, yb = max(y0 - d, 0), min(y0 + ty + d, h)
    xa, xb = max(x0 - d, 0), min(x0 + tx + d, w)
    out[ya - y0 + d:yb - y0 + d, xa - x0 + d:xb - x0 + d] = src[ya:yb, xa:xb]
    return out


def walk(p, total, ops):
    """What the kernels compute for plan ``p`` on operands ``ops`` (each
    (B, H, W, pitch) float32): per block, per tile of its share of one
    combo (:func:`wg_range`), the U rows and V rows staged (zero outside the image; NaN in U's channels of an m16 tile
    that are never staged): for taps the tile's x rows and the dc window
    at the job's dilation, each tap's product taking the window shifted
    by minus its offset (out[t] = sum over q of x(q) dc(q - offset t));
    for a plain product both tiles.  Per m16 tile and k-step the 16-pixel
    product; the block's sums to its partial row; then the rows summed as
    reduce_rows_kernel sums them."""
    h, w, ty, mt, tx = p["h"], p["w"], p["ty"], p["mt"], WG_TX
    part = torch.zeros((p["slots"], total), dtype=torch.float32)
    for k in range(p["blocks"]):
        combo, row, t0, t1 = wg_range(p, k)
        acc = {}
        for t in range(t0, t1):
            jj, ks, nsl = p["combos"][combo]
            j = p["jobs"][jj]
            img, u = divmod(t, p["tpi"])
            y0, x0 = u // p["tiles_x"] * ty, u % p["tiles_x"] * tx
            d = j["d"]
            k0, n0 = 16 * mt * ks, 8 * p["nsw"] * nsl
            cpu = min(-(-(j["K"] - k0) // 8), 2 * mt)
            cpv = min(-(-j["N"] // 8) - p["nsw"] * nsl, p["nsw"])
            ut = torch.full((ty, tx, 16 * mt), float("nan"))
            ut[..., :8 * cpu] = _rows(
                ops[j["u"]][img, ..., j["u0"] + k0:j["u0"] + k0 + 8 * cpu],
                y0, x0, 0, ty, h, w)
            vt = _rows(ops[j["v"]][img, ..., j["v0"] + n0:
                                   j["v0"] + n0 + 8 * cpv],
                       y0, x0, d, ty, h, w)
            ksteps = -(-min(ty, h - y0) // 2)
            # taps: every m16 tile of the m64 (rows past K are not kept)
            mte = mt if d else min(-(-(j["K"] - k0) // 16), mt)
            for tap in range(p["taps"]):
                oy, ox = d * (2 - tap // 3), d * (2 - tap % 3)
                for m in range(mte):
                    for s in range(ksteps):
                        a = ut[2 * s:2 * s + 2, :,
                               16 * m:16 * m + 16].reshape(16, 16)
                        bv = vt[oy + 2 * s:oy + 2 * s + 2,
                                ox:ox + tx].reshape(16, -1)
                        key = (tap, m)
                        prod = a.t() @ bv
                        acc[key] = prod if key not in acc else acc[key] + prod
            if t + 1 < t1:
                continue
            # the walk's end: its sums to the block's row
            for (tap, m), v in acc.items():
                kk = k0 + 16 * m + torch.arange(16)
                nn = n0 + torch.arange(v.shape[1])
                keep_k, keep_n = kk < j["K"], nn < j["N"]
                idx = (j["out_off"] + tap * j["K"] * j["N"]
                       + kk[keep_k, None] * j["N"] + nn[None, keep_n])
                part[row, idx.reshape(-1)] = v[keep_k][:, keep_n].reshape(-1)
            acc = {}
    # reduce_rows_kernel: 8 strided sums of the rows, then added in order
    out = part[0::8].sum(0)
    for r in range(1, 8):
        out = out + (part[r::8].sum(0) if r < p["slots"]
                     else torch.zeros(total))
    return out


@pytest.mark.parametrize("op,shape", cases(WALK_SHAPES + SPLIT_SHAPES))
def test_wgrad_walk_matches_plain_on_exact_sums(op, shape):
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    ops = _operands(shape, seed=sum(shape[:4]))
    p = cam.tile_plan("f3b", *shape)
    x = ops["x"][..., :c]
    want = {"dkh": torch.stack([
        cam._wgrad(x, ops["dc"][..., i * p["khc"]:i * p["khc"] + hc], d)
        for i, d in enumerate(dils)]).reshape(-1)}
    want["dkr"] = torch.einsum("bhwc,bhwn->cn", x,
                               ops["dr"][..., :c]).reshape(-1)
    want["dkt"] = torch.einsum("bhwj,bhwc->jc", ops["a"][..., :nb * hc],
                               ops["dt"][..., :c]).reshape(-1)
    want["dkr_dkt"] = torch.cat([want["dkr"], want["dkt"]])
    for name, plan, total in wgrad_launches(op, *shape):
        got = walk(plan, total, ops)
        assert torch.equal(got, want[name]), name


# ------------------------------------------------------------ vs JAX

def _jax_wgrad(u, v, d):
    """JAX's weight-gradient sum (pallas_cam._mmT, as _f1b_kernel's dkh
    and dkr take it) over the same shifted bf16 operands."""
    import jax.numpy as jnp     # here, so the card tests import the plan

    from rtpe_tpu.ops import pallas_cam as pc
    u = jnp.asarray(u.float().numpy()).astype(jnp.bfloat16)
    v = jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
    k, n = u.shape[-1], v.shape[-1]
    vf = v.reshape(-1, n)
    if not d:
        return np.asarray(pc._mmT(u.reshape(-1, k), vf))
    h, w = u.shape[1:3]
    up = jnp.pad(u, ((0, 0), (d, d), (d, d), (0, 0)))
    taps = [pc._mmT(up[:, ti * d:ti * d + h, tj * d:tj * d + w]
                    .reshape(-1, k), vf)
            for ti in range(3) for tj in range(3)]
    return np.asarray(jnp.stack(taps)).reshape(3, 3, k, n)


@pytest.mark.parametrize("d", [0, 1, 3])
@pytest.mark.parametrize("exact", [True, False])
def test_cam_wgrad_plain_matches_jax(d, exact):
    """cam_wgrad on CPU tensors is its plain version, which sums what
    JAX's kernels sum: bitwise on exact sums, else within float32 sum
    order (2^-16 of the largest |u v| sum)."""
    rng = np.random.default_rng(d + 10 * exact)
    shp = (2, 9, 11)
    if exact:
        u = torch.from_numpy(rng.integers(-3, 4, (*shp, 24)).astype(
            np.float32))
        v = torch.from_numpy(rng.integers(-3, 4, (*shp, 12)).astype(
            np.float32))
    else:
        u = torch.from_numpy(rng.random((*shp, 24), np.float32))
        v = torch.from_numpy(rng.standard_normal((*shp, 12), np.float32))
    u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
    before = cam.cam_wgrad_plain.calls, cam.cam_wgrad.launches
    got = cam.cam_wgrad(u, v, d)
    assert (cam.cam_wgrad_plain.calls, cam.cam_wgrad.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == torch.float32
    assert got.shape == ((3, 3, 24, 12) if d else (24, 12))
    want = torch.from_numpy(np.array(_jax_wgrad(u, v, d)))
    if exact:
        assert torch.equal(got, want)
    else:
        den = cam.cam_wgrad_plain(u.abs(), v.abs(), d).abs().max()
        assert float((got - want).abs().max()) <= 2.0 ** -16 * float(den)
