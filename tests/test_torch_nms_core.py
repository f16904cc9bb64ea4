"""The NMS + top-k kernel's Hopper design (``csrc/nms_topk.cu``), walked
in PyTorch on the CPU.

The kernel pools with a max that propagates NaN, keys each peak by a
descending uint32 image of its value (``desc_key``: the larger value the
smaller key, -0 as +0), and selects each tile's top-K without K rounds:
the keys are split at the zero key, then a radix select of 8-bit digits
over histograms runs on the side that holds the K-th key and stops at the
first bin taken whole; the compaction takes every key below the
threshold and the first keys at it in flat order (row-major tile order).
The merge selects over the tiles' candidates the same way, narrows the
candidates at the plane's threshold by a radix select on their flat
index, and ranks the K winners by (key, flat index).  Here
:func:`nms_walk` does the same steps with tensors, at the kernel's tile
(32 x 64) and at other tiles that put many tile borders in a small
plane, and is held exactly to ``nms_topk_plain`` and to the
interpret-mode Pallas ``nms_topk_pallas``: NaN windows (a peak beside a
NaN, a NaN on a tile border), ties across tile borders, sparse,
negative, constant and ragged planes, ksize 3 / 5 / 9, and with
``hypothesis`` small random planes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from rtpe_tpu.ops.pallas_decode import nms_topk_pallas
from rtpe_tpu_torch.ops.nms_topk import nms_topk, nms_topk_plain

F32 = torch.float32
ZERO_KEY = 0x7FFFFFFF
NONE = 0xFFFFFFFF
ALL = 0xFFFFFFFF
INT_MAX = 2 ** 31 - 1


def desc_key(v: torch.Tensor) -> torch.Tensor:
    """``nms_topk.cu:desc_key``: uint32 keys (held in int64)."""
    u = v.to(F32).contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    u = torch.where(((u << 1) & 0xFFFFFFFF) == 0, 0, u)      # -0 -> +0
    return torch.where(u >= 0x80000000, u, ~u & 0x7FFFFFFF)


def radix_select(keys: torch.Tensor, k: int, top_shift: int) -> tuple:
    """``nms_topk.cu:radix_select`` over the keys given: (t, need)."""
    prefix, need = 0, k
    pmask = (0xFFFFFFFF << (top_shift + 8)) & 0xFFFFFFFF  # bits above: 0
    for shift in range(top_shift, -1, -8):
        live = keys[(keys & pmask) == prefix]
        hist = torch.bincount((live >> shift) & 255, minlength=256)
        cum = torch.cumsum(hist, 0)
        d = int(torch.searchsorted(cum, torch.tensor(need)))
        before = int(cum[d] - hist[d])
        need -= before
        prefix |= d << shift
        pmask |= 0xFF << shift
        if int(hist[d]) == need:                  # the bin, taken whole
            return prefix | (~pmask & 0xFFFFFFFF), ALL
    return prefix, need


def value_select(keys: torch.Tensor, k: int) -> tuple:
    """``nms_topk.cu:value_select``: the split at the zero key, then a
    radix select on the side that holds the k-th key."""
    lt = int((keys < ZERO_KEY).sum())
    eq = int((keys == ZERO_KEY).sum())
    if lt < k <= lt + eq:
        value_select.zero_split += 1
        return ZERO_KEY, k - lt
    if k <= lt:
        t, need = radix_select(keys[keys < ZERO_KEY], k, 24)
        return min(t, ZERO_KEY - 1), need
    return radix_select(keys[keys > ZERO_KEY], k - lt - eq, 24)


value_select.zero_split = 0


def take(keys: torch.Tensor, t: int, need: int) -> torch.Tensor:
    """The compaction's mask: keys below t, and the first ``need`` keys
    at t in the order given."""
    eq = keys == t
    rank = torch.cumsum(eq.to(torch.int64), 0) - 1
    return (keys < t) | (eq & (rank < need))


def peaks_of(plane: torch.Tensor, ksize: int) -> torch.Tensor:
    """The pooled peaks of one (H, W) plane; ``max_pool2d`` propagates
    NaN as the kernel's ``max.NaN.f32`` does."""
    pooled = F.max_pool2d(plane[None, None], ksize, 1, ksize // 2)[0, 0]
    return torch.where(pooled == plane, plane, torch.zeros((), dtype=F32))


def nms_walk(det: torch.Tensor, k: int, ksize: int, th: int = 32,
             tw: int = 64) -> tuple:
    """The kernel's two passes on ``det`` (B, H, W, J) with th x tw
    tiles: (val, x, y), each (B, J, K)."""
    b, h, w, j = det.shape
    vals = torch.empty((b, j, k), dtype=F32)
    xs = torch.empty((b, j, k), dtype=torch.int32)
    ys = torch.empty((b, j, k), dtype=torch.int32)
    kk = min(k, th * tw)
    for bi in range(b):
        for ji in range(j):
            pk = peaks_of(det[bi, :, :, ji].to(F32), ksize)
            cand_v, cand_i = [], []
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    # the tile in row-major order, outside pixels NONE
                    yy = torch.arange(ty, ty + th)[:, None]
                    xx = torch.arange(tx, tx + tw)[None, :]
                    inside = ((yy < h) & (xx < w)).reshape(-1)
                    fi = (yy * w + xx).reshape(-1)
                    v = torch.full((th * tw,), float("-inf"))
                    v[inside] = pk.reshape(-1)[fi[inside]]
                    key = torch.where(inside, desc_key(v), NONE)
                    fi = torch.where(inside, fi, INT_MAX)
                    t, need = value_select(key, kk)
                    m = take(key, t, need)
                    assert int(m.sum()) == kk
                    pad = k - kk
                    cand_v.append(torch.cat([v[m], torch.full(
                        (pad,), float("-inf"))]))
                    cand_i.append(torch.cat([fi[m], torch.full(
                        (pad,), INT_MAX, dtype=torch.int64)]))
            cv, ci = torch.cat(cand_v), torch.cat(cand_i)
            key = torch.where(ci == INT_MAX, NONE, desc_key(cv))
            t, need = value_select(key, k)
            t_idx = ALL
            if need != ALL:
                nb = max(h * w - 1, 1).bit_length()
                t_idx, _ = radix_select(ci[key == t], need,
                                        ((nb - 1) // 8) * 8)
            win = (key < t) | ((key == t) & (ci <= t_idx))
            assert int(win.sum()) == k
            wk, wi, wv = key[win], ci[win], cv[win]
            # rank by (key, flat index): flat indices are distinct
            order = torch.argsort(wi)
            order = order[torch.argsort(wk[order], stable=True)]
            vals[bi, ji] = wv[order]
            xs[bi, ji] = (wi[order] % w).to(torch.int32)
            ys[bi, ji] = (wi[order] // w).to(torch.int32)
    return vals, xs, ys


def nan_scene() -> np.ndarray:
    """The scene that showed the pool's fault: a 40 x 72 zero plane, 1.0
    at (y=10, x=11) beside a NaN at (10, 10), 0.5 at (30, 40); and a NaN
    on a tile border (31, 63) beside a 0.9 at (32, 64)."""
    det = np.zeros((1, 40, 72, 2), np.float32)
    det[0, 10, 11, 0] = 1.0
    det[0, 10, 10, 0] = np.nan
    det[0, 30, 40, 0] = 0.5
    det[0, 31, 63, 1] = np.nan
    det[0, 32, 64, 1] = 0.9
    det[0, 5, 5, 1] = 0.25
    return det


def scenes() -> dict:
    rng = np.random.default_rng(0)
    out = {"nan": nan_scene()}
    smooth = rng.normal(size=(2, 9, 13, 3)).astype(np.float32)
    smooth = F.interpolate(torch.from_numpy(smooth).permute(0, 3, 1, 2),
                           size=(70, 130), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
    smooth = (torch.round(smooth * 16) / 16).numpy()    # plateaus, ties
    smooth[0, :, :, 1] = -np.abs(smooth[0, :, :, 1]) - 0.01  # negative
    smooth[1, :, :, 1] = 0.375                           # constant
    smooth[1, :, :, 2] = 0.0                             # all zero
    out["smooth"] = smooth
    ties = np.zeros((1, 70, 130, 2), np.float32)
    for py, px in [(31, 63), (32, 64), (0, 0), (69, 129), (31, 64),
                   (32, 63), (40, 127), (40, 128)]:
        ties[0, py, px, 0] = 0.5                         # across borders
    ties[0, ::7, ::9, 1] = 0.125                         # many equal peaks
    out["ties"] = ties
    sparse = np.zeros((1, 37, 45, 2), np.float32)       # ragged, sparse
    sparse[0, 3, 4, 0] = 0.8
    sparse[0, 20, 30, 0] = 0.3
    sparse[0, 36, 44, 1] = -0.5
    sparse[0, 36, 44, 0] = np.nan
    out["sparse_ragged"] = sparse
    wide = rng.normal(size=(1, 33, 150, 2)).astype(np.float32)
    out["wide"] = np.round(wide * 4) / 4
    return out


SCENES = scenes()


def assert_same(got, want):
    for g, w in zip(got, want):
        g = torch.as_tensor(np.asarray(g))
        w = torch.as_tensor(np.asarray(w))
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g, w)


def test_desc_key_orders_like_the_values():
    vals = torch.tensor([float("inf"), 3.4028235e38, 1.0, 1e-45, 0.0, -0.0,
                         -1e-45, -1.0, -3.4028235e38, float("-inf")])
    keys = desc_key(vals)
    assert keys.tolist() == sorted(keys.tolist())
    assert int(keys[4]) == int(keys[5]) == ZERO_KEY      # -0 as +0
    assert int(keys[-1]) < NONE


@settings(max_examples=200, deadline=None)
@given(st.floats(width=32, allow_nan=False), st.floats(width=32,
                                                       allow_nan=False))
def test_desc_key_is_the_descending_order(a, b):
    ka, kb = desc_key(torch.tensor([a, b], dtype=F32)).tolist()
    assert (ka < kb) == (a > b) and (ka == kb) == (a == b)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(0, 40), min_size=1, max_size=300),
       st.integers(1, 300), st.sampled_from([0x10101, 0x7F000000,
                                            0x7FFFFFFF, 1]))
def test_value_select_takes_the_k_smallest(small, k, scale):
    """Many repeats and every split: the taken keys are the k smallest
    (as a multiset), the ties at the threshold in order."""
    keys = torch.tensor(small, dtype=torch.int64) * scale & 0xFFFFFFFF
    k = min(k, keys.numel())
    t, need = value_select(keys, k)
    m = take(keys, t, need)
    assert int(m.sum()) == k
    assert sorted(keys[m].tolist()) == sorted(keys.tolist())[:k]


@pytest.mark.parametrize("ksize", [3, 5, 9])
@pytest.mark.parametrize("tile", [(64, 64), (32, 64), (4, 8), (3, 5)])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_matches_plain(name, tile, ksize):
    det = torch.from_numpy(SCENES[name])
    k = min(30, det.shape[1] * det.shape[2])
    assert_same(nms_walk(det, k, ksize, *tile), nms_topk_plain(det, k, ksize))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_matches_pallas_interpret(name):
    det = SCENES[name]
    want = nms_topk_pallas(jnp.asarray(det), max_people=30, ksize=5,
                           interpret=True)
    assert_same(nms_walk(torch.from_numpy(det), 30, 5, 4, 8), want)
    assert_same(nms_topk_plain(torch.from_numpy(det), 30, 5), want)


def test_plain_keeps_nan_windows_as_pallas_does():
    """The NaN scene: (10, 11) has a NaN in its window, so it is no peak;
    the first entry is 0.5 at (x=40, y=30), then zeros in flat order."""
    det = nan_scene()
    want = nms_topk_pallas(jnp.asarray(det), max_people=4, ksize=5,
                           interpret=True)
    got = nms_topk(torch.from_numpy(det), 4, 5)
    assert_same(got, want)
    v, x, y = (t[0, 0].tolist() for t in got)
    assert v == [0.5, 0.0, 0.0, 0.0]
    assert x == [40, 0, 1, 2] and y == [30, 0, 0, 0]
    # the other plane: the 0.9 at (32, 64) sits beside the NaN at (31, 63)
    assert got[0][0, 1].tolist()[0] == 0.25


def test_most_tiles_of_a_sparse_plane_end_at_the_zero_split():
    """On zero-filled heatmaps the first count decides the threshold of
    almost every tile: no radix pass runs."""
    det = torch.zeros((1, 320, 320, 2))
    det[0, 100, 100, 0] = 0.9
    det[0, 200, 50, 1] = 0.4
    value_select.zero_split = 0
    assert_same(nms_walk(det, 30, 5), nms_topk_plain(det, 30, 5))
    tiles = 2 * 10 * 5
    assert value_select.zero_split == tiles + 2          # and the merges


def k_cases():
    return [(k, s) for s, k in enumerate([1, 7, 30, 64])]


@pytest.mark.parametrize("k,seed", k_cases())
def test_walk_takes_any_k(k, seed):
    """K above a small tile's pixel count (fillers in the candidates)
    and K = 1."""
    rng = np.random.default_rng(seed)
    det = torch.from_numpy(np.round(rng.normal(size=(1, 12, 14, 2))
                                    .astype(np.float32) * 2) / 2)
    assert_same(nms_walk(det, k, 3, 3, 5), nms_topk_plain(det, k, 3))


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 2), st.integers(2, 19), st.integers(2, 23),
       st.sampled_from([3, 5, 9]), st.integers(0, 2 ** 31 - 1),
       st.booleans())
def test_walk_on_random_planes(b, h, w, ksize, seed, nans):
    rng = np.random.default_rng(seed)
    det = np.round(rng.normal(size=(b, h, w, 2)) * 3) / 3
    if nans:
        det[rng.random(det.shape) < 0.03] = np.nan
    det = torch.from_numpy(det.astype(np.float32))
    k = min(30, h * w)
    assert_same(nms_walk(det, k, ksize, 4, 8), nms_topk_plain(det, k, ksize))
