"""The LAP solver's Hopper design (``csrc/lap_core.cuh``), walked in
PyTorch on the CPU.

The solver runs one warp.  Lane t holds the Q contiguous columns
Q t .. Q t + Q - 1 (Q = 2 up to 63 cost columns, 4 up to 127), so the
lowest lane among tied minima holds the smallest column.  A Dijkstra
step's argmin is one ``__reduce_min_sync`` over each lane's best
(``min_key``: -0 equal to +0, a NaN distance masked as INF, the
smallest q on ties), one ballot of the lanes at the minimum and ``__ffs`` for the
owner, then delta, u and p of the winning column from the owner.  Here
:func:`lap_warp` does those steps on a (32, Q) view of the columns, and
is held exactly to the plain solver ``ops/lap.py:lap_columns`` (through
``lap_rect_plain``) and to the interpret-mode Pallas
``hungarian_rect_pallas``: decode-shaped costs (``chip_smoke.
decode_costs``), exact ties, the decode's sentinels, costs of -0.0 and
+0.0, and m in {30, 60, 63, 64, 127}.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from chip_smoke import decode_costs
from rtpe_tpu.ops.pallas_lap import hungarian_rect_pallas
from rtpe_tpu_torch.ops.lap import lap_columns, lap_rect_plain

F32 = torch.float32
INF = 1e18


def lanes_q(m: int) -> int:
    """``lap_core.cuh:lanes_q``."""
    return 2 if m + 1 <= 64 else 4


def min_key(x: torch.Tensor) -> torch.Tensor:
    """``lap_core.cuh:min_key``: uint32 keys (held in int64) of masked
    distances, which are never NaN (``mask`` makes a NaN INF)."""
    u = (x.to(F32) + 0.0).contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF                                          # -0 -> +0
    return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def mask(minv: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The step's masked distances: INF for a used or invalid column
    (``out``) and for a NaN distance, which the parent never took."""
    return torch.where(out | torch.isnan(minv), torch.tensor(INF, dtype=F32),
                       minv)


def warp_argmin(masked: torch.Tensor, q: int) -> int:
    """The step's argmin as the warp takes it: each lane's best of its q
    columns (smallest q on ties), one reduction over the lanes' keys,
    the lowest lane at the minimum.  Returns the winning column."""
    keys = min_key(masked).view(32, q)
    kb = keys.min(dim=1).values
    qb = (keys == kb[:, None]).to(torch.int64).argmax(dim=1)   # first q
    owner = int((kb == kb.min()).to(torch.int64).argmax())     # __ffs
    return q * owner + int(qb[owner])


def lap_warp(cost: torch.Tensor, q: int):
    """``lap_core.cuh:lap_warp<q>`` on one (n, m) matrix: p (32 q,) int64,
    the 1-indexed row of each column (column l is cost column l - 1), or
    None where a row finds no free column below 1e18."""
    n, m = cost.shape
    cols = 32 * q
    lane_col = torch.arange(cols)
    valid = (lane_col >= 1) & (lane_col <= m)
    crows = torch.zeros((n, cols), dtype=F32)
    crows[:, 1:m + 1] = cost.to(F32)
    v = torch.zeros(cols, dtype=F32)
    u = torch.zeros(cols, dtype=F32)
    p = torch.zeros(cols, dtype=torch.int64)
    for i in range(1, n + 1):
        p[0] = i
        u[0] = 0.0
        minv = torch.full((cols,), INF, dtype=F32)
        way = torch.zeros(cols, dtype=torch.int64)
        used = torch.zeros(cols, dtype=torch.bool)
        j0, pj0, uj0 = 0, i, torch.zeros((), dtype=F32)
        for _ in range(m + 2):
            if pj0 == 0:
                break
            used[j0] = True
            c = torch.where(valid, crows[pj0 - 1], torch.zeros((), dtype=F32))
            cur = (c - uj0) - v                      # two f32 roundings
            better = valid & ~used & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = mask(minv, used | ~valid)
            j1 = warp_argmin(masked, q)
            delta = masked[j1]
            if not bool(delta < INF):
                return None
            u = torch.where(used, u + delta, u)
            v = torch.where(used, v - delta, v)
            minv = torch.where(~used, minv - delta, minv)
            j0, pj0, uj0 = j1, int(p[j1]), u[j1].clone()
        else:
            return None
        for _ in range(m + 2):
            if j0 == 0:
                break
            j1 = int(way[j0])
            p[j0], u[j0] = p[j1], u[j1]
            j0 = j1
        else:
            return None
    p[0] = 0
    return p


def columns(p, n: int, m: int) -> torch.Tensor:
    """p from :func:`lap_warp` -> (n,) int32 column of each row (-1 for
    every row of a matrix that was not solved)."""
    if p is None:
        return torch.full((n,), -1, dtype=torch.int32)
    out = torch.zeros(n, dtype=torch.int32)
    for l in range(1, m + 1):
        if p[l] >= 1:
            out[p[l] - 1] = l - 1
    return out


def signed_zeros(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    cost = rng.integers(-1, 2, size=(n, m)).astype(np.float32)
    zero = np.where(rng.random((n, m)) < 0.5, np.float32(-0.0),
                    np.float32(0.0))
    return np.where(cost == 0, zero, cost).astype(np.float32)


def cases():
    rng = np.random.default_rng(7)
    out = []
    for m in (30, 60, 63, 64, 127):
        n = min(30, m)
        for i, c in enumerate(decode_costs(4, n, m, rng)):
            out.append((f"decode{i}_m{m}", c))
        out.append((f"zeros_m{m}", signed_zeros(n, m, m)))
    return out


CASES = cases()


def test_min_key_ties_the_zeros_and_masks_nan_as_inf():
    x = torch.tensor([float("-inf"), -1.0, -0.0, 0.0, 1e-45, 1.0, INF,
                      float("inf")])
    k = min_key(x).tolist()
    assert k[2] == k[3]
    assert k == sorted(k)
    m = mask(torch.tensor([float("nan"), 1.0]), torch.tensor([False, False]))
    assert m.tolist() == [float(np.float32(INF)), 1.0]


@settings(max_examples=200, deadline=None)
@given(st.floats(width=32, allow_nan=False), st.floats(width=32,
                                                       allow_nan=False))
def test_min_key_is_the_float_order(a, b):
    ka, kb = min_key(torch.tensor([a, b], dtype=F32)).tolist()
    assert (ka < kb) == (a < b) and (ka == kb) == (a == b)


@pytest.mark.parametrize("q", [2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_warp_argmin_takes_the_smallest_column_at_the_minimum(q, seed):
    """Against torch.argmin (the first column at the minimum), on values
    full of ties, signed zeros and the INF mask."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2, 3, 32 * q).astype(np.float32)
    vals[rng.random(32 * q) < 0.3] = INF
    vals = np.where(vals == 0, np.where(rng.random(32 * q) < 0.5,
                                        np.float32(-0.0), np.float32(0.0)),
                    vals).astype(np.float32)
    masked = torch.from_numpy(vals)
    assert warp_argmin(masked, q) == int(torch.argmin(masked))


def test_lanes_q_at_the_boundary():
    assert [lanes_q(m) for m in (30, 60, 63, 64, 127)] == [2, 2, 2, 4, 4]


@pytest.mark.parametrize("name,cost", CASES, ids=[c[0] for c in CASES])
def test_walk_matches_plain(name, cost):
    n, m = cost.shape
    c = torch.from_numpy(cost)
    want = lap_rect_plain(c[None])[0]
    assert torch.equal(columns(lap_warp(c, lanes_q(m)), n, m), want)
    if m <= 63:     # the wider layout gives the same columns
        assert torch.equal(columns(lap_warp(c, 4), n, m), want)


@pytest.mark.parametrize("m", [30, 60, 63, 64, 127])
def test_walk_matches_pallas_interpret(m):
    cost = decode_costs(2, min(30, m), m, np.random.default_rng(m))[1]
    want = np.asarray(hungarian_rect_pallas(jnp.asarray(cost),
                                            interpret=True))
    got = columns(lap_warp(torch.from_numpy(cost), lanes_q(m)), *cost.shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_walk_fails_where_the_plain_solver_does(bad):
    cost = decode_costs(1, 6, 9, np.random.default_rng(0))[0]
    cost[2] = bad
    c = torch.from_numpy(cost)
    assert lap_warp(c, 2) is None
    assert lap_rect_plain(c[None])[0].tolist() == [-1] * 6


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 12), st.integers(0, 20), st.integers(0, 2 ** 31 - 1),
       st.sampled_from([2, 4]))
def test_walk_on_random_tie_matrices(n, extra, seed, q):
    m = min(n + extra, 32 * q - 1)
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 3, size=(n, m)).astype(np.float32)
    c = torch.from_numpy(cost)
    assert torch.equal(columns(lap_warp(c, q), n, m),
                       lap_rect_plain(c[None])[0])


@pytest.mark.parametrize("m", [30, 63, 127])
def test_image_passes_count_each_matrix(m):
    """``lap_columns.image_passes`` after one batched solve: each matrix's
    Dijkstra steps as the matrix solved alone counts them (``passes``),
    summed over calls until it is set to None, restarted by a call of
    another batch (``chip_smoke.py`` takes the longest image's chain of
    steps from it)."""
    cost = torch.from_numpy(decode_costs(8, min(30, m), m,
                                         np.random.default_rng(m + 1)))
    alone = []
    for i in range(cost.shape[0]):
        lap_columns.passes = 0
        lap_rect_plain(cost[i:i + 1])
        alone.append(lap_columns.passes)
    assert len(set(alone)) > 1
    lap_columns.image_passes = None
    lap_rect_plain(cost)
    assert lap_columns.image_passes.tolist() == alone
    lap_rect_plain(cost)
    assert lap_columns.image_passes.tolist() == [2 * a for a in alone]
    lap_rect_plain(cost[:3])
    assert lap_columns.image_passes.tolist() == alone[:3]
