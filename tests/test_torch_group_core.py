"""The grouping kernels' Hopper design (``csrc/group_core.cuh``), walked
in PyTorch on the CPU.

The kernels take each greedy row's argmin as one ``__reduce_min_sync``
over an order-preserving uint32 image of the cost (``order_key``) and one
ballot for the smallest slot at the minimum, and they reorder the
update: new rows first look for their key among the slots that no
allocation of the joint can change; the rest (the walkers) merge onto the
first walker with their key or take fresh slots in order, or, once the
people are at p_max, share the last slot, or, on the joint that reaches
p_max, walk in order over the slots the joint allocates; then each slot
takes the key of the last row that allocated it and, from the last row
that reset it, adds the matched rows' tags in row order.  Here:

* a PyTorch mirror of ``order_key`` against the parent kernels'
  comparator ``before`` (NaN first, then the smaller cost, then the
  smaller slot) on NaN, -0 and +0, the infinities, subnormals and the
  sentinels ``MASKED``, ``HUGE`` and ``BIG``, and with ``hypothesis`` on
  random float32 pairs; and the key argmin, one candidate slot a lane or
  two or four, against ``torch.argmin`` of the plain versions;
* a walk of the new order (:func:`group_walk`) against the plain versions
  of both kernels (``match_by_tag_lockstep_plain``,
  ``match_by_tag_kernel_plain``, both solvers) on the scenes of
  ``tests/test_torch_group.py`` and ``tests/test_torch_decode.py``, and
  against the interpret-mode Pallas kernels: people and n_people exactly
  equal.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from rtpe_tpu.ops.pallas_group import match_by_tag_kernel as j_kernel
from rtpe_tpu.ops.pallas_group_lockstep import \
    match_by_tag_lockstep as j_lockstep
from rtpe_tpu_torch.ops import group as mega
from rtpe_tpu_torch.ops.group_lockstep import match_by_tag_lockstep_plain
from rtpe_tpu_torch.ops.lap import lap_columns, rows_to_columns

from test_torch_decode import lockstep_inputs
from test_torch_group import edge_scenes, nan_scene, scene

F32 = torch.float32
MASKED = 1e18
SENTINELS = [MASKED, mega.HUGE, mega.BIG, mega.COST_CLAMP]
SPECIAL = [float("nan"), -0.0, 0.0, float("inf"), float("-inf"),
           1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38, 1.17549435e-38,
           3.4028235e38, -3.4028235e38, 1.0, -1.0] + SENTINELS


def order_key(x: torch.Tensor) -> torch.Tensor:
    """``group_core.cuh:order_key`` in PyTorch: the uint32 key (held in
    int64) of float32 costs."""
    u = x.to(F32).contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    u = torch.where(((u << 1) & 0xFFFFFFFF) == 0, 0, u)     # -0 -> +0
    key = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(x), 0, key)


def before(a: float, sa: int, b: float, sb: int) -> bool:
    """The parent kernels' comparator (``group_lockstep.cu``,
    ``group_mega.cu`` before the redesign)."""
    a_nan, b_nan = a != a, b != b
    if a_nan or b_nan:
        return a_nan and (not b_nan or sa < sb)
    return a < b or (a == b and sa < sb)


def key_order(a: float, sa: int, b: float, sb: int) -> bool:
    ka, kb = order_key(torch.tensor([a, b], dtype=F32)).tolist()
    return (ka, sa) < (kb, sb)


def key_argmin(masked: torch.Tensor, q: int) -> int:
    """The kernels' argmin of one row: slot Q * lane + q on lane ``lane``;
    each lane keeps its smallest key (smallest q on ties), the warp takes
    the minimum (``__reduce_min_sync``) and the lowest lane holding it
    (ballot, ``__ffs``)."""
    keys = order_key(masked).reshape(32, q)
    best, qb = keys.min(dim=1)          # first index of the minimum
    lane = int(torch.nonzero(best == best.min())[0, 0])
    return q * lane + int(qb[lane])


def test_order_key_sorts_special_values_like_before():
    vals = SPECIAL
    for a in vals:
        for b in vals:
            for sa, sb in ((0, 1), (1, 0), (5, 5)):
                a32, b32 = (float(np.float32(v)) for v in (a, b))
                assert key_order(a32, sa, b32, sb) == before(a32, sa, b32,
                                                            sb), (a, b)
    keys = order_key(torch.tensor(vals, dtype=F32)).tolist()
    assert keys[0] == 0 and min(keys[1:]) > 0          # NaN below all
    assert keys[1] == keys[2]                          # -0 == +0


f32s = st.floats(width=32, allow_nan=True, allow_infinity=True,
                 allow_subnormal=True) | st.sampled_from(SPECIAL)


@settings(max_examples=400, deadline=None)
@given(a=f32s, b=f32s, sa=st.integers(0, 127), sb=st.integers(0, 127))
def test_order_key_matches_before_on_random_pairs(a, b, sa, sb):
    assert key_order(a, sa, b, sb) == before(a, sa, b, sb)


@pytest.mark.parametrize("q", [1, 2, 4])
def test_key_argmin_matches_torch_argmin(q):
    """The rows the greedy chains see: candidates below p_cur and unused
    at their cost, the rest at MASKED; costs with exact ties, NaNs, zeros
    of both signs and the sentinels."""
    rng = np.random.default_rng(q)
    n = 32 * q
    pool = np.array(SPECIAL + [-0.5, 0.25, 0.25, 100.0, -0.0, 0.0],
                    np.float32)
    for _ in range(300):
        cost = np.where(rng.random(n) < 0.5, rng.choice(pool, n),
                        np.round(rng.normal(size=n) * 4) / 4).astype(
                            np.float32)
        p_cur = int(rng.integers(0, n + 1))
        used = rng.random(n) < 0.3
        cand = (np.arange(n) < p_cur) & ~used
        masked = torch.from_numpy(np.where(cand, cost, np.float32(MASKED)))
        assert key_argmin(masked, q) == int(torch.argmin(masked))


# ---------------------------------------------------------------- the walk

def lockstep_costs(mean, tags, vals, m):
    """(K, S) cost and distance of the lockstep kernel's rows against the
    means (S, D), by the plain version's arithmetic."""
    k, d = tags.shape
    s_f = torch.arange(mean.shape[0], dtype=F32)
    diff_sq = torch.zeros((k, mean.shape[0]), dtype=F32)
    for dd in range(d):
        dl = tags[:, dd, None] - mean[None, :, dd]
        diff_sq = diff_sq + dl * dl
    diff = torch.sqrt(diff_sq)
    return diff, torch.round(diff) * 100.0 - vals[:, None]


def group_walk(tag, loc, val, m, p_max, solver, det_thr=0.1, tag_thr=1.0,
               use_val=True, ignore_too_much=False):
    """One image after another, one joint after another, in the kernels'
    order: the costs, the greedy chain on order keys (or the exact LAP),
    then the update's slots (stable key matches, then the walkers by the
    joint's regime) and each slot's rows applied from its last reset."""
    b, j, k, d = tag.shape
    slots = 128
    one = torch.ones((), dtype=F32)
    people = torch.zeros((b, p_max, j, 3 + d), dtype=F32)
    n_out = torch.zeros(b, dtype=torch.int32)
    key_mask = int(order_key(torch.tensor([MASKED], dtype=F32)))
    for bi in range(b):
        keys = torch.full((slots,), float("inf"), dtype=F32)
        tsum = torch.zeros((slots, d), dtype=F32)
        tcnt = torch.zeros(slots, dtype=F32)
        npv, ok = 0, True
        for jj in range(j):
            t, v = tag[bi, jj].to(F32), val[bi, jj].to(F32)
            p_cur = min(npv, m)
            skip = ignore_too_much and p_cur == m
            lo = min(npv, p_max - 1)
            valid = v > torch.tensor(det_thr, dtype=F32)
            act = valid & ~torch.tensor(skip)
            mean = tsum / torch.maximum(tcnt, one)[:, None]
            col = torch.zeros(k, dtype=torch.int64)
            matched = torch.zeros(k, dtype=torch.bool)
            if solver == "lap":
                p_cur_t = torch.tensor([p_cur])
                cost, diff = mega.joint_cost(
                    mean[None, :m], t[None], v[None], valid[None], p_cur_t,
                    mega.tie_bias(k, m, "cpu"), use_val)
                rows1 = torch.arange(1, k + 1)
                n_valid = int(torch.where(valid, rows1, 0).max())
                n_rows = 0 if (p_cur == 0 or skip) else n_valid
                p = lap_columns(cost, torch.tensor([n_rows]))
                ok = ok and int(p[0, 0]) >= 0
                col = rows_to_columns(p, k)[0]
                d_at = diff[0, torch.arange(k), col.clamp(0, m - 1)]
                matched = act & (col < p_cur) & (d_at < tag_thr)
            elif p_cur > 0:
                if solver == "lockstep":
                    diff, cost = lockstep_costs(mean, t, v, m)
                    if not use_val:
                        cost = diff
                    cost = torch.minimum(cost, torch.tensor(
                        mega.COST_CLAMP, dtype=F32))
                    s_f = torch.arange(slots, dtype=F32)
                    crow = torch.stack([
                        cost[r] + torch.tensor((2 * m - r) * 1e-8,
                                               dtype=F32) * s_f
                        for r in range(k)])
                else:
                    cost, diff = mega.joint_cost(
                        mean[None, :m], t[None], v[None], valid[None],
                        torch.tensor([p_cur]), mega.tie_bias(k, m, "cpu"),
                        use_val)
                    crow, diff = cost[0], diff[0]
                q = 1 if min(m, p_max) <= 32 else (
                    2 if min(m, p_max) <= 64 else 4)
                used = torch.zeros(32 * q, dtype=torch.bool)
                for r in torch.nonzero(act)[:, 0].tolist():
                    c_r = torch.full((32 * q,), MASKED, dtype=F32)
                    c_r[:p_cur] = crow[r, :p_cur]
                    cand = (torch.arange(32 * q) < p_cur) & ~used
                    keys_r = torch.where(cand, order_key(c_r), key_mask)
                    kmin = keys_r.reshape(32, q).min(dim=1).values.min()
                    s_at = int(torch.nonzero(keys_r == kmin)[0, 0])
                    hit = bool(cand[s_at]) and bool(
                        c_r[s_at] < mega.BIG) and bool(diff[r, s_at]
                                                       < tag_thr)
                    col[r], matched[r] = s_at, hit
                    used[s_at] |= hit
            # the update's slots: matched rows their column, new rows their
            # stable key match, the walkers by the joint's regime
            is_new = act & ~matched
            slot = torch.full((k,), -1, dtype=torch.int64)
            alloc = torch.zeros(k, dtype=torch.bool)
            walkers = []
            for r in range(k):
                if matched[r]:
                    slot[r] = min(max(int(col[r]), 0), p_max - 1)
                elif is_new[r]:
                    stable = torch.nonzero(keys[:lo] == t[r, 0])
                    if len(stable):
                        slot[r] = int(stable[0, 0])
                    else:
                        walkers.append(r)
            kw_ = [float(t[r, 0]) for r in walkers]
            if len(walkers) <= p_max - npv:
                # fresh slots: merge onto the first walker with the key
                n_new = 0
                for i, r in enumerate(walkers):
                    first = next(w for w, kk in enumerate(kw_)
                                 if kk == kw_[i] or w == i)
                    if first == i:
                        slot[r], alloc[r] = npv + n_new, True
                        n_new += 1
                    else:
                        slot[r] = slot[walkers[first]]
                npv += n_new
            elif npv == p_max:
                # saturated: the key at p_max - 1 is the previous walker's
                for i, r in enumerate(walkers):
                    prev = kw_[i - 1] if i else float(keys[p_max - 1])
                    slot[r], alloc[r] = p_max - 1, not prev == kw_[i]
            else:
                # the joint that reaches p_max: walk the allocated slots
                dyn = []
                for r, kr in zip(walkers, kw_):
                    hits = [i for i, kk in enumerate(dyn) if kk == kr]
                    if hits:
                        slot[r] = lo + hits[0]
                        continue
                    s_r = min(npv, p_max - 1)
                    dyn[s_r - lo:s_r - lo + 1] = [kr]
                    slot[r], alloc[r] = s_r, True
                    npv = min(npv + 1, p_max)
            # each slot: the key of its last allocating row, then from its
            # last resetting row (or its own state) the matched rows' tags
            # added in row order
            for s in range(p_max):
                rows = torch.nonzero(slot == s)[:, 0].tolist()
                allocs = [r for r in rows if alloc[r]]
                if allocs:
                    keys[s] = t[allocs[-1], 0]
                resets = [r for r in rows if not matched[r]]
                if resets:
                    tsum[s], tcnt[s] = t[resets[-1]], one
                    rows_after = [r for r in rows if r > resets[-1]]
                else:
                    rows_after = rows
                for r in rows_after:
                    tsum[s] = tsum[s] + t[r]
                    tcnt[s] = tcnt[s] + one
                if rows:
                    r = rows[-1]
                    people[bi, s, jj] = torch.cat(
                        [loc[bi, jj, r].to(F32), v[r:r + 1], t[r]])
        n_out[bi] = npv if ok else -1
    return people, n_out


def as_torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def plain(arrays, solver, m, p_max, **kw):
    args = as_torch(arrays)
    if solver == "lockstep":
        return match_by_tag_lockstep_plain(
            *args, max_num_people=m, p_max=p_max, **kw)
    return mega.match_by_tag_kernel_plain(
        *args, max_num_people=m, p_max=p_max, solver=solver, **kw)


def sorted_scene(shape, seed):
    tags, locs, vals = scene(*shape, seed=seed)
    return tags, locs, np.sort(vals, axis=-1)[..., ::-1].copy()


def spread_scene(shape, seed, spread):
    """Many distinct keys: more people than 32 candidate slots."""
    tags, locs, vals = sorted_scene(shape, seed)
    tags[..., 0] = np.round(tags[..., 0] * spread) / 2
    return tags, locs, vals


WALK_SCENES = {
    "group": (lambda: scene(2, 4, 8, 1, seed=14), 8, 24, {}),
    "group_d2": (lambda: scene(2, 3, 6, 2, seed=13), 8, 10, {}),
    "edges": (edge_scenes, 4, 6, {}),
    "edges_skip": (edge_scenes, 4, 6, {"ignore_too_much": True}),
    "nan": (lambda: nan_scene(3, 5, 8, 1, seed=5), 8, 24, {}),
    "nan_d2": (lambda: nan_scene(3, 4, 6, 2, seed=5), 8, 10,
               {"ignore_too_much": True}),
    "decode": (lambda: lockstep_inputs((2, 6, 12, 1)), 12, 90, {}),
    "decode_main": (lambda: lockstep_inputs((1, 17, 30, 1)), 30, 90, {}),
    "saturate": (lambda: sorted_scene((2, 6, 12, 1), 3), 20, 6, {}),
    "many": (lambda: spread_scene((2, 5, 20, 1), 4, 40.0), 40, 48, {}),
    "no_val": (lambda: sorted_scene((2, 5, 10, 2), 9), 10, 20,
               {"use_val": False}),
}


@pytest.mark.parametrize("solver", ["lockstep", "greedy", "lap"])
@pytest.mark.parametrize("name", sorted(WALK_SCENES))
def test_walk_matches_the_plain_versions(solver, name):
    make, m, p_max, kw = WALK_SCENES[name]
    arrays = make()
    p_w, n_w = group_walk(*as_torch(arrays), m, p_max, solver, **kw)
    if "use_val" in kw:
        kw = {"use_detection_val": kw["use_val"]}
    p_p, n_p = plain(arrays, solver, m, p_max, **kw)
    assert torch.equal(n_w, n_p)
    torch.testing.assert_close(p_w, p_p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("solver", ["lockstep", "greedy", "lap"])
@pytest.mark.parametrize("name", ["group", "nan", "saturate"])
def test_walk_matches_pallas_interpret(solver, name):
    make, m, p_max, kw = WALK_SCENES[name]
    arrays = make()
    p_w, n_w = group_walk(*as_torch(arrays), m, p_max, solver, **kw)
    j_args = [jnp.asarray(a) for a in arrays]
    if solver == "lockstep":
        p_j, n_j = j_lockstep(*j_args, max_num_people=m, p_max=p_max,
                              interpret=True, **kw)
    else:
        p_j, n_j = j_kernel(*j_args, max_num_people=m, p_max=p_max,
                            solver=solver, interpret=True, **kw)
    np.testing.assert_array_equal(n_w.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_w.numpy(), np.asarray(p_j))


def test_trace_marks_fit_the_kernel_source():
    """``tools/group_trace.py`` marks the phases of ``group_core.cuh``; a
    change to the kernel's phase boundaries must keep its marks in step."""
    from rtpe_tpu_torch.tools import group_trace
    path = os.path.join(os.path.dirname(group_trace.__file__), os.pardir,
                        "csrc", "group_core.cuh")
    with open(path) as f:
        marked = group_trace.mark_core(f.read())
    assert marked.count("TR_AT(8 * j") == 7
    assert "TR_BEGIN" in marked and "TR_END(J)" in marked
