"""The grouping mega-kernel: the CUDA kernel ``csrc/group_mega.cu`` and
its plain PyTorch version.

Replaces ``rtpe_tpu/ops/pallas_group.py:match_by_tag_kernel`` (the
Pallas kernel ``_group_kernel`` / ``_group_step`` with
``_lap_on_scratch``): the whole associative-embedding grouping of a
batch, one joint after another, each joint a cost build against the
frozen tag means, an assignment (``solver="lap"``: the exact
successive-shortest-path LAP over rows up to the last valid detection;
``"greedy"``: each row in top-k order takes the cheapest unused person)
and the row-by-row people-table update.  Same contract: ``tag_k``
(B, J, K, D), ``loc_k`` (B, J, K, 2), ``val_k`` (B, J, K) -> people
(B, p_max, J, 3 + D) float32 and n_people (B,) int32.

The plain version keeps the JAX kernel's arithmetic step for step
(float32 throughout, round half to even, the float32 tie bias
``((2m - r) * c) * 1e-8``, the sentinels of :data:`COST_CLAMP`,
:data:`BIG` and :data:`HUGE`), so the kernel can be held to it exactly.
:func:`tie_bias`, :func:`joint_cost` and :func:`update_rows` are the
cost build and the update it shares with ``decode/group_jit.py``, whose per-joint solver
is a separate LAP.  :func:`match_by_tag_kernel` runs the plain version
for CPU tensors and the kernel for CUDA tensors;
``match_by_tag_kernel.launches`` counts kernel launches.
"""

import ctypes
from typing import Tuple

import torch

from . import _build, _observe
from .lap import lap_columns, rows_to_columns

MAX_ROWS = 32     # detection rows per joint
LANES = 128       # cost columns + the LAP's entering column
MAX_PEOPLE = 96   # p_max envelope
COST_CLAMP = 1000.0
BIG = 2048.0      # valid row -> dummy column ("new person")
HUGE = 4096.0     # forbidden cells
_INF = 1e18
_KERNEL_DMAX = 8
SOLVERS = ("lap", "greedy")

_SIGS = {
    "group_mega_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
}

Result = Tuple[torch.Tensor, torch.Tensor]


def fits(k: int, m: int, p_max: int) -> bool:
    """Shape envelope of the kernel (the TPU kernel's, too)."""
    return k <= MAX_ROWS and 2 * m + 1 <= LANES and p_max <= MAX_PEOPLE \
        and k <= m


def _check(tag_k, loc_k, val_k, max_num_people, p_max, solver):
    b, j, k, d = tag_k.shape
    if tuple(loc_k.shape) != (b, j, k, 2) or tuple(val_k.shape) != (b, j, k):
        raise ValueError(f"shapes tag {tuple(tag_k.shape)}, loc "
                         f"{tuple(loc_k.shape)}, val {tuple(val_k.shape)} "
                         "do not agree")
    if not fits(k, max_num_people, p_max):
        raise ValueError(f"K={k}, max_num_people={max_num_people}, "
                         f"p_max={p_max} outside the grouping envelope")
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")


class PeopleState:
    """Person state of a batch, updated in place: the people table,
    the float keys, tag sums and counts of ``slots`` person slots, and
    ``npv`` (B,), the number of people."""

    def __init__(self, b: int, j: int, d: int, p_max: int, slots: int,
                 device):
        f32 = torch.float32
        self.p_max = p_max
        self.people = torch.zeros((b, p_max, j, 3 + d), dtype=f32,
                                  device=device)
        self.keys = torch.full((b, slots), float("inf"), dtype=f32,
                               device=device)
        self.tsum = torch.zeros((b, slots, d), dtype=f32, device=device)
        self.tcnt = torch.zeros((b, slots), dtype=f32, device=device)
        self.npv = torch.zeros(b, dtype=torch.int64, device=device)

    def means(self, m: int) -> torch.Tensor:
        """(B, m, D) tag means of the first m slots."""
        one = torch.ones((), dtype=torch.float32, device=self.tcnt.device)
        return self.tsum[:, :m] / torch.maximum(self.tcnt[:, :m],
                                                one)[..., None]


def tie_bias(k: int, m: int, device) -> torch.Tensor:
    """(K, 2m) float32 tie bias ``((2m - r) * c) * 1e-8``: among equal
    costs, earlier rows take earlier columns (the reference's munkres
    tie-breaking, ``group_jit.py:103-112``)."""
    f32 = torch.float32
    rows_f = torch.arange(k, dtype=f32, device=device)[:, None]
    cols_f = torch.arange(2 * m, dtype=f32, device=device)[None, :]
    return ((2 * m - rows_f) * cols_f) * torch.tensor(1e-8, dtype=f32,
                                                      device=device)


def joint_cost(mean: torch.Tensor, tags: torch.Tensor, vals: torch.Tensor,
               det_valid: torch.Tensor, p_cur: torch.Tensor,
               tie: torch.Tensor, use_detection_val: bool):
    """One joint's rectangular cost (``group_jit.py:91-119``,
    ``pallas_group.py:165-195``).  Tensor ops only: no host sync.

    :param mean: (B, m, D) frozen tag means; tags (B, K, D); vals and
      det_valid (B, K) (rows above the detection threshold); p_cur (B,)
      people considered, ``min(npv, m)``; tie (K, 2m) :func:`tie_bias`.
    :returns: cost (B, K, 2m) float32 and the unrounded distances
      (B, K, m).
    """
    b, k, d = tags.shape
    m = mean.shape[1]
    diff_sq = torch.zeros((b, k, m), dtype=torch.float32, device=tags.device)
    for dd in range(d):
        dl = tags[:, :, None, dd] - mean[:, None, :, dd]
        diff_sq = diff_sq + dl * dl
    diff = torch.sqrt(diff_sq)
    if use_detection_val:
        dn = torch.round(diff) * 100.0 - vals[:, :, None]
    else:
        dn = diff
    dn = dn.clamp(max=COST_CLAMP)
    cols = torch.arange(2 * m, device=tags.device)
    col_real = cols[None, None, :] < p_cur[:, None, None]
    padded = torch.cat([dn, torch.zeros_like(dn)], dim=2) + tie
    block = torch.where(col_real, padded, BIG)
    cost = torch.where(det_valid[..., None], block,
                       torch.where(col_real, HUGE, 0.0))
    return cost, diff


def update_rows(st: PeopleState, jj: int, rowvec: torch.Tensor,
                tags: torch.Tensor, cols: torch.Tensor,
                matched: torch.Tensor, is_new: torch.Tensor) -> None:
    """Row-by-row update of one joint (``group_jit.py:128-170``): a
    matched row adds its tag to its slot; a new row merges onto the
    first person with the same float key (setdefault) or appends one at
    ``min(npv, p_max - 1)``; the people row is the last writer's.

    :param rowvec: (B, K, 3 + D) detection rows; tags (B, K, D);
      cols (B, K) assigned columns; matched / is_new (B, K) bool.
    """
    b, k, _ = tags.shape
    dev = tags.device
    bi = torch.arange(b, device=dev)
    slots = st.keys.shape[1]
    s_idx = torch.arange(slots, device=dev)[None, :]
    p_max = st.p_max
    for r in range(k):
        m_r, n_r = matched[:, r], is_new[:, r]
        t_r = tags[:, r]
        key = t_r[:, 0]
        slot_m = cols[:, r].clamp(0, p_max - 1)
        key_hit = (st.keys == key[:, None]) & (s_idx < st.npv[:, None])
        has_hit = key_hit.any(dim=1)
        hit_slot = torch.where(key_hit, s_idx, slots).amin(dim=1)
        slot_n = torch.where(has_hit, hit_slot, st.npv.clamp(max=p_max - 1))
        slot_r = torch.where(m_r, slot_m, slot_n)
        write = m_r | n_r
        st.people[bi, slot_r, jj] = torch.where(
            write[:, None], rowvec[:, r], st.people[bi, slot_r, jj])
        st.tsum[bi, slot_m] = torch.where(
            m_r[:, None], st.tsum[bi, slot_m] + t_r, st.tsum[bi, slot_m])
        st.tcnt[bi, slot_m] = torch.where(
            m_r, st.tcnt[bi, slot_m] + 1.0, st.tcnt[bi, slot_m])
        # a new person (or a key merge) resets the tag history
        st.tsum[bi, slot_n] = torch.where(n_r[:, None], t_r,
                                          st.tsum[bi, slot_n])
        st.tcnt[bi, slot_n] = torch.where(n_r, 1.0, st.tcnt[bi, slot_n])
        alloc = n_r & ~has_hit
        st.keys[bi, slot_n] = torch.where(alloc, key, st.keys[bi, slot_n])
        st.npv = torch.where(alloc, (st.npv + 1).clamp(max=p_max), st.npv)


def _greedy(cost, diff, active, p_cur, tag_thr):
    """Each row in order takes the cheapest unused real column (smallest
    on ties) and matches when that cost is below BIG and the unrounded
    distance below the tag threshold (``pallas_group.py:237-262``)."""
    b, k, m2 = cost.shape
    m = diff.shape[2]
    dev = cost.device
    bi = torch.arange(b, device=dev)
    c_idx = torch.arange(m2, device=dev)[None, :]
    used = torch.zeros((b, m2), dtype=torch.bool, device=dev)
    cols, matched = [], []
    for r in range(k):
        cand = (c_idx < p_cur[:, None]) & ~used
        masked = torch.where(cand, cost[:, r], _INF)
        c_at = torch.argmin(masked, dim=1)
        cmin = masked[bi, c_at]
        d_at = diff[bi, r, c_at.clamp(max=m - 1)]
        m_r = active[:, r] & (cmin < BIG) & (d_at < tag_thr)
        used = used | (m_r[:, None] & (c_idx == c_at[:, None]))
        cols.append(torch.where(m_r, c_at, m2))
        matched.append(m_r)
    return torch.stack(cols, dim=1), torch.stack(matched, dim=1)


def match_by_tag_kernel_plain(tag_k: torch.Tensor, loc_k: torch.Tensor,
                              val_k: torch.Tensor, max_num_people: int = 30,
                              detection_threshold: float = 0.1,
                              tag_threshold: float = 1.0,
                              use_detection_val: bool = True,
                              ignore_too_much: bool = False,
                              p_max: int = 90,
                              solver: str = "lap") -> Result:
    """Plain version of the kernel (see the module docstring)."""
    _check(tag_k, loc_k, val_k, max_num_people, p_max, solver)
    b, j, k, d = tag_k.shape
    m = max_num_people
    dev = tag_k.device
    f32 = torch.float32
    tag = tag_k.to(f32)
    val = val_k.to(f32)
    rowvec = torch.cat([loc_k.to(f32), val[..., None], tag], dim=-1)
    tag_thr = torch.tensor(tag_threshold, dtype=f32, device=dev)
    det_valid_all = val > torch.tensor(detection_threshold, dtype=f32,
                                       device=dev)
    tie = tie_bias(k, m, dev)
    rows1 = torch.arange(1, k + 1, device=dev)[None, :]
    failed = torch.zeros(b, dtype=torch.bool, device=dev)
    st = PeopleState(b, j, d, p_max, max(p_max, m), dev)
    for jj in range(j):
        p_cur = st.npv.clamp(max=m)
        skip_all = (p_cur == m) & ignore_too_much
        det_valid = det_valid_all[:, jj]
        cost, diff = joint_cost(st.means(m), tag[:, jj], val[:, jj],
                                det_valid, p_cur, tie, use_detection_val)
        active = det_valid & ~skip_all[:, None]
        if solver == "greedy":
            cols, matched = _greedy(cost, diff, active, p_cur, tag_thr)
        else:
            # rows up to the last valid detection; none when there is no
            # one to match or the joint is skipped
            n_valid = torch.where(det_valid, rows1, 0).amax(dim=1)
            n_rows = torch.where((p_cur == 0) | skip_all, 0, n_valid)
            p = lap_columns(cost, n_rows)
            failed = failed | (p[:, 0] < 0)
            cols = rows_to_columns(p, k)
            d_at = diff.gather(2, cols.clamp(0, m - 1)[..., None])[..., 0]
            matched = active & (cols < p_cur[:, None]) & (d_at < tag_thr)
        update_rows(st, jj, rowvec[:, jj], tag[:, jj], cols, matched,
                    active & ~matched)
    return st.people, torch.where(failed, -1, st.npv).to(torch.int32)


def _kernel_cuda(tag_k, loc_k, val_k, max_num_people, detection_threshold,
                 tag_threshold, use_detection_val, ignore_too_much, p_max,
                 solver) -> Result:
    _check(tag_k, loc_k, val_k, max_num_people, p_max, solver)
    b, j, k, d = tag_k.shape
    if d > _KERNEL_DMAX:
        raise ValueError(f"group_mega kernel takes D <= {_KERNEL_DMAX}")
    tag = tag_k.to(torch.float32).contiguous()
    loc = loc_k.to(torch.float32).contiguous()
    val = val_k.to(torch.float32).contiguous()
    people = torch.empty((b, p_max, j, 3 + d), dtype=torch.float32,
                         device=tag.device)
    n = torch.empty(b, dtype=torch.int32, device=tag.device)
    if b == 0:
        return people, n
    lib = _build.load("group_mega", _SIGS)
    stream = torch.cuda.current_stream(tag.device).cuda_stream
    err = lib.group_mega_launch(
        tag.data_ptr(), loc.data_ptr(), val.data_ptr(), b, j, k, d,
        max_num_people, p_max, detection_threshold, tag_threshold,
        int(use_detection_val), int(ignore_too_much), int(solver == "greedy"),
        people.data_ptr(), n.data_ptr(), stream)
    _build.check(err, "group_mega")
    match_by_tag_kernel.launches += 1
    if _observe.active:
        _observe.launched("group_mega", (tag, loc, val), (people,))
    return people, n


def match_by_tag_kernel(tag_k: torch.Tensor, loc_k: torch.Tensor,
                        val_k: torch.Tensor, max_num_people: int = 30,
                        detection_threshold: float = 0.1,
                        tag_threshold: float = 1.0,
                        use_detection_val: bool = True,
                        ignore_too_much: bool = False,
                        p_max: int = 90, solver: str = "lap") -> Result:
    """Batched grouping as one launch (plain on CPU, the kernel on CUDA).

    :param solver: ``"lap"`` (exact) or ``"greedy"``.
    :returns: (people (B, p_max, J, 3+D) f32, n_people (B,) i32; -1 for
      an image whose exact solve met costs that are not finite).
    """
    args = (tag_k, loc_k, val_k, max_num_people, detection_threshold,
            tag_threshold, use_detection_val, ignore_too_much, p_max, solver)
    if tag_k.device.type == "cpu":
        return match_by_tag_kernel_plain(*args)
    if tag_k.device.type != "cuda":
        raise ValueError(f"match_by_tag_kernel: unsupported device "
                         f"{tag_k.device}")
    return _kernel_cuda(*args)


match_by_tag_kernel.launches = 0
