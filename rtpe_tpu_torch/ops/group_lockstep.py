"""Lockstep greedy grouping: the CUDA kernel ``csrc/group_lockstep.cu``
and its plain PyTorch version.

Replaces ``rtpe_tpu/ops/pallas_group_lockstep.py:match_by_tag_lockstep``
(the Pallas kernel ``_lockstep_kernel`` plus the people-table rebuild
after it): greedy associative-embedding grouping, one step per joint,
for every image of the batch.  Same contract: ``tag_k`` (B, J, K, D),
``loc_k`` (B, J, K, 2), ``val_k`` (B, J, K) -> people
(B, p_max, J, 3 + D) float32 and n_people (B,) int32.

The plain version keeps the JAX kernel's arithmetic step for step
(float32 throughout, round half to even, the same tie bias and
sentinels), so the kernel can be held to it exactly.
:func:`match_by_tag_lockstep` runs the plain version for CPU tensors
and the kernel for CUDA tensors; ``match_by_tag_lockstep.launches``
counts kernel launches.
"""

import ctypes
from typing import Tuple

import torch

from . import _build, _observe

SLOTS = 128       # people slots of the state (the TPU kernel's lanes)
MAX_ROWS = 32     # detection rows per joint
MAX_PEOPLE = 96   # p_max envelope
COST_CLAMP = 1000.0
BIG = 2048.0
HUGE = 4096.0
_MASKED = 1e18
_KERNEL_DMAX = 8

_SIGS = {
    "group_lockstep_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
}

Result = Tuple[torch.Tensor, torch.Tensor]


def _check_shapes(tag_k, loc_k, val_k, max_num_people, p_max):
    b, j, k, d = tag_k.shape
    if tuple(loc_k.shape) != (b, j, k, 2) or tuple(val_k.shape) != (b, j, k):
        raise ValueError(f"shapes tag {tuple(tag_k.shape)}, loc "
                         f"{tuple(loc_k.shape)}, val {tuple(val_k.shape)} "
                         "do not agree")
    if not (k <= MAX_ROWS and 2 * max_num_people + 1 <= SLOTS
            and p_max <= MAX_PEOPLE and k <= max_num_people):
        raise ValueError(f"K={k}, max_num_people={max_num_people}, "
                         f"p_max={p_max} outside the grouping envelope")


def match_by_tag_lockstep_plain(tag_k: torch.Tensor, loc_k: torch.Tensor,
                                val_k: torch.Tensor,
                                max_num_people: int = 30,
                                detection_threshold: float = 0.1,
                                tag_threshold: float = 1.0,
                                use_detection_val: bool = True,
                                ignore_too_much: bool = False,
                                p_max: int = 90) -> Result:
    """Plain version of the kernel (see the module docstring)."""
    _check_shapes(tag_k, loc_k, val_k, max_num_people, p_max)
    b, j, k, d = tag_k.shape
    m = max_num_people
    dev = tag_k.device
    f32 = torch.float32
    tag = tag_k.to(f32)
    val = val_k.to(f32)
    rowvec = torch.cat([loc_k.to(f32), val[..., None], tag], dim=-1)

    s_idx = torch.arange(SLOTS, device=dev)
    s_f = s_idx.to(f32)
    det_thr = torch.tensor(detection_threshold, dtype=f32, device=dev)
    tag_thr = torch.tensor(tag_threshold, dtype=f32, device=dev)
    clamp = torch.tensor(COST_CLAMP, dtype=f32, device=dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    ties = [torch.tensor((2 * m - r) * 1e-8, dtype=f32, device=dev) * s_f
            for r in range(k)]

    keys = torch.full((b, SLOTS), float("inf"), dtype=f32, device=dev)
    tsum = torch.zeros((d, b, SLOTS), dtype=f32, device=dev)
    tcnt = torch.zeros((b, SLOTS), dtype=f32, device=dev)
    npv = torch.zeros(b, dtype=torch.int64, device=dev)
    people = torch.zeros((b, p_max, j, 3 + d), dtype=f32, device=dev)

    for jj in range(j):
        p_cur = npv.clamp(max=m)
        skip_all = (p_cur == m) & ignore_too_much
        mean = tsum / torch.maximum(tcnt, one)
        cand_base = s_idx[None, :] < p_cur[:, None]
        used = torch.zeros((b, SLOTS), dtype=torch.bool, device=dev)

        # ---- loop 1: greedy decisions against the frozen means
        decisions = []
        for r in range(k):
            val_r = val[:, jj, r]
            active = (val_r > det_thr) & ~skip_all
            diff_sq = torch.zeros((b, SLOTS), dtype=f32, device=dev)
            for dd in range(d):
                dlt = tag[:, jj, r, dd, None] - mean[dd]
                diff_sq = diff_sq + dlt * dlt
            diff = torch.sqrt(diff_sq)
            if use_detection_val:
                cost = torch.round(diff) * 100.0 - val_r[:, None]
            else:
                cost = diff
            cost = torch.minimum(cost, clamp)
            crow = torch.where(active[:, None], cost + ties[r], HUGE)
            masked = torch.where(cand_base & ~used, crow, _MASKED)
            s_at = torch.argmin(masked, dim=1)
            cmin = masked.gather(1, s_at[:, None])[:, 0]
            d_at = diff.gather(1, s_at[:, None])[:, 0]
            matched = active & (cmin < BIG) & (d_at < tag_thr)
            used = used | (matched[:, None] & (s_idx[None, :] == s_at[:, None]))
            decisions.append((s_at, matched, active))

        # ---- loop 2: state update with evolving keys / npv
        win = torch.full((b, SLOTS), -1, dtype=torch.int64, device=dev)
        for r, (col, matched, active) in enumerate(decisions):
            is_new = active & ~matched
            tag_r = tag[:, jj, r]                               # (B, D)
            key_r = tag_r[:, 0]
            slot_m = col.clamp(0, p_max - 1)
            key_hit = (keys == key_r[:, None]) & (s_idx[None, :] < npv[:, None])
            has_hit = key_hit.any(dim=1)
            hit_slot = torch.where(key_hit, s_idx[None, :], SLOTS).amin(dim=1)
            slot_n = torch.where(has_hit, hit_slot, npv.clamp(max=p_max - 1))
            slot_r = torch.where(matched, slot_m, slot_n)
            write = matched | is_new
            win = torch.where(write[:, None] & (s_idx[None, :] == slot_r[:, None]),
                              r, win)
            sel_m = matched[:, None] & (s_idx[None, :] == slot_m[:, None])
            sel_n = is_new[:, None] & (s_idx[None, :] == slot_n[:, None])
            for dd in range(d):
                t = tag_r[:, dd, None]
                tsum[dd] = torch.where(sel_m, tsum[dd] + t,
                                       torch.where(sel_n, t, tsum[dd]))
            tcnt = torch.where(sel_m, tcnt + 1.0,
                               torch.where(sel_n, one, tcnt))
            alloc = is_new & ~has_hit
            keys = torch.where(alloc[:, None]
                               & (s_idx[None, :] == slot_n[:, None]),
                               key_r[:, None], keys)
            npv = torch.where(alloc, (npv + 1).clamp(max=p_max), npv)

        # ---- people rows of this joint: last writer per slot
        w = win[:, :p_max]
        rows = rowvec[:, jj].gather(
            1, w.clamp(min=0)[..., None].expand(-1, -1, 3 + d))
        people[:, :, jj] = torch.where((w >= 0)[..., None], rows, 0.0)
    return people, npv.to(torch.int32)


def _lockstep_cuda(tag_k, loc_k, val_k, max_num_people, detection_threshold,
                   tag_threshold, use_detection_val, ignore_too_much,
                   p_max) -> Result:
    _check_shapes(tag_k, loc_k, val_k, max_num_people, p_max)
    b, j, k, d = tag_k.shape
    if d > _KERNEL_DMAX:
        raise ValueError(f"group_lockstep kernel takes D <= {_KERNEL_DMAX}")
    tag = tag_k.to(torch.float32).contiguous()
    loc = loc_k.to(torch.float32).contiguous()
    val = val_k.to(torch.float32).contiguous()
    people = torch.empty((b, p_max, j, 3 + d), dtype=torch.float32,
                         device=tag.device)
    n = torch.empty(b, dtype=torch.int32, device=tag.device)
    if b == 0:
        return people, n
    lib = _build.load("group_lockstep", _SIGS)
    stream = torch.cuda.current_stream(tag.device).cuda_stream
    err = lib.group_lockstep_launch(
        tag.data_ptr(), loc.data_ptr(), val.data_ptr(), b, j, k, d,
        max_num_people, p_max, detection_threshold, tag_threshold,
        int(use_detection_val), int(ignore_too_much), people.data_ptr(),
        n.data_ptr(), stream)
    _build.check(err, "group_lockstep")
    match_by_tag_lockstep.launches += 1
    if _observe.active:
        _observe.launched("group_lockstep", (tag, loc, val), (people,))
    return people, n


def match_by_tag_lockstep(tag_k: torch.Tensor, loc_k: torch.Tensor,
                          val_k: torch.Tensor, max_num_people: int = 30,
                          detection_threshold: float = 0.1,
                          tag_threshold: float = 1.0,
                          use_detection_val: bool = True,
                          ignore_too_much: bool = False,
                          p_max: int = 90) -> Result:
    """Batched greedy grouping (plain on CPU, the kernel on CUDA)."""
    args = (tag_k, loc_k, val_k, max_num_people, detection_threshold,
            tag_threshold, use_detection_val, ignore_too_much, p_max)
    if tag_k.device.type == "cpu":
        return match_by_tag_lockstep_plain(*args)
    if tag_k.device.type != "cuda":
        raise ValueError(f"match_by_tag_lockstep: unsupported device "
                         f"{tag_k.device}")
    return _lockstep_cuda(*args)


match_by_tag_lockstep.launches = 0
