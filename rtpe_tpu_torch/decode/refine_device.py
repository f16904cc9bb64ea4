"""Batched quarter-pixel adjust + tag-guided refine on the device.

Port of ``rtpe_tpu/decode/refine_device.py`` (``adjust_refine_device``,
``adjust_refine_batch`` with its slot cap, ``refine_batch_device``,
``_refine_people_vectorized`` and its per-person form).  Plain PyTorch: the
JAX package runs this in XLA, not Pallas.  The refine's
(people, J, H*W) score is built a few people at a time so that its
temporary stays small at full resolution.
"""

from typing import Tuple

import torch

_REFINE_CHUNK = 8  # people per refine score block


def _adjust_people(det: torch.Tensor, people: torch.Tensor) -> torch.Tensor:
    """(B, P, J, 3+D) people adjusted against (B, H, W, J) heatmaps
    (reference ``group.py:181-200``)."""
    b, h, w, j = det.shape
    xs, ys = people[..., 0], people[..., 1]
    vis = people[..., 2] > 0
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    bb = torch.arange(b, device=det.device)[:, None, None]
    jj = torch.arange(j, device=det.device)[None, None, :]

    def read(yy, xx):
        return det[bb, yy.clamp(0, h - 1), xx.clamp(0, w - 1), jj]

    right = read(yi, (xi + 1).clamp(max=w - 1))
    left = read(yi, (xi - 1).clamp(min=0))
    down = read((yi + 1).clamp(max=h - 1), xi)
    up = read((yi - 1).clamp(min=0), xi)
    new_x = torch.where(right > left, xs + 0.25, xs - 0.25) + 0.5
    new_y = torch.where(down > up, ys + 0.25, ys - 0.25) + 0.5
    out = people.clone()
    out[..., 0] = torch.where(vis, new_x, xs)
    out[..., 1] = torch.where(vis, new_y, ys)
    return out


def _refine_people_vectorized(det: torch.Tensor, tag: torch.Tensor,
                              people: torch.Tensor) -> torch.Tensor:
    """Tag-guided refine of all people slots of ONE image.

    :param det: (H, W, J); tag: (H, W, J, D); people: (P, J, 3+D).
    For each (person, joint) the argmax over the plane of
    ``det - round(||tag - mean tag of the person's visible joints||)``
    (first occurrence) fills a missing joint whose value there is > 0.
    """
    h, w, j = det.shape
    d = tag.shape[-1]
    p_slots = people.shape[0]
    dev = det.device
    vis = people[:, :, 2] > 0                                # (P, J)
    n_vis = vis.sum(dim=1)                                   # (P,)
    xi = people[:, :, 0].to(torch.int64).clamp(0, w - 1)
    yi = people[:, :, 1].to(torch.int64).clamp(0, h - 1)
    jj = torch.arange(j, device=dev)
    joint_tags = tag[yi, xi, jj[None, :]]                    # (P, J, D)
    prev_tag = (torch.where(vis[..., None], joint_tags, 0.0).sum(dim=1)
                / n_vis.clamp(min=1)[:, None].to(torch.float32))

    tag_pj = tag.permute(2, 0, 1, 3).reshape(j, h * w, d)    # (J, HW, D)
    det_pj = det.permute(2, 0, 1).reshape(j, h * w)          # (J, HW)
    idx = torch.empty((p_slots, j), dtype=torch.int64, device=dev)
    for p0 in range(0, p_slots, _REFINE_CHUNK):
        prev = prev_tag[p0:p0 + _REFINE_CHUNK]               # (c, D)
        diff = tag_pj[None] - prev[:, None, None, :]         # (c, J, HW, D)
        tt = torch.sqrt((diff * diff).sum(dim=-1))
        score = det_pj[None] - torch.round(tt)               # (c, J, HW)
        idx[p0:p0 + _REFINE_CHUNK] = torch.argmax(score, dim=-1)
    ry = idx // w
    rx = idx % w
    jj2 = jj[None, :].expand(p_slots, j)
    val = det[ry, rx, jj2]
    right = det[ry, (rx + 1).clamp(max=w - 1), jj2]
    left = det[ry, (rx - 1).clamp(min=0), jj2]
    down = det[(ry + 1).clamp(max=h - 1), rx, jj2]
    up = det[(ry - 1).clamp(min=0), rx, jj2]
    fx = rx + 0.5 + torch.where(right > left, 0.25, -0.25)
    fy = ry + 0.5 + torch.where(down > up, 0.25, -0.25)

    fill = (val > 0) & (people[:, :, 2] == 0) & (n_vis[:, None] > 0)
    out = people.clone()
    out[:, :, 0] = torch.where(fill, fx.float(), people[:, :, 0])
    out[:, :, 1] = torch.where(fill, fy.float(), people[:, :, 1])
    out[:, :, 2] = torch.where(fill, val, people[:, :, 2])
    return out


def adjust_refine_device(det: torch.Tensor, tag: torch.Tensor,
                         people: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjust + scores + refine of one image (the device finish of
    ``HeatmapParser.parse``).

    :param det: (H, W, J); tag: (H, W, J, D); people: (P, J, 3+D),
      zero rows for padding (a person with no visible joint is inert).
    :returns: (people (P, J, 3+D), scores (P,)) — scores after the
      adjust and before the refine, as the reference does.
    """
    det = det.float()
    people = _adjust_people(det[None], people.float()[None])[0]
    scores = people[:, :, 2].mean(dim=1)
    return _refine_people_vectorized(det, tag.float(), people), scores


def _make_refine_person(det: torch.Tensor, tag: torch.Tensor):
    """Per-person refine over one image's (H, W, J) det and (H, W, J, D)
    tag (reference ``group.py:202-264``): the one-person form of
    :func:`_refine_people_vectorized`, with the same first-occurrence
    argmax and fill condition."""
    det = det.float()
    tag = tag.float()

    def refine_person(person: torch.Tensor) -> torch.Tensor:
        return _refine_people_vectorized(det, tag, person[None])[0]

    return refine_person


def refine_batch_device(det: torch.Tensor, tag: torch.Tensor,
                        people: torch.Tensor) -> torch.Tensor:
    """Refine of a whole batch (``HeatmapParser.parse_batch``).

    :param det: (B, H, W, J); tag: (B, H, W, J, D); people:
      (B, P, J, 3+D) grouped, already adjusted, zero-padded along P.
    :returns: refined people, same shape.
    """
    det = det.float()
    tag = tag.float()
    return torch.stack([_refine_people_vectorized(det[i], tag[i],
                                                  people[i].float())
                        for i in range(det.shape[0])])


def adjust_refine_batch(det: torch.Tensor, tag: torch.Tensor,
                        people: torch.Tensor, n_people: torch.Tensor,
                        cap: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched adjust + scores + slot-capped refine.

    Grouping fills people slots from 0 in order, so when every image's
    ``n_people`` fits ``cap`` only ``people[:, :cap]`` is refined (one
    host read of ``max(n_people)`` picks the branch, where the JAX
    version uses a ``lax.cond``); ``cap=0`` refines every slot.

    :param det: (B, H, W, J); tag: (B, H, W, J, D);
      people: (B, P, J, 3+D); n_people: (B,).
    :returns: (people (B, P, J, 3+D), scores (B, P)) — scores are taken
      after the adjust and before the refine, as the reference does.
    """
    det = det.float()
    tag = tag.float()
    people = _adjust_people(det, people.float())
    scores = people[..., 2].mean(dim=2)
    p_slots = people.shape[1]
    n_ref = p_slots
    if 0 < cap < p_slots and int(n_people.max()) <= cap:
        n_ref = cap
    refined = torch.stack([
        _refine_people_vectorized(det[i], tag[i], people[i, :n_ref])
        for i in range(det.shape[0])])
    return torch.cat([refined, people[:, n_ref:]], dim=1), scores
