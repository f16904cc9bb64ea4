"""COCO keypoint evaluation (OKS AP/AR), implemented from the protocol.

Port of ``rtpe_tpu/eval/cocoeval.py``, float64 numpy, the same
operations in the same order, so that the ten stats are equal to the
JAX package's, not merely close.  pycocotools is not installed (the
reference relies on its C extension,
``rtpe/third_party/COCODataset.py:292-306``), so the official keypoint
metric is implemented from the published COCO evaluation protocol:

* OKS between a detection and a ground truth:
  ``mean_i exp(-d_i^2 / (2 * area * k_i^2))`` over labeled keypoints,
  with the per-keypoint constants ``k_i = 2*sigma_i``; for ground truths
  without labeled keypoints, distances are measured to the x2-expanded
  bbox.
* greedy score-ordered matching per OKS threshold (crowd/ignore ground
  truths can absorb detections but never count as misses)
* 101-point interpolated precision, averaged over OKS thresholds
  .50:.05:.95 and area ranges all / medium (32^2-96^2) / large
  (96^2-1e5^2), maxDets=20

Output is the 10-value stats vector with the same names and order the
reference prints (``COCODataset.py:299-303``).
"""

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KPT_OKS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0

STATS_NAMES = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
               "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]

_AREA_RNGS = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def compute_oks(dts: List[dict], gts: List[dict],
                sigmas: np.ndarray = KPT_OKS_SIGMAS) -> np.ndarray:
    """(len(dts), len(gts)) OKS matrix; dts must be score-sorted."""
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))
    vars_ = (sigmas * 2.0) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], dtype=np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = ((dx ** 2 + dy ** 2) / vars_
                 / (gt.get("area", 1.0) + np.spacing(1)) / 2.0)
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


def _match_image(dts: List[dict], gts: List[dict], ious: np.ndarray,
                 iou_thrs: np.ndarray, area_rng: Tuple[float, float]):
    """Greedy matching for one image and one area range.

    :returns: (dt_matches, dt_ignore, dt_scores, num_gt) where the first
      two are (T, D) arrays.
    """
    t_n = len(iou_thrs)
    # ground-truth ignore: base flag or out of area range
    gt_ig = np.array([
        1 if (g["_ignore"] or g.get("area", 0) < area_rng[0]
              or g.get("area", 0) > area_rng[1]) else 0
        for g in gts])
    # sort gts: non-ignored first (stable)
    gt_order = np.argsort(gt_ig, kind="mergesort")
    gts_s = [gts[i] for i in gt_order]
    gt_ig = gt_ig[gt_order]
    ious_s = ious[:, gt_order] if ious.size else ious

    d_n = len(dts)
    g_n = len(gts_s)
    dtm = np.zeros((t_n, d_n), dtype=np.int64) - 1
    gtm = np.zeros((t_n, g_n), dtype=np.int64) - 1
    dt_ig = np.zeros((t_n, d_n), dtype=bool)

    for ti, t in enumerate(iou_thrs):
        for di in range(d_n):
            iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(g_n):
                if gtm[ti, gi] >= 0 and not gts_s[gi].get("iscrowd", 0):
                    continue  # gt already claimed (crowds can re-match)
                if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                    break  # matched a real gt; rest are ignores
                if ious_s[di, gi] < iou:
                    continue
                iou = ious_s[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[ti, di] = bool(gt_ig[m])
            dtm[ti, di] = m
            gtm[ti, m] = di

    # unmatched detections outside the area range are ignored
    def _area(d):
        a = d.get("area")
        return _dt_area(d) if a is None else a
    a = np.array([not (area_rng[0] <= _area(d) <= area_rng[1])
                  for d in dts]) if d_n else np.zeros(0, bool)
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == -1, a[None, :]))
    scores = np.array([d["score"] for d in dts])
    return dtm >= 0, dt_ig, scores, int(np.count_nonzero(gt_ig == 0))


def _dt_area(d):
    kp = np.asarray(d["keypoints"], dtype=np.float64)
    x, y = kp[0::3], kp[1::3]
    return float((x.max() - x.min()) * (y.max() - y.min()))


class KeypointEvaluator:
    """Evaluate person-keypoint detections against a
    :class:`rtpe_tpu_torch.data.coco.CocoAnnotations` index."""

    def __init__(self, coco, img_ids: Optional[Sequence[int]] = None,
                 iou_thrs: Optional[np.ndarray] = None, max_dets: int = 20,
                 sigmas: np.ndarray = KPT_OKS_SIGMAS):
        self.coco = coco
        self.img_ids = list(img_ids) if img_ids is not None else coco.ids
        self.iou_thrs = (np.linspace(0.5, 0.95, 10) if iou_thrs is None
                         else np.asarray(iou_thrs))
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = max_dets
        self.sigmas = np.asarray(sigmas)

    def _gts_for(self, img_id: int) -> List[dict]:
        gts = []
        for aid in self.coco.get_ann_ids(img_id):
            a = dict(self.coco.anns[aid])
            if a.get("category_id") != self.coco.person_cat_id:
                continue
            a["_ignore"] = int(bool(a.get("iscrowd", 0))
                               or a.get("num_keypoints", 0) == 0)
            gts.append(a)
        return gts

    def evaluate(self, detections: List[dict]) -> Dict[str, float]:
        """:param detections: list of ``{"image_id", "keypoints"(51 flat),
          "score"}`` dicts, COCO results format.
        :returns: ordered dict of the 10 stats (name -> value)."""
        by_img = defaultdict(list)
        for d in detections:
            by_img[d["image_id"]].append(d)

        per_area = {name: [] for name in _AREA_RNGS}
        for img_id in self.img_ids:
            gts = self._gts_for(img_id)
            dts = sorted(by_img.get(img_id, []),
                         key=lambda d: -d["score"])[: self.max_dets]
            if not gts and not dts:
                continue
            ious = compute_oks(dts, gts, self.sigmas)
            for name, rng in _AREA_RNGS.items():
                per_area[name].append(
                    _match_image(dts, gts, ious, self.iou_thrs, rng))

        results = {}
        pr_by_area = {}
        for name in _AREA_RNGS:
            pr_by_area[name] = self._accumulate(per_area[name])

        t50 = int(np.argmin(np.abs(self.iou_thrs - 0.5)))
        t75 = int(np.argmin(np.abs(self.iou_thrs - 0.75)))

        def ap(name, ti=None):
            prec = pr_by_area[name]["precision"]  # (T, R)
            sel = prec if ti is None else prec[ti:ti + 1]
            valid = sel[sel > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        def ar(name, ti=None):
            rec = pr_by_area[name]["recall"]  # (T,)
            sel = rec if ti is None else rec[ti:ti + 1]
            valid = sel[sel > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        results["AP"] = ap("all")
        results["Ap .5"] = ap("all", t50)
        results["AP .75"] = ap("all", t75)
        results["AP (M)"] = ap("medium")
        results["AP (L)"] = ap("large")
        results["AR"] = ar("all")
        results["AR .5"] = ar("all", t50)
        results["AR .75"] = ar("all", t75)
        results["AR (M)"] = ar("medium")
        results["AR (L)"] = ar("large")
        return results

    def _accumulate(self, img_results) -> Dict[str, np.ndarray]:
        t_n = len(self.iou_thrs)
        r_n = len(self.rec_thrs)
        precision = -np.ones((t_n, r_n))
        recall = -np.ones(t_n)
        if not img_results:
            return {"precision": precision, "recall": recall}

        dtm = np.concatenate([r[0] for r in img_results], axis=1)
        dt_ig = np.concatenate([r[1] for r in img_results], axis=1)
        scores = np.concatenate([r[2] for r in img_results])
        npig = sum(r[3] for r in img_results)
        if npig == 0:
            return {"precision": precision, "recall": recall}

        order = np.argsort(-scores, kind="mergesort")
        dtm = dtm[:, order]
        dt_ig = dt_ig[:, order]

        tps = np.logical_and(dtm, ~dt_ig)
        fps = np.logical_and(~dtm, ~dt_ig)
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

        for ti in range(t_n):
            tp = tp_sum[ti]
            fp = fp_sum[ti]
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.spacing(1))
            recall[ti] = rc[-1] if nd else 0.0
            # precision envelope
            q = np.zeros(r_n)
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, self.rec_thrs, side="left")
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[ti] = q
        return {"precision": precision, "recall": recall}
