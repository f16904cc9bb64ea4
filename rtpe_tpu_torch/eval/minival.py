"""In-training minival: batched attention BCE and detection AP (port of
``rtpe_tpu/eval/minival.py``).

* :func:`attention_minival` buckets the minival images by shape and
  evaluates whole batches per forward (the per-image losses are exact:
  the reduction is per image, so the result equals the bs=1 loop up to
  summation order);
* :func:`detection_minival` runs the full decode and OKS-AP evaluation
  (the reference's commented-out block, ``distillation.py:391-418``)
  for students that carry AE channels, with the engine contract of
  ``eval/engine.py`` (reference ``rtpe/engine.py:21-75``).

Both run under ``torch.no_grad()`` with the model in ``eval()`` on the
model's device, and give the model back in the mode it came in.  Each
chunk is uploaded once; the maps stay on the device through the resize
and the NMS + top-k (:meth:`~rtpe_tpu_torch.decode.HeatmapParser.
parse_batch`), and only the top-k crosses to the host.
"""

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.preprocess import normalize_image
from ..ops.resize import resize_bilinear


def _bucket_by_shape(dataset, max_images: Optional[int] = None):
    n = len(dataset) if max_images is None else min(len(dataset),
                                                    max_images)
    buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i in range(n):
        img_id = dataset.ids[i]
        im = dataset.coco.imgs[img_id]
        buckets[(im["height"], im["width"])].append(i)
    return buckets


@contextlib.contextmanager
def _evaluating(model: nn.Module):
    """``eval()`` and no gradient inside; the model's mode after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _chunks(dataset, buckets, batch_size: int, with_segm: bool, dev):
    """Per chunk of a bucket: ``(idxs, n, imgs, alts, segms)``, the
    chunk padded to ``batch_size`` by repeating its last image and
    uploaded once as NCHW float32 (``segms`` (B, H, W, 1) or None)."""
    for (h, w), idxs in sorted(buckets.items()):
        for c0 in range(0, len(idxs), batch_size):
            chunk = idxs[c0:c0 + batch_size]
            n = len(chunk)
            padded = chunk + [chunk[-1]] * (batch_size - n)
            imgs = np.zeros((batch_size, h, w, 3), np.float32)
            alts = np.zeros((batch_size, h, w, 3), np.float32)
            segms = np.zeros((batch_size, h, w, 1), np.float32)
            for k, i in enumerate(padded):
                s = dataset[i]
                imgs[k] = normalize_image(s["img"])
                alts[k] = s["img_alt"]
                if with_segm:
                    segms[k, :, :, 0] = s["segm_mask"]

            def up(a):
                return torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)

            yield (chunk, n, up(imgs), up(alts),
                   torch.from_numpy(segms).to(dev) if with_segm else None)


def attention_losses(model: nn.Module, dataset, pos_weight: float = 7.0,
                     batch_size: int = 8, max_images: Optional[int] = None):
    """Yield, per chunk of a shape bucket: the chunk's dataset indices,
    each image's attention BCE (numpy) and its attention map (n, h, w),
    float32 on the model's device.  Ragged tail chunks are padded by
    repetition and the padded rows dropped."""
    with _evaluating(model):
        buckets = _bucket_by_shape(dataset, max_images)
        for chunk, n, imgs, alts, segms in _chunks(dataset, buckets,
                                                   batch_size, True,
                                                   _device(model)):
            att, _ = model(imgs, alts)
            att = att.float().permute(0, 2, 3, 1)
            y = resize_bilinear(segms, tuple(att.shape[1:3]),
                                align_corners=False)
            # quirk preserved: the reference feeds the sigmoided map to
            # BCEWithLogits (eval_attention.py:160-162)
            loss = -(pos_weight * y * F.logsigmoid(att)
                     + (1.0 - y) * F.logsigmoid(-att))
            yield (chunk, loss.mean(dim=(1, 2, 3))[:n].cpu().numpy(),
                   att[:n, :, :, 0])


def attention_minival(model: nn.Module, dataset, pos_weight: float = 7.0,
                      batch_size: int = 8,
                      max_images: Optional[int] = None) -> float:
    """Mean per-image attention BCE over the minival set, batched by
    image shape (:func:`attention_losses`)."""
    losses = [float(v) for _, chunk_losses, _ in attention_losses(
        model, dataset, pos_weight, batch_size, max_images)
        for v in chunk_losses]
    return float(np.mean(losses)) if losses else float("nan")


def detection_minival(model: nn.Module, dataset, num_heatmaps: int = 17,
                      hm_parser=None, batch_size: int = 8,
                      max_images: Optional[int] = None,
                      logger=None) -> Dict[str, float]:
    """Decode + COCO-AP minival for an AE-carrying student.

    The student forwards at native size; the detection logits are
    upsampled to image resolution (align_corners=True, as the reference
    students do internally), decoded in one ``parse_batch`` a chunk, and
    scored by OKS AP over the minival ids.  Images are bucketed by
    (H, W), ragged tails padded by repetition and the padded rows
    dropped before the decode.
    """
    from ..decode import HeatmapParser

    n = len(dataset) if max_images is None else min(len(dataset),
                                                    max_images)
    all_preds: List = [None] * n
    all_scores: List = [None] * n
    with _evaluating(model):
        buckets = _bucket_by_shape(dataset, n)
        for chunk, nc, imgs, alts, _ in _chunks(dataset, buckets,
                                                batch_size, False,
                                                _device(model)):
            h, w = imgs.shape[2:]
            _, det = model(imgs, alts)
            det = resize_bilinear(det.permute(0, 2, 3, 1), (h, w),
                                  align_corners=True)
            det = det.float()[:nc]
            pred_hms = det[..., :num_heatmaps]
            pred_ae = det[..., num_heatmaps:]
            if hm_parser is None:
                # students carry one shared AE map (ae_dims=1); the
                # teacher carries one per joint
                hm_parser = HeatmapParser(
                    num_joints=num_heatmaps,
                    tag_per_joint=pred_ae.shape[-1] == num_heatmaps)
            grouped, scores = hm_parser.parse_batch(pred_hms, pred_ae)
            for k, i in enumerate(chunk):
                people = [p for p in grouped[k] if np.asarray(p).size > 0]
                all_preds[i] = people
                all_scores[i] = scores[k]
                if logger is not None:
                    logger.info(f"det minival {i}: {len(people)} people")
    # evaluate over exactly the images forwarded (AP over the full id
    # list with a prediction prefix would deflate silently)
    return dataset.evaluate(all_preds, all_scores,
                            img_ids=[dataset.ids[i] for i in range(n)])
