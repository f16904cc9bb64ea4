"""Student evaluation loop (port of ``rtpe_tpu/eval/engine.py``;
reference ``rtpe/engine.py:21-75``).

For each image: forward the model at native size, split the heatmap and
AE channels, decode with the HeatmapParser, optionally save skeleton
pictures (cv2, imported only then), and finally compute COCO keypoint
AP over the dataset's ids.
"""

import os
from typing import Callable, Optional

import torch

from ..device import DeviceLike, resolve_device


def eval_student(apply_fn: Callable, hm_parser, dataset,
                 num_heatmaps: int = 17,
                 save_every: Optional[int] = None,
                 save_dir: str = "/tmp",
                 logger=None, device: DeviceLike = "cuda"):
    """:param apply_fn: ``f(img_nhwc, out_hw) -> (B, h, w, C)`` heatmap+AE
      prediction, closed over the model: ``img_nhwc`` is the [0, 1] RGB
      image as a (1, H, W, 3) float32 tensor on ``device``.
    :param hm_parser: :class:`rtpe_tpu_torch.decode.HeatmapParser`.
    :param dataset: :class:`rtpe_tpu_torch.data.CocoDistillationDataset`.
    :returns: COCO stats dict (name -> value).
    """
    dev = resolve_device(device)
    all_preds = []
    all_scores = []
    for batch_i in range(len(dataset)):
        sample = dataset[batch_i]
        img = sample["img"]
        out_hw = img.shape[:2]
        with torch.no_grad():
            pred = apply_fn(torch.from_numpy(img[None]).to(dev), out_hw)
        # sliced on the device: the native-resolution map is not pulled
        # to the host, only the decode's top-k is
        pred = pred.float()
        grouped, scores = hm_parser.parse_batch(
            pred[..., :num_heatmaps], pred[..., num_heatmaps:],
            adjust=True, refine=True)
        final_results = [x for x in grouped[0] if x.size > 0]
        all_preds.append(final_results)
        all_scores.append(scores[0])
        if logger is not None:
            logger.info(f"eval: {batch_i} ({len(final_results)} people)")
        if save_every is not None and batch_i % save_every == 0:
            from ..obs.vis import save_valid_image
            save_valid_image(
                img, final_results,
                os.path.join(save_dir, f"student_minival_{batch_i}.jpg"))

    stats = dataset.evaluate(all_preds, all_scores)
    if logger is not None:
        logger.info("\n".join(f"{k}={v}" for k, v in stats.items()))
    return stats
