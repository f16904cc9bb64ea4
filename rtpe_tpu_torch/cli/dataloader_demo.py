"""Data-pipeline demo and decode-stack AP check.

    python -m rtpe_tpu_torch.cli.dataloader_demo --coco_dir <root> \\
        [--teacher_dir <npz corpus>] [--device cpu]

Port of ``scripts/dataloader_demo.py`` with the same flags, plus
``--device``: (1) run the training pipeline (batches of 4, 450 x 450,
sigma 7) and save an overview picture of each batch's first sample
(image, heatmaps, segmentation; cv2, imported only then), and (2) run
the precomputed teacher outputs through the decoder and score COCO AP
on a minival split, which measures the decode and grouping stack apart
from any model (reference ``dataloader_demo.py:90-121``).  The stats
are printed last, as the JAX script prints them.
"""

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.coco import read_whitelist
from ..data.dataset import CocoDistillationDataset
from ..data.pipeline import TrainPipeline
from ..decode import HeatmapParser
from ..device import resolve_device
from ..utils import ColorLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dataloader_demo")
    home = os.path.expanduser("~")
    p.add_argument("--coco_dir", default=os.path.join(home, "datasets",
                                                      "coco"))
    p.add_argument("--dataset", default="val2017")
    p.add_argument("--teacher_dir", default=None)
    p.add_argument("--minival_file", default=None)
    p.add_argument("--num_demo_batches", type=int, default=2)
    p.add_argument("--max_eval_images", type=int, default=100)
    p.add_argument("--save_dir", default="/tmp")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def demo_batches(ds, args: argparse.Namespace, log) -> int:
    """Part 1: save an overview of the first ``--num_demo_batches``
    batches; returns the number of batches drawn."""
    pipeline = TrainPipeline(ds, batch_size=4, out_hw=(450, 450), sigma=7.0,
                             device=args.device)
    n = 0
    for bi, batch in enumerate(pipeline if args.num_demo_batches else []):
        if bi >= args.num_demo_batches:
            break
        import cv2
        img = batch["img"][0].cpu().numpy()
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        hms = batch["gt_hms"][0].amax(dim=-1).cpu().numpy()
        seg = batch["segm_mask"][0, :, :, 0].cpu().numpy()
        panel = np.concatenate([
            (img * 255).astype(np.uint8),
            cv2.applyColorMap((hms * 255).astype(np.uint8),
                              cv2.COLORMAP_JET),
            cv2.cvtColor((seg * 255).astype(np.uint8),
                         cv2.COLOR_GRAY2BGR),
        ], axis=1)
        out = os.path.join(args.save_dir, f"dataloader_demo_{bi}.jpg")
        cv2.imwrite(out, panel)
        log.info(f"saved augmentation overview to {out}")
        n += 1
    return n


def decode_teacher(val_ds, args: argparse.Namespace, log) -> dict:
    """Part 2: the teacher's maps -> decoder -> COCO AP."""
    dev = resolve_device(args.device)
    hm_parser = HeatmapParser(num_joints=17, max_num_people=30,
                              detection_threshold=0.1, tag_threshold=1.0,
                              use_detection_val=True,
                              ignore_too_much=False, tag_per_joint=True)
    n = min(len(val_ds), args.max_eval_images)
    all_preds, all_scores = [], []
    for i in range(n):
        s = val_ds[i]
        hms = torch.from_numpy(s["teacher_hms"][None]).to(dev)
        aes = torch.from_numpy(s["teacher_ae"][None]).to(dev)
        grouped, scores = hm_parser.parse(hms, aes, adjust=True,
                                          refine=True)
        all_preds.append([x for x in grouped[0] if x.size > 0])
        all_scores.append(scores)
        log.info(f"decoded {i + 1}/{n}")
    val_ds.ids = val_ds.ids[:n]
    stats = val_ds.evaluate(all_preds, all_scores)
    for k, v in stats.items():
        log.info(f"{k}={v}")
    return stats


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    log = ColorLogger("dataloader_demo")
    whitelist = (read_whitelist(args.minival_file)
                 if args.minival_file else None)
    ds = CocoDistillationDataset(args.coco_dir, args.dataset,
                                 remove_images_without_annotations=True,
                                 gt_stddevs_pix=[7.0],
                                 host_gt_heatmaps=False)  # device-rendered
    demo_batches(ds, args, log)
    if args.teacher_dir is None:
        log.warning("no --teacher_dir given; skipping decode-AP part")
        return None
    val_ds = CocoDistillationDataset(
        args.coco_dir, args.dataset, args.teacher_dir,
        remove_images_without_annotations=False,
        whitelist_ids=whitelist, host_gt_heatmaps=False)
    stats = decode_teacher(val_ds, args, log)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
