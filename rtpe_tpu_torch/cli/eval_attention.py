"""Evaluate a trained student's attention head on COCO val.

    python -m rtpe_tpu_torch.cli.eval_attention --coco_dir <root> \\
        --snapshot_dir <dir> --load_timestamp <ts> --load_epoch E \\
        --load_step S [--device cpu]

Port of ``scripts/eval_attention.py`` with the same flags, plus
``--device``: load an ``AttentionStudentSteps`` snapshot by timestamp,
epoch and step (the part files :mod:`~rtpe_tpu_torch.cli.distillation`
writes, or the JAX script's: the keys are the same), run the validation
set bucketed by image shape, compute each image's attention BCE
(pos_weight 7) against its human segmentation mask, log it, and save
the attention maps as pictures (cv2, imported only then; ``--save_every
0`` writes none).  The last log line is ``mean attention loss over N
images: L``.
"""

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from ..data.coco import read_whitelist
from ..data.dataset import CocoDistillationDataset
from ..device import resolve_device
from ..eval.minival import attention_losses
from ..io.checkpoint import load_student_parts
from ..models.factory import get_attention_student
from ..obs.tb import MetricWriter
from ..utils import ColorLogger, make_timestamp
from .distillation import load_stem


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval_attention")
    home = os.path.expanduser("~")
    p.add_argument("--coco_dir", default=os.path.join(home, "datasets",
                                                      "coco"))
    p.add_argument("--dataset", default="val2017")
    p.add_argument("--snapshot_dir", default=os.path.join("models",
                                                          "snapshots"))
    p.add_argument("--load_timestamp", required=True)
    p.add_argument("--load_epoch", type=int, required=True)
    p.add_argument("--load_step", type=int, required=True)
    p.add_argument("--model_path",
                   default="models/pose_higher_hrnet_w48_640.pth.tar")
    p.add_argument("--inplanes", type=int, default=80)
    p.add_argument("--num_heatmaps", type=int, default=17)
    p.add_argument("--whitelist", default=None)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--save_dir", default="/tmp")
    p.add_argument("--tb_dir", default=os.path.join("tb_log", "att_val"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


@dataclasses.dataclass
class AttentionEval:
    """Per evaluated image (dataset order) its loss and id, and their
    mean."""
    losses: np.ndarray
    img_ids: np.ndarray
    mean: float


def load_student(args: argparse.Namespace, log, device=None):
    """The student of ``args``'s snapshot, on ``device`` (default
    ``--device``), in eval mode."""
    dev = resolve_device(device if device is not None else args.device)
    model = get_attention_student(inplanes=args.inplanes,
                                  num_heatmaps=args.num_heatmaps, ae_dims=0,
                                  device=dev)
    load_stem(model, args.model_path, log)
    prefix = (f"{args.load_timestamp}_epoch{args.load_epoch}"
              f"_step{args.load_step}")
    load_student_parts(model, args.snapshot_dir, prefix)
    log.info(f"loaded snapshot {prefix} from {args.snapshot_dir}")
    return model.eval()


def evaluate(model, ds, args: argparse.Namespace, log,
             tb: Optional[MetricWriter] = None, batch_size: int = 8
             ) -> AttentionEval:
    """Each image's attention BCE, batched by image shape
    (:func:`~rtpe_tpu_torch.eval.minival.attention_losses`)."""
    n = len(ds) if args.max_images is None else min(len(ds),
                                                    args.max_images)
    if args.save_every:
        os.makedirs(args.save_dir, exist_ok=True)
    losses = np.full(n, np.nan)
    img_ids = np.asarray(ds.ids[:n], np.int64)
    for chunk, chunk_losses, att in attention_losses(
            model, ds, batch_size=batch_size, max_images=n):
        for k, i in enumerate(chunk):
            losses[i] = float(chunk_losses[k])
            if args.save_every and i % args.save_every == 0:
                import cv2
                amap = att[k].cpu().numpy()
                amap = (np.clip(amap, 0, 1) * 255).astype(np.uint8)
                cv2.imwrite(os.path.join(args.save_dir,
                                         f"attention_{i}.png"), amap)
    for i in range(n):  # in dataset order, like the reference
        log.info(f"VALIDATION img {i + 1}: att loss {losses[i]:.5f}")
        if tb is not None:
            tb.scalar("validation att loss", losses[i], i + 1)
            tb.scalar("validation img id", img_ids[i], i + 1)
    mean = float(np.mean(losses))
    log.info(f"mean attention loss over {n} images: {mean:.5f}")
    return AttentionEval(losses, img_ids, mean)


def main(argv: Optional[Sequence[str]] = None) -> AttentionEval:
    args = build_parser().parse_args(argv)
    log = ColorLogger("eval_attention")
    model = load_student(args, log)
    whitelist = read_whitelist(args.whitelist) if args.whitelist else None
    ds = CocoDistillationDataset(args.coco_dir, args.dataset,
                                 remove_images_without_annotations=False,
                                 gt_stddevs_pix=[2.0],
                                 whitelist_ids=whitelist,
                                 alt_colorspace="LAB",
                                 host_gt_heatmaps=False)  # never read
    tb = MetricWriter(os.path.join(
        args.tb_dir,
        f"[eval_attention.py]_{make_timestamp(with_tz_output=False)}"))
    try:
        return evaluate(model, ds, args, log, tb)
    finally:
        tb.close()


if __name__ == "__main__":
    main()
