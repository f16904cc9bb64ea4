"""Teacher COCO-AP validation.

    python -m rtpe_tpu_torch.cli.validate_hhrnet --coco_dir <root> \\
        -m models/pose_higher_hrnet_w48_640.pth.tar [--flip] [--device cpu]

Port of ``scripts/validate_hhrnet.py`` with the same flags, plus
``--device``: run the W48 teacher over a COCO split, upsample the
heatmaps and tags to image size, decode with
:meth:`~rtpe_tpu_torch.decode.HeatmapParser.parse_batch` (the NMS +
top-k kernel, grouping on the host, adjust and refine), and print the
ten keypoint AP/AR stats as one JSON line.  ``--int8`` (and
``--int8_act``) serve the quantized forward with scales calibrated on
the first 4 images at the input size, as the JAX script does, and
route no chunk to bf16 (the JAX script calls its int8 program
directly).  Images are bucketed by
their original (h, w), and each chunk of a bucket runs one batched
forward (or :func:`~rtpe_tpu_torch.eval.tta.tta_forward`), one resize
of the maps and one decode.

The JAX script's ``CompileWatchdog`` guards the TPU's remote compile
service against wedged compiles; nothing here compiles through such a
service, so it is not carried over.
"""

import argparse
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.coco import read_whitelist
from ..data.dataset import CocoDistillationDataset
from ..decode import HeatmapParser
from ..eval.predictor import PosePredictor
from ..eval.tta import tta_forward
from ..ops.resize import resize_bilinear
from .common import (calibrate, check_int8_flags, get_logger, load_teacher,
                     model_input)

NUM_JOINTS = 17


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("validate_hhrnet")
    parser.add_argument("--coco_dir", type=str,
                        default=os.path.join(os.path.expanduser("~"),
                                             "datasets", "coco"))
    parser.add_argument("--dataset", type=str, default="val2017")
    parser.add_argument("-m", "--model_path", type=str,
                        default="models/pose_higher_hrnet_w48_640.pth.tar")
    parser.add_argument("--input_size", type=int, default=640)
    parser.add_argument("--whitelist", type=str, default=None,
                        help="minival id-list file")
    parser.add_argument("--save_every", type=int, default=100,
                        help="write every n-th image's skeletons (needs "
                             "cv2); 0 writes none")
    parser.add_argument("--save_dir", type=str, default="/tmp")
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--flip", action="store_true",
                        help="flip test-time augmentation (the 0.698-AP "
                             "pipeline uses it; legacy/valid_ae1dim.py)")
    parser.add_argument("--scales", type=str, default="1",
                        help="comma-separated multi-scale TTA factors")
    parser.add_argument("--batch_size", type=int, default=4,
                        help="images sharing an original size are "
                             "forwarded together")
    parser.add_argument("--allow_random_init", action="store_true",
                        help="Proceed with a RANDOM-INIT teacher when "
                             "model_path does not exist (smoke/shape "
                             "runs only; the AP numbers are "
                             "meaningless).")
    parser.add_argument("--packed", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="Run the BN-folded serving forward "
                             "(models/hrnet_packed.py); --no-packed "
                             "runs the canonical forward.")
    parser.add_argument("--int8", action="store_true",
                        help="int8-quantized packed forward, activation "
                             "scales calibrated on the first val images "
                             "(requires --packed)")
    parser.add_argument("--int8_act", action="store_true",
                        help="additionally store inter-layer activations "
                             "int8 (requires --int8)")
    parser.add_argument("--ae_mode", default="full",
                        choices=["full", "first", "mean"],
                        help="associative-embedding ablations: 'first' "
                             "keeps only AE dim 0, 'mean' averages the "
                             "dims (explorations.md:209-244)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


@dataclasses.dataclass
class Validation:
    """What :func:`validate` found: the stats, and per evaluated image
    (in dataset order) its people in image coordinates and their
    scores; ``forward_s`` is the host-clock time of the forwards."""
    stats: dict
    preds: List[List[np.ndarray]]
    scores: List[List[float]]
    forward_s: float


def reduce_ae(aes: torch.Tensor, ae_mode: str) -> torch.Tensor:
    """The tag maps the ``ae_mode`` ablation keeps."""
    if ae_mode == "first":
        return aes[..., 0:1]
    if ae_mode == "mean":
        return aes.mean(dim=-1, keepdim=True)
    return aes


def validate(model: torch.nn.Module, ds: CocoDistillationDataset,
             args: argparse.Namespace, log=None) -> Validation:
    """Validate ``model`` (the W48 teacher's module, with its weights)
    on ``ds`` with the options of :func:`build_parser`."""
    log = log or get_logger("validate_hhrnet")
    kw = {}
    if args.int8:
        # the first 4 images (scripts/validate_hhrnet.py:118-133)
        first = [ds[i]["img"] * 255.0 for i in range(min(4, len(ds)))]
        kw = dict(int8=True, int8_act=args.int8_act, int8_min_batch=0,
                  act_scales=calibrate(model, first, args.input_size,
                                       args.device))
    pred = PosePredictor(model, device=args.device,
                         input_size=args.input_size, packed=args.packed,
                         **kw)
    path = ("packed + int8_act" if args.int8_act else "packed + int8"
            if args.int8 else "packed" if args.packed else "canonical")
    log.info(f"forward path: {path} {pred.dtype} on {pred.device}")
    # the reference's parser settings (validate_hhrnet.py:78); 'first'
    # and 'mean' reduce the tags to one channel shared by the joints
    hm_parser = HeatmapParser(num_joints=NUM_JOINTS, max_num_people=30,
                              detection_threshold=0.1, tag_threshold=1.0,
                              use_detection_val=True, ignore_too_much=False,
                              tag_per_joint=args.ae_mode == "full",
                              nms_ksize=5, nms_padding=2)
    scales = tuple(float(s) for s in args.scales.split(","))
    use_tta = args.flip or scales != (1.0,)
    if args.save_every:
        from ..obs.vis import save_valid_image
        os.makedirs(args.save_dir, exist_ok=True)
    n = len(ds) if args.max_images is None else min(len(ds),
                                                    args.max_images)
    # bucket by the ORIGINAL (h, w) from the annotations (the resized
    # shape is a function of it) and load each chunk just in time
    buckets = defaultdict(list)
    for i in range(n):
        im = ds.coco.imgs[ds.ids[i]]
        buckets[(im["height"], im["width"])].append(i)

    all_preds: List = [None] * n
    all_scores: List = [None] * n
    done, fwd_s = 0, 0.0
    bs = max(1, args.batch_size)
    with torch.inference_mode():
        for (h, w), idxs in sorted(buckets.items()):
            for s0 in range(0, len(idxs), bs):
                chunk = []
                for i in idxs[s0:s0 + bs]:
                    sample = ds[i]
                    img = sample["img"] * 255.0
                    chunk.append((i, model_input(img, args.input_size,
                                                 pred.device),
                                  img, sample["img_id"]))
                xb = torch.stack([x for _, x, _, _ in chunk])
                t0 = time.perf_counter()
                if use_tta:
                    hm_b, tag_b = tta_forward(
                        pred._forward_nhwc, xb, num_joints=NUM_JOINTS,
                        with_flip=args.flip, scales=scales)
                else:
                    coarse, refined = pred._forward_nhwc(xb)
                    hm_b = refined[..., :NUM_JOINTS].float()
                    tag_b = coarse[..., NUM_JOINTS:].float()
                if hm_b.is_cuda:
                    torch.cuda.synchronize(hm_b.device)
                fwd_s += time.perf_counter() - t0
                # one upsample and one decode per chunk: the chunk shares
                # the original (h, w)
                hms_b = resize_bilinear(hm_b, (h, w), align_corners=True)
                aes_b = resize_bilinear(tag_b, (h, w), align_corners=True)
                grouped_b, scores_b = hm_parser.parse_batch(
                    hms_b, reduce_ae(aes_b, args.ae_mode), adjust=True,
                    refine=True)
                for k, (i, _, img, img_id) in enumerate(chunk):
                    final = [p for p in grouped_b[k]
                             if np.asarray(p).size > 0]
                    all_preds[i] = final
                    all_scores[i] = scores_b[k]
                    done += 1
                    log.info(f"[{done}/{n}] {img_id}: {len(final)} people")
                    if args.save_every and i % args.save_every == 0:
                        save_valid_image(
                            img.astype(np.uint8), final,
                            os.path.join(args.save_dir,
                                         f"validate_hhrnet_{i}.jpg"))
    if done and fwd_s > 0:
        log.info(f"teacher forward rate: {done / fwd_s:.1f} img/s "
                 f"({done} images, {fwd_s:.1f}s incl. the first calls)")
    stats = ds.evaluate(all_preds, all_scores, img_ids=ds.ids[:n])
    return Validation(stats, all_preds, all_scores, fwd_s)


def main(argv: Optional[Sequence[str]] = None) -> Validation:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_int8_flags(parser, args)
    log = get_logger("validate_hhrnet")
    whitelist = read_whitelist(args.whitelist) if args.whitelist else None
    ds = CocoDistillationDataset(args.coco_dir, args.dataset,
                                 remove_images_without_annotations=False,
                                 whitelist_ids=whitelist,
                                 host_gt_heatmaps=False)  # never read
    model = load_teacher(args.model_path, args.allow_random_init, log,
                         "shape/drive runs only")
    res = validate(model, ds, args, log)
    for k, v in res.stats.items():
        log.info(f"{k}={v}")
    print(json.dumps(res.stats))
    return res


if __name__ == "__main__":
    main()
