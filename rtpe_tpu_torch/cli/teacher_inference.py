"""Batch teacher prediction -> one ``.npz`` per image.

    python -m rtpe_tpu_torch.cli.teacher_inference -I img/*.jpg -o out \\
        -m models/pose_higher_hrnet_w48_640.pth.tar [-C | --device cpu]

Port of ``scripts/teacher_inference.py`` with the same flags (``-I``
images, ``-o`` out dir, ``-m`` state dict, ``-C`` the CPU), plus
``--device``, and the same output contract
(:mod:`rtpe_tpu_torch.data.teacher_cache`:
``{img}.jpg_w48_predictions.npz`` with ``pred_heatmaps``,
``embeddings``, ``heatmaps_refined`` and ``heatmaps_order``).  Images
are bucketed by their size, read from the file's header, and each
chunk of a bucket runs one batched forward.  ``--int8`` serves the
quantized forward, every chunk (no bf16 route, as the JAX script's int8
program), with the scales of an existing ``--act_scales`` file, or
calibrated on the first 4 inputs and then written to ``--act_scales``
when it is given.
"""

import argparse
import os
import time
from collections import defaultdict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.teacher_cache import save_teacher_prediction
from ..eval.predictor import PosePredictor
from ..models.hrnet_packed import load_act_scales, save_act_scales
from .common import (calibrate, check_int8_flags, get_logger, load_teacher,
                     model_input)

INPUT_SIZE = 640


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("HigherHRNet Inference")
    parser.add_argument("-I", "--input_paths", required=True, type=str,
                        nargs="+", help="Abs paths for the input images")
    parser.add_argument("-o", "--out_dir", required=True, type=str,
                        help="Path to output the predictions")
    parser.add_argument("-m", "--model_path", required=True, type=str,
                        help="Path to the HigherHRNet_w48_640 state dict")
    parser.add_argument("-C", "--force_cpu", action="store_true",
                        help="Run on the CPU (--device cpu)")
    parser.add_argument("--input_size", type=int, default=INPUT_SIZE,
                        help="resize-align target (reference fixes 640)")
    parser.add_argument("-b", "--batch_size", type=int, default=4,
                        help="Per-bucket batch size")
    parser.add_argument("--allow_random_init", action="store_true",
                        help="Proceed with a RANDOM-INIT teacher when "
                             "model_path does not exist (smoke/shape "
                             "runs only: the npz corpus will be noise).")
    parser.add_argument("--packed", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="Serve through the BN-folded forward "
                             "(models/hrnet_packed.py; the default for "
                             "corpus jobs); --no-packed runs the "
                             "canonical forward")
    parser.add_argument("--int8", action="store_true",
                        help="Quantize the packed weights to int8 with "
                             "activation scales calibrated on the first "
                             "input images (requires --packed)")
    parser.add_argument("--act_scales", default=None,
                        help="Activation-scale JSON for --int8: used "
                             "instead of calibrating if it exists, else "
                             "the scales calibrated here are saved there")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def corpus_scales(model: torch.nn.Module,
                  sources: Sequence[Tuple[str, Tuple[int, int]]],
                  load: Callable[[str], np.ndarray],
                  args: argparse.Namespace, log) -> dict:
    """The int8 activation scales: an existing ``--act_scales`` file, or
    calibrated on the first 4 inputs (each a batch of 1 at the input
    size) and saved to ``--act_scales`` when it is given."""
    if args.act_scales and os.path.exists(args.act_scales):
        scales = load_act_scales(args.act_scales)
        log.info(f"int8 scales loaded from {args.act_scales} "
                 f"({len(scales)} entries; calibration skipped)")
        return scales
    first = [load(p) for p, _ in sources[:4]]
    scales = calibrate(model, first, args.input_size, args.device)
    log.info(f"int8 calibration on {len(first)} corpus images")
    if args.act_scales:
        save_act_scales(args.act_scales, scales)
        log.info(f"int8 scales saved to {args.act_scales}")
    return scales


def write_corpus(model: torch.nn.Module,
                 sources: Sequence[Tuple[str, Tuple[int, int]]],
                 load: Callable[[str], np.ndarray], out_dir: str,
                 args: argparse.Namespace, log=None) -> dict:
    """Run the teacher over ``sources`` and write one ``.npz`` each.

    :param sources: ``(image path, (h, w))`` pairs; the file's basename
      names its ``.npz``.
    :param load: ``path -> (h, w, 3)`` RGB image, 0-255, read when its
      chunk runs.
    :returns: the number of images and the host-clock seconds of the
      forwards and their pulls to the host.
    """
    log = log or get_logger("teacher_inference")
    kw = {}
    if args.int8:
        kw = dict(int8=True, int8_min_batch=0,
                  act_scales=corpus_scales(model, sources, load, args, log))
    pred = PosePredictor(model, device=args.device,
                         input_size=args.input_size, packed=args.packed,
                         **kw)
    path = ("packed + int8" if args.int8 else "packed" if args.packed
            else "canonical")
    log.info(f"serving path: {path} {pred.dtype} on {pred.device}")
    os.makedirs(out_dir, exist_ok=True)
    buckets = defaultdict(list)
    for path, hw in sources:
        buckets[tuple(hw)].append(path)
    n_done, fwd_s = 0, 0.0
    with torch.inference_mode():
        for _, paths in sorted(buckets.items()):
            for i in range(0, len(paths), args.batch_size):
                chunk = paths[i:i + args.batch_size]
                x = torch.stack([model_input(load(p), args.input_size,
                                             pred.device) for p in chunk])
                t0 = time.perf_counter()
                coarse, refined = pred._forward(x)
                coarse = coarse.float().cpu().numpy()  # sync + pull
                fwd_s += time.perf_counter() - t0
                refined = refined.float().cpu().numpy()
                n_done += len(chunk)
                for k, img_path in enumerate(chunk):
                    out = save_teacher_prediction(
                        out_dir, os.path.basename(img_path), coarse[k],
                        refined[k])
                    log.info(f"saved predictions to {out}")
    if n_done and fwd_s > 0:
        log.info(f"teacher forward rate: {n_done / fwd_s:.1f} img/s "
                 f"({n_done} images, {fwd_s:.1f}s forward+fetch)")
    return {"images": n_done, "forward_s": fwd_s}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_int8_flags(parser, args)
    if args.force_cpu:
        args.device = "cpu"
    log = get_logger("teacher_inference")
    model = load_teacher(args.model_path, args.allow_random_init, log,
                         "the npz corpus will be noise")
    from PIL import Image

    sources = []
    for img_path in args.input_paths:
        with Image.open(img_path) as im:  # the header only
            w, h = im.size
        sources.append((img_path, (h, w)))

    def load(img_path: str) -> np.ndarray:
        with Image.open(img_path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.float32)

    return write_corpus(model, sources, load, args.out_dir, args, log)


if __name__ == "__main__":
    main()
