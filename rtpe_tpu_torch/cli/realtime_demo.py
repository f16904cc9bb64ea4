"""Single-stream pose demo: frames -> people, pipelined.

    python -m rtpe_tpu_torch.cli.realtime_demo -I frames/*.jpg --loops 3 \\
        -m models/pose_higher_hrnet_w48_640.pth.tar [--flip] [--device cpu]

Port of ``scripts/realtime_demo.py`` with the same flags, plus
``--device``: frames flow through
:meth:`~rtpe_tpu_torch.eval.PosePredictor.stream`, which queues frame
N+1's forward on the card (CUDA launches are asynchronous) before frame
N is decoded.  Prints one JSON line of stats with the JAX script's keys
(p50/p90 frame latency and the sustained frames per second, the first
frame excluded) and, with ``-o``, writes annotated frames.  With
``--int8`` the scales come from ``--act_scales`` where that file
exists; otherwise they are calibrated on the first 8 frames and, with
``--act_scales``, written there (the JAX script passes
``save_act_scales`` its arguments in the wrong order and raises
instead; ROADMAP.md Queue 3).
"""

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ..eval.predictor import PosePredictor
from ..models.hrnet_packed import save_act_scales
from .common import check_int8_flags, get_logger, load_teacher


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("realtime_demo")
    p.add_argument("-I", "--input_paths", required=True, nargs="+",
                   help="Frame image paths (shell glob), streamed in "
                        "order")
    p.add_argument("-m", "--model_path", required=True,
                   help="Path to the HigherHRNet_w48_640 state dict")
    p.add_argument("--allow_random_init", action="store_true",
                   help="Proceed with a RANDOM-INIT teacher when "
                        "model_path does not exist (smoke runs only)")
    p.add_argument("--loops", type=int, default=1,
                   help="Cycle the frame list this many times (simulate "
                        "a longer stream; stats cover all frames)")
    p.add_argument("--input_size", type=int, default=640,
                   help="resize-align target (reference fixes 640)")
    p.add_argument("-C", "--force_cpu", action="store_true",
                   help="Run on the CPU (--device cpu)")
    p.add_argument("--packed", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="BN-folded serving forward (default; "
                        "--no-packed = the canonical forward)")
    p.add_argument("--int8", action="store_true",
                   help="int8 weights (requires --packed); activation "
                        "scales calibrate on the first frames unless "
                        "--act_scales points at an existing file")
    p.add_argument("--int8_act", action="store_true",
                   help="additionally store inter-layer activations "
                        "int8 (requires --int8)")
    p.add_argument("--act_scales", default=None,
                   help="Activation-scale JSON (save_act_scales): used "
                        "if it exists, else written after calibration")
    p.add_argument("--flip", action="store_true",
                   help="Flip-TTA on the streamed forward (a doubled "
                        "batch, still pipelined)")
    p.add_argument("-o", "--out_dir", default=None,
                   help="If set, write annotated frames here (needs cv2)")
    p.add_argument("--save_frames", type=int, default=8,
                   help="Max annotated frames to write with -o")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def make_predictor(model, frames: Sequence[np.ndarray],
                   args: argparse.Namespace, log=None) -> PosePredictor:
    """The stream's predictor from the flags: with ``--int8`` the scales
    of an existing ``--act_scales`` file, else calibrated on the first 8
    frames and written to ``--act_scales`` when it is given."""
    log = log or get_logger("realtime_demo")
    kw = {}
    if args.int8:
        if args.act_scales and os.path.exists(args.act_scales):
            kw["act_scales"] = args.act_scales
            log.info(f"int8 scales loaded from {args.act_scales}")
        else:
            # the stream's own frames are the calibration corpus
            kw["calibration_images"] = list(frames[:8])
    pred = PosePredictor(model, device=args.device,
                         input_size=args.input_size, packed=args.packed,
                         int8=args.int8, int8_act=args.int8_act,
                         with_flip=args.flip, **kw)
    if args.int8 and args.act_scales \
            and not os.path.exists(args.act_scales):
        save_act_scales(args.act_scales, pred.act_scales)
        log.info(f"int8 scales calibrated on {min(8, len(frames))} "
                 f"frames -> {args.act_scales}")
    return pred


def run_stream(pred: PosePredictor, frames: Sequence[np.ndarray],
               args: argparse.Namespace, log=None):
    """Stream ``frames`` ``args.loops`` times through ``pred``.

    :returns: ``(stats, results)``: the stats dict the CLI prints and
      the ``(people, scores)`` of every streamed frame, in order.
    """
    log = log or get_logger("realtime_demo")

    def frame_iter():
        for _ in range(args.loops):
            yield from frames

    n_total = len(frames) * args.loops
    lat_ms: List[float] = []
    results = []
    people_total = 0
    saved = 0
    t_prev = time.perf_counter()
    t_first_done = None
    for i, (people, scores) in enumerate(pred.stream(frame_iter())):
        now = time.perf_counter()
        lat_ms.append((now - t_prev) * 1e3)
        t_prev = now
        if t_first_done is None:
            t_first_done = now
        results.append((people, scores))
        people_total += len(people)
        if args.out_dir and saved < args.save_frames:
            from ..obs.vis import save_valid_image
            os.makedirs(args.out_dir, exist_ok=True)
            save_valid_image(frames[i % len(frames)], people,
                             os.path.join(args.out_dir,
                                          f"frame{i:05d}.png"),
                             seed=0)
            saved += 1
        if i == 0:
            log.info(f"first frame: {lat_ms[0]:.0f} ms")

    # the steady state leaves out frame 0 (first calls, pipeline fill)
    steady = lat_ms[1:] or lat_ms
    fps = ((n_total - 1) / (t_prev - t_first_done)
           if n_total > 1 and t_prev > t_first_done else 0.0)
    stats = {
        "frames": n_total,
        "fps_sustained": round(fps, 2),
        "lat_p50_ms": round(float(np.percentile(steady, 50)), 2),
        "lat_p90_ms": round(float(np.percentile(steady, 90)), 2),
        "first_frame_ms": round(lat_ms[0], 1),
        "people_total": people_total,
        "backend": pred.device.type,
        "path": ("int8_act" if pred.int8_act else
                 "int8" if pred.int8_params is not None else
                 "packed" if pred.packed else "canonical"),
        # a --flip run's rate is not comparable to a plain run's
        "flip": pred.with_flip,
        # int8 streams a batch of 1 a frame, which the predictor serves
        # by its bf16 params below int8_min_batch: which params served
        "routed_bf16": pred.routes_to_bf16(1),
    }
    log.info(f"sustained {stats['fps_sustained']} FPS, "
             f"p50 {stats['lat_p50_ms']} ms")
    return stats, results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_int8_flags(parser, args)
    if args.force_cpu:
        args.device = "cpu"
    log = get_logger("realtime_demo")
    model = load_teacher(args.model_path, args.allow_random_init, log,
                         "poses will be noise")
    from PIL import Image

    frames = []
    for fp in args.input_paths:
        with Image.open(fp) as im:
            frames.append(np.asarray(im.convert("RGB")))
    pred = make_predictor(model, frames, args, log)
    log.info(f"{len(frames)} frames x {args.loops} loops, "
             f"input_size={args.input_size}, device={pred.device}")
    stats, _ = run_stream(pred, frames, args, log)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
