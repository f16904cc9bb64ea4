"""Single-stream pose demo: frames -> people, pipelined.

    python -m rtpe_tpu_torch.cli.realtime_demo -I frames/*.jpg --loops 3 \\
        -m models/pose_higher_hrnet_w48_640.pth.tar [--flip] [--device cpu]

Port of ``scripts/realtime_demo.py`` with the same flags, plus
``--device``: frames flow through
:meth:`~rtpe_tpu_torch.eval.PosePredictor.stream`, which queues frame
N+1's forward on the card (CUDA launches are asynchronous) before frame
N is decoded.  Prints one JSON line of stats with the JAX script's keys
(p50/p90 frame latency and the sustained frames per second, the first
frame excluded) and, with ``-o``, writes annotated frames.
"""

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ..eval.predictor import PosePredictor
from .common import get_logger, load_teacher, refuse_int8


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
                   help="not in this slice of the port")
    p.add_argument("--int8_act", action="store_true",
                   help="not in this slice of the port")
    p.add_argument("--act_scales", default=None,
                   help="not in this slice of the port")
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
        "path": "packed" if pred.packed else "canonical",
        # a --flip run's rate is not comparable to a plain run's
        "flip": pred.with_flip,
        # the int8 serving modes, which route small batches through the
        # bf16 program, are not in this slice: no frame is ever routed
        "routed_bf16": False,
    }
    log.info(f"sustained {stats['fps_sustained']} FPS, "
             f"p50 {stats['lat_p50_ms']} ms")
    return stats, results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_int8(parser, args)
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
    pred = PosePredictor(model, device=args.device,
                         input_size=args.input_size, packed=args.packed,
                         with_flip=args.flip)
    log.info(f"{len(frames)} frames x {args.loops} loops, "
             f"input_size={args.input_size}, device={pred.device}")
    stats, _ = run_stream(pred, frames, args, log)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
