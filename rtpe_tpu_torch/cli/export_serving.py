"""Export a serving artifact from the teacher's weights.

    python -m rtpe_tpu_torch.cli.export_serving -m <w48.pth.tar> -o art \\
        [--int8 --calib a.jpg b.jpg | --act_scales s.json] [--int8_act] \\
        [--device cpu]

Port of ``scripts/export_serving.py`` with the same flags, ``--device``
in place of ``-C``: the weights (and, with ``--int8``, the activation
scales of ``--act_scales`` where that file exists, else calibrated on
the ``--calib`` images) go into one directory
(``io/serving.py:export_serving_artifact``) that either package's
``PosePredictor.from_artifact`` serves.  The artifact is then reloaded
and its forward checked bitwise equal to the exporting predictor's
(``--no-verify`` skips it; the int8 forward is checked, not its bf16
route).  Prints one JSON line.
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..eval.predictor import PosePredictor
from ..io.jax_import import jax_variables_from_state_dict
from ..io.serving import export_serving_artifact
from .common import check_int8_flags, get_logger, load_teacher


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Serving artifact export")
    parser.add_argument("-m", "--model_path", required=True,
                        help="HigherHRNet_w48_640 state dict path")
    parser.add_argument("-o", "--out_dir", required=True,
                        help="Artifact directory to write")
    parser.add_argument("--input_size", type=int, default=640)
    parser.add_argument("--packed", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="Record the BN-folded forward as the serving "
                             "mode (--no-packed: canonical)")
    parser.add_argument("--int8", action="store_true",
                        help="Ship calibrated int8 scales (requires --calib "
                             "images or an --act_scales file)")
    parser.add_argument("--int8_act", action="store_true",
                        help="Additionally record int8 activation storage "
                             "(requires --int8)")
    parser.add_argument("--calib", nargs="*", default=None,
                        help="Image paths for int8 activation-range "
                             "calibration")
    parser.add_argument("--act_scales", default=None,
                        help="Existing scale JSON (save_act_scales) to "
                             "ship instead of calibrating")
    parser.add_argument("--no-verify", action="store_true",
                        help="Skip the reload + bitwise forward check")
    parser.add_argument("--allow_random_init", action="store_true",
                        help="Proceed with a RANDOM-INIT teacher when "
                             "model_path does not exist (smoke runs only: "
                             "the artifact serves noise)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def verify(model, d: str, args: argparse.Namespace, act_scales) -> bool:
    """Reload ``d`` and hold its forward bitwise to the exporting
    predictor's on one seeded 256 x 256 input (int8 unrouted)."""
    kw = dict(device=args.device, int8_min_batch=0)
    ref = PosePredictor(model, input_size=args.input_size,
                        packed=args.packed, int8=args.int8,
                        int8_act=args.int8_act, act_scales=act_scales, **kw)
    got = PosePredictor.from_artifact(d, **kw)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 256, 256, 3)
                         .astype(np.float32)).to(ref.device)
    with torch.inference_mode():
        for a, b in zip(ref._forward(x), got._forward(x)):
            if not torch.equal(a, b):
                raise RuntimeError(f"{d}: the reloaded artifact's forward "
                                   "differs from the exporting predictor's")
    return True


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_int8_flags(parser, args)
    have_file = bool(args.act_scales and os.path.exists(args.act_scales))
    if args.int8 and not args.calib and not have_file:
        parser.error("--int8 needs --calib images or an existing "
                     "--act_scales file: the artifact must ship validated "
                     "scales")
    log = get_logger("export_serving")
    random_init = not (args.model_path and os.path.exists(args.model_path))
    model = load_teacher(args.model_path, args.allow_random_init, log,
                         "the artifact serves noise")
    variables = jax_variables_from_state_dict(model.state_dict(), model.cfg)

    act_scales = None
    if args.int8:
        if have_file:
            act_scales = args.act_scales
            log.info(f"shipping existing scales {args.act_scales}")
        else:
            from PIL import Image

            calib = []
            for p in args.calib:
                with Image.open(p) as im:
                    calib.append(np.asarray(im.convert("RGB")))
            log.info(f"calibrating int8 scales on {len(calib)} images")
            act_scales = PosePredictor(
                model, device=args.device, input_size=args.input_size,
                packed=True, int8=True,
                calibration_images=calib).act_scales

    d = export_serving_artifact(
        args.out_dir, variables, model.cfg, input_size=args.input_size,
        packed=args.packed, int8=args.int8, int8_act=args.int8_act,
        act_scales=act_scales,
        extra_meta={"source_statedict": args.model_path,
                    "random_init": random_init})
    size_mb = sum(os.path.getsize(os.path.join(d, f))
                  for f in os.listdir(d)) / 1e6
    verified = None
    if not args.no_verify:
        verified = verify(model, d, args, act_scales)
        log.info("reload parity: the artifact's forward is bitwise equal")
    out = {"artifact": d, "size_mb": round(size_mb, 1),
           "packed": args.packed, "int8": args.int8,
           "int8_act": args.int8_act, "verified": verified}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
