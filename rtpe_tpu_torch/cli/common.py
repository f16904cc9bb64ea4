"""What the port's command-line entry points share: the teacher's
weights with the missing-file refusal, the int8 flags' checks and the
scripts' calibration, the model input of a 0-255 image, and the log."""

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..data.preprocess import normalize_image, resize_align_multi_scale
from ..device import DeviceLike, default_dtype, resolve_device
from ..models.factory import get_hrnet_w48_teacher
from ..models.hrnet_packed import calibrate_act_scales, pack_w48_params

def check_int8_flags(parser: argparse.ArgumentParser,
                     args: argparse.Namespace) -> None:
    """The JAX scripts' parser errors (status 2): ``--int8`` needs
    ``--packed``, ``--int8_act`` needs ``--int8``."""
    if getattr(args, "int8", False) and not args.packed:
        parser.error("--int8 requires --packed")
    if getattr(args, "int8_act", False) and not args.int8:
        parser.error("--int8_act requires --int8")


def get_logger(name: str) -> logging.Logger:
    """A logger on stderr: standard output carries only the result."""
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
    return log


def load_teacher(model_path: Optional[str], allow_random_init: bool,
                 log: logging.Logger, what: str):
    """The W48 teacher from a reference-format state dict; a missing
    file exits with status 2 unless ``allow_random_init``, which serves
    seeded random weights (``what`` says what that makes of the run)."""
    mp = model_path if model_path and os.path.exists(model_path) else None
    if mp is None:
        if not allow_random_init:
            log.error(f"model path {model_path!r} not found; pass "
                      f"--allow_random_init for a smoke/shape run")
            sys.exit(2)
        log.warning(f"model path {model_path!r} not found: RANDOM-INIT "
                    f"teacher ({what})")
    model, _ = get_hrnet_w48_teacher(mp)
    return model


def model_input(img_255: np.ndarray, input_size: int,
                device: DeviceLike) -> torch.Tensor:
    """A (h, w, 3) RGB image in 0-255 -> the normalized model input on
    ``device``, as the JAX scripts make it."""
    resized, _, _ = resize_align_multi_scale(img_255, input_size, 1, 1,
                                             device=device)
    return normalize_image(resized / 255.0)


def calibrate(model: torch.nn.Module, images_255, input_size: int,
              device: DeviceLike) -> dict:
    """int8 activation scales as the JAX scripts calibrate them: each
    0-255 image a batch of 1 at the input size, through the packed
    forward in the dtype the predictor serves on ``device``."""
    dev = resolve_device(device)
    dtype = default_dtype(dev)
    pk = pack_w48_params(model.state_dict(), model.cfg, dtype, dev)
    calib = [model_input(im, input_size, dev)[None].permute(0, 3, 1, 2)
             for im in images_255]
    return calibrate_act_scales(pk, calib, model.cfg, dtype)
