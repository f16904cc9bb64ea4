"""What the port's command-line entry points share: the teacher's
weights with the missing-file refusal, the refusal of the int8 flags,
the model input of a 0-255 image, and the log."""

import argparse
import logging
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..data.preprocess import normalize_image, resize_align_multi_scale
from ..device import DeviceLike
from ..models.factory import get_hrnet_w48_teacher

INT8_LATER = ("the int8 serving modes (ROADMAP.md Queue 1 item 4) come "
              "with a later slice of the port")


def refuse_int8(parser: argparse.ArgumentParser,
                args: argparse.Namespace) -> None:
    """Exit with the parser's error (status 2) on any int8 flag."""
    for flag in ("int8", "int8_act", "act_scales"):
        if getattr(args, flag, None) not in (None, False):
            parser.error(f"--{flag}: {INT8_LATER}")


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
