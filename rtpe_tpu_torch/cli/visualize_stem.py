"""Write the stem's 256 feature planes of one image as PNGs.

    python -m rtpe_tpu_torch.cli.visualize_stem -i a.jpg -m <w48.pth.tar> \\
        -o out_dir [--input_size 640] [--device cpu]

Port of ``scripts/visualize_stem.py`` (the reference ``visualize_stem.py``)
with the same flags, plus ``--device`` (``cuda`` by default; raises
without CUDA): the teacher's stem (the reference's fp16 stem; bf16 on
CUDA, float32 on the CPU) from the state dict's stem keys
(:func:`~rtpe_tpu_torch.io.torch_import.import_stem_statedict`; seeded
random weights with a warning when the file is missing), one forward of
the resized, normalized image in eval mode, each feature plane
min-max normalized to a grayscale ``plane{i}.png``.

:func:`stem_planes` is the core: it returns the uint8 planes of an image
in memory.  ``cv2`` (reading the image, writing the PNGs) is imported in
the functions that use it.  Prints one JSON line on stdout.
"""

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, default_dtype, resolve_device
from ..io.torch_import import import_stem_statedict, load_torch_statedict
from ..models.stem import StemHRNet
from ..models.students import init_student_
from .common import get_logger, model_input


class StemHolder(nn.Module):
    """The stem alone, under the students' ``stem`` name."""

    def __init__(self):
        super().__init__()
        self.stem = StemHRNet()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("visualize_stem")
    p.add_argument("-i", "--image", required=True, help="input image path")
    p.add_argument("-m", "--model_path",
                   default="models/pose_higher_hrnet_w48_640.pth.tar")
    p.add_argument("-o", "--out_dir", default="/tmp/stem_planes")
    p.add_argument("--max_planes", type=int, default=256)
    p.add_argument("--input_size", type=int, default=640,
                   help="resize target (reference fixes 640; smaller "
                        "keeps CPU smoke drives fast)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_stem(model_path: Optional[str], device: DeviceLike,
              log=None) -> StemHolder:
    """The stem of a reference-format state dict on ``device``, in eval
    mode; seeded random weights when the file is missing."""
    holder = init_student_(StemHolder(), seed=0)
    if model_path and os.path.exists(model_path):
        import_stem_statedict(holder, load_torch_statedict(model_path))
        if log:
            log.info(f"loaded stem from {model_path}")
    elif log:
        log.warning("statedict not found; using random stem")
    return holder.to(resolve_device(device)).eval()


@torch.no_grad()
def stem_planes(holder: StemHolder, img_255: np.ndarray, input_size: int,
                device: DeviceLike, max_planes: int = 256,
                dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """The (P, H/4, W/4) uint8 planes of a (h, w, 3) RGB image in 0-255:
    each stem feature plane as ``(f - min) / (max - min + 1e-9) * 255``,
    truncated, as the JAX script writes them."""
    dev = resolve_device(device)
    x = model_input(img_255.astype(np.float32), input_size, dev)
    feats = holder.stem(x[None].permute(0, 3, 1, 2),
                        default_dtype(dev, dtype))
    feats = feats[0].float().cpu().numpy()
    out = []
    for f in feats[:max_planes]:
        f = (f - f.min()) / (f.max() - f.min() + 1e-9)
        out.append((f * 255).astype(np.uint8))
    return np.stack(out)


def write_planes(planes: np.ndarray, out_dir: str) -> List[str]:
    """``plane{i}.png`` for each plane, in ``out_dir``."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, plane in enumerate(planes):
        path = os.path.join(out_dir, f"plane{i}.png")
        cv2.imwrite(path, plane)
        paths.append(path)
    return paths


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    log = get_logger("visualize_stem")
    holder = load_stem(args.model_path, dev, log)
    import cv2
    img = cv2.imread(args.image)
    if img is None:
        raise FileNotFoundError(args.image)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    planes = stem_planes(holder, img, args.input_size, dev, args.max_planes)
    log.info(f"stem features: {planes.shape}")
    paths = write_planes(planes, args.out_dir)
    log.info(f"wrote {len(paths)} planes to {args.out_dir}")
    print(json.dumps({"planes": len(paths), "out_dir": args.out_dir,
                      "shape": list(planes.shape[1:])}))
    return paths


if __name__ == "__main__":
    main()
