"""Minival split generation (port of ``rtpe_tpu/data/minival.py``;
reference ``make_rand_minival_split``, ``rtpe/helpers.py:186-208``)."""

import os
import random
from typing import List, Optional, Tuple


def make_rand_minival_split(val_dir: str, minival_size: int,
                            extension: str = ".jpg",
                            seed: Optional[int] = None
                            ) -> Tuple[List[str], List[str]]:
    """:returns: ``(minival, rest_val)`` image basename lists."""
    imgs = [p for p in os.listdir(val_dir) if p.endswith(extension)]
    rng = random.Random(seed)
    rng.shuffle(imgs)
    return imgs[:minival_size], imgs[minival_size:]


def write_minival_file(basenames: List[str], path: str) -> None:
    with open(path, "w") as f:
        for elt in basenames:
            f.write(f"{elt}\n")
