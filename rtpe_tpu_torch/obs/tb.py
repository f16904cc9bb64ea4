"""Metric writing, TensorBoard and JSONL (port of ``rtpe_tpu/obs/tb.py``).

The reference logs scalars every step and images/histograms every 500
steps through tensorboardX (``distillation.py:132,338-389``).  The same
surface here: every scalar goes to ``metrics.jsonl`` in ``log_dir``, and
to TensorBoard as well where tensorboardX is installed (imported here,
not at module import: the card's machine has none).
"""

import json
import os
import time
from typing import Dict

import numpy as np


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
            self.tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            self.tb = None

    def scalar(self, tag: str, value, step: int):
        value = float(value)
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": value,
             "step": int(step)}) + "\n")

    def scalars(self, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(k, v, step)
        self._jsonl.flush()

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        if self.tb is not None:
            img = np.asarray(img_hwc)
            if img.ndim == 2:
                img = img[:, :, None]
            self.tb.add_image(tag, img, step, dataformats="HWC")

    def histogram(self, tag: str, values: np.ndarray, step: int):
        if self.tb is not None:
            self.tb.add_histogram(tag, np.asarray(values), step)

    def text(self, tag: str, text: str, step: int = 0):
        if self.tb is not None:
            self.tb.add_text(tag, text, step)

    def hparams(self, hparams: Dict):
        if self.tb is not None:
            try:
                self.tb.add_hparams(
                    {str(k): str(v) for k, v in hparams.items()}, {})
            except Exception:  # TensorBoard's hparams plugin is optional
                pass
        self._jsonl.write(json.dumps(
            {"t": time.time(), "hparams":
             {str(k): str(v) for k, v in hparams.items()}}) + "\n")
        self._jsonl.flush()

    def flush(self):
        self._jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()
