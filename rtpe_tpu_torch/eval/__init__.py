"""Serving API (:class:`PosePredictor`), COCO keypoint evaluation, the
in-training minival and the student evaluation engine."""

from .predictor import PosePredictor  # noqa: F401
