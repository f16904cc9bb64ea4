"""Serving API: :class:`PosePredictor`."""

from .predictor import PosePredictor  # noqa: F401
