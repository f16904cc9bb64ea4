"""Observability: skeleton and heatmap pictures (:mod:`.vis`) and the
metric writer (:mod:`.tb`)."""

from .tb import MetricWriter  # noqa: F401
