"""Observability: skeleton and heatmap pictures (:mod:`.vis`)."""
