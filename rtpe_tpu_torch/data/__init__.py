"""Inference preprocessing (resize-align, normalize, inverse transform)."""
