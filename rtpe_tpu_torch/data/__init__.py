"""Data: inference preprocessing (resize-align, normalize, inverse
transform), the COCO annotation reader and its masks, heatmap targets,
the teacher's ``.npz`` corpus, the distillation/evaluation dataset and
minival splits."""
