"""Device decode: NMS + top-k, lockstep grouping, adjust + refine."""

from .fused import decode_full_batch  # noqa: F401
from .parser import GroupingParams, HeatmapParser  # noqa: F401
