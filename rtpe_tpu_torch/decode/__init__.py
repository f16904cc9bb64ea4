"""Bottom-up heatmap decoding: NMS + top-k, associative-embedding
grouping, adjust and refine.

Port of ``rtpe_tpu/decode``: the device decode (:mod:`.fused`, the
kernels of ``csrc/`` on CUDA), the host grouping (:mod:`.group`,
:mod:`.group_fast`), the per-joint grouping with an exact LAP
(:mod:`.group_jit`, :mod:`.hungarian_jit`) and :class:`HeatmapParser`,
with the reference class's constructor surface.
"""

from .nms import nms_heatmaps, top_k  # noqa: F401
from .group import GroupingParams, match_by_tag, munkres_assign  # noqa: F401
from .group_jit import match_by_tag_jit  # noqa: F401
from .hungarian_jit import hungarian  # noqa: F401
from .fused import decode_full, decode_full_batch  # noqa: F401
from .parser import HeatmapParser  # noqa: F401
