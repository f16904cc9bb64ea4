"""HigherHRNet-W48 teacher as PyTorch modules."""

from .hrnet import (  # noqa: F401
    HRNetConfig,
    PoseHigherHRNet,
    StageCfg,
    init_random_,
    w48_config,
)
