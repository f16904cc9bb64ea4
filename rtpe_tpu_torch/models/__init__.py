"""The HigherHRNet-W48 teacher and the attention student as PyTorch
modules."""

from .hrnet import (  # noqa: F401
    HRNetConfig,
    PoseHigherHRNet,
    StageCfg,
    init_random_,
    w48_config,
)
from .stem import STEM_OUT_CHANS, StemHRNet  # noqa: F401
from .students import (  # noqa: F401
    AttentionStudentSteps,
    ContextAwareModule,
    SELayer,
    init_student_,
)
