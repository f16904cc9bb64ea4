"""The HigherHRNet-W48 teacher and the student family as PyTorch
modules."""

from .hrnet import (  # noqa: F401
    HRNetConfig,
    PoseHigherHRNet,
    StageCfg,
    init_random_,
    w48_config,
)
from .rsb import ConvBnRelu, ResidualStepBlock  # noqa: F401
from .stem import STEM_OUT_CHANS, StemHRNet  # noqa: F401
from .students import (  # noqa: F401
    AttentionStudent,
    AttentionStudentSteps,
    CamStudent,
    ContextAwareModule,
    MultistageStudent,
    RefinerStudent,
    SELayer,
    SkipConv,
    init_student_,
    straight_skip_conv,
)
