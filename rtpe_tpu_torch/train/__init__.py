"""Training: the losses, the SGDR schedule, the distillation step, and
the legacy students' step with its loss scaling."""

from .legacy_steps import (  # noqa: F401
    StudentDistillConfig,
    StudentTrainState,
    make_student_optimizer,
    make_student_train_step,
    student_labels,
)
from .loss_scaling import (  # noqa: F401
    DynamicScalerState,
    StaticScaler,
    has_overflow,
    init_dynamic_scaler,
    scaled_grads_or_skip,
    update_scaler,
)
from .losses import (  # noqa: F401
    bce_with_logits,
    distillation_bce_loss_keypoint_mining,
    distillation_loss,
    distillation_loss_keypoint_mining,
    masked_bce_with_logits,
    masked_mse,
    mining_mask,
)
from .schedules import SgdrConfig, sgdr_schedule  # noqa: F401
from .step import (  # noqa: F401
    ATT_PREFIXES,
    DET_PREFIXES,
    DistillConfig,
    DistillTrainState,
    att_divisor_at,
    label_params,
    make_distill_optimizer,
    make_distill_train_step,
)
