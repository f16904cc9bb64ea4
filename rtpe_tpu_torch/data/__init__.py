"""Data: inference preprocessing (resize-align, normalize, inverse
transform), the COCO annotation reader and its masks, RLE, heatmap
targets, the teacher's ``.npz`` corpus, the distillation/evaluation
dataset, minival splits, and the training pipeline (one-matrix
augmentation, targets and warp on the device)."""

from .augment import AugmentConfig, sample_affine_matrices  # noqa: F401
from .coco import (  # noqa: F401
    COCO_FLIP_PAIRS,
    COCO_JOINT_NAMES,
    COCO_NUM_JOINTS,
    CocoAnnotations,
    get_human_segmentation_mask,
    get_ignore_mask,
    get_joints,
    read_whitelist,
)
from .dataset import CocoDistillationDataset  # noqa: F401
from .minival import make_rand_minival_split, write_minival_file  # noqa: F401
from .pipeline import TrainPipeline  # noqa: F401
from .rle import (  # noqa: F401
    polygons_to_mask,
    rle_decode,
    rle_encode,
    segmentation_to_mask,
)
from .targets import HeatmapGenerator, render_heatmaps  # noqa: F401
from .teacher_cache import (  # noqa: F401
    load_teacher_prediction,
    save_teacher_prediction,
)
