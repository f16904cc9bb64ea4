"""The configuration tree (port of ``rtpe_tpu/configs/__init__.py``).

The reference has no config system: every entry script repeats
module-level UPPER_CASE globals, with the upstream yacs schema kept only
as a comment (``legacy/distillation.py:36-95``).  Here every tunable
lives in one nested dataclass tree that serializes to and from YAML,
with defaults equal to the reference's live values; the fields and the
YAML are the JAX package's, so a file either package writes loads in
the other to equal dicts.  PyYAML is imported only where a file is read
or written.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..data.augment import AugmentConfig
from ..models.hrnet import HRNetConfig, w48_config
from ..train.step import DistillConfig


@dataclass(frozen=True)
class DecodeConfig:
    """HeatmapParser settings (``distillation.py:54-61`` /
    ``validate_hhrnet.py:78``)."""

    num_joints: int = 17
    max_num_people: int = 30
    detection_threshold: float = 0.1
    tag_threshold: float = 1.0
    use_detection_val: bool = True
    ignore_too_much: bool = False
    tag_per_joint: bool = True
    nms_ksize: int = 5
    nms_padding: int = 2


@dataclass(frozen=True)
class DataConfig:
    """Paths and dataset settings (``distillation.py:42-46,73-80``)."""

    coco_dir: str = "~/datasets/coco"
    train_dataset: str = "val2017"
    teacher_dir: Optional[str] = None
    train_batch_size: int = 16
    train_hw: Tuple[int, int] = (450, 450)
    train_gt_stddevs: Tuple[float, ...] = (7.0,)
    val_gt_stddevs: Tuple[float, ...] = (2.0,)
    minival_file: Optional[str] = None
    alt_colorspace: str = "LAB"


@dataclass(frozen=True)
class MeshConfig:
    """Data/model parallel sizes (the reference is single-device)."""

    n_data: Optional[int] = None  # None = all devices
    n_model: int = 1


@dataclass(frozen=True)
class FrameworkConfig:
    model: HRNetConfig = field(default_factory=w48_config)
    data: DataConfig = DataConfig()
    augment: AugmentConfig = AugmentConfig()
    decode: DecodeConfig = DecodeConfig()
    distill: DistillConfig = DistillConfig()
    mesh: MeshConfig = MeshConfig()


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_yaml(cfg, path: str) -> None:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def _build(cls, data):
    if not dataclasses.is_dataclass(cls) or not isinstance(data, dict):
        return data
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        # nested dataclasses by the field's default type
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if dataclasses.is_dataclass(default) and isinstance(v, dict):
            kwargs[f.name] = _build(type(default), v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(
                _build(type(default[0]), e)
                if (isinstance(default, tuple) and default
                    and dataclasses.is_dataclass(default[0])) else
                (tuple(e) if isinstance(e, list) else e) for e in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_yaml(path: str) -> FrameworkConfig:
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f)
    return _build(FrameworkConfig, data)
