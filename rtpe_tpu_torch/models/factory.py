"""Model factories (port of ``rtpe_tpu/models/factory.py``; reference
``rtpe/helpers.py:32-73`` and ``rtpe/students.py:285-295``)."""

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..device import DeviceLike, default_dtype, resolve_device
from ..io.jax_import import strip_fp16_prefix
from .hrnet import PoseHigherHRNet, init_random_, w48_config
from .hrnet_packed import PackedParams, pack_w48_params, packed_forward
from .students import (AttentionStudentSteps, CamStudent, MultistageStudent,
                       RefinerStudent, init_student_)

LEGACY_STUDENTS = {"cam": CamStudent, "refiner": RefinerStudent,
                   "multistage": MultistageStudent}


def get_hrnet_w48_teacher(w48_statedict_path: Optional[str] = None,
                          seed: int = 0
                          ) -> Tuple[PoseHigherHRNet, Dict[str, torch.Tensor]]:
    """The W48 teacher on the CPU in float32 and its state dict.

    With a path, the reference-format state dict is read with
    ``torch.load(map_location="cpu")`` (a saved module gives its
    ``state_dict()``) and the fp16 ``network_to_half`` ``"1."`` prefix
    is stripped; without one the weights are seeded random
    (:func:`~rtpe_tpu_torch.models.hrnet.init_random_`): no pretrained
    weights ship with the repository.
    """
    model = PoseHigherHRNet(w48_config())
    if w48_statedict_path is None:
        init_random_(model, seed=seed)
    else:
        sd = torch.load(w48_statedict_path, map_location="cpu",
                        weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = {k: v.float() if v.is_floating_point() else v
              for k, v in strip_fp16_prefix(sd).items()}
        model.load_state_dict(sd)
    return model.eval(), model.state_dict()


def get_packed_teacher(w48_statedict_path: Optional[str] = None,
                       dtype: Optional[torch.dtype] = None,
                       device: DeviceLike = None, seed: int = 0
                       ) -> Tuple[Callable, PackedParams]:
    """The W48 teacher on the BN-folded serving forward.

    :returns: ``(forward, packed_params)``: ``forward(packed_params, x,
      pallas_chains=False)`` takes NCHW images and returns the canonical
      model's ``(coarse, refined)``; the weights are folded once here, in
      ``dtype`` (bf16 on CUDA, float32 on the CPU) on ``device``.
    """
    dev = resolve_device(device)
    dtype = default_dtype(dev, dtype)
    cfg = w48_config()
    _, sd = get_hrnet_w48_teacher(w48_statedict_path, seed=seed)
    pk = pack_w48_params(sd, cfg, dtype=dtype, device=dev)

    def forward(packed_params: PackedParams, x: torch.Tensor,
                pallas_chains: bool = False):
        return packed_forward(packed_params, x, cfg, dtype,
                              pallas_chains=pallas_chains)

    return forward, pk


def get_attention_student(inplanes: int = 80, num_heatmaps: int = 17,
                          ae_dims: int = 0, alt_planes: int = 50,
                          detach_att_for_det: bool = True,
                          fused_cam: bool = False, remat: bool = False,
                          dtype: Optional[torch.dtype] = None,
                          device: DeviceLike = None, seed: int = 0
                          ) -> AttentionStudentSteps:
    """``AttentionStudentSteps`` with seeded random weights
    (:func:`~rtpe_tpu_torch.models.students.init_student_`, an explicit
    ``torch.Generator``) on ``device``, computing in ``dtype`` (bf16 on
    CUDA, float32 on the CPU), in train mode and ``channels_last``
    memory.  The defaults are the distillation script's
    (``scripts/distillation.py:150-155``)."""
    dev = resolve_device(device)
    model = AttentionStudentSteps(
        inplanes=inplanes, num_heatmaps=num_heatmaps, ae_dims=ae_dims,
        alt_planes=alt_planes, detach_att_for_det=detach_att_for_det,
        dtype=default_dtype(dev, dtype), fused_cam=fused_cam, remat=remat)
    init_student_(model, seed=seed)
    return model.to(dev, memory_format=torch.channels_last).train()


def get_legacy_student(kind: str, num_heatmaps: int = 17, ae_dims: int = 0,
                       dtype: Optional[torch.dtype] = None,
                       device: DeviceLike = None, seed: int = 0
                       ) -> torch.nn.Module:
    """A legacy student (``kind`` ``"cam"``, ``"refiner"`` or
    ``"multistage"``) as the distillation script builds it
    (``scripts/distillation.py:158-170``: ``inplanes=48`` for ``cam``),
    with seeded random weights, computing in ``dtype`` (bf16 on CUDA,
    float32 on the CPU), in train mode and ``channels_last`` memory on
    ``device``."""
    dev = resolve_device(device)
    kw = dict(num_heatmaps=num_heatmaps, ae_dims=ae_dims,
              dtype=default_dtype(dev, dtype))
    if kind == "cam":
        kw["inplanes"] = 48
    model = init_student_(LEGACY_STUDENTS[kind](**kw), seed=seed)
    return model.to(dev, memory_format=torch.channels_last).train()


@torch.no_grad()
def load_pretrained_stem(student: torch.nn.Module,
                         teacher_state_dict: Mapping[str, torch.Tensor]
                         ) -> torch.nn.Module:
    """Copy the teacher's stem (``conv1``, ``bn1``, ``conv2``, ``bn2``,
    ``layer1.*``) into ``student.stem`` by name, the fp16 ``"1."`` prefix
    stripped (reference ``get_pretrained_stem``); strict, in place."""
    sd = strip_fp16_prefix(teacher_state_dict)
    keys = student.stem.state_dict().keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"the teacher state dict lacks {len(missing)} stem "
                       f"keys, e.g. {missing[:5]}")
    student.stem.load_state_dict({k: sd[k] for k in keys}, strict=True)
    return student
