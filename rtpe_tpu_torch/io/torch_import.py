"""The reference's torch state dicts -> the port's students (port of
``rtpe_tpu/io/torch_import.py``).

The reference saves its students as torch state dicts whose module
names differ from the JAX tree the port's modules carry (``att_hi.0``
for ``att.hi``, ``steps.3`` for ``det_top``, ``hdcs.1.0`` for
``hdc1_conv``, ``stem.1.`` for the fp16-wrapped stem).  Both the
reference and the port lay out convolutions as OIHW and linear layers as
``(out, in)``, so only names are translated: each key of the port's
``state_dict`` is mapped to exactly one reference key, as JAX's
translators map each flax leaf.  Like JAX's, every importer refuses a
missing key (``KeyError``) and a shape mismatch (``ValueError``); with
``strict``, also any reference key left unconsumed other than
``num_batches_tracked`` (``ValueError``).  ``strict`` defaults to what
JAX's importer does: the stem importer checks, the student importers do
not.  The result loads with ``load_state_dict(strict=True)``; each BN's
``num_batches_tracked`` keeps the model's own count.

The teacher's reference-format state dict loads by name already
(:func:`rtpe_tpu_torch.models.factory.get_hrnet_w48_teacher`).
"""

import os
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .jax_import import strip_fp16_prefix

_STEM_KEYS = re.compile(r"^(conv1|bn1|conv2|bn2|layer1)\.")
# Sequential(conv, bn, relu, conv, bn, relu) of the mid / alt stems
_SEQ_STEM = {"conv0": "0", "bn0": "1", "conv1": "3", "bn1": "4"}


def load_torch_statedict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict file (or a saved module's ``state_dict()``) as
    CPU tensors without gradient, floating ones in float32."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            for k, v in sd.items() if hasattr(v, "detach")}


def _cam_prefix(parts: Tuple[str, ...], root: str) -> str:
    """A ``ContextAwareModule`` member -> the reference CAM's names
    (``rtpe/students.py:145-178``)."""
    name = parts[0]
    if name == "residual_conv":
        return f"{root}.residual.0"
    if name == "residual_bn":
        return f"{root}.residual.1"
    if name == "se":
        return f"{root}.se.fc." + {"fc1": "0", "fc2": "2"}[parts[1]]
    m = re.fullmatch(r"hdc(\d+)_(conv|bn)", name)
    if m:
        i, kind = m.groups()
        return f"{root}.hdcs.{i}.{0 if kind == 'conv' else 1}"
    if name == "hdc_top_conv":
        return f"{root}.hdc_top.0"
    if name == "hdc_top_bn":
        return f"{root}.hdc_top.1"
    raise KeyError(f"unknown CAM member {parts}")


def _skipconv_prefix(parts: Tuple[str, ...], root: str) -> str:
    """A ``SkipConv`` member -> the reference SkipConv's names
    (``rtpe/students.py:37-90``: ``convs`` / ``bns`` lists and
    ``downsample``)."""
    name = parts[0]
    m = re.fullmatch(r"(conv|bn)(\d+)", name)
    if m:
        kind, i = m.groups()
        return f"{root}.{'convs' if kind == 'conv' else 'bns'}.{i}"
    if name == "downsample_conv":
        return f"{root}.downsample.0"
    if name == "downsample_bn":
        return f"{root}.downsample.1"
    raise KeyError(f"unknown SkipConv member {parts}")


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.asarray(v))


@torch.no_grad()
def _load(model: nn.Module, sd: Mapping, ref_key: Callable[[str], str],
          strict: bool, dropped: Callable[[str], bool] = lambda k: False,
          keep: Callable[[str], bool] = lambda k: False) -> nn.Module:
    """Fill every key of ``model.state_dict()`` from ``sd[ref_key(port
    prefix) + "." + leaf]`` (``keep(key)``: the model's own value), then
    ``load_state_dict(strict=True)``.  ``dropped(ref key)``: reference
    keys that are consumed without a counterpart."""
    own = model.state_dict()
    out, used = {}, set()
    for key, tpl in own.items():
        if key.endswith("num_batches_tracked") or keep(key):
            out[key] = tpl
            continue
        prefix, leaf = key.rsplit(".", 1)
        rk = f"{ref_key(prefix)}.{leaf}"
        if rk not in sd:
            raise KeyError(f"torch statedict missing {rk} (for {key})")
        val = _as_tensor(sd[rk])
        if tuple(val.shape) != tuple(tpl.shape):
            raise ValueError(f"shape mismatch at {key}: torch "
                             f"{tuple(val.shape)} vs {tuple(tpl.shape)}")
        out[key] = val.to(tpl.dtype)
        used.add(rk)
    if strict:
        leftover = [k for k in sd if k not in used and not dropped(k)
                    and not k.endswith("num_batches_tracked")]
        if leftover:
            raise ValueError(f"unconsumed torch keys: {leftover[:10]}"
                             f" (+{max(0, len(leftover) - 10)} more)")
    model.load_state_dict(out, strict=True)
    return model


def _stem_key(prefix: str) -> Optional[str]:
    return "stem.1." + prefix[len("stem."):] \
        if prefix.startswith("stem.") else None


def import_attention_steps_statedict(model: nn.Module, sd: Mapping,
                                     strict: bool = False) -> nn.Module:
    """A torch ``AttentionStudentSteps`` state dict (reference
    ``rtpe/students.py:786-1073``) into the port's
    :class:`~rtpe_tpu_torch.models.AttentionStudentSteps`: stem, mid /
    alt stems, attention pyramid, steps and detection head.  Accepts both
    stem layouts, fp16-wrapped (``stem.1.``) and identity-wrapped
    (``half_precision=False``)."""

    def ref(prefix: str) -> str:
        stem = _stem_key(prefix)
        if stem is not None:
            return stem if any(k.startswith(stem + ".") for k in sd) \
                else prefix
        head, *rest = prefix.split(".")
        m = re.fullmatch(r"(mid|alt)_stem_(conv0|bn0|conv1|bn1)", head)
        if m:
            seq = "mid_stem" if m.group(1) == "mid" else "alt_img_stem"
            return f"{seq}.{_SEQ_STEM[m.group(2)]}"
        if head == "att":
            root = {"hi": "att_hi.0", "mid": "att_mid.1",
                    "lo": "att_lo.1"}[rest[0]]
            return _cam_prefix(tuple(rest[1:]), root)
        if head == "att_top":
            return "att_top.0"
        m = re.fullmatch(r"step(\d)", head)
        if m:
            return _cam_prefix(tuple(rest), f"steps.{m.group(1)}")
        if head == "det_top":
            return "steps.3"
        raise KeyError(f"unknown AttentionStudentSteps module {prefix}")

    return _load(model, sd, ref, strict)


def import_attention_student_statedict(model: nn.Module, sd: Mapping,
                                       strict: bool = False) -> nn.Module:
    """A full torch ``AttentionStudent`` state dict
    (``rtpe/students.py:595-781``) into the port's
    :class:`~rtpe_tpu_torch.models.AttentionStudent`.  The reference's
    ``det_mid`` branch, which its forward never calls, is dropped."""

    def ref(prefix: str) -> str:
        stem = _stem_key(prefix)
        if stem is not None:
            return stem
        head, *rest = prefix.split(".")
        m = re.fullmatch(r"mid_stem_(conv0|bn0|conv1|bn1)", head)
        if m:
            return f"mid_stem.{_SEQ_STEM[m.group(1)]}"
        if head == "att":
            root = {"hi": "att_hi.0", "mid": "att_mid.1",
                    "lo": "att_lo.1"}[rest[0]]
            return _cam_prefix(tuple(rest[1:]), root)
        if head == "att_top":
            return "att_top.0"
        if head in ("det_hi", "det_lo"):
            return _cam_prefix(tuple(rest), f"{head}."
                               f"{0 if head == 'det_hi' else 1}")
        if head == "det_top":
            return "det_top.0"
        raise KeyError(f"unknown AttentionStudent module {prefix}")

    return _load(model, sd, ref, strict,
                 dropped=lambda k: k.startswith("det_mid."))


def import_attention_student_parts(model: nn.Module, snapshot_dir: str,
                                   prefix: str) -> nn.Module:
    """A reference per-part ``AttentionStudent`` snapshot (the 4MB
    ``assets/pretrained_segm_4MB`` artifact, the reference's
    ``load_state_dicts`` contract, ``rtpe/students.py:708-722``) into the
    port's :class:`~rtpe_tpu_torch.models.AttentionStudent`, in place.

    Parts ``{prefix}{part}.statedict``: ``mid_stem`` (Sequential conv,
    bn, relu twice), ``att_hi`` (the CAM at Sequential index 0),
    ``att_mid`` / ``att_lo`` (AvgPool then the CAM, index 1) and
    ``att_top`` (the conv at index 0).  The stem and the detection body
    keep their values."""

    def part(name: str) -> Dict[str, torch.Tensor]:
        path = os.path.join(snapshot_dir, f"{prefix}{name}.statedict")
        return load_torch_statedict(path)

    sd = {}
    for name, root in (("mid_stem", "mid_stem"), ("att_top", "att_top"),
                       ("att_hi", "att_hi"), ("att_mid", "att_mid"),
                       ("att_lo", "att_lo")):
        sd.update({f"{root}.{k}": v for k, v in part(name).items()})

    def ref(p: str) -> str:
        head, *rest = p.split(".")
        m = re.fullmatch(r"mid_stem_(conv0|bn0|conv1|bn1)", head)
        if m:
            return f"mid_stem.{_SEQ_STEM[m.group(1)]}"
        if head == "att_top":
            return "att_top.0"
        root = {"hi": "att_hi.0", "mid": "att_mid.1",
                "lo": "att_lo.1"}[rest[0]]
        return _cam_prefix(tuple(rest[1:]), root)

    return _load(model, sd, ref, strict=False,
                 keep=lambda k: not k.startswith(("mid_stem_", "att.",
                                                  "att_top.")))


def import_student_statedict(model: nn.Module, sd: Mapping, kind: str,
                             strict: bool = False) -> nn.Module:
    """A full torch state dict of a legacy student into the port's.

    :param kind: ``"cam"`` (:class:`~rtpe_tpu_torch.models.CamStudent`,
      ``students.py:502-592``), ``"refiner"`` (``RefinerStudent``,
      :302-386) or ``"multistage"`` (``MultistageStudent``, :389-498).
    """
    if kind not in ("cam", "refiner", "multistage"):
        raise ValueError(f"unknown student kind {kind!r}")

    def ref(prefix: str) -> str:
        stem = _stem_key(prefix)
        if stem is not None:
            return stem
        head, *rest = prefix.split(".")
        if kind == "cam":
            if head == "mid_stem_conv":
                return "mid_stem.0"
            if head == "mid_stem_bn":
                return "mid_stem.1"
            m = re.fullmatch(r"cam(\d+)", head)
            if m:
                return _cam_prefix(tuple(rest), f"cams.{m.group(1)}")
            m = re.fullmatch(r"hm_conv(\d+)", head)
            if m:
                return f"hm_convs.{m.group(1)}"
        else:
            m = re.fullmatch(r"stage(\d+)", head)
            if m:
                return _skipconv_prefix(tuple(rest), f"stages.{m.group(1)}")
        raise KeyError(f"unknown {kind} module {prefix}")

    return _load(model, sd, ref, strict)


def import_stem_statedict(model: nn.Module, sd: Mapping,
                          submodule: str = "stem") -> nn.Module:
    """The stem of a (full) teacher state dict into ``model.<submodule>``,
    as ``StemHRNet.load_pretrained`` does (``rtpe/students.py:263-282``):
    the fp16 ``"1."`` prefix stripped, only the stem's keys read, every
    one of them consumed.  Other parameters keep their values."""
    sd = {k: v for k, v in strip_fp16_prefix(dict(sd)).items()
          if _STEM_KEYS.match(k)}
    _load(getattr(model, submodule), sd, lambda p: p, strict=True)
    return model
