"""The attention student and its building blocks (port of
``rtpe_tpu/models/students.py``: ``SELayer``, ``ContextAwareModule``,
``_CamPyramid``, ``AttentionStudentSteps``).

NCHW ``nn.Module``s on cuDNN; the fused CAM kernels read NHWC, which an
NCHW activation in ``channels_last`` memory is without a copy.
Parameters are float32; convolutions and dense layers compute in the
module's ``dtype`` (bf16 on CUDA), BatchNorm as
:mod:`rtpe_tpu_torch.models.layers` says.  Module names follow the JAX
tree (``att.hi.hdc0_conv``, ``step2.hdc_top_bn``, ``stem.layer1.0``), so
:func:`rtpe_tpu_torch.io.jax_import.student_state_dict_from_jax` carries
JAX variables across by name.

The JAX module's quirks and cast points are kept: the pyramid returns
``hi + 2 * up(lo)``; the attention map is ``sigmoid(att_top / divisor)``
in float32 and multiplies the features; the resized alt image and (with
``detach_att_for_det``) the attention map on the detection path carry
no gradient; the stem and ``mid_stem`` are frozen (no gradient, but
their BN runs train-mode and updates its running statistics).
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cam import fused_cam
from ..ops.pooling import avg_pool, global_avg_pool
from ..ops.resize import resize_bilinear, resize_nearest
from .layers import BatchNorm2d, conv, update_running_stats
from .stem import STEM_OUT_CHANS, StemHRNet


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype)``: the product in ``dtype``, then the
    bias added in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def _conv_bn_relu(conv_m, bn, x, dtype):
    return torch.relu(bn(conv_m(x)).to(dtype))


class SELayer(nn.Module):
    """Squeeze-excitation gate (reference :118-142).  Returns the gate,
    (B, C, 1, 1); the caller multiplies."""

    def __init__(self, chans: int, hidden_chans: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = hidden_chans or chans // 4
        self.dtype = dtype
        self.fc1 = nn.Linear(chans, hidden)
        self.fc2 = nn.Linear(hidden, chans)

    def forward(self, x: torch.Tensor, pooled: bool = False) -> torch.Tensor:
        # ``pooled``: x is already the (B, C) mean (the fused CAM's F1)
        y = x if pooled else global_avg_pool(_nhwc(x))
        y = torch.relu(_dense(y, self.fc1, self.dtype))
        y = _dense(y, self.fc2, self.dtype)
        y = torch.sigmoid(y.float()).to(self.dtype)
        return y[:, :, None, None]


class ContextAwareModule(nn.Module):
    """PCR context-aware module (reference :145-201):
    ``relu(residual(x) + SE_gate(x) * HDC(x))``, channel-preserving.

    ``fused=True`` routes train-mode applications through the fused CAM
    kernels (:func:`rtpe_tpu_torch.ops.cam.fused_cam`) with the same
    parameters and flax's running-statistic update; eval mode always runs
    the unfused path.
    """

    def __init__(self, chans: int, hdc_dilations: Sequence[int] = (1, 2, 3, 4),
                 se_chans: Optional[int] = None,
                 hdc_chans: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        self.chans = chans
        self.dils = tuple(hdc_dilations)
        self.hdc_ch = hdc_chans or chans // 4
        self.dtype = dtype
        self.fused = fused
        self.residual_conv = conv(chans, chans, 1)
        self.residual_bn = BatchNorm2d(chans)
        self.se = SELayer(chans, se_chans, dtype)
        for i, d in enumerate(self.dils):
            setattr(self, f"hdc{i}_conv",
                    conv(chans, self.hdc_ch, 3, 1, d, dilation=d))
            setattr(self, f"hdc{i}_bn", BatchNorm2d(self.hdc_ch))
        self.hdc_top_conv = conv(len(self.dils) * self.hdc_ch, chans, 1)
        self.hdc_top_bn = BatchNorm2d(chans)

    def _branch(self, i: int):
        return getattr(self, f"hdc{i}_conv"), getattr(self, f"hdc{i}_bn")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.training:
            return self._fused_forward(x)
        dtype = self.dtype
        x = x.to(dtype)
        residual = _conv_bn_relu(self.residual_conv, self.residual_bn, x,
                                 dtype)
        gate = self.se(x)
        outs = [_conv_bn_relu(*self._branch(i), x, dtype)
                for i in range(len(self.dils))]
        y = _conv_bn_relu(self.hdc_top_conv, self.hdc_top_bn,
                          torch.cat(outs, 1), dtype)
        out = residual.float() + (y * gate).float()
        return torch.relu(out).to(dtype)

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode application through the fused kernels: the same
        parameters as the unfused path, flax's running-stat update."""
        bf = torch.bfloat16
        nb, hc, c = len(self.dils), self.hdc_ch, self.chans
        bns = [self._branch(i)[1] for i in range(nb)]
        kr = self.residual_conv.weight[:, :, 0, 0].t().to(bf)
        kh = torch.stack([self._branch(i)[0].weight.permute(2, 3, 1, 0)
                          for i in range(nb)]).to(bf)
        kt = self.hdc_top_conv.weight[:, :, 0, 0].t().reshape(nb, hc, c).to(bf)

        def gate_fn(gap):
            return self.se(gap.to(self.dtype), pooled=True)[:, :, 0, 0].float()

        out, stats = fused_cam(
            _nhwc(x).to(bf), kr, kh, kt,
            scales={"r": self.residual_bn.weight,
                    "t": self.hdc_top_bn.weight,
                    "h": torch.stack([b.weight for b in bns])},
            biases={"r": self.residual_bn.bias, "t": self.hdc_top_bn.bias,
                    "h": torch.stack([b.bias for b in bns])},
            gate_fn=gate_fn, dils=self.dils)
        update_running_stats(self.residual_bn, *stats["r"])
        update_running_stats(self.hdc_top_bn, *stats["t"])
        for i, bn in enumerate(bns):
            update_running_stats(bn, stats["h"][0][i], stats["h"][1][i])
        return _nchw(out).to(self.dtype)


class _CamPyramid(nn.Module):
    """Three-scale CAM pyramid (reference :652-706): ``mid`` runs on the
    3/2/1-average-pooled input, ``lo`` on the pooled ``mid``, and

    quirk: the reference overwrites its ``mid`` variable with the
    upsampled ``lo`` (students.py:739-743,998-1001), so the output is
    ``hi + 2 * upsample(lo)``; reproduced here.
    """

    def __init__(self, chans: int, hdc_dilations: Sequence[int],
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        for name in ("hi", "mid", "lo"):
            setattr(self, name, ContextAwareModule(chans, hdc_dilations,
                                                   dtype=dtype, fused=fused))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[2:])
        hi = self.hi(x)
        mid = self.mid(_nchw(avg_pool(_nhwc(x), 3, 2, 1,
                                      count_include_pad=False)))
        lo = self.lo(_nchw(avg_pool(_nhwc(mid), 3, 2, 1,
                                    count_include_pad=False)))
        lo_up = _nchw(resize_nearest(_nhwc(lo), hw))
        return hi + lo_up + lo_up


class AttentionStudentSteps(nn.Module):
    """The student trained by distillation (reference :786-1073).

    ``forward(x, alt, att_divisor=None)``: ``x`` the normalised RGB image
    and ``alt`` its LAB/HSV version, both (B, 3, H, W).  Returns
    ``(att, det)``: the sigmoided attention map (B, 1, H/4, W/4) in
    float32 and the detection heatmap logits (B, num_heatmaps + ae_dims,
    H/4, W/4) in ``dtype``.
    """

    def __init__(self, inplanes: int = 80, num_heatmaps: int = 17,
                 ae_dims: int = 0, alt_planes: int = 50,
                 trainable_stem: bool = False,
                 detach_att_for_det: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_cam: bool = False):
        super().__init__()
        self.inplanes = inplanes
        self.trainable_stem = trainable_stem
        self.detach_att_for_det = detach_att_for_det
        self.dtype = dtype
        self.fused_cam = fused_cam
        mid_ch = (STEM_OUT_CHANS + inplanes) // 2
        self.stem = StemHRNet()
        self.mid_stem_conv0 = conv(STEM_OUT_CHANS, mid_ch, 3, 1, 1)
        self.mid_stem_bn0 = BatchNorm2d(mid_ch)
        self.mid_stem_conv1 = conv(mid_ch, inplanes, 3, 1, 1)
        self.mid_stem_bn1 = BatchNorm2d(inplanes)
        self.alt_stem_conv0 = conv(3, alt_planes, 5, 2, 2)
        self.alt_stem_bn0 = BatchNorm2d(alt_planes)
        self.alt_stem_conv1 = conv(alt_planes, inplanes, 5, 2, 2)
        self.alt_stem_bn1 = BatchNorm2d(inplanes)
        self.att = _CamPyramid(inplanes + 3, (1, 2, 3, 4), dtype, fused_cam)
        self.att_top = conv(inplanes + 3, 1, 3, 1, 1, bias=True)
        for i in range(3):
            setattr(self, f"step{i}", ContextAwareModule(
                2 * inplanes + 3, (1, 2, 3), dtype=dtype, fused=fused_cam))
        self.det_top = conv(2 * inplanes + 3, num_heatmaps + ae_dims, 3, 1, 1,
                            bias=True)

    def forward(self, x: torch.Tensor, alt: torch.Tensor,
                att_divisor: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.dtype
        # quirk: mid_stem sits inside the frozen-stem no_grad block
        # (students.py:978-980), so it is frozen with the stem
        with torch.set_grad_enabled(self.trainable_stem
                                    and torch.is_grad_enabled()):
            s = self.stem(x, dtype)
            s = _conv_bn_relu(self.mid_stem_conv0, self.mid_stem_bn0, s,
                              dtype)
            s = _conv_bn_relu(self.mid_stem_conv1, self.mid_stem_bn1, s,
                              dtype)
        if not self.trainable_stem:
            s = s.detach()
        # alt-image stem (trainable; outside no_grad, students.py:982)
        a = _conv_bn_relu(self.alt_stem_conv0, self.alt_stem_bn0,
                          alt.to(dtype), dtype)
        alt_stem_out = _conv_bn_relu(self.alt_stem_conv1, self.alt_stem_bn1,
                                     a, dtype)
        # the bilinear-resized alt image (align_corners=False,
        # students.py:989-992) joins the stem features, without gradient
        hw = tuple(s.shape[2:])
        alt_small = _nchw(resize_bilinear(_nhwc(alt.to(dtype)), hw,
                                          align_corners=False)).detach()
        s = torch.cat([s, alt_small], 1)

        att = self.att_top(self.att(s)).float()
        if att_divisor is not None:
            att = att / att_divisor
        att = torch.sigmoid(att)
        att_for_det = att.detach() if self.detach_att_for_det else att
        s = s * att_for_det.to(dtype)
        s = torch.cat([s, alt_stem_out], 1)
        for i in range(3):
            s = getattr(self, f"step{i}")(s)
        return att, self.det_top(s)


@torch.no_grad()
def init_student_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights with flax's default initialisers: conv and
    dense weights N(0, 1/fan_in), biases 0, BN scale 1 and bias 0, running
    mean 0 and variance 1.  Draws on the CPU from ``torch.Generator``
    seeded with ``seed``, whatever the model's device."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=g) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model
