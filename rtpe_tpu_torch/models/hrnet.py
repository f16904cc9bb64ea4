"""HigherHRNet teacher as PyTorch modules.

Port of ``rtpe_tpu/models/hrnet.py``: stem -> 4-stage multi-resolution
trunk -> 1x1 final conv (17 heatmaps + 17 tags) -> cat -> 4x4/s2 deconv
+ 4 BasicBlocks -> 1x1 final conv (17 heatmaps).

The forward takes NCHW input and returns NCHW ``(coarse, refined)``:

* ``coarse``  — (B, num_joints + ae_dims, H/4, W/4) heatmaps + tags
* ``refined`` — (B, num_joints, H/2, W/2) higher-resolution heatmaps

Submodule names are the reference torch model's (``layer1.0.conv1``,
``stage2.0.branches.1.3.bn2``, ``final_layers.0``,
``deconv_layers.0.0.0``, ...), so the reference ``.pth.tar`` state dict
loads with ``load_state_dict`` after
:func:`rtpe_tpu_torch.io.jax_import.strip_fp16_prefix`.  The compute
dtype is the convolution weights' dtype (:meth:`set_compute_dtype`);
BatchNorm stays float32 (``models/layers.py``).
"""

import dataclasses
import math
from typing import List, Tuple

import torch
from torch import nn

from .blocks import BLOCK_TYPES, BasicBlock, Bottleneck, HighResolutionModule
from .layers import BatchNorm2d, conv, conv_bn, run_conv_bn


@dataclasses.dataclass(frozen=True)
class StageCfg:
    num_modules: int
    num_branches: int
    block: str
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    """Same fields and defaults as ``rtpe_tpu.models.HRNetConfig``."""

    num_joints: int = 17
    tag_per_joint: bool = True
    final_conv_ksize: int = 1
    inplanes: int = 64
    stage2: StageCfg = StageCfg(1, 2, "BASIC", (4, 4), (48, 96))
    stage3: StageCfg = StageCfg(4, 3, "BASIC", (4, 4, 4), (48, 96, 192))
    stage4: StageCfg = StageCfg(3, 4, "BASIC", (4, 4, 4, 4),
                                (48, 96, 192, 384))
    num_deconvs: int = 1
    deconv_chans: Tuple[int, ...] = (48,)
    deconv_ksize: Tuple[int, ...] = (4,)
    deconv_num_blocks: int = 4
    deconv_cat: Tuple[bool, ...] = (True,)
    with_ae_loss: Tuple[bool, ...] = (True, False)

    @property
    def ae_dims(self) -> int:
        return self.num_joints if self.tag_per_joint else 1


def w48_config() -> HRNetConfig:
    """The HigherHRNet-W48 teacher (63,827,139 parameters)."""
    return HRNetConfig()


def _stage_chans(scfg: StageCfg) -> List[int]:
    exp = BLOCK_TYPES[scfg.block].expansion
    return [c * exp for c in scfg.num_channels]


def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
    """Reference ``_make_transition_layer``: 3x3 conv-bn-relu where the
    width changes (``None`` where it does not); new branches are
    strided chains from the last previous branch."""
    layers = []
    for i, c in enumerate(cur):
        if i < len(pre):
            layers.append(conv_bn(pre[i], c, 3, 1, 1, relu=True)
                          if c != pre[i] else None)
        else:
            chain = []
            for j in range(i + 1 - len(pre)):
                out = c if j == i - len(pre) else pre[-1]
                chain.append(conv_bn(pre[-1], out, 3, 2, 1, relu=True))
            layers.append(nn.Sequential(*chain))
    return nn.ModuleList(layers)


def _stage(scfg: StageCfg, multi_scale_output: bool) -> nn.Sequential:
    chans = _stage_chans(scfg)
    mods = []
    for m in range(scfg.num_modules):
        mods.append(HighResolutionModule(
            scfg.num_branches, scfg.block, scfg.num_blocks, chans,
            scfg.num_channels,
            multi_scale_output or m < scfg.num_modules - 1))
    return nn.Sequential(*mods)


class PoseHigherHRNet(nn.Module):
    """HigherHRNet; see the module docstring."""

    def __init__(self, cfg: HRNetConfig = None):
        super().__init__()
        cfg = cfg or w48_config()
        self.cfg = cfg
        self.conv1 = conv(3, 64, 3, 2, 1)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv(64, 64, 3, 2, 1)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(
            *[Bottleneck(64 if i == 0 else 256, 64, 1, i == 0)
              for i in range(4)])

        s2, s3, s4 = (_stage_chans(cfg.stage2), _stage_chans(cfg.stage3),
                      _stage_chans(cfg.stage4))
        self.transition1 = _transition([256], s2)
        self.stage2 = _stage(cfg.stage2, True)
        self.transition2 = _transition(s2, s3)
        self.stage3 = _stage(cfg.stage3, True)
        self.transition3 = _transition(s3, s4)
        self.stage4 = _stage(cfg.stage4, False)

        fk = cfg.final_conv_ksize
        pad = 1 if fk == 3 else 0
        head_ch = [cfg.num_joints + (cfg.ae_dims if ae else 0)
                   for ae in cfg.with_ae_loss]
        finals = [conv(s4[0], head_ch[0], fk, 1, pad, bias=True)]
        deconvs = []
        in_ch = s4[0]
        for i in range(cfg.num_deconvs):
            if cfg.deconv_cat[i]:
                in_ch += head_ch[i]
            out_ch = cfg.deconv_chans[i]
            layers = [nn.Sequential(
                nn.ConvTranspose2d(in_ch, out_ch, cfg.deconv_ksize[i],
                                   stride=2, padding=1, bias=False),
                BatchNorm2d(out_ch), nn.ReLU())]
            layers += [nn.Sequential(BasicBlock(out_ch, out_ch))
                       for _ in range(cfg.deconv_num_blocks)]
            deconvs.append(nn.Sequential(*layers))
            finals.append(conv(out_ch, head_ch[i + 1], fk, 1, pad,
                               bias=True))
            in_ch = out_ch
        self.final_layers = nn.ModuleList(finals)
        self.deconv_layers = nn.ModuleList(deconvs)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def set_compute_dtype(self, dtype: torch.dtype) -> "PoseHigherHRNet":
        """Cast the (transposed) convolution parameters to ``dtype``;
        BatchNorm parameters and statistics stay float32."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)
        return self

    @staticmethod
    def _run_transition(layers: nn.ModuleList, xs: List[torch.Tensor],
                        dtype: torch.dtype) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(layers):
            if i < len(xs):
                outs.append(xs[i] if layer is None
                            else run_conv_bn(layer, xs[i], dtype))
            else:
                y = xs[-1]
                for seq in layer:
                    y = run_conv_bn(seq, y, dtype)
                outs.append(y)
        return outs

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
        dtype = self.dtype
        x = x.to(dtype)
        x = torch.relu(self.bn1(self.conv1(x)).to(dtype))
        x = torch.relu(self.bn2(self.conv2(x)).to(dtype))
        x = self.layer1(x)

        xs = self._run_transition(self.transition1, [x], dtype)
        for mod in self.stage2:
            xs = mod(xs)
        xs = self._run_transition(self.transition2, xs, dtype)
        for mod in self.stage3:
            xs = mod(xs)
        xs = self._run_transition(self.transition3, xs, dtype)
        for mod in self.stage4:
            xs = mod(xs)

        x = xs[0]
        y = self.final_layers[0](x)
        outputs = [y]
        for i, layers in enumerate(self.deconv_layers):
            if self.cfg.deconv_cat[i]:
                x = torch.cat([x, y], dim=1)
            x = run_conv_bn(layers[0], x, dtype)
            for blk in layers[1:]:
                x = blk(x)
            y = self.final_layers[i + 1](x)
            outputs.append(y)
        return tuple(outputs)


def init_random_(model: nn.Module, seed: int = 0,
                 gain: float = 1.0) -> nn.Module:
    """Seeded random weights (no pretrained weights ship with the repo).

    Convolutions draw from N(0, gain^2 / fan_in) — with the eval-mode
    BN below this keeps activations O(1) through the residual trunk —
    and BN gets non-trivial affine parameters and running statistics so
    that a BN or layout mistake shows in the outputs.
    """
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                          else w.shape[1]) * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=g)
                        * (gain / math.sqrt(fan_in)))
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g)
                                 * 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(
                    1.0 + 0.5 * torch.rand(n, generator=g))
    return model
