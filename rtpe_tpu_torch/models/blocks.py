"""HRNet residual blocks and the HighResolutionModule.

Port of ``rtpe_tpu/models/blocks.py``.  Submodule names follow the
reference torch model (``conv1``, ``bn1``, ``downsample.0``,
``branches.<i>.<j>``, ``fuse_layers.<i>.<j>...``), so its state dict
loads as is.  Numerics follow the JAX modules: every BN runs in fp32,
activations are cast back to the compute dtype (the input's dtype)
after it, and residual and fuse sums are taken in fp32.
"""

from typing import List, Sequence

import torch
from torch import nn

from .layers import BatchNorm2d, conv, conv_bn, run_conv_bn


class BasicBlock(nn.Module):
    """3x3 conv-bn-relu x2 with identity (or projected) residual."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, stride),
                                         BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        out = torch.relu(self.bn1(self.conv1(x)).to(dtype))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else \
            self.downsample[1](self.downsample[0](x))
        return torch.relu(out + residual.float()).to(dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck with residual."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            conv(inplanes, planes * 4, 1, stride), BatchNorm2d(planes * 4))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        out = torch.relu(self.bn1(self.conv1(x)).to(dtype))
        out = torch.relu(self.bn2(self.conv2(out)).to(dtype))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else \
            self.downsample[1](self.downsample[0](x))
        return torch.relu(out + residual.float()).to(dtype)


BLOCK_TYPES = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class HighResolutionModule(nn.Module):
    """Parallel multi-resolution branches with full cross-scale fusion.

    Fuse step for output ``i`` from branch ``j``: identity (j == i);
    1x1 conv + BN + nearest x2^(j-i) upsample (j > i); a chain of
    strided 3x3 conv + BN (+ ReLU except the last) (j < i).  The sum is
    taken in fp32, then ReLU and the cast back to the compute dtype.
    """

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], num_inchannels: Sequence[int],
                 num_channels: Sequence[int],
                 multi_scale_output: bool = True):
        super().__init__()
        block_cls = BLOCK_TYPES[block]
        out_ch = [c * block_cls.expansion for c in num_channels]
        self.num_branches = num_branches
        self.multi_scale_output = multi_scale_output
        branches = []
        for i in range(num_branches):
            layers = []
            for j in range(num_blocks[i]):
                inp = num_inchannels[i] if j == 0 else out_ch[i]
                layers.append(block_cls(inp, num_channels[i], 1,
                                        j == 0 and inp != out_ch[i]))
            branches.append(nn.Sequential(*layers))
        self.branches = nn.ModuleList(branches)
        if num_branches == 1:
            self.fuse_layers = None
            return
        fuse = []
        for i in range(num_branches if multi_scale_output else 1):
            row = []
            for j in range(num_branches):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(nn.Sequential(
                        conv(out_ch[j], out_ch[i], 1), BatchNorm2d(out_ch[i]),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                else:
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.append(conv_bn(
                            out_ch[j], out_ch[i] if last else out_ch[j],
                            3, 2, 1, relu=not last))
                    row.append(nn.Sequential(*chain))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        dtype = ys[0].dtype
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    y = ys[j]
                elif j > i:
                    y = layer[2](layer[1](layer[0](ys[j])).to(dtype))
                else:
                    y = ys[j]
                    for seq in layer:
                        y = run_conv_bn(seq, y, dtype)
                acc = y.float() if acc is None else acc + y.float()
            fused.append(torch.relu(acc).to(dtype))
        return fused
