"""The BN-folded serving forward of the HigherHRNet-W48 teacher.

Port of ``rtpe_tpu/models/hrnet_packed.py`` (bf16 and float32; the int8
modes wait for a later slice).  The JAX module is the TPU's serving fast
path: inference BatchNorm folded into the convolutions once at load
time, and the high-resolution branch and deconv head in a row-packed
layout that answers the TPU's 128-lane padding.  The port keeps the
function and leaves the layout: the packed graph computes the same
function as the canonical model (``hrnet_packed.py:3-6``), so here it
runs dense, NCHW (channels_last on CUDA), with the folded weights.

Cast points are the packed graph's, not the canonical model's: every
conv accumulates in float32 and adds its float32 bias, each activation
is rounded to the model dtype where JAX's ``_store`` / ``astype`` round
it, and the residual and fuse sums are taken in the model dtype.  On
the CPU in float32 this is JAX's arithmetic up to summation order.  In
bf16 on CUDA, cuDNN returns the conv rounded to bf16, so adding the
float32 bias rounds a second time where JAX rounds once
(``preferred_element_type=float32``); the chain kernel
(``pallas_chains=True``) rounds once, as JAX does.  ``chip_smoke.py``
states the tolerance this costs against the kernel path.
"""

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.blocks import basicblock_chain
from ..ops.fold import fold_bn
from .hrnet import HRNetConfig, w48_config

PackedParams = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
STAGES = ((2, "stage2"), (3, "stage3"), (4, "stage4"))


def _check_cfg(cfg: HRNetConfig) -> None:
    """The packed path covers the teacher architecture family: BASIC
    stages whose branch-0 channel count is constant, one cat deconv."""
    c0 = cfg.stage2.num_channels[0]
    for scfg in (cfg.stage2, cfg.stage3, cfg.stage4):
        assert scfg.block == "BASIC", scfg.block
        assert scfg.num_channels[0] == c0, scfg.num_channels
    assert cfg.num_deconvs == 1 and cfg.deconv_cat[0], cfg
    assert cfg.deconv_ksize[0] == 4, cfg.deconv_ksize
    assert cfg.final_conv_ksize == 1, cfg.final_conv_ksize


def chain_key(module: str, branch: int) -> str:
    """Key of a branch's stacked chain weights, beside the per-conv
    ``{module}/branch{branch}_{j}/conv{1,2}`` entries."""
    return f"{module}/branch{branch}_chain"


def _stage_modules(cfg: HRNetConfig):
    for s, attr in STAGES:
        scfg = getattr(cfg, attr)
        for m in range(scfg.num_modules):
            yield f"stage{s}_{m}", f"stage{s}.{m}", scfg


def serving_params(folded: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
                   cfg: HRNetConfig, dtype: torch.dtype,
                   device: torch.device) -> PackedParams:
    """Folded float32 weights (port layouts: OIHW, and (in, out, kh, kw)
    for the transposed conv) -> the serving dict: weights in ``dtype``
    (channels_last on CUDA, as cuDNN takes them), biases float32, and
    for every branch > 0 of every stage module its chain stacked once
    in the layout the chain kernel reads: weights (n, 2, 3, 3, C, C)
    HWIO and biases (n, 2, C)."""
    out: PackedParams = {}
    for key, (w, b) in folded.items():
        w = w.to(device=device, dtype=dtype)
        if device.type == "cuda":
            w = w.contiguous(memory_format=torch.channels_last)
        out[key] = (w, b.to(device=device, dtype=torch.float32))
    for pfx, _, scfg in _stage_modules(cfg):
        for i in range(1, scfg.num_branches):
            names = [f"{pfx}/branch{i}_{j}/conv{c}"
                     for j in range(scfg.num_blocks[i]) for c in (1, 2)]
            n = scfg.num_blocks[i]
            w = torch.stack([folded[k][0].permute(2, 3, 1, 0) for k in names])
            b = torch.stack([folded[k][1] for k in names])
            out[chain_key(pfx, i)] = (
                w.reshape(n, 2, *w.shape[1:]).to(device=device, dtype=dtype)
                .contiguous(),
                b.reshape(n, 2, -1).to(device=device, dtype=torch.float32)
                .contiguous())
    return out


def pack_w48_params(state_dict: Mapping[str, torch.Tensor],
                    cfg: Optional[HRNetConfig] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> PackedParams:
    """Fold BN into the port's ``PoseHigherHRNet`` state dict (reference
    keys; the fp16 ``"1."`` prefix is stripped).

    Keeps the JAX function's name for the predictor and the factory but
    folds without row-packing (see the module docstring).

    :returns: flat dict ``name -> (weight, bias)`` under the JAX names
      (``conv1``, ``layer1_0/downsample``, ``stage3_1/branch2_0/conv1``,
      ``stage4_0/fuse0_3``, ``deconv0_tconv``, ``final_1``, ...), plus
      the stacked chains (:func:`chain_key`).
    :param device: where the result lives; default the state dict's.
    """
    from ..io.jax_import import strip_fp16_prefix

    cfg = cfg or w48_config()
    _check_cfg(cfg)
    sd = strip_fp16_prefix(state_dict)
    folded: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def conv_bn(key, conv, bn, out_axis=0):
        folded[key] = fold_bn(sd[f"{conv}.weight"], sd[f"{bn}.weight"],
                              sd[f"{bn}.bias"], sd[f"{bn}.running_mean"],
                              sd[f"{bn}.running_var"], out_axis)

    def with_bias(key, conv):
        folded[key] = (sd[f"{conv}.weight"].float(),
                       sd[f"{conv}.bias"].float())

    conv_bn("conv1", "conv1", "bn1")
    conv_bn("conv2", "conv2", "bn2")
    for i in range(4):
        for c in (1, 2, 3):
            conv_bn(f"layer1_{i}/conv{c}", f"layer1.{i}.conv{c}",
                    f"layer1.{i}.bn{c}")
        if f"layer1.{i}.downsample.0.weight" in sd:
            conv_bn(f"layer1_{i}/downsample", f"layer1.{i}.downsample.0",
                    f"layer1.{i}.downsample.1")
    conv_bn("transition1_0", "transition1.0.0", "transition1.0.1")
    for t in (1, 2, 3):
        conv_bn(f"transition{t}_{t}_0", f"transition{t}.{t}.0.0",
                f"transition{t}.{t}.0.1")
    for pfx, tp, scfg in _stage_modules(cfg):
        nb = scfg.num_branches
        for i in range(nb):
            for j in range(scfg.num_blocks[i]):
                for c in (1, 2):
                    blk = f"{tp}.branches.{i}.{j}"
                    conv_bn(f"{pfx}/branch{i}_{j}/conv{c}", f"{blk}.conv{c}",
                            f"{blk}.bn{c}")
        for i in range(nb):              # absent fuse rows are skipped
            for j in range(nb):
                if j > i:
                    tk = f"{tp}.fuse_layers.{i}.{j}"
                    if f"{tk}.0.weight" in sd:
                        conv_bn(f"{pfx}/fuse{i}_{j}", f"{tk}.0", f"{tk}.1")
                for k in range(i - j):
                    tk = f"{tp}.fuse_layers.{i}.{j}.{k}"
                    if f"{tk}.0.weight" in sd:
                        conv_bn(f"{pfx}/fuse{i}_{j}_{k}", f"{tk}.0",
                                f"{tk}.1")
    with_bias("final_0", "final_layers.0")
    # the transposed conv's weight is (in, out, kh, kw): BN scales axis 1
    conv_bn("deconv0_tconv", "deconv_layers.0.0.0", "deconv_layers.0.0.1",
            out_axis=1)
    for b in range(cfg.deconv_num_blocks):
        blk = f"deconv_layers.0.{b + 1}.0"
        for c in (1, 2):
            conv_bn(f"deconv0_block{b}/conv{c}", f"{blk}.conv{c}",
                    f"{blk}.bn{c}")
    with_bias("final_1", "final_layers.1")
    if device is None:
        device = next(iter(sd.values())).device
    return serving_params(folded, cfg, dtype, torch.device(device))


def fold_w48_params(state_dict: Mapping[str, torch.Tensor],
                    cfg: Optional[HRNetConfig] = None,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> PackedParams:
    """BN-folded weights in float32 by default: the JAX function's
    parameter form.  Here the same dict as :func:`pack_w48_params`."""
    return pack_w48_params(state_dict, cfg, dtype=dtype, device=device)


# ---------------------------------------------------------------- forward

def _conv(x: torch.Tensor, wb, stride: int = 1,
          relu: bool = False) -> torch.Tensor:
    """Folded conv: the conv, the float32 bias (one rounding to the
    activation dtype, in place), then the optional ReLU."""
    w, b = wb
    y = F.conv2d(x, w, None, stride, (w.shape[-1] - 1) // 2)
    y = y.add_(b[:, None, None])
    return y.relu_() if relu else y


def _basic_block(pk: PackedParams, name: str, x: torch.Tensor) -> torch.Tensor:
    out = _conv(x, pk[f"{name}/conv1"], relu=True)
    out = _conv(out, pk[f"{name}/conv2"])
    return out.add_(x).relu_()                      # the add in the dtype


def _bottleneck(pk: PackedParams, name: str, x: torch.Tensor) -> torch.Tensor:
    out = _conv(x, pk[f"{name}/conv1"], relu=True)
    out = _conv(out, pk[f"{name}/conv2"], relu=True)
    out = _conv(out, pk[f"{name}/conv3"])
    residual = (_conv(x, pk[f"{name}/downsample"])
                if f"{name}/downsample" in pk else x)
    return out.add_(residual).relu_()


def _chain(pk: PackedParams, key: str, x: torch.Tensor) -> torch.Tensor:
    """A branch's whole block chain through ``ops/blocks.py``: the CUDA
    kernel for a CUDA tensor, its plain version on the CPU.  On CUDA the
    forward's activations are channels_last, so their NHWC view goes in
    without a copy (the kernel refuses any other layout)."""
    w, b = pk[key]
    return basicblock_chain(x.permute(0, 2, 3, 1), w, b).permute(0, 3, 1, 2)


def _module(pk: PackedParams, pfx: str, scfg, xs: List[torch.Tensor],
            mso: bool, pallas_chains: bool) -> List[torch.Tensor]:
    nb = scfg.num_branches
    ys = []
    for i in range(nb):
        x = xs[i]
        if pallas_chains and i > 0:
            x = _chain(pk, chain_key(pfx, i), x)
        else:
            for j in range(scfg.num_blocks[i]):
                x = _basic_block(pk, f"{pfx}/branch{i}_{j}", x)
        ys.append(x)
    if nb == 1:
        return ys
    fused = []
    for i in range(nb if mso else 1):
        acc = None
        for j in range(nb):
            if j == i:
                y = ys[j]
            elif j > i:
                # 1x1 conv at the low resolution, then nearest upsampling
                y = F.interpolate(_conv(ys[j], pk[f"{pfx}/fuse{i}_{j}"]),
                                  scale_factor=2 ** (j - i), mode="nearest")
            else:
                y = ys[j]
                for k in range(i - j):
                    y = _conv(y, pk[f"{pfx}/fuse{i}_{j}_{k}"], stride=2,
                              relu=k < i - j - 1)
            acc = y if acc is None else acc + y     # the sum in the dtype
        fused.append(torch.relu(acc))
    return fused


def packed_forward(pk: PackedParams, x: torch.Tensor,
                   cfg: Optional[HRNetConfig] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   pallas_chains: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward on the folded weights of :func:`pack_w48_params`,
    the same outputs as the port's ``PoseHigherHRNet.forward``: NCHW
    ``(coarse, refined)`` in ``dtype`` from NCHW ``x``.

    :param pallas_chains: run the block chains of branches 1..3 of every
      stage module through the chain kernel (``csrc/basicblock_chain.cu``;
      the JAX keyword names its Pallas kernel).  On CUDA it takes bf16
      only, as the TPU kernel; on the CPU its plain version takes either
      dtype.  Branch 0 and every other conv run on cuDNN.
    """
    cfg = cfg or w48_config()
    _check_cfg(cfg)
    if pallas_chains and x.is_cuda and dtype != torch.bfloat16:
        raise TypeError(f"pallas_chains=True on CUDA takes bf16: the chain "
                        f"kernel is bf16-only, got {dtype}")
    x = x.to(dtype)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)

    x = _conv(x, pk["conv1"], stride=2, relu=True)
    x = _conv(x, pk["conv2"], stride=2, relu=True)
    for i in range(4):
        x = _bottleneck(pk, f"layer1_{i}", x)

    xs = [_conv(x, pk["transition1_0"], relu=True),
          _conv(x, pk["transition1_1_0"], stride=2, relu=True)]
    for s, attr in STAGES:
        scfg = getattr(cfg, attr)
        if s > 2:
            xs.append(_conv(xs[-1], pk[f"transition{s - 1}_{s - 1}_0"],
                            stride=2, relu=True))
        for m in range(scfg.num_modules):
            mso = s < 4 or m < scfg.num_modules - 1
            xs = _module(pk, f"stage{s}_{m}", scfg, xs, mso, pallas_chains)

    x0 = xs[0]
    y0 = _conv(x0, pk["final_0"])
    w, b = pk["deconv0_tconv"]
    xh = F.conv_transpose2d(torch.cat([x0, y0], dim=1), w, None, 2, 1)
    xh = xh.add_(b[:, None, None]).relu_()
    for blk in range(cfg.deconv_num_blocks):
        xh = _basic_block(pk, f"deconv0_block{blk}", xh)
    y1 = _conv(xh, pk["final_1"])
    return y0, y1
