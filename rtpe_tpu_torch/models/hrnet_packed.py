"""The BN-folded serving forward of the HigherHRNet-W48 teacher.

Port of ``rtpe_tpu/models/hrnet_packed.py``: bf16 and float32, and the
int8 modes (calibration, ``quantize_packed``, scale files, and the
``int8_act`` graph; ``ops/quant.py``).  The JAX module is the TPU's
serving fast path: inference BatchNorm folded into the convolutions
once at load time, and the high-resolution branch and deconv head in a
row-packed layout that answers the TPU's 128-lane padding.  The port keeps the
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

import json
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.blocks import basicblock_chain
from ..ops.quant import (QConv, kernel_layout, qconv, quantize_act,
                         quantize_tconv_weight, quantize_weight)
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


# ------------------------------------------------------------- int8 path
#
# Port of ``rtpe_tpu/models/hrnet_packed.py:180-310``: calibration of the
# static activation scales, quantization of the folded weights and the
# scale files.  Calibration runs on the device and in the dtype of the
# params it is given; JAX moves it to its CPU backend only to spare the
# TPU's compiler a graph with ~300 outputs, which the port does not need.

_ACT_SCALES_FORMAT = "rtpe_tpu-act-scales-v1"


def conv_names(pk: Mapping) -> List[str]:
    """The conv entries of a serving dict, one for each convolution of
    the graph (the stacked chains, :func:`chain_key`, left out): the
    keys of JAX's ``PackedParams``."""
    return [k for k in pk if not k.endswith("_chain")]


def _quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (method "linear") of a flat float32 tensor,
    in float32 step for step.  ``torch.quantile`` refuses inputs above
    2^24 elements, so the two order statistics come from a sort."""
    n = a.numel()
    pos = torch.tensor(q, dtype=torch.float32) * (
        torch.tensor(float(n), dtype=torch.float32) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    srt = torch.sort(a).values
    lo = int(low.clamp(0, n - 1))
    hi = int(high.clamp(0, n - 1))
    return srt[lo] * low_w.to(a.device) + srt[hi] * high_w.to(a.device)


def _act_range(t: torch.Tensor, q: Optional[float]) -> torch.Tensor:
    a = t.float().abs().reshape(-1)
    return a.max() if q is None else _quantile_linear(a, q / 100.0)


class _CalibEntry:
    """Calibration wrapper of one conv's ``(weight, bias)``: records into
    ``store`` the range of its input (and, for a fuse conv, of its
    output) — max |x|, or the ``q``-th percentile of |x| when set."""

    __slots__ = ("w", "b", "store", "q")

    def __init__(self, w, b, store, q=None):
        self.w, self.b, self.store, self.q = w, b, store, q

    def record(self, key: str, t: torch.Tensor) -> None:
        v = _act_range(t, self.q)
        prev = self.store.get(key)
        self.store[key] = v if prev is None else torch.maximum(prev, v)


@torch.inference_mode()
def calibrate_act_scales(pk: PackedParams, xs: Iterable[torch.Tensor],
                         cfg: Optional[HRNetConfig] = None,
                         dtype: torch.dtype = torch.bfloat16,
                         percentile: Optional[float] = None
                         ) -> Dict[str, float]:
    """Per-conv input range over the calibration batches ``xs`` (NCHW, on
    ``pk``'s device), through the float forward in ``dtype``: max |x|, or
    with ``percentile`` (e.g. 99.9) that percentile of |x| (``jnp.quantile``'s
    linear interpolation), reduced over the batches by the maximum.  Fuse
    convs also get ``"<name>:out"``, their output's range (the scale
    ``int8_act`` stores their operands with).

    :returns: ``name -> float``, the scale set of
      ``rtpe_tpu.models.hrnet_packed.calibrate_act_scales``.
    """
    cfg = cfg or w48_config()
    scales: Dict[str, float] = {}
    for x in xs:
        store: Dict[str, torch.Tensor] = {}
        calib = {k: _CalibEntry(*pk[k], store, percentile)
                 for k in conv_names(pk)}
        packed_forward(calib, x, cfg, dtype)
        keys = list(store)
        values = torch.stack([store[k].float() for k in keys]).cpu().tolist()
        for k, v in zip(keys, values):
            scales[k] = max(scales.get(k, 0.0), float(v))
    return scales


def quantize_packed(pk: PackedParams, act_scales: Mapping[str, float]
                    ) -> Dict[str, QConv]:
    """Folded weights -> one :class:`~rtpe_tpu_torch.ops.quant.QConv` a
    conv (per-channel int8 weights, the static activation scale of
    :func:`calibrate_act_scales`), on the weights' device.

    JAX's arithmetic: ``amax <= 0`` becomes 1e-6; ``inv_sx`` is ``127 /
    amax`` in double, rounded once to float32; ``alpha`` the float32
    product of ``s_w`` and ``float32(amax / 127)``; a fuse conv's
    ``inv_sy`` from its ``":out"`` range.  The transposed conv's weights
    get a scale per output-row parity and channel, as JAX's row-packed
    kernel has them (``quantize_tconv_weight``).  The result drops into
    :func:`packed_forward`; not with ``pallas_chains`` (the chain kernel
    is bf16-only)."""
    out: Dict[str, QConv] = {}
    for name in conv_names(pk):
        w, b = pk[name]
        amax = float(act_scales[name])
        if amax <= 0.0:
            amax = 1e-6
        transposed = name.endswith("tconv")
        w_q, s_w = (quantize_tconv_weight(w) if transposed
                    else quantize_weight(w))
        f32 = dict(dtype=torch.float32, device=w.device)
        inv_sy = None
        out_amax = act_scales.get(f"{name}:out")
        if out_amax is not None:
            inv_sy = torch.tensor(127.0 / max(float(out_amax), 1e-6), **f32)
        kernel, cin = kernel_layout(w_q, transposed)
        out[name] = QConv(kernel=kernel, bias=b.float().contiguous(),
                          alpha=s_w * torch.tensor(amax / 127.0, **f32),
                          inv_sx=torch.tensor(127.0 / amax, **f32),
                          cin=cin, transposed=transposed, inv_sy=inv_sy)
    return out


def save_act_scales(path: str, act_scales: Mapping[str, float]) -> None:
    """Write a scale set as the JAX package's JSON (same format marker,
    read by either package's :func:`load_act_scales`), atomically: the
    file is the complete set or absent."""
    payload = {"format": _ACT_SCALES_FORMAT,
               "num_entries": len(act_scales),
               "scales": {k: float(v) for k, v in act_scales.items()}}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_act_scales(path: str) -> Dict[str, float]:
    """Read a scale set written by either package's ``save_act_scales``;
    a foreign or truncated file raises ``ValueError``."""
    with open(path) as f:
        payload = json.load(f)
    got = (payload.get("format") if isinstance(payload, dict)
           else type(payload).__name__)
    if got != _ACT_SCALES_FORMAT:
        raise ValueError(f"{path}: not an activation-scale file (expected "
                         f"format={_ACT_SCALES_FORMAT!r}, got {got!r})")
    scales = payload.get("scales")
    if not isinstance(scales, dict) \
            or len(scales) != payload.get("num_entries"):
        raise ValueError(f"{path}: truncated or inconsistent scale set")
    return {k: float(v) for k, v in scales.items()}


# ---------------------------------------------------------------- forward
#
# Every conv of the graph goes through _conv, which dispatches on its
# entry, as JAX's _apply does: a (weight, bias) pair runs in the
# activation dtype on cuDNN, a QConv on the int8 kernel (float32 out), a
# _CalibEntry records its ranges around the float conv.  With int8_act
# every stored inter-layer tensor is int8 at its consumer conv's scale
# (consumers of one tensor calibrate the same scale: they see the same
# values), and the residual and fuse sums read it back dequantized.


class _Graph:
    """What the convs of one forward share: the params, the activation
    dtype, int8-act storage, and the census of stored activations."""

    __slots__ = ("pk", "dtype", "ia", "census")

    def __init__(self, pk, dtype, ia, census):
        self.pk, self.dtype, self.ia, self.census = pk, dtype, ia, census


def _float_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int, transposed: bool) -> torch.Tensor:
    """Folded conv in the activation dtype: the conv, then the float32
    bias (one rounding to the dtype, in place)."""
    if transposed:
        y = F.conv_transpose2d(x, w, None, 2, 1)
    else:
        y = F.conv2d(x, w, None, stride, (w.shape[-1] - 1) // 2)
    return y.add_(b[:, None, None])


def _conv(g: _Graph, x: torch.Tensor, name: str, stride: int = 1,
          relu: bool = False, upsample: int = 1) -> torch.Tensor:
    """One conv of the graph (the transposed one is ``*tconv``), then
    the nearest ``upsample`` of a fuse conv at the low resolution, then
    the optional ReLU."""
    wb = g.pk[name]
    transposed = name.endswith("tconv")
    if isinstance(wb, QConv):
        y = (qconv(x, wb, 2, 1) if transposed else qconv(x, wb, stride))
    elif isinstance(wb, _CalibEntry):
        wb.record(name, x)
        y = _float_conv(x, wb.w, wb.b, stride, transposed)
    else:
        y = _float_conv(x, *wb, stride, transposed)
    if upsample > 1:
        y = F.interpolate(y, scale_factor=upsample, mode="nearest")
    if isinstance(wb, _CalibEntry) and "/fuse" in name:
        # a fuse conv feeds the fuse sum, not a conv: its output range is
        # the scale int8_act stores it with (QConv.inv_sy)
        wb.record(name + ":out", y)
    return y.relu_() if relu else y


def _store(g: _Graph, y: torch.Tensor, consumer: Optional[str]
           ) -> torch.Tensor:
    """Materialize an activation: int8 at its consumer conv's scale when
    int8_act is on and the consumer is quantized, else in the dtype."""
    out = None
    if g.ia and consumer is not None:
        wb = g.pk.get(consumer)
        if isinstance(wb, QConv):
            out = quantize_act(y, wb.inv_sx)
    if out is None:
        out = y.to(g.dtype)
    if g.census is not None:
        g.census.append((consumer, tuple(y.shape), out.dtype))
    return out


def _loadf(g: _Graph, x: torch.Tensor, consumer: str) -> torch.Tensor:
    """Float32 view of a stored activation for a residual or fuse sum:
    an int8 one is divided by its scale, as in JAX."""
    if x.dtype == torch.int8:
        return x.float() / g.pk[consumer].inv_sx
    return x


def _operand(g: _Graph, y: torch.Tensor, name: str) -> torch.Tensor:
    """A fuse conv's result, consumed by the fuse sum: with int8_act and
    an output scale, stored int8 at it and read back dequantized."""
    if g.ia:
        wb = g.pk.get(name)
        if isinstance(wb, QConv) and wb.inv_sy is not None:
            q = quantize_act(y, wb.inv_sy)
            if g.census is not None:
                g.census.append((name + ":out", tuple(y.shape), q.dtype))
            return (q.float() / wb.inv_sy).to(g.dtype)
    return y.to(g.dtype)


def _basic_block(g: _Graph, name: str, x: torch.Tensor,
                 out_consumer: Optional[str] = None) -> torch.Tensor:
    out = _conv(g, x, f"{name}/conv1", relu=True)
    out = _store(g, out, f"{name}/conv2")
    out = _conv(g, out, f"{name}/conv2")
    if g.ia:
        res = _loadf(g, x, f"{name}/conv1").to(g.dtype)
        return _store(g, torch.relu(out.to(g.dtype) + res), out_consumer)
    return out.to(g.dtype).add_(x).relu_()          # the add in the dtype


def _bottleneck(g: _Graph, name: str, x: torch.Tensor,
                out_consumer: Optional[str] = None) -> torch.Tensor:
    out = _conv(g, x, f"{name}/conv1", relu=True)
    out = _store(g, out, f"{name}/conv2")
    out = _conv(g, out, f"{name}/conv2", relu=True)
    out = _store(g, out, f"{name}/conv3")
    out = _conv(g, out, f"{name}/conv3")
    ds = f"{name}/downsample"
    if g.ia:
        # an int8 x feeds the downsample directly: its scale is conv1's
        residual = (_conv(g, x, ds) if ds in g.pk
                    else _loadf(g, x, f"{name}/conv1")).to(g.dtype)
        return _store(g, torch.relu(out.to(g.dtype) + residual),
                      out_consumer)
    residual = _conv(g, x, ds).to(g.dtype) if ds in g.pk else x
    return out.to(g.dtype).add_(residual).relu_()


def _chain(pk: PackedParams, key: str, x: torch.Tensor) -> torch.Tensor:
    """A branch's whole block chain through ``ops/blocks.py``: the CUDA
    kernel for a CUDA tensor, its plain version on the CPU.  On CUDA the
    forward's activations are channels_last, so their NHWC view goes in
    without a copy (the kernel refuses any other layout)."""
    w, b = pk[key]
    return basicblock_chain(x.permute(0, 2, 3, 1), w, b).permute(0, 3, 1, 2)


def _ys_consumer(pfx: str, scfg, j: int, mso: bool) -> Optional[str]:
    """The canonical consumer conv of branch ``j``'s chain output inside
    a module: branch j > 0 feeds the branch-0 upsampling fuse; branch 0
    the first downsampling chain, where the module has several
    outputs."""
    if j > 0:
        return f"{pfx}/fuse0_{j}"
    if mso and scfg.num_branches > 1:
        return f"{pfx}/fuse1_0_0"
    return None


def _module(g: _Graph, pfx: str, scfg, xs: List[torch.Tensor], mso: bool,
            pallas_chains: bool, out_consumers: Sequence[str]
            ) -> List[torch.Tensor]:
    nb = scfg.num_branches
    ys = []
    for i in range(nb):
        x = xs[i]
        if pallas_chains and i > 0:
            x = _chain(g.pk, chain_key(pfx, i), x)
        else:
            for j in range(scfg.num_blocks[i]):
                last = j == scfg.num_blocks[i] - 1
                oc = (_ys_consumer(pfx, scfg, i, mso) if last
                      else f"{pfx}/branch{i}_{j + 1}/conv1")
                x = _basic_block(g, f"{pfx}/branch{i}_{j}", x, oc)
        ys.append(x)
    if nb == 1:
        return ys
    fused = []
    for i in range(nb if mso else 1):
        acc = None
        for j in range(nb):
            if j == i:
                y = (_loadf(g, ys[j], _ys_consumer(pfx, scfg, j, mso)
                            ).to(g.dtype) if g.ia else ys[j])
            elif j > i:
                # 1x1 conv at the low resolution, then nearest upsampling
                name = f"{pfx}/fuse{i}_{j}"
                y = _operand(g, _conv(g, ys[j], name, upsample=2 ** (j - i)),
                             name)
            else:
                y = ys[j]
                for k in range(i - j):
                    name = f"{pfx}/fuse{i}_{j}_{k}"
                    y = _conv(g, y, name, stride=2)
                    if k == i - j - 1:
                        y = _operand(g, y, name)
                    else:
                        y = torch.relu(y.to(g.dtype))
                        if g.ia:
                            y = _store(g, y, f"{pfx}/fuse{i}_{j}_{k + 1}")
            acc = y if acc is None else acc + y     # the sum in the dtype
        if g.ia:
            fused.append(_store(g, torch.relu(acc), out_consumers[i]))
        else:
            fused.append(torch.relu(acc))
    return fused


def packed_forward(pk: Mapping, x: torch.Tensor,
                   cfg: Optional[HRNetConfig] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   pallas_chains: bool = False, int8_act: bool = False,
                   census: Optional[list] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward on the folded weights of :func:`pack_w48_params`
    (or their :func:`quantize_packed` entries), the same outputs as the
    port's ``PoseHigherHRNet.forward``: NCHW ``(coarse, refined)`` in
    ``dtype`` from NCHW ``x``.

    :param pallas_chains: run the block chains of branches 1..3 of every
      stage module through the chain kernel (``csrc/basicblock_chain.cu``;
      the JAX keyword names its Pallas kernel).  On CUDA it takes bf16
      only, as the TPU kernel; on the CPU its plain version takes either
      dtype.  Branch 0 and every other conv run on cuDNN.  Not with int8
      entries or ``int8_act``.
    :param int8_act: (int8 entries only) store every inter-layer
      activation int8 at its consumer conv's static scale, the fuse
      operands at their own output scale, and the head's concat at the
      transposed conv's.
    :param census: a list that gets one ``(consumer, shape, dtype)`` for
      each stored activation, in order: the port's ``STORE_TAP``.
    """
    cfg = cfg or w48_config()
    _check_cfg(cfg)
    quantized = any(isinstance(v, QConv) for v in pk.values())
    if pallas_chains and (int8_act or quantized):
        raise ValueError("pallas_chains takes neither int8 entries nor "
                         "int8_act: the chain kernel is bf16-only")
    if int8_act and not isinstance(pk.get("deconv0_tconv"), QConv):
        raise ValueError("int8_act=True takes the QConv entries of "
                         "quantize_packed")
    if pallas_chains and x.is_cuda and dtype != torch.bfloat16:
        raise TypeError(f"pallas_chains=True on CUDA takes bf16: the chain "
                        f"kernel is bf16-only, got {dtype}")
    g = _Graph(pk, dtype, bool(int8_act), census)
    x = x.to(dtype)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)

    x = _store(g, _conv(g, x, "conv1", stride=2, relu=True), "conv2")
    x = _store(g, _conv(g, x, "conv2", stride=2, relu=True),
               "layer1_0/conv1")
    for i in range(4):
        oc = f"layer1_{i + 1}/conv1" if i < 3 else "transition1_0"
        x = _bottleneck(g, f"layer1_{i}", x, oc)

    xs = [_store(g, _conv(g, x, "transition1_0", relu=True),
                 "stage2_0/branch0_0/conv1"),
          _store(g, _conv(g, x, "transition1_1_0", stride=2, relu=True),
                 "stage2_0/branch1_0/conv1")]
    for s, attr in STAGES:
        scfg = getattr(cfg, attr)
        if s > 2:
            xs.append(_store(
                g, _conv(g, xs[-1], f"transition{s - 1}_{s - 1}_0",
                         stride=2, relu=True),
                f"stage{s}_0/branch{s - 1}_0/conv1"))
        for m in range(scfg.num_modules):
            last = m == scfg.num_modules - 1
            mso = s < 4 or not last
            nxt = f"stage{s + 1}_0" if last else f"stage{s}_{m + 1}"
            ocs = ([f"{nxt}/branch{i}_0/conv1"
                    for i in range(scfg.num_branches)] if mso
                   else ["final_0"])
            xs = _module(g, f"stage{s}_{m}", scfg, xs, mso, pallas_chains,
                         ocs)

    x0 = xs[0]
    y0 = _conv(g, x0, "final_0").to(dtype)
    if g.ia:
        # dequantize x0, widen y0, concat, requantize at the transposed
        # conv's own (concat) scale
        cat = torch.cat([_loadf(g, x0, "final_0"), y0.float()], dim=1)
        xh = quantize_act(cat, pk["deconv0_tconv"].inv_sx)
    else:
        xh = torch.cat([x0, y0], dim=1)
    if xh.is_cuda:
        xh = xh.contiguous(memory_format=torch.channels_last)
    xh = _store(g, _conv(g, xh, "deconv0_tconv", relu=True),
                "deconv0_block0/conv1")
    for blk in range(cfg.deconv_num_blocks):
        oc = (f"deconv0_block{blk + 1}/conv1"
              if blk < cfg.deconv_num_blocks - 1 else "final_1")
        xh = _basic_block(g, f"deconv0_block{blk}", xh, oc)
    y1 = _conv(g, xh, "final_1").to(dtype)
    return y0, y1
