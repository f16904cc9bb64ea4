"""The int8 graph's fused elementwise pass: the CUDA kernel
``csrc/qfuse.cu`` and its plain PyTorch version.

Port of what XLA fuses in ``rtpe_tpu/models/hrnet_packed.py``'s int8
graph around the convolutions that are not conv epilogues: the HRNet
fuse sum (``_module``: the branch's own activation and the fuse convs'
nearest-upsampled, dequantized operands summed in the model dtype, a
rounding after each add, the ReLU, the store in the dtype and / or int8
at the consumer's scale) and ``quantize_act`` where no conv produces the
int8 (the network input, the head's concat).  :func:`fuse_sum` runs the
kernel for CUDA tensors and :func:`fuse_sum_plain` (today's composition
of PyTorch ops) for CPU tensors; there is no fallback from one to the
other.  ``fuse_sum.launches`` counts kernel launches.

An operand is ``(tensor, inv, factor)``: a (B, C, H / factor, W /
factor) tensor in bf16, float32, or int8 read as ``t.float() / inv``.
On CUDA every tensor is channels_last (its NHWC view dense).
"""

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build, _observe

__all__ = ["Operand", "fuse_sum", "fuse_sum_plain", "quantize",
           "int8_buffer", "LAUNCH_FIELDS"]

MAX_OPS = 4
_KIND = {torch.bfloat16: 1, torch.float32: 2, torch.int8: 3}

# qfuse_launch's int64 fields, in csrc/qfuse.cu's enum Field order
LAUNCH_FIELDS = tuple(
    [f"{k}{j}" for j in range(MAX_OPS) for k in ("op", "inv", "kind", "f")]
    + ["b", "h", "w", "c", "relu", "bf16", "out", "out_f32", "q", "q_inv",
       "q_pitch", "q_off", "q_zero"])
_SIGS = {"qfuse_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}


class Operand(NamedTuple):
    t: torch.Tensor                  # (B, C, H / factor, W / factor)
    inv: Optional[torch.Tensor] = None   # f32 0-dim: an int8 t's scale
    factor: int = 1                  # nearest upsampling


def int8_buffer(b: int, c: int, h: int, w: int,
                device: torch.device) -> torch.Tensor:
    """An int8 (B, C, H, W) tensor, channels_last on CUDA (dense NHWC
    rows of ``c`` bytes: the layout the qconv kernel reads)."""
    if device.type == "cuda":
        return torch.empty((b, c, h, w), dtype=torch.int8, device=device,
                           memory_format=torch.channels_last)
    return torch.empty((b, c, h, w), dtype=torch.int8, device=device)


def fuse_sum_plain(ops: Sequence[Operand], dtype: torch.dtype,
                   relu: bool = False, store: bool = True,
                   q_inv: Optional[torch.Tensor] = None,
                   out_q: Optional[torch.Tensor] = None, q_off: int = 0,
                   q_zero: int = 0
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of :func:`fuse_sum`, on any device: the graph's own
    ops (JAX's ``_loadf`` / ``_operand`` dequantize, ``.to(dtype)``,
    ``F.interpolate``, the sum, ``torch.relu``, ``quantize_act``)."""
    from .quant import quantize_act
    acc = None
    for t, inv, f in ops:
        v = t.float() / inv if t.dtype == torch.int8 else t
        v = v.to(dtype)
        if f > 1:
            v = F.interpolate(v, scale_factor=f, mode="nearest")
        acc = v if acc is None else acc + v         # the sum in the dtype
    if relu:
        acc = torch.relu(acc)
    q = None
    if q_inv is not None:
        q = quantize_act(acc, q_inv)
        if out_q is not None:
            c = q.shape[1]
            out_q[:, q_off:q_off + c] = q
            out_q[:, q_off + c:q_off + c + q_zero] = 0
            q = out_q[:, q_off:q_off + c]
    return (acc if store else None), q


def _nhwc(t: torch.Tensor, what: str) -> torch.Tensor:
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        raise ValueError(f"fuse_sum: {what} must be channels_last (its NHWC "
                         f"view dense), got strides {tuple(t.stride())}")
    return v


def fuse_sum(ops: Sequence[Operand], dtype: torch.dtype, relu: bool = False,
             store: bool = True, q_inv: Optional[torch.Tensor] = None,
             out_q: Optional[torch.Tensor] = None, q_off: int = 0,
             q_zero: int = 0
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``relu(sum_j op_j)`` of up to four operands (nearest-upsampled,
    int8 ones dequantized, each rounded to ``dtype``, a rounding after
    each add) -> ``(out, q)``: ``out`` the (B, C, H, W) result in
    ``dtype`` when ``store``, ``q`` it quantized at ``q_inv`` (int8 NCHW)
    when ``q_inv`` is given.  With ``out_q`` (a (B, P, H, W) int8
    buffer) ``q`` is written into its channels ``q_off`` .. ``q_off + C``
    and the ``q_zero`` channels after them are set to 0; ``q`` is then
    that channel range of ``out_q``."""
    dev = ops[0].t.device
    if dev.type == "cpu":
        return fuse_sum_plain(ops, dtype, relu, store, q_inv, out_q, q_off,
                              q_zero)
    if dev.type != "cuda":
        raise ValueError(f"fuse_sum: unsupported device {dev}")
    if not 1 <= len(ops) <= MAX_OPS:
        raise ValueError(f"fuse_sum takes 1 to {MAX_OPS} operands, got "
                         f"{len(ops)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fuse_sum: the sum's dtype is bf16 or float32, "
                         f"got {dtype}")
    if not store and q_inv is None:
        raise ValueError("fuse_sum: nothing to store")
    b, c = ops[0].t.shape[:2]
    h, w = ops[0].t.shape[2] * ops[0].factor, ops[0].t.shape[3] * ops[0].factor
    fields = []
    for i, (t, inv, f) in enumerate(ops):
        if t.device != dev or t.dtype not in _KIND \
                or tuple(t.shape) != (b, c, h // f, w // f) or h % f or w % f:
            raise ValueError(f"fuse_sum: operand {i} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"(B, C, H / {f}, W / {f}) = "
                             f"({b}, {c}, {h // f}, {w // f}) on {dev}")
        if t.dtype == torch.int8 and (inv is None or inv.device != dev):
            raise ValueError(f"fuse_sum: int8 operand {i} needs its scale on "
                             f"{dev}")
        fields += [_nhwc(t, f"operand {i}").data_ptr(),
                   inv.data_ptr() if t.dtype == torch.int8 else 0,
                   _KIND[t.dtype], f]
    fields += [0, 0, 0, 1] * (MAX_OPS - len(ops))
    out = None
    if store:
        out = torch.empty((b, c, h, w), dtype=dtype, device=dev,
                          memory_format=torch.channels_last)
    q, pitch = None, c
    if q_inv is not None:
        if q_inv.device != dev or q_inv.dtype != torch.float32:
            raise ValueError(f"fuse_sum: q_inv must be float32 on {dev}")
        if out_q is None:
            if q_off or q_zero:
                raise ValueError("fuse_sum: q_off / q_zero need out_q")
            out_q = int8_buffer(b, c, h, w, dev)
        if out_q.dtype != torch.int8 or out_q.device != dev \
                or out_q.shape[0] != b or tuple(out_q.shape[2:]) != (h, w) \
                or q_off < 0 or q_zero < 0 \
                or q_off + c + q_zero > out_q.shape[1]:
            raise ValueError(f"fuse_sum: out_q {out_q.dtype} "
                             f"{tuple(out_q.shape)} cannot take channels "
                             f"{q_off}..{q_off + c + q_zero} of ({b}, C, {h}, "
                             f"{w})")
        pitch = out_q.shape[1]
        _nhwc(out_q, "out_q")
        q = out_q[:, q_off:q_off + c]
    fields += [b, h, w, c, int(relu), int(dtype == torch.bfloat16),
               out.data_ptr() if out is not None else 0,
               int(dtype == torch.float32),
               out_q.data_ptr() if q is not None else 0,
               q_inv.data_ptr() if q is not None else 0, pitch, q_off,
               q_zero if q is not None else 0]
    assert len(fields) == len(LAUNCH_FIELDS)
    lib = _build.load("qfuse", _SIGS)
    arr = (ctypes.c_longlong * len(fields))(*fields)
    err = lib.qfuse_launch(arr, len(fields),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "qfuse")
    fuse_sum.launches += 1
    if _observe.active:
        _observe.launched("qfuse", ops, (out,))
    return out, q


fuse_sum.launches = 0


def quantize(x: torch.Tensor, inv: torch.Tensor,
             pitch: Optional[int] = None) -> torch.Tensor:
    """``quantize_act(x, inv)`` in one pass of :func:`fuse_sum`: int8
    (B, C, H, W), on CUDA the first C channels of a channels_last buffer
    of ``pitch`` channels (default C) whose other channels are 0."""
    b, c, h, w = x.shape
    buf = int8_buffer(b, pitch or c, h, w, x.device)
    return fuse_sum([Operand(x)], torch.float32, store=False, q_inv=inv,
                    out_q=buf, q_zero=(pitch or c) - c)[1]
