"""Symmetric int8 quantization for the packed serving path: the CUDA
kernel ``csrc/qconv.cu`` and its plain PyTorch version.

Port of ``rtpe_tpu/ops/quant.py``, the same scheme step for step:

* weights per output channel, ``s_w = max(absmax, 1e-12) / 127``,
  ``w_q = clip(round(w / s_w), -127, 127)`` (round half to even);
* activations per tensor with a static scale from calibration,
  ``x_q = clip(round(x.float() * inv_sx), -127, 127)``;
* the int32 sums dequantized into the float32 bias,
  ``acc.float() * alpha + bias`` with ``alpha = s_x * s_w``: the same
  float32 pre-activation the bf16 path produces; the caller applies the
  ReLU and the cast.

JAX's int8 convolution is XLA's s8 conv, not a Pallas kernel; PyTorch
has none on CUDA, so :func:`qconv` runs the kernel of
``csrc/qconv.cu`` (an implicit GEMM on ``mma.sync`` s8) for a CUDA
tensor and the plain version for a CPU tensor: ``F.conv2d`` /
``F.conv_transpose2d`` on float64 copies of the int8 tensors, exact
since every partial sum is an integer below 2^53.  There is no fallback
from one to the other.  ``qconv.launches`` counts kernel launches.

Layouts: activations NCHW as in the rest of the port (channels_last on
CUDA, whose NHWC view the kernel reads without a copy); a
:class:`QConv`'s ``kernel`` is (Cout, kh, kw, Cpad) with the input
channels zero-padded to a multiple of 16 (the kernel's 16-byte
segments), a transposed conv's flipped, as the kernel reads it.
"""

import ctypes
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["QConv", "quantize_weight", "quantize_tconv_weight",
           "quantize_act", "qconv", "qconv_plain", "qconv_int32_plain",
           "kernel_layout", "qconv_plan"]

SEGMENT = 16          # channels a K segment of the kernel (bytes of int8)
BN_CHOICES = (64, 48, 32)

_SIGS = {"qconv_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
         + [ctypes.c_void_p]}


class QConv(NamedTuple):
    """A quantized conv: int8 kernel, dequant factors, float32 bias.

    ``inv_sy`` (fuse convs only) is the output's inverse scale, with
    which ``packed_forward(int8_act=True)`` stores the fuse operands
    int8 (``rtpe_tpu/ops/quant.py:QConv``)."""
    kernel: torch.Tensor    # int8 (cout, kh, kw, cpad), K-major
    bias: torch.Tensor      # f32 (cout,)
    alpha: torch.Tensor     # f32 (cout,), or (2, cout) by output-row
    #                         parity for the transposed conv: s_x * s_w
    inv_sx: torch.Tensor    # f32 0-dim: 127 / act_absmax
    cin: int                # input channels (the kernel's are padded)
    transposed: bool        # the 4 x 4 stride-2 transposed conv
    inv_sy: Optional[torch.Tensor] = None   # f32 0-dim: 127 / out_absmax


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device: dividing by it is a
    true division (CUDA divides by a host scalar through its
    reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_weight(w: torch.Tensor, out_axis: int = 0):
    """Per-output-channel symmetric int8: ``(w_q, s_w)`` with ``w ≈ w_q *
    s_w``, ``w_q`` in ``w``'s layout and ``s_w`` (cout,) float32.
    ``out_axis`` is 0 for OIHW, 1 for a transposed conv's (in, out, kh,
    kw)."""
    wf = w.float()
    dims = tuple(d for d in range(wf.dim()) if d != out_axis)
    absmax = wf.abs().amax(dim=dims)
    s_w = torch.clamp(absmax, min=1e-12) / _const(127.0, wf)
    shape = [1] * wf.dim()
    shape[out_axis] = -1
    w_q = torch.clamp(torch.round(wf / s_w.view(shape)), -127, 127)
    return w_q.to(torch.int8), s_w


def quantize_tconv_weight(w: torch.Tensor):
    """The transposed conv's weights (in, out, 4, 4), quantized as JAX's
    row-packed kernel quantizes them (``rowpack.pack_tconv4x4s2_pp``):
    output rows of parity u read only the taps kh = u + 1 (mod 2), so
    each (u, channel) has its own scale.  Returns ``(w_q, s_w)``, ``w_q``
    in ``w``'s layout, ``s_w`` (2, out)."""
    wf = w.float()
    w_q = torch.empty(wf.shape, dtype=torch.int8, device=wf.device)
    s_w = []
    for u in range(2):
        taps = [kh for kh in range(wf.shape[2]) if kh % 2 == (u + 1) % 2]
        part, s = quantize_weight(wf[:, :, taps], out_axis=1)
        w_q[:, :, taps] = part
        s_w.append(s)
    return w_q, torch.stack(s_w)


def quantize_act(x: torch.Tensor, inv_sx: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 with a static scale; keeps ``x``'s
    memory format."""
    return torch.clamp(torch.round(x.float() * inv_sx), -127, 127).to(
        torch.int8)


def kernel_layout(w_q: torch.Tensor, transposed: bool = False):
    """int8 weights in the port's layout (OIHW, or (in, out, kh, kw) for
    the transposed conv) -> ``(kernel, cin)``: the kernel's (Cout, kh,
    kw, Cpad), input channels zero-padded to a multiple of 16 (exact:
    the padded products are 0), the transposed conv's flipped so that it
    runs as a conv over the 2x-dilated input."""
    if transposed:
        k = w_q.flip(2, 3).permute(1, 2, 3, 0)
    else:
        k = w_q.permute(0, 2, 3, 1)
    cin = k.shape[-1]
    cpad = -(-cin // SEGMENT) * SEGMENT
    return F.pad(k, (0, cpad - cin)).contiguous(), cin


def qconv_plan(cin: int, cout: int, kh: int, kw: int) -> Dict[str, int]:
    """The kernel's tiling (``csrc/qconv.cu:qconv_plan``): the N tile of
    64, 48 or 32 channels that pads Cout least (the larger on a tie),
    16-channel segments a tap, K segments, and k32 steps (two segments
    each; the last may hold one and zeros)."""
    bn = min(BN_CHOICES, key=lambda n: (-(-cout // n) * n, -n))
    cseg = -(-cin // SEGMENT)
    nseg = kh * kw * cseg
    return {"bn": bn, "cseg": cseg, "nseg": nseg, "ksteps": -(-nseg // 2)}


def qconv_plan_c(cin: int, cout: int, kh: int, kw: int) -> Dict[str, int]:
    """The kernel's own plan, built on first use like the kernel: for
    holding :func:`qconv_plan` against it."""
    lib = _build.load("qconv", _SIGS)
    lib.qconv_plan.argtypes = [ctypes.c_int] * 5
    lib.qconv_plan.restype = ctypes.c_int
    return {k: int(lib.qconv_plan(cin, cout, kh, kw, i))
            for i, k in enumerate(("bn", "cseg", "nseg", "ksteps"))}


def _geometry(q: QConv, h: int, w: int, stride: int, padding: int):
    """The kernel's (stride, pad, dil, ho, wo): a transposed conv runs as
    a stride-1 conv over the input dilated by ``stride``, padded by
    kh - 1 - padding."""
    _, kh, kw, _ = q.kernel.shape
    if q.transposed:
        ho = (h - 1) * stride - 2 * padding + kh
        wo = (w - 1) * stride - 2 * padding + kw
        return 1, kh - 1 - padding, stride, ho, wo
    return (stride, padding, 1, (h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def qconv_int32_plain(xq: torch.Tensor, q: QConv, stride: int = 1,
                      padding: Optional[int] = None) -> torch.Tensor:
    """The int32 sums: ``xq`` (B, Cin, H, W) int8 -> (B, Cout, Ho, Wo)
    int32, by a float64 convolution of the int8 values (exact in any
    summation order; the rounding only guards the cast)."""
    if padding is None:
        padding = (q.kernel.shape[1] - 1) // 2
    k = q.kernel[..., :q.cin].to(torch.float64)            # (O, kh, kw, I)
    x64 = xq.to(torch.float64)
    if q.transposed:
        acc = F.conv_transpose2d(x64, k.flip(1, 2).permute(3, 0, 1, 2),
                                 stride=stride, padding=padding)
    else:
        acc = F.conv2d(x64, k.permute(0, 3, 1, 2), stride=stride,
                       padding=padding)
    return acc.round().to(torch.int32)


def dequantize(acc: torch.Tensor, q: QConv) -> torch.Tensor:
    """``acc.float() * alpha + bias``: two float32 roundings, as the
    kernel's epilogue; a (P, cout) alpha by output row modulo P."""
    alpha = q.alpha.reshape(-1, q.alpha.shape[-1])
    rows = torch.arange(acc.shape[2], device=acc.device) % alpha.shape[0]
    return acc.to(torch.float32) * alpha[rows].T[:, :, None] \
        + q.bias[:, None, None]


def qconv_plain(x: torch.Tensor, q: QConv, stride: int = 1,
                padding: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`qconv`, on any device."""
    xq = x if x.dtype == torch.int8 else quantize_act(x, q.inv_sx)
    return dequantize(qconv_int32_plain(xq, q, stride, padding), q)


def _qconv_cuda(xq: torch.Tensor, q: QConv, stride: int,
                padding: int) -> torch.Tensor:
    if xq.dim() != 4 or xq.shape[1] != q.cin:
        raise ValueError(f"qconv takes x (B, {q.cin}, H, W), got "
                         f"{tuple(xq.shape)}")
    for name, t, dtype in (("kernel", q.kernel, torch.int8),
                           ("alpha", q.alpha, torch.float32),
                           ("bias", q.bias, torch.float32)):
        if t.device != xq.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"qconv: {name} must be {dtype}, contiguous, on "
                             f"{xq.device}; got {t.dtype} on {t.device}")
    x_nhwc = xq.permute(0, 2, 3, 1)
    if not x_nhwc.is_contiguous():
        raise ValueError("the qconv kernel takes x channels_last (its NHWC "
                         "view contiguous)")
    if q.kernel.data_ptr() % 16:
        raise ValueError("the qconv kernel takes a 16-byte aligned kernel")
    b, h, w, cin = x_nhwc.shape
    cout, kh, kw, _ = q.kernel.shape
    s, pad, dil, ho, wo = _geometry(q, h, w, stride, padding)
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32,
                      device=xq.device)
    if out.numel():
        lib = _build.load("qconv", _SIGS)
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.qconv_launch(x_nhwc.data_ptr(), q.kernel.data_ptr(),
                               q.alpha.data_ptr(), q.bias.data_ptr(),
                               out.data_ptr(), b, h, w, cin, ho, wo, cout, kh,
                               kw, s, pad, dil, q.alpha.numel() // cout,
                               stream)
        _build.check(err, "qconv")
        qconv.launches += 1
    return out.permute(0, 3, 1, 2)


def qconv(x: torch.Tensor, q: QConv, stride: int = 1,
          padding: Optional[int] = None) -> torch.Tensor:
    """int8 conv + dequant + bias -> float32 (B, Cout, Ho, Wo), the
    contract of the JAX ``qconv``.  ``stride`` and ``padding`` are the
    float conv's (``F.conv2d``, or ``F.conv_transpose2d`` for a
    transposed ``q``); ``padding`` defaults to (kh - 1) // 2.  An int8
    ``x`` is taken as already quantized with ``q``'s scale (the int8-act
    graph)."""
    if padding is None:
        padding = (q.kernel.shape[1] - 1) // 2
    if x.device.type == "cpu":
        return qconv_plain(x, q, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"qconv: unsupported device {x.device}")
    xq = x if x.dtype == torch.int8 else quantize_act(x, q.inv_sx)
    return _qconv_cuda(xq, q, stride, padding)


qconv.launches = 0
