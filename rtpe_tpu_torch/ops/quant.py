"""Symmetric int8 quantization for the packed serving path: the CUDA
kernel ``csrc/qconv.cu`` and its plain PyTorch version.

Port of ``rtpe_tpu/ops/quant.py``, the same scheme step for step:

* weights per output channel, ``s_w = max(absmax, 1e-12) / 127``,
  ``w_q = clip(round(w / s_w), -127, 127)`` (round half to even);
* activations per tensor with a static scale from calibration,
  ``x_q = clip(round(x.float() * inv_sx), -127, 127)``;
* the int32 sums dequantized into the float32 bias,
  ``acc.float() * alpha + bias`` with ``alpha = s_x * s_w``: the same
  float32 pre-activation the bf16 path produces.

JAX's int8 convolution is XLA's s8 conv, not a Pallas kernel; PyTorch
has none on CUDA, so :func:`qconv` runs the kernel of ``csrc/qconv.cu``
(an implicit GEMM on ``wgmma`` s8) for a CUDA tensor and the plain
version for a CPU tensor: ``F.conv2d`` / ``F.conv_transpose2d`` on
float64 copies of the int8 tensors, exact since every partial sum is an
integer below 2^53.  There is no fallback from one to the other.
``qconv.launches`` counts kernel launches.

By default :func:`qconv` returns the float32 pre-activation (the JAX
contract).  With an :class:`Epilogue` it also does what XLA fuses after
the conv in JAX's int8 graph (the ReLU, the residual add in the dtype,
the cast, the requantize of the stored activation) and returns the
activation in the dtype and / or int8: on CUDA in the kernel's
epilogue, on the CPU as :func:`epilogue_plain`, the graph's own ops.

Layouts: activations NCHW as in the rest of the port (channels_last on
CUDA, whose NHWC view the kernel reads without a copy; its pixel rows
a multiple of 16 bytes); a :class:`QConv`'s ``kernel`` is (Cout, kh,
kw, Cpad) with the input channels zero-padded to a multiple of 16 (the
kernel's 16-byte chunks), a transposed conv's flipped, as the kernel
reads it.
"""

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["QConv", "Epilogue", "quantize_weight", "quantize_tconv_weight",
           "quantize_act", "qconv", "qconv_plain", "qconv_int32_plain",
           "epilogue_plain", "kernel_layout", "qconv_plan"]

SEGMENT = 16          # bytes (int8 channels) of one of the kernel's chunks
N_TILES = (16, 24, 32, 48, 64)   # the wgmma s8 N the kernel has
BM = 128              # output pixels a block
KC = 128              # K bytes a stage
STAGES = 4
SMS = 132             # the H100's SMs
MIN_SPLIT_STEPS = 2

# qconv_launch's int64 fields, in csrc/qconv.cu's enum Field order
LAUNCH_FIELDS = ("x", "w", "alpha", "bias", "b", "h", "width", "pitch",
                 "cin", "cout", "kh", "kw", "stride", "pad", "transposed",
                 "period", "relu", "res_kind", "res", "res_inv",
                 "relu_after", "bf16", "out_f32", "out_bf16", "out_q",
                 "q_inv", "q_rounded", "ws", "counters")
PLAN_KEYS = ("bn", "tiles_m", "tiles_n", "phases", "taps", "nsteps",
             "splits", "smem", "ws_bytes", "counters", "cpad")
_SIGS = {"qconv_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}


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
    # inv_sx's value on the host (quantize_packed sets it): the int8 graph
    # compares consumers' scales with it without a device sync
    inv_sx_value: Optional[float] = None


class Epilogue(NamedTuple):
    """What :func:`qconv` does after the dequantize, in this order, each
    step rounded on its own as the graph's PyTorch ops round it:
    ``relu``; the residual ``res`` (the dtype, or int8 read as
    ``res.float() / res_inv``) added in ``dtype``; ``relu_after``; then
    the stores: the activation in ``dtype`` when ``store``, and int8 at
    ``q_inv`` of the value rounded to ``dtype`` (``q_rounded``) or of
    the float32 one."""
    dtype: torch.dtype = torch.bfloat16
    relu: bool = False
    res: Optional[torch.Tensor] = None
    res_inv: Optional[torch.Tensor] = None
    relu_after: bool = False
    store: bool = True
    q_inv: Optional[torch.Tensor] = None
    q_rounded: bool = True


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


def _n_tile(cout: int):
    """(N tile, channel tiles): tiles of at most 64 channels, each the
    narrowest s8 N the kernel has that covers its share of Cout."""
    tiles_n = -(-cout // N_TILES[-1])
    per = -(-cout // tiles_n)
    return next(n for n in N_TILES if n >= per), tiles_n


@functools.lru_cache(maxsize=1024)
def qconv_plan(b: int, h: int, w: int, cin: int, cout: int, kh: int,
               kw: int, stride: int = 1, pad: int = 0,
               transposed: bool = False) -> Optional[Dict[str, int]]:
    """The kernel's tiling of one call (``csrc/qconv.cu:make_plan``),
    ``None`` where it refuses the geometry: 128-pixel by ``bn``-channel
    tiles, 4 sub-pixel phases for the transposed conv (each a 2 x 2 conv
    over the undilated input), K = taps x Cpad in stages of 128 bytes,
    split in ``splits`` ranges (at least 2 stages each) while the tiles
    alone give fewer than 132 blocks, as many as keep the grid within
    132; shared memory, the int32 split workspace and its counters
    (memoized: each call of the graph asks for it)."""
    if min(b, h, w, cin, cout, kh, kw, stride) <= 0 or pad < 0:
        return None
    cpad = -(-cin // SEGMENT) * SEGMENT
    if transposed:
        if (kh, kw, stride, pad) != (4, 4, 2, 1):
            return None
        hm, wm, phases, taps = h, w, 4, 4
    else:
        hm = (h + 2 * pad - kh) // stride + 1
        wm = (w + 2 * pad - kw) // stride + 1
        if hm <= 0 or wm <= 0 or kh * kw > 31:
            return None
        phases, taps = 1, kh * kw
    m = b * hm * wm
    if m >= 2 ** 31:
        return None
    bn, tiles_n = _n_tile(cout)
    tiles_m = -(-m // BM)
    nsteps = -(-taps * cpad // KC)
    base = tiles_m * tiles_n * phases
    splits = 1
    if base < SMS:
        splits = max(1, min(SMS // base, nsteps // MIN_SPLIT_STEPS))
    smem = min(STAGES, -(-nsteps // splits)) * (BM * KC + bn * KC) + 1024
    return {"bn": bn, "tiles_m": tiles_m, "tiles_n": tiles_n,
            "phases": phases, "taps": taps, "nsteps": nsteps,
            "splits": splits, "smem": smem,
            "ws_bytes": 4 * base * splits * BM * bn if splits > 1 else 0,
            "counters": base if splits > 1 else 0, "cpad": cpad}


def qconv_plan_c(b: int, h: int, w: int, cin: int, cout: int, kh: int,
                 kw: int, stride: int = 1, pad: int = 0,
                 transposed: bool = False) -> Optional[Dict[str, int]]:
    """The kernel's own plan (:func:`qconv_plan`'s arguments), built on
    first use like the kernel: for holding :func:`qconv_plan` against
    it."""
    lib = _build.load("qconv", _SIGS)
    lib.qconv_plan.argtypes = [ctypes.c_int] * 11
    lib.qconv_plan.restype = ctypes.c_longlong
    geo = (b, h, w, cin, cout, kh, kw, stride, pad, int(transposed))
    got = {k: int(lib.qconv_plan(*geo, i)) for i, k in enumerate(PLAN_KEYS)}
    return None if got["bn"] < 0 else got


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


def epilogue_plain(y: torch.Tensor, e: Epilogue):
    """The graph's ops after a conv, on the float32 pre-activation ``y``:
    ``(out, q)`` as :class:`Epilogue` says (``None`` where not stored)."""
    if e.relu:
        y = y.relu_()
    if e.res is not None:
        r = e.res.float() / e.res_inv if e.res.dtype == torch.int8 \
            else e.res
        y = y.to(e.dtype) + r.to(e.dtype)           # the add in the dtype
    if e.relu_after:
        y = torch.relu(y)
    q = None
    if e.q_inv is not None:
        q = quantize_act(y.to(e.dtype) if e.q_rounded else y, e.q_inv)
    return (y.to(e.dtype) if e.store else None), q


def qconv_plain(x: torch.Tensor, q: QConv, stride: int = 1,
                padding: Optional[int] = None,
                epilogue: Optional[Epilogue] = None):
    """Plain version of :func:`qconv`, on any device."""
    xq = x if x.dtype == torch.int8 else quantize_act(x, q.inv_sx)
    y = dequantize(qconv_int32_plain(xq, q, stride, padding), q)
    return y if epilogue is None else epilogue_plain(y, epilogue)


_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(n: int, dev: torch.device) -> torch.Tensor:
    """The split tiles' arrival counters, zeroed once per device and
    stream (every launch leaves them zeroed)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _kernel_input(xq: torch.Tensor, cpad: int) -> torch.Tensor:
    """The NHWC view of a channels_last int8 ``xq`` as the kernel reads
    it: pixel rows of a multiple of 16 bytes and at least Cpad (the
    graph's producers write such rows, channels past Cin included).
    Dense rows of another width (3 or 82 channels) are copied into a
    zero-padded buffer: a copy the graph never makes."""
    b, c, h, w = xq.shape
    pitch = xq.stride(3)
    if xq.stride(1) != 1 or xq.stride(2) != w * pitch \
            or xq.stride(0) != h * w * pitch or pitch < c:
        raise ValueError("the qconv kernel takes x channels_last (its NHWC "
                         "view contiguous, or rows padded past C)")
    v = xq.permute(0, 2, 3, 1)
    if pitch % SEGMENT == 0 and pitch >= cpad and xq.data_ptr() % 16 == 0:
        return v
    buf = torch.zeros((b, h, w, cpad), dtype=torch.int8, device=xq.device)
    buf[..., :c] = v[..., :c]
    return buf


def _qconv_cuda(x: torch.Tensor, q: QConv, stride: int, padding: int,
                e: Optional[Epilogue]):
    if x.dim() != 4 or x.shape[1] != q.cin:
        raise ValueError(f"qconv takes x (B, {q.cin}, H, W), got "
                         f"{tuple(x.shape)}")
    for name, t, dtype in (("kernel", q.kernel, torch.int8),
                           ("alpha", q.alpha, torch.float32),
                           ("bias", q.bias, torch.float32)):
        if t.device != x.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"qconv: {name} must be {dtype}, contiguous, on "
                             f"{x.device}; got {t.dtype} on {t.device}")
    if q.kernel.data_ptr() % 16:
        raise ValueError("the qconv kernel takes a 16-byte aligned kernel")
    cout, kh, kw, cpad = q.kernel.shape
    if q.alpha.numel() != cout and not q.transposed:
        raise ValueError("the qconv kernel takes alpha (Cout,) for a conv "
                         "(by output-row parity only for the transposed one)")
    b, _, h, w = x.shape
    plan = qconv_plan(b, h, w, q.cin, cout, kh, kw, stride, padding,
                      q.transposed)
    if plan is None:
        raise ValueError(f"the qconv kernel refuses x {tuple(x.shape)} with "
                         f"kernel {tuple(q.kernel.shape)}, stride {stride}, "
                         f"padding {padding}, transposed={q.transposed}")
    if x.dtype == torch.int8:
        xk = _kernel_input(x, cpad)
    elif x.permute(0, 2, 3, 1).is_contiguous():
        from .qfuse import quantize
        xk = quantize(x, q.inv_sx, cpad).permute(0, 2, 3, 1)
    else:
        raise ValueError("the qconv kernel takes x channels_last (its NHWC "
                         "view contiguous)")
    if q.transposed:
        ho, wo = 2 * h, 2 * w
    else:
        ho = (h + 2 * padding - kh) // stride + 1
        wo = (w + 2 * padding - kw) // stride + 1
    dev = x.device
    shape = (b, cout, ho, wo)

    def empty(dtype):
        return torch.empty(shape, dtype=dtype, device=dev,
                           memory_format=torch.channels_last)

    out_f32 = out_bf16 = out_q = None
    res_kind, res, res_inv = 0, None, None
    relu = relu_after = bf16 = 0
    q_rounded, q_inv = 1, None
    if e is None:
        out_f32 = empty(torch.float32)
    else:
        if e.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"qconv: an epilogue's dtype is bf16 or "
                             f"float32, got {e.dtype}")
        if not e.store and e.q_inv is None:
            raise ValueError("qconv: the epilogue stores nothing")
        bf16 = int(e.dtype == torch.bfloat16)
        relu, relu_after, q_rounded = int(e.relu), int(e.relu_after), \
            int(e.q_rounded)
        if e.store:
            if bf16:
                out_bf16 = empty(torch.bfloat16)
            else:
                out_f32 = empty(torch.float32)
        if e.q_inv is not None:
            if e.q_inv.device != dev or e.q_inv.dtype != torch.float32:
                raise ValueError(f"qconv: q_inv must be float32 on {dev}")
            q_inv = e.q_inv
            out_q = empty(torch.int8)
        if e.res is not None:
            r = e.res
            want = torch.int8 if r.dtype == torch.int8 else e.dtype
            if r.dtype != want or tuple(r.shape) != shape \
                    or r.device != dev \
                    or not r.permute(0, 2, 3, 1).is_contiguous():
                raise ValueError(f"qconv: the residual must be {e.dtype} or "
                                 f"int8 {shape}, channels_last, on {dev}; got "
                                 f"{r.dtype} {tuple(r.shape)}")
            if r.dtype == torch.int8 and (e.res_inv is None
                                          or e.res_inv.device != dev):
                raise ValueError(f"qconv: an int8 residual needs res_inv on "
                                 f"{dev}")
            res_kind = 2 if r.dtype == torch.int8 else 1
            res, res_inv = r, e.res_inv if r.dtype == torch.int8 else None
    ws = counters = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["ws_bytes"] // 4, dtype=torch.int32,
                         device=dev)
        counters = _counters(plan["counters"], dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    fields = [xk.data_ptr(), q.kernel.data_ptr(), q.alpha.data_ptr(),
              q.bias.data_ptr(), b, h, w, xk.stride(2), q.cin, cout, kh, kw,
              stride, padding, int(q.transposed), q.alpha.numel() // cout,
              relu, res_kind, ptr(res), ptr(res_inv), relu_after, bf16,
              ptr(out_f32), ptr(out_bf16), ptr(out_q), ptr(q_inv), q_rounded,
              ptr(ws), ptr(counters)]
    assert len(fields) == len(LAUNCH_FIELDS)
    lib = _build.load("qconv", _SIGS)
    arr = (ctypes.c_longlong * len(fields))(*fields)
    err = lib.qconv_launch(arr, len(fields),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "qconv")
    qconv.launches += 1
    if e is None:
        return out_f32
    return (out_bf16 if bf16 else out_f32), out_q


def qconv(x: torch.Tensor, q: QConv, stride: int = 1,
          padding: Optional[int] = None,
          epilogue: Optional[Epilogue] = None):
    """int8 conv + dequant + bias -> float32 (B, Cout, Ho, Wo), the
    contract of the JAX ``qconv``; with ``epilogue``, ``(out, q)`` as
    :class:`Epilogue` says.  ``stride`` and ``padding`` are the float
    conv's (``F.conv2d``, or ``F.conv_transpose2d`` for a transposed
    ``q``, which the kernel takes at stride 2, padding 1); ``padding``
    defaults to (kh - 1) // 2.  An int8 ``x`` is taken as already
    quantized with ``q``'s scale (the int8-act graph); a float one is
    quantized at ``q.inv_sx`` (on CUDA in one pass of
    :func:`~rtpe_tpu_torch.ops.qfuse.quantize`, into padded rows)."""
    if padding is None:
        padding = (q.kernel.shape[1] - 1) // 2
    if x.device.type == "cpu":
        return qconv_plain(x, q, stride, padding, epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"qconv: unsupported device {x.device}")
    return _qconv_cuda(x, q, stride, padding, epilogue)


qconv.launches = 0
