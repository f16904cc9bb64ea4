"""The fused ContextAwareModule (CAM) ops: the CUDA kernels of
``csrc/cam_f{1,2,3}.cu`` and their plain PyTorch versions.

Port of ``rtpe_tpu/ops/pallas_cam.py``.  The train-mode CAM

    res  = relu(BN_r(conv1x1_r(x)))
    gate = sigmoid(fc2(relu(fc1(gap(x)))))          # SELayer
    a_i  = relu(BN_i(conv3x3_dil_i(x)))             # i over dilations
    y    = relu(BN_t(conv1x1_t(concat_i a_i)))
    out  = relu(res + y * gate)

with batch-statistic BN is split, as in JAX, into three ops with
hand-written backward passes, and the glue (statistics, rsqrt, the SE
MLP) is left to plain autograd:

    F1: x -> sums / sums of squares of conv_r(x) and each conv_i(x), gap(x)
    F2: x, branch BN rows -> sums / sums of squares of the top conv
    F3: x, every BN row, the SE gate -> out

Six kernels: each op's forward and its backward (``cam_f1_fwd``,
``cam_f1_bwd``, ``cam_f2_fwd``, ``cam_f2_bwd``, ``cam_f3_fwd``,
``cam_f3_bwd``), all on 8 x 8-pixel tiles: ``csrc/cam_wg.cuh``'s
``wgmma`` kernels, at every geometry the ops take.  Each
runs its plain version for CPU tensors and its kernel for CUDA tensors,
with no fallback from one to the other; each counts its kernel launches
in ``.launches``, and each plain version its calls in ``.calls``.  Layout is the JAX one: x (B, H, W, C) NHWC bf16,
kr (C, C) [in, out], kh (nb, 3, 3, C, hc) HWIO, kt (nb, hc, C), BN rows
[mean, inv, scale, bias] stacked as (4, C) or (4 nb, hc) float32.

Rounding points are the TPU kernels': conv outputs are rounded to bf16
before the statistics and the BN, branch activations before the top
conv, t before the top BN, dc / dr / dt before the weight-gradient
products; sums and the BN arithmetic are float32.  The plain versions
run the convolutions in float32 (on CUDA the caller turns TF32 off,
``rtpe_tpu_torch.device.set_tf32(False)``).

One deliberate difference from the TPU kernels: ``_f3b_kernel``'s
phase 1 reads image 0's SE gate for every image
(``pallas_cam.py:507``), which makes its ``dx`` wrong for images
b >= 1; here both phases use image b's gate (ROADMAP.md Queue 3).

Under data parallelism (:class:`~rtpe_tpu_torch.parallel.dist.
global_batch_stats`) :func:`fused_cam` all-reduces F1's and F2's sums
and the pixel count over the group between the launches, as JAX's
one-program step reduces them over the global batch; the kernels are
the same.
"""

import ctypes
import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.dist import all_reduce_sum, stats_group
from . import _build, _observe

BN_EPS = 1e-5
NB_MAX = 6       # the kernels' most dilations

_P = ctypes.c_void_p
_CNT = [_P, ctypes.c_int]   # cam_wgrad_counts, in every CAM library
_SIGS = {
    "cam_f1": {"cam_f1_launch": [_P] * 8, "cam_f1b_launch": [_P] * 12,
               "cam_wgrad_launch": [_P] * 6, "cam_wgrad_counts": _CNT},
    "cam_f2": {"cam_f2_launch": [_P] * 7, "cam_f2b_launch": [_P] * 12,
               "cam_wgrad_counts": _CNT},
    "cam_f3": {"cam_f3_launch": [_P] * 10, "cam_f3b_launch": [_P] * 19,
               "cam_wgrad_counts": _CNT},
}
_WORKSPACE = {"cam_f1": ("cam_f1_workspace", "cam_f1b_workspace"),
              "cam_f2": ("cam_f2_workspace", "cam_f2b_workspace"),
              "cam_f3": ("cam_f3_workspace", "cam_f3b_workspace")}


# ------------------------------------------------------------ plain versions
#
# The plain versions evaluate in float32 on every path of the port.  For
# the card check (``tools/cam_check.py``) they also evaluate in float64,
# with the same bf16 rounding points, and give each output element's sum
# of |terms|: the same evaluation on absolute inputs (a BN row's mean as
# -|mean|, so c - mean sums |c| + |mean|), with no rounding and every
# ReLU mask taken from the signed evaluation.

def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _Eval:
    """How a plain version evaluates: in ``dtype``; each ReLU mask by the
    name of its pre-activation ("z0".."z5" the branches', "zr", "zt",
    "pre") taken from ``masks`` where it is there, else made (z > 0) and
    kept there; with ``absolute`` the sums of |terms| (no bf16 rounding,
    every mask given)."""

    def __init__(self, dtype=torch.float32, masks=None, absolute=False):
        self.dtype = dtype
        self.masks = {} if masks is None else dict(masks)
        self.absolute = absolute

    def bf(self, t):
        return t if self.absolute else _bf(t)

    def mask(self, key, z):
        if key not in self.masks:
            if self.absolute:
                raise KeyError(f"the sums of |terms| need the mask of {key}")
            self.masks[key] = z > 0.0
        return self.masks[key]

    def relu(self, key, z):
        return torch.where(self.mask(key, z), z, torch.zeros_like(z))

    def out(self, t, dtype):
        """A per-pixel output, in the kernel's dtype (not the sums)."""
        return t if self.absolute else t.to(dtype)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _conv(x32, k, d):
    """Dilated 3x3 conv, zero "same" padding: (B,H,W,C), (3,3,C,hc)
    -> (B,H,W,hc) in x32's dtype."""
    w = k.to(x32.dtype).permute(3, 2, 0, 1)
    return _nhwc(F.conv2d(_nchw(x32), w, padding=d, dilation=d))


def _conv_t(dc32, k, d):
    """Its input-transpose: (B,H,W,hc) -> (B,H,W,C), the sum over taps of
    dc shifted by minus the tap offset times the tap's kernel^T."""
    w = k.to(dc32.dtype).permute(3, 2, 0, 1)
    return _nhwc(F.conv_transpose2d(_nchw(dc32), w, padding=d, dilation=d))


def _wgrad(x32, dc32, d):
    """(3, 3, C, hc): for each tap, the sum over pixels of x shifted by the
    tap's offset (zero outside the image) times dc."""
    h, w = x32.shape[1:3]
    xp = F.pad(x32, (0, 0, d, d, d, d))
    taps = [torch.einsum("bhwc,bhwj->cj",
                         xp[:, ti * d:ti * d + h, tj * d:tj * d + w], dc32)
            for ti in range(3) for tj in range(3)]
    return torch.stack(taps).reshape(3, 3, *taps[0].shape)


def _bn_rows(bn, i, width):
    """(mean, inv, scale, bias) of BN stack ``bn`` for branch ``i``."""
    return tuple(bn[4 * i + k].reshape(1, 1, 1, width) for k in range(4))


def _bn(c, mean, inv, scale, bias):
    return (c - mean) * inv * scale + bias


def _sums(t):
    return torch.stack([t.sum((0, 1, 2)), (t * t).sum((0, 1, 2))])


def _branches(ev, x32, kh, bnh, dils):
    """Recompute every branch: bf16(c_i) and its pre-activation z_i."""
    hc = kh.shape[-1]
    cs, zs = [], []
    for i, d in enumerate(dils):
        c = ev.bf(_conv(x32, kh[i], d))
        cs.append(c)
        zs.append(_bn(c, *_bn_rows(bnh, i, hc)))
    return cs, zs


def _top(ev, zs, kt):
    """The top conv's float32 rows, pre-rounding, over bf16(relu(z_i))."""
    t = None
    for i, z in enumerate(zs):
        p = ev.bf(ev.relu(f"z{i}", z)) @ kt[i].to(z.dtype)
        t = p if t is None else t + p
    return t


def _f1(ev, x, kr, kh, dils):
    x32 = x.to(ev.dtype)
    s_r = _sums(ev.bf(x32 @ kr.to(ev.dtype)))
    s_h = torch.cat([_sums(ev.bf(_conv(x32, kh[i], d)))
                     for i, d in enumerate(dils)])
    return s_r, s_h, x32.sum((1, 2))


def _f1b(ev, x, kr, kh, dsr, dsh, dgap, dils):
    x32 = x.to(ev.dtype)
    h, w = x.shape[1:3]
    dcs, dkh = [], []
    for i, d in enumerate(dils):
        c = ev.bf(_conv(x32, kh[i], d))
        dc = ev.bf(dsh[2 * i] + 2.0 * c * dsh[2 * i + 1])
        dcs.append(dc)
        dkh.append(_wgrad(x32, dc, d))
    krf = kr.to(ev.dtype)
    rc = ev.bf(x32 @ krf)
    dr = ev.bf(dsr[0] + 2.0 * rc * dsr[1])
    dkr = torch.einsum("bhwc,bhwn->cn", x32, dr)
    dx = dr @ krf.t()
    for i, d in enumerate(dils):
        dx = dx + _conv_t(dcs[i], kh[i], d)
    dx = dx + dgap[:, None, None, :] * (1.0 / (h * w))
    return ev.out(dx, x.dtype), dkr, torch.stack(dkh)


def _f2(ev, x, kh, kt, bnh, dils):
    _, zs = _branches(ev, x.to(ev.dtype), kh, bnh, dils)
    return _sums(ev.bf(_top(ev, zs, kt)))


def _branch_backward(ev, x32, kh, kt, bnh, dils, cs, zs, dt_bf):
    """dkt, dS, dkh and the transposed-conv dx of the branches, given
    bf16(dt)."""
    hc = kh.shape[-1]
    dkt, ds, dkh, dx = [], [], [], None
    for i, d in enumerate(dils):
        m = ev.mask(f"z{i}", zs[i])
        a = torch.where(m, zs[i], torch.zeros_like(zs[i]))
        dkt.append(torch.einsum("bhwj,bhwc->jc", ev.bf(a), dt_bf))
        da = dt_bf @ kt[i].to(ev.dtype).t()
        dz = torch.where(m, da, torch.zeros_like(da))
        mean, inv, scale, _ = _bn_rows(bnh, i, hc)
        ds += [dz.sum((0, 1, 2)), (dz * (cs[i] - mean)).sum((0, 1, 2))]
        dc = ev.bf(dz * (scale * inv))
        dkh.append(_wgrad(x32, dc, d))
        p = _conv_t(dc, kh[i], d)
        dx = p if dx is None else dx + p
    return torch.stack(dkt), torch.stack(ds), torch.stack(dkh), dx


def _f2b(ev, x, kh, kt, bnh, dst, dils):
    x32 = x.to(ev.dtype)
    cs, zs = _branches(ev, x32, kh, bnh, dils)
    t = ev.bf(_top(ev, zs, kt))
    dt_bf = ev.bf(dst[0] + 2.0 * t * dst[1])
    dkt, ds, dkh, dx = _branch_backward(ev, x32, kh, kt, bnh, dils, cs, zs,
                                        dt_bf)
    return ev.out(dx, x.dtype), dkh, dkt, ds


def _f3_recompute(ev, x32, kr, kh, kt, bnr, bnh, bnt, dils):
    c = x32.shape[-1]
    rc = ev.bf(x32 @ kr.to(ev.dtype))
    zr = _bn(rc, *_bn_rows(bnr, 0, c))
    cs, zs = _branches(ev, x32, kh, bnh, dils)
    t_bf = ev.bf(_top(ev, zs, kt))
    zt = _bn(t_bf, *_bn_rows(bnt, 0, c))
    return rc, ev.relu("zr", zr), zr, cs, zs, t_bf, ev.relu("zt", zt), zt


def _f3(ev, x, kr, kh, kt, bnr, bnh, bnt, gate, dils):
    _, res, _, _, _, _, y, _ = _f3_recompute(ev, x.to(ev.dtype), kr, kh, kt,
                                             bnr, bnh, bnt, dils)
    return ev.out(ev.relu("pre", res + y * gate[:, None, None, :]), x.dtype)


def _f3b(ev, x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils):
    x32 = x.to(ev.dtype)
    c = x.shape[-1]
    rc, res, zr, cs, zs, t_bf, y, zt = _f3_recompute(
        ev, x32, kr, kh, kt, bnr, bnh, bnt, dils)
    gt = gate[:, None, None, :]
    pre = res + y * gt
    zero = torch.zeros_like(pre)
    d_o = torch.where(ev.mask("pre", pre), g.to(ev.dtype), zero)
    dgate = (d_o * y).sum((1, 2))
    mean_r, inv_r, scale_r, _ = _bn_rows(bnr, 0, c)
    dzr = torch.where(ev.mask("zr", zr), d_o, zero)
    dsr = torch.stack([dzr.sum((0, 1, 2)),
                       (dzr * (rc - mean_r)).sum((0, 1, 2))])
    drc = ev.bf(dzr * (scale_r * inv_r))
    krf = kr.to(ev.dtype)
    dkr = torch.einsum("bhwc,bhwn->cn", x32, drc)
    mean_t, inv_t, scale_t, _ = _bn_rows(bnt, 0, c)
    dzt = torch.where(ev.mask("zt", zt), d_o * gt, zero)
    dst = torch.stack([dzt.sum((0, 1, 2)),
                       (dzt * (t_bf - mean_t)).sum((0, 1, 2))])
    dt_bf = ev.bf(dzt * (scale_t * inv_t))
    dkt, dsh, dkh, dx_h = _branch_backward(ev, x32, kh, kt, bnh, dils, cs,
                                           zs, dt_bf)
    dx = drc @ krf.t() + dx_h
    return ev.out(dx, x.dtype), dkr, dkh, dkt, dsr, dsh, dst, dgate


# each op's body and the positions of its BN row stacks among its
# arguments
_BODIES = {"cam_f1_fwd": (_f1, ()), "cam_f1_bwd": (_f1b, ()),
           "cam_f2_fwd": (_f2, (3,)), "cam_f2_bwd": (_f2b, (3,)),
           "cam_f3_fwd": (_f3, (4, 5, 6)), "cam_f3_bwd": (_f3b, (4, 5, 6))}


def _absolute(args, bn):
    """``args`` (tensors, then dils) made absolute for the sums of
    |terms|: every tensor |t|, a BN stack's mean rows -|mean|."""
    out = []
    for i, a in enumerate(args[:-1]):
        a = a.abs()
        if i in bn:
            a = a.clone()
            a[0::4] = -a[0::4]
        out.append(a)
    return (*out, args[-1])


def _evaluate(name, args, dtype=torch.float32, masks=None, absolute=False):
    """Plain version ``name`` on ``args`` (its arguments, dils last) in
    ``dtype``, with the ReLU masks in ``masks`` pinned (name -> bool
    tensor) and, with ``absolute``, as the sums of |terms| of the
    evaluation that made ``masks``.  Returns (outputs, masks used)."""
    body, bn = _BODIES[name]
    ev = _Eval(dtype, masks, absolute)
    if absolute:
        args = _absolute(args, bn)
    return body(ev, *args), ev.masks


def _plain(name, args, dtype, terms):
    out, masks = _evaluate(name, args, dtype)
    if not terms:
        return out
    return out, _evaluate(name, args, dtype, masks, absolute=True)[0]


def cam_f1_fwd_plain(x, kr, kh, dils, dtype=torch.float32, terms=False):
    """F1: s_r (2, C), s_h (2 nb, hc) and per-image sums of x (B, C), in
    ``dtype``; with ``terms`` also each element's sum of |terms| (as
    (outputs, sums))."""
    cam_f1_fwd_plain.calls += 1
    return _plain("cam_f1_fwd", (x, kr, kh, dils), dtype, terms)


def cam_f1_bwd_plain(x, kr, kh, dsr, dsh, dgap, dils, dtype=torch.float32,
                     terms=False):
    """F1b: dx (x.dtype), dkr (C, C), dkh (nb, 3, 3, C, hc) in ``dtype``;
    ``dgap`` is the cotangent of the mean gap (the 1/(H W) is applied
    here, as the kernel does).  ``terms`` as :func:`cam_f1_fwd_plain`."""
    cam_f1_bwd_plain.calls += 1
    return _plain("cam_f1_bwd", (x, kr, kh, dsr, dsh, dgap, dils), dtype,
                  terms)


def cam_f2_fwd_plain(x, kh, kt, bnh, dils, dtype=torch.float32,
                     terms=False) -> torch.Tensor:
    """F2: s_t (2, C) of t = bf16(top conv of the normalised branches).
    ``dtype``, ``terms`` as :func:`cam_f1_fwd_plain`."""
    cam_f2_fwd_plain.calls += 1
    return _plain("cam_f2_fwd", (x, kh, kt, bnh, dils), dtype, terms)


def cam_f2_bwd_plain(x, kh, kt, bnh, dst, dils, dtype=torch.float32,
                     terms=False):
    """F2b: dx (x.dtype), dkh, dkt (nb, hc, C), dS (2 nb, hc) in
    ``dtype``.  ``terms`` as :func:`cam_f1_fwd_plain`."""
    cam_f2_bwd_plain.calls += 1
    return _plain("cam_f2_bwd", (x, kh, kt, bnh, dst, dils), dtype, terms)


def cam_f3_fwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, dils,
                     dtype=torch.float32, terms=False):
    """F3: the CAM output relu(res + y * gate), (B, H, W, C) in x.dtype.
    ``dtype``, ``terms`` as :func:`cam_f1_fwd_plain`."""
    cam_f3_fwd_plain.calls += 1
    return _plain("cam_f3_fwd", (x, kr, kh, kt, bnr, bnh, bnt, gate, dils),
                  dtype, terms)


def cam_f3_bwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils,
                     dtype=torch.float32, terms=False):
    """F3b: dx (x.dtype), dkr, dkh, dkt, dSr (2, C), dSh (2 nb, hc),
    dSt (2, C), dgate (B, C) in ``dtype``.  Image b's gate throughout.
    ``terms`` as :func:`cam_f1_fwd_plain`."""
    cam_f3_bwd_plain.calls += 1
    return _plain("cam_f3_bwd",
                  (x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils), dtype, terms)


for _fn in (cam_f1_fwd_plain, cam_f1_bwd_plain, cam_f2_fwd_plain,
            cam_f2_bwd_plain, cam_f3_fwd_plain, cam_f3_bwd_plain):
    _fn.calls = 0


# ------------------------------------------------------------ the kernels

def _geo(x, kh, dils):
    b, h, w, c = x.shape
    nb, _, _, _, hc = kh.shape
    dl = list(dils) + [1] * (NB_MAX - len(dils))
    return (ctypes.c_int * 12)(b, h, w, c, nb, hc, *dl)


def _check(x, kr, kh, kt, dils, f32_args, bf16_args=()):
    """Shapes, types and device of a kernel call; returns the contiguous
    tensors in the order given (x, then the bf16 weights, then float32)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if kh.dim() != 5 or tuple(kh.shape[1:4]) != (3, 3, c):
        raise ValueError(f"kh must be (nb, 3, 3, {c}, hc), got "
                         f"{tuple(kh.shape)}")
    nb, hc = kh.shape[0], kh.shape[4]
    if len(dils) != nb or not 1 <= nb <= NB_MAX or min(dils) < 1:
        raise ValueError(f"the CAM kernels take 1..{NB_MAX} dilations >= 1 "
                         f"(one per branch); got dils {tuple(dils)}, kh "
                         f"{tuple(kh.shape)}")
    if kr is not None and tuple(kr.shape) != (c, c):
        raise ValueError(f"kr must be ({c}, {c}), got {tuple(kr.shape)}")
    if kt is not None and tuple(kt.shape) != (nb, hc, c):
        raise ValueError(f"kt must be ({nb}, {hc}, {c}), got "
                         f"{tuple(kt.shape)}")
    out = []
    for t in (x, kr, kh, kt, *bf16_args):
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CAM kernels take bf16 activations and "
                            f"weights, got {t.dtype}")
        out.append(t)
    for t in f32_args:
        if t.dtype != torch.float32:
            raise TypeError(f"the CAM kernels take float32 BN rows, gates "
                            f"and cotangents, got {t.dtype}")
        out.append(t)
    for t in out:
        if t.device != x.device:
            raise ValueError(f"a CAM operand is on {t.device}, x on "
                             f"{x.device}")
    return [t.contiguous() for t in out]


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name, _SIGS[name])
    for fn in _WORKSPACE[name]:
        getattr(lib, fn).argtypes = [_P]
        getattr(lib, fn).restype = ctypes.c_longlong
    plans = [f"cam_{op}_plan" for op in TILE_OPS   # cam_wg.cuh:op_plan
             if f"cam_{op[:2]}" == name]
    if name == "cam_f1":
        lib.cam_wgrad_workspace.argtypes = [_P]
        lib.cam_wgrad_workspace.restype = ctypes.c_longlong
        plans.append("cam_wgrad_plan")
    for fn in plans:
        getattr(lib, fn).argtypes = [_P, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_longlong
    return lib


def _workspace(lib, fn: str, geo, device) -> torch.Tensor:
    n = getattr(lib, fn)(ctypes.addressof(geo))
    if n < 0:
        raise ValueError("the CAM kernels refuse this geometry")
    return torch.empty(max(int(n), 1), dtype=torch.uint8, device=device)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _dispatch(x, name):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def cam_f1_fwd(x, kr, kh, dils):
    """F1 (replaces ``pallas_cam.py:_f1_call``): (s_r, s_h, sums of x per
    image), float32.  On the card ``csrc/cam_wg.cuh``'s f1_wg_kernel;
    ``ValueError`` only for a largest dilation whose halo does not fit
    (:func:`tile_plan`)."""
    if not _dispatch(x, "cam_f1_fwd"):
        return cam_f1_fwd_plain(x, kr, kh, dils)
    x, kr, kh = _check(x, kr, kh, None, dils, ())
    b, _, _, c = x.shape
    nb, hc = kh.shape[0], kh.shape[4]
    lib, geo, ws, w0, _, xpad = _tile_call("f1", "cam_f1_fwd", x, kr, kh,
                                           None, dils)
    f32 = dict(dtype=torch.float32, device=x.device)
    s_r, s_h, gap = (torch.empty((2, c), **f32),
                     torch.empty((2 * nb, hc), **f32),
                     torch.empty((b, c), **f32))
    err = lib.cam_f1_launch(ctypes.addressof(geo),
                            *_ptrs(xpad, w0, ws, s_r, s_h, gap), _stream(x))
    _build.check(err, "cam_f1_fwd")
    cam_f1_fwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f1_fwd", (x, kr, kh, dils), (s_r, s_h, gap),
                          cam_f1_fwd_plain)
    return s_r, s_h, gap


def cam_f2_fwd(x, kh, kt, bnh, dils):
    """F2 (replaces ``pallas_cam.py:_f2_call``): s_t (2, C) float32.  On
    the card ``csrc/cam_wg.cuh``'s f2_wg_kernel; ``ValueError`` only for a
    largest dilation whose halo does not fit (:func:`tile_plan`)."""
    if not _dispatch(x, "cam_f2_fwd"):
        return cam_f2_fwd_plain(x, kh, kt, bnh, dils)
    x, kh, kt, bnh = _check(x, None, kh, kt, dils, (bnh,))
    lib, geo, ws, w0, _, xpad = _tile_call("f2", "cam_f2_fwd", x, None, kh,
                                           kt, dils)
    s_t = torch.empty((2, x.shape[3]), dtype=torch.float32, device=x.device)
    err = lib.cam_f2_launch(ctypes.addressof(geo),
                            *_ptrs(xpad, w0, bnh, ws, s_t), _stream(x))
    _build.check(err, "cam_f2_fwd")
    cam_f2_fwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f2_fwd", (x, kh, kt, bnh, dils), (s_t,),
                          cam_f2_fwd_plain)
    return s_t


def cam_f3_fwd(x, kr, kh, kt, bnr, bnh, bnt, gate, dils):
    """F3 (replaces ``pallas_cam.py:_f3_call``): the CAM output,
    (B, H, W, C) bf16.  On the card ``csrc/cam_wg.cuh``'s f3_wg_kernel;
    ``ValueError`` only for a largest dilation whose halo does not fit
    (:func:`tile_plan`)."""
    if not _dispatch(x, "cam_f3_fwd"):
        return cam_f3_fwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, dils)
    x, kr, kh, kt, bnr, bnh, bnt, gate = _check(
        x, kr, kh, kt, dils, (bnr, bnh, bnt, gate))
    lib, geo, ws, w0, _, xpad = _tile_call("f3", "cam_f3_fwd", x, kr, kh,
                                           kt, dils)
    out = torch.empty_like(x)
    err = lib.cam_f3_launch(
        ctypes.addressof(geo),
        *_ptrs(xpad, w0, bnr, bnh, bnt, gate, ws, out), _stream(x))
    _build.check(err, "cam_f3_fwd")
    cam_f3_fwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f3_fwd",
                          (x, kr, kh, kt, bnr, bnh, bnt, gate, dils), (out,),
                          cam_f3_fwd_plain)
    return out


# ------------------------------------------------------------ the tiles
#
# The kernels of the six ops (csrc/cam_wg.cuh: f1_wg_kernel, f2_wg_kernel,
# f3_wg_kernel, and each backward's phase 0, f1b_wg_kernel, f2b_wg_kernel,
# f3b_wg_kernel, then its dx_wg_kernel) walk 8 x 8 pixel tiles of one
# image and read every weight in the order and layout the wrapper gives
# it once per call: whole branches of up to 128 columns, the halo at full
# depth where it fits (_wg_plan; dx: all output columns in one block, the
# dc halo once a tile, _dx_plan).  Every op refuses only a geometry past
# the ops' limit (_limit): a largest dilation whose halo does not fit the
# mma.sync tile plans that first ran the ops.  tile_plan and
# _tile_weights are that contract's Python side, per op ("f1", "f2",
# "f3", "f1b", "f2b", "f3b"); the C side (cam_wg.cuh: within_limit,
# make_fplan, fwd_produce, make_dplan, dx_produce, op_plan) computes the
# same, and each wrapper checks the weight counts against it
# (cam_f{1,2,3}_plan, cam_f{1,2,3}b_plan) once a geometry.

TILE_TS = 8          # tile side (cam_wg.cuh:TS)
TILE_TP = 64         # pixels of a tile (cam_core.cuh:TP)
SMEM_MAX = 232448    # dynamic shared memory of an sm_90 block, bytes
# the ops' limit (cam_wg.cuh:within_limit): the mma.sync plans' branch
# width, weight slots, 1x1-chunk rows and dx rows, and their column-sum
# scratch (bytes)
LIM_SW, LIM_SLOTS, LIM_ROWS, LIM_NX = 40, 3, 56, 168
LIM_RED = 4 * 4 * 5 * LIM_ROWS
# cam_wg.cuh's plan: ring slots, columns of a 1x1 chunk, n8 tiles of a
# branch slice (the kernels' instances), bytes before the ring, F1's and
# F2's and the branch backward's (F2b, F3b) column-sum scratch (f32);
# dx_wg_kernel's n8 tiles a warpgroup (its instances)
WG_NS, WG_N1, WG_NTB, WG_BAR, WG_RED = 4, 64, (2, 4, 6, 8, 12, 16), 128, 1024
WG_RED3 = 1280
DX_NTW = (8, 12, 14, 17)
# cam_<op>_plan's codes 0..20 (cam_wg.cuh:op_plan), as tile_plan's keys
PLAN_CODES = ("smem0", "smem1", "w0_elems", "w1_elems", "wg", "kq", "kqa",
              "dx_kb", "dx_kq", "nsl", "ntb", "kb", "a_res", "rows_smem",
              "wg_nst", "dx_wg", "dx_ntw", "dx_npass", "dx_hres",
              "dx_dr_res", "dx_nst")
# op -> (its phase 0 runs x kr^T, a kt^T, the branch backward), as
# cam_wg.cuh:make_tgeo sets res, top and bb; a backward ("...b") also has
# a phase 1 (dx), a forward none
TILE_OPS = {"f1b": (True, False, False), "f2b": (False, True, True),
            "f3b": (True, True, True), "f1": (True, False, False),
            "f3": (True, True, False), "f2": (False, True, False)}


def _up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _k_chunks(k: int, kmax: int) -> Tuple[int, int]:
    """(width, count) of chunks of K (cam_wg.cuh:k_chunks): as few as
    fit in kmax, of even width to 16."""
    n = -(-k // kmax)
    return _up(-(-k // n), 16), n


def _k_fit(hr: int, slot: int, fixed: int) -> int:
    """The widest chunk (a multiple of 16; -1 if none) whose two halo
    buffers of hr rows and LIM_SLOTS slots of ``slot`` rows, pitch
    chunk + 8 bf16, and ``fixed`` bytes fit SMEM_MAX (cam_wg.cuh:
    k_fit): the K-chunked mma.sync plan's fit, part of the ops' limit."""
    k = (SMEM_MAX - fixed) // (2 * (2 * hr + LIM_SLOTS * slot)) - 8
    return -1 if k < 16 else k // 16 * 16


def _limit(op: str, p: Dict[str, int], c: int, nh: int, hc: int) -> bool:
    """Whether ``op`` takes the geometry of ``p`` (cam_wg.cuh:
    within_limit): where the mma.sync tile plans that first ran the ops
    took it.  The whole-depth plan's shared memory (a branch of at most
    LIM_SW columns; phase 0: the x halo at full depth, LIM_SLOTS weight
    slots of LIM_ROWS rows of the widest K, a's and the branch backward's
    rows, the epilogues' rows and column-sum scratch; a backward's dx:
    dr's rows, the dc halo, LIM_SLOTS slots of up to LIM_NX rows of khc),
    or else the K-chunked plan's (:func:`_k_fit`: a 16-channel chunk of
    the halo, double-buffered, beside LIM_SLOTS slots of LIM_ROWS weight
    and 64 A rows; for a backward also of up to LIM_NX weight and 64 dr
    rows).  So at C = 163 F1b and F3b refuse a largest dilation of 19, the
    others 20; the plans that run now need less wherever it is taken."""
    res, top, bb = TILE_OPS[op]
    bwd = op.endswith("b")
    kc, knh, khc, hr, tp = p["kc"], p["knh"], p["khc"], p["hr"], TILE_TP
    nxr = min(LIM_NX, _up(c, 8))
    kw0 = max(kc, knh) if top else kc
    el = hr * (kc + 8) + LIM_SLOTS * LIM_ROWS * (kw0 + 8)
    if top:
        el += tp * (knh + 8)
    if bb:
        el += tp * (knh + 8) + tp * (kc + 8)
    smem0 = 2 * el + 4 * _wg_rows(op, c, nh) + (LIM_RED if bb else 0)
    smem1 = 2 * (tp * (kc + 8) * res + hr * (p["ldc"] + 8)
                 + LIM_SLOTS * nxr * (khc + 8)) if bwd else 0
    if hc <= LIM_SW and max(smem0, smem1) <= SMEM_MAX:
        return True
    return (_k_fit(hr, LIM_ROWS + tp, LIM_RED if bb else 0) >= 0
            and (not bwd or _k_fit(hr, nxr + res * tp, 0) >= 0))


def tile_plan(op: str, b: int, h: int, w: int, c: int, dils: Sequence[int],
              hc: int) -> Dict[str, int]:
    """Tiles, padded widths and pitches (bf16 elements), stage counts,
    shared memory (bytes; smem1 0 for a forward) and re-laid weight sizes
    (bf16 elements; w1_elems 0 for a forward) of ``op``'s kernels at x
    (b, h, w, c), ``dils``, branch width hc: phase 0's plan
    (:func:`_wg_plan`: its slices, nsl of sw columns, and chunks, kq / nq
    of kc, kqa / nqa of knh) and a backward's phase 1's (dx_wg_kernel,
    :func:`_dx_plan`); "ok" (and "wg") 0 where the geometry is past the
    ops' limit (:func:`_limit`)."""
    bwd = op.endswith("b")
    nb = len(dils)
    nh = nb * hc
    kc, khc, knh = _up(c, 16), _up(hc, 16), _up(nh, 16)
    tiles_x, tiles_y = -(-w // TILE_TS), -(-h // TILE_TS)
    dmax = max(dils)
    hs = TILE_TS + 2 * dmax
    p = dict(tiles_x=tiles_x, tiles_y=tiles_y, tpi=tiles_x * tiles_y,
             n_tiles=b * tiles_x * tiles_y, dmax=dmax, hs=hs, hr=hs * hs,
             kc=kc, khc=khc, knh=knh, ldc=nb * khc, ok=1, wg=1, smem1=0,
             w1_elems=0, dx_wg=0, dx_ntw=0, dx_npass=0, dx_hres=0,
             dx_dr_res=0, dx_nst=0, dx_kb=0, dx_kq=0)
    if not _limit(op, p, c, nh, hc):
        p.update(ok=0, wg=0)
        return p
    _wg_plan(p, op, c, nb, hc)
    if bwd and p["ok"]:
        _dx_plan(p, TILE_OPS[op][0], c, nb)
    return p


def _wg_rows(op, c, nh):
    """cam_wg.cuh:fplan_rows: f32 elements of the rows ``op``'s epilogues
    read (f1b dsr and dsh, f2b dst and bnh, f2 bnh, f3 and f3b bnr, bnt,
    the gate and bnh)."""
    return {"f1": 0, "f1b": 2 * c + 2 * nh, "f2": 4 * nh,
            "f2b": 2 * c + 4 * nh}.get(op, 9 * c + 4 * nh)


def _wg_fixed(p, op, c, nh, kq, a_res, rows):
    """cam_wg.cuh:fplan_fixed: shared memory besides the ring."""
    _, top, bb = TILE_OPS[op]
    b = WG_BAR + 2 * p["hr"] * kq
    if top and a_res:
        b += 2 * TILE_TP * p["knh"]
    if rows:
        b += 4 * _wg_rows(op, c, nh)
    return b + (4 * WG_RED3 if bb else 0) \
        + (4 * WG_RED if op in ("f1", "f2") else 0)


def _wg_plan(p, op, c, nb, hc):
    """The phase-0 plan of ``op`` (cam_wg.cuh:make_fplan), into ``p``: a branch
    slice of ntb n8 tiles (sw columns, nsl slices), 1x1 chunks of WG_N1 columns
    (nch1), the x halo in nq chunks of kq, x's stages kb wide at most, a's
    (top: F2, F3, F2b, F3b) kqa (nqa of them), a (a_res) and the epilogues'
    rows (rows_smem; F1b's always) in shared memory or not; the branch
    backward's (F2b, F3b) dt restaged into the halo's buffer in nd chunks of
    kdq, its stages kbd wide; wg_nst stages a tile; smem0 and w0_elems its
    own."""
    res, top, bb = TILE_OPS[op]
    kc, knh, hr, nh = p["kc"], p["knh"], p["hr"], nb * hc
    n8 = -(-hc // 8)
    nsl = -(-n8 // 16)
    ntb = next(v for v in WG_NTB if v >= -(-n8 // nsl))
    sw, nch1 = 8 * ntb, -(-c // WG_N1)
    nw = max(sw, WG_N1)
    found = None
    for thr in (64, 16):
        for m in range(3 if top else 1):
            a_res = int(top and m < 2)
            rows = int(m < 1) if top else int(op == "f1b")
            prev, nq = 0, 0
            while found is None:
                nq += 1
                kq = _up(-(-kc // nq), 16)
                if kq == prev:
                    continue
                prev = kq
                avail = SMEM_MAX - _wg_fixed(p, op, c, nh, kq, a_res, rows)
                k = -1 if avail < 0 else avail // (2 * WG_NS * nw) // 16 * 16
                if k >= min(thr, kq):
                    found = (k, kq, a_res, rows)
                elif kq <= 16:
                    break
            if found:
                break
        if found:
            break
    if found is None:
        p["ok"] = 0
        return
    kb, kq, a_res, rows = found
    nq = -(-kc // kq)
    kbx = _k_chunks(kq, kb)[0]
    kba, nba = 0, 0
    cap = hr * kq // TILE_TP // 16 * 16    # rows restaged into the halo's
    if top:                                # buffer, 64 a plane
        ka = kb if a_res else min(cap, kb)
        kba, nba = _k_chunks(knh, ka)
    kdq, nd, kbd, nud = 0, 0, 0, 0
    if bb:
        kdq, nd = (kc, 1) if kc <= cap else _k_chunks(kc, cap)
        kbd = _k_chunks(kdq, kb)[0]
        nud = sum(-(-min(kdq, kc - q * kdq) // kbd) for q in range(nd))
    slot = max(kbx, kba, kbd) * nw
    nu = sum(-(-min(kq, kc - q * kq) // kbx) for q in range(nq))
    nbr = 9 * nb * nsl * nu
    n11 = nch1 * (res * nu + top * nba)
    nst = nbr + n11 + bb * nb * nsl * nud
    p.update(wg=1, ntb=ntb, sw=sw, nsl=nsl, nch1=nch1, kq=kq, nq=nq,
             kb=kbx, kqa=kba, nqa=nba, a_res=a_res, rows_smem=rows, kdq=kdq,
             nd=nd, kbd=kbd, slot=slot, wg_nst=nst,
             smem0=_wg_fixed(p, op, c, nh, kq, a_res, rows)
             + 2 * WG_NS * slot,
             w0_elems=9 * nb * nsl * kc * sw + nch1 * WG_N1 * (
                 res * kc + top * knh) + bb * nb * nsl * kc * sw)


def _dx_fixed(p, res, hres, kq, dr_res):
    """cam_wg.cuh:dplan_fixed: shared memory besides the ring and the
    restaged dr rows."""
    return WG_BAR + 2 * p["hr"] * (p["ldc"] if hres else 2 * kq) \
        + (2 * TILE_TP * p["kc"] if res and dr_res else 0)


def _dx_plan(p, res, c, nb):
    """A backward's phase 1, dx_wg_kernel's plan (cam_wg.cuh:make_dplan), into
    ``p``: dx_ntw n8 tiles a consumer warpgroup (one wgmma), dx_npass column
    passes of dx_np columns, the dc halo whole (dx_hres) or a chunk of dx_kq
    channels of a branch at a time in two buffers (dx_nq chunks a branch), dr's
    rows whole (dx_dr_res) or a stage at a time, stages dx_kbr wide over dr's
    kc and dx_kb over a chunk, dx_nst stages a tile; smem1 and w1_elems its
    own."""
    kc, khc, hr = p["kc"], p["khc"], p["hr"]
    n8 = -(-c // 8)
    npass = -(-n8 // (2 * max(DX_NTW)))
    ntw = next(v for v in DX_NTW if v >= -(-n8 // (2 * npass)))
    np_ = 16 * ntw
    found = None
    for thr in (64, 16):
        for hres, dr_res in ((1, 1), (0, 1), (1, 0), (0, 0)):
            if not res and not dr_res:
                continue
            prev, nq = 0, 0
            while found is None:
                nq += 1
                kq = _up(-(-khc // nq), 16)
                if kq == prev:
                    continue
                prev = kq
                avail = SMEM_MAX - _dx_fixed(p, res, hres, kq, dr_res)
                per = 2 * (WG_NS * np_ + (TILE_TP if res and not dr_res
                                          else 0))
                k = -1 if avail < 0 else avail // per // 16 * 16
                if k >= min(thr, kq):
                    found = (k, hres, kq, dr_res)
                if hres or kq <= 16:
                    break
            if found:
                break
        if found:
            break
    if found is None:
        p["ok"] = 0
        return
    kb, hres, kq, dr_res = found
    nq = -(-khc // kq)
    kbr = _k_chunks(kc, kb)[0] if res else 0
    kbc = _k_chunks(kq, kb)[0]
    slot = max(kbr, kbc) * np_
    nu = sum(-(-min(kq, khc - q * kq) // kbc) for q in range(nq))
    nst = npass * ((-(-kc // kbr) if res else 0) + 9 * nb * nu)
    p.update(dx_wg=1, dx_ntw=ntw, dx_npass=npass, dx_np=np_, dx_hres=hres,
             dx_kq=kq, dx_nq=nq, dx_dr_res=dr_res, dx_kbr=kbr, dx_kb=kbc,
             dx_slot=slot, dx_nst=nst,
             smem1=_dx_fixed(p, res, hres, kq, dr_res) + 2 * WG_NS * slot
             + (2 * TILE_TP * kbr if res and not dr_res else 0),
             w1_elems=npass * np_ * (res * kc + 9 * nb * khc))


def _wg_stages(k: int, width: int):
    """(first k, width) of the K stages over ``k`` channels in chunks of
    ``width`` (the last what is left)."""
    return [(k0, min(width, k - k0)) for k0 in range(0, k, width)]


def _wg_x_stages(p):
    """x's K stages in walking order: per chunk of kq, its stages of kb
    (cam_wg.cuh:fwd_produce)."""
    kc, kq = p["kc"], p["kq"]
    return [[(q * kq + k0, kw) for k0, kw in
             _wg_stages(min(kq, kc - q * kq), p["kb"])]
            for q in range(p["nq"])]


def _wg_block(t: torch.Tensor, k0: int, kw: int) -> torch.Tensor:
    """Rows k0 .. k0 + kw of t (..., K, N) as wgmma's N-major core
    matrices: (..., N / 8, kw, 8)."""
    blk = t[..., k0:k0 + kw, :]
    blk = blk.reshape(*blk.shape[:-1], blk.shape[-1] // 8, 8)
    return blk.transpose(-3, -2)


def _wg_weights(op: str, p: Dict[str, int], kr, kh, kt) -> torch.Tensor:
    """cam_wg.cuh's re-laid weights, in the order fwd_produce copies them,
    each stage [N / 8][kw][8] (N the stage's output columns) with zeros
    padding K and N: per (branch, slice, chunk of x, tap, stage of kb)
    kh[i, tap] [kw][sw]; then per 1x1 chunk of WG_N1 output columns kr's
    x stages [kw][WG_N1] (f1, f3, f1b, f3b) and kt's stages over knh (f2,
    f3, f2b, f3b); then (f2b, f3b) per (branch, slice, chunk of dt, stage
    of kbd) kt[i]^T [kw][sw].  So f1b's layout is f1's, f2's the prefix
    of f2b's before its kt[i]^T stages, and f2b's f3b's without the kr
    stages."""
    res, top, bb = TILE_OPS[op]
    nb, _, _, c, hc = kh.shape
    nh = nb * hc
    kc, knh, nsl, sw, nch1 = p["kc"], p["knh"], p["nsl"], p["sw"], p["nch1"]
    xst = _wg_x_stages(p)
    khp = F.pad(kh.reshape(nb, 9, c, hc), (0, nsl * sw - hc, 0, kc - c))
    khp = khp.reshape(nb, 9, kc, nsl, sw).permute(0, 3, 1, 2, 4)
    branch = []
    for chunk in xst:
        # per tap, the chunk's stages: (nb, nsl, 9, ...)
        branch.append(torch.cat(
            [_wg_block(khp, k0, kw).reshape(nb, nsl, 9, -1)
             for k0, kw in chunk], 3).reshape(nb, nsl, -1))
    ncol = nch1 * WG_N1
    ones = []
    if res:
        krp = F.pad(kr, (0, ncol - c, 0, kc - c)).reshape(kc, nch1, WG_N1)
        ones += [_wg_block(krp.transpose(0, 1), k0, kw).reshape(nch1, -1)
                 for chunk in xst for k0, kw in chunk]
    if top:
        ktp = F.pad(kt.reshape(nh, c), (0, ncol - c, 0, knh - nh))
        ktp = ktp.reshape(knh, nch1, WG_N1).transpose(0, 1)
        ones += [_wg_block(ktp, k0, kw).reshape(nch1, -1)
                 for k0, kw in _wg_stages(knh, p["kqa"])]
    out = [torch.cat(branch, 2).reshape(-1), torch.cat(ones, 1).reshape(-1)]
    if bb:
        # kt[i]^T (kc, nsl sw) per branch, a slice's columns a stage
        ktb = F.pad(kt.transpose(1, 2), (0, nsl * sw - hc, 0, kc - c))
        ktb = ktb.reshape(nb, kc, nsl, sw).transpose(1, 2)
        out.append(torch.cat(
            [_wg_block(ktb, q + k0, kw).reshape(nb, nsl, -1)
             for q, wd in _wg_stages(kc, p["kdq"])
             for k0, kw in _wg_stages(wd, p["kbd"])], 2).reshape(-1))
    return torch.cat(out).contiguous()


def _dx_weights(op: str, p: Dict[str, int], kr, kh) -> torch.Tensor:
    """dx_wg_kernel's re-laid weights, in the order cam_wg.cuh:dx_produce
    copies them, each stage [dx_np / 8][kw][8] with zeros padding K and N:
    per column pass of dx_np output channels, kr's stages over dr's kc
    (f1b, f3b: B[k][n] = kr[n][k]), then per (branch, chunk of khc, tap,
    stage) kh[i, tap]^T [kw][dx_np]."""
    res = TILE_OPS[op][0]
    nb, _, _, c, hc = kh.shape
    kc, khc, np_ = p["kc"], p["khc"], p["dx_np"]
    ncol = p["dx_npass"] * np_
    parts = []
    if res:
        krt = F.pad(kr.t(), (0, ncol - c, 0, kc - c))
        parts += [_wg_block(krt, k0, kw).reshape(-1)
                  for k0, kw in _wg_stages(kc, p["dx_kbr"])]
    # (nb, 9, khc, ncol): kh[i, tap]^T
    kht = F.pad(kh.reshape(nb, 9, c, hc).transpose(2, 3),
                (0, ncol - c, 0, khc - hc))
    for i in range(nb):
        for q, wq in _wg_stages(khc, p["dx_kq"]):
            for tap in range(9):
                parts += [_wg_block(kht[i, tap], q + k0, kw).reshape(-1)
                          for k0, kw in _wg_stages(wq, p["dx_kb"])]
    # the passes: each stage's n8 groups split by pass, pass-major
    out = []
    for pc in range(p["dx_npass"]):
        g0 = pc * np_ // 8
        out += [t.reshape(ncol // 8, -1)[g0:g0 + np_ // 8].reshape(-1)
                for t in parts]
    return torch.cat(out).contiguous()


def _relaid_index(op: str, p: Dict[str, int], nb: int, c: int,
                  hc: int) -> Tuple[torch.Tensor, int]:
    """Where each element of ``op``'s re-laid weights on the plan ``p``
    comes from: (index, n0), the layouts of :func:`_wg_weights` (w0, n0
    elements) and, for a backward, :func:`_dx_weights` (w1, after it) as
    positions in [0, kr, kh, kt] flattened (kr where ``op`` runs kr^T,
    kt where it runs kt^T; the 0 in front is every padding element),
    int64 on the CPU.  Built once per plan geometry (``op``, C, the
    dilation count, hc, the largest dilation: the plan depends on no
    other size) by running the layout code on index tensors."""
    key = (op, c, nb, hc, p["dmax"])
    got = _INDEX.get(key)
    if got is None:
        res, top, _ = TILE_OPS[op]
        n = 1

        def ids(*shape):
            nonlocal n
            t = torch.arange(n, n + math.prod(shape)).reshape(shape)
            n += t.numel()
            return t

        kr = ids(c, c) if res else None
        kh = ids(nb, 3, 3, c, hc)
        kt = ids(nb, hc, c) if top else None
        w0 = _wg_weights(op, p, kr, kh, kt)
        w1 = [_dx_weights(op, p, kr, kh)] if op.endswith("b") else []
        got = _INDEX[key] = (torch.cat([w0] + w1), w0.numel())
    return got


_INDEX: Dict[tuple, Tuple[torch.Tensor, int]] = {}


def _tile_weights(op: str, kr, kh, kt, plan, index=None) -> Tuple[
        torch.Tensor, ...]:
    """kr, kh, kt (those ``op`` reads; None for the others) re-laid for
    its kernels on ``plan`` (the call's :func:`tile_plan`): w0, phase 0's
    stages (:func:`_wg_weights`), and for a backward w1, dx_wg_kernel's
    (:func:`_dx_weights`; None for a forward), by one ``index_select`` of
    the weights flattened behind one zero, bitwise those functions'
    output.  ``index``: :func:`_relaid_index`'s (index, n0) on the
    weights' device, else built here."""
    nb, _, _, c, hc = kh.shape
    res, top, _ = TILE_OPS[op]
    idx, n0 = index or _relaid_index(op, plan, nb, c, hc)
    parts = [kh.new_zeros(1)] + [t.reshape(-1) for t, on in (
        (kr, res), (kh, True), (kt, top)) if on]
    w = torch.cat(parts).index_select(0, idx.to(kh.device))
    return w[:n0], (w[n0:] if op.endswith("b") else None)


def _tile_call(op: str, name: str, x, kr, kh, kt, dils):
    """The plan, the library, the geometry, the workspace (None where
    ``op`` takes none), the re-laid weights (w1 None for a forward) and
    the channel-padded x of a kernel call of ``op``; ``ValueError``
    where the largest dilation's halo, in chunks of 16 channels, does not
    fit a block's shared memory.  The plan, the weights' index on x's
    device and the C plans' check of the weight counts are made once a
    geometry (:data:`_CALLS`)."""
    b, h, w, c = x.shape
    nb, hc = kh.shape[0], kh.shape[4]
    key = (op, b, h, w, c, tuple(dils), hc, x.device)
    got = _CALLS.get(key)
    if got is None:
        plan = tile_plan(op, b, h, w, c, dils, hc)
        if not plan["ok"]:
            raise ValueError(
                f"{name}: the largest dilation {max(dils)} is too large: "
                f"its tile halo ({plan['hs']} x {plan['hs']} pixels) in "
                f"chunks of 16 channels does not fit {SMEM_MAX} bytes of "
                f"shared memory")
    lname = f"cam_{op[:2]}"
    lib = _lib(lname)
    geo = _geo(x, kh, dils)
    if got is None:
        idx, n0 = _relaid_index(op, plan, nb, c, hc)
        plan_fn = getattr(lib, f"cam_{op}_plan")
        for what, n in ((2, n0), (3, idx.numel() - n0)):
            if plan_fn(ctypes.addressof(geo), what) != n:
                raise RuntimeError(f"{name}: the re-laid weights and the "
                                   "kernels' layout disagree")
        got = _CALLS[key] = (plan, (idx.to(x.device), n0))
    plan, index = got
    ws_fn = f"cam_{op}_workspace"
    ws = (_workspace(lib, ws_fn, geo, x.device)
          if ws_fn in _WORKSPACE[lname] else None)
    w0, w1 = _tile_weights(op, kr, kh, kt, plan, index)
    xpad = F.pad(x, (0, plan["kc"] - c))
    return lib, geo, ws, w0, w1, xpad


# (op, B, H, W, C, dilations, hc, device) -> (the plan, the weights'
# index on that device): what _tile_call makes once a geometry
_CALLS: Dict[tuple, tuple] = {}


def cam_f1_bwd(x, kr, kh, dsr, dsh, dgap, dils):
    """F1b (replaces ``pallas_cam.py:_f1b_call``): (dx, dkr, dkh).  On
    the card ``csrc/cam_wg.cuh``'s f1b_wg_kernel for phase 0 and
    dx_wg_kernel for dx; ``ValueError`` only for a largest dilation whose
    halo does not fit (:func:`tile_plan`)."""
    if not _dispatch(x, "cam_f1_bwd"):
        return cam_f1_bwd_plain(x, kr, kh, dsr, dsh, dgap, dils)
    x, kr, kh, dsr, dsh, dgap = _check(x, kr, kh, None, dils,
                                       (dsr, dsh, dgap))
    lib, geo, ws, w0, w1, xpad = _tile_call("f1b", "cam_f1_bwd", x, kr, kh,
                                            None, dils)
    dx = torch.empty_like(x)
    dkr = torch.empty(kr.shape, dtype=torch.float32, device=x.device)
    dkh = torch.empty(kh.shape, dtype=torch.float32, device=x.device)
    err = lib.cam_f1b_launch(
        ctypes.addressof(geo),
        *_ptrs(xpad, w0, w1, dsr, dsh, dgap, ws, dx, dkr, dkh), _stream(x))
    _build.check(err, "cam_f1_bwd")
    cam_f1_bwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f1_bwd", (x, kr, kh, dsr, dsh, dgap, dils),
                          (dx, dkr, dkh), cam_f1_bwd_plain)
    return dx, dkr, dkh


def _f2b_launch(x, kh, kt, bnh, dst, dils):
    """F2b's kernels on the card: ((dx, dkh, dkt, dS), workspace)."""
    x, kh, kt, bnh, dst = _check(x, None, kh, kt, dils, (bnh, dst))
    lib, geo, ws, w0, w1, xpad = _tile_call("f2b", "cam_f2_bwd", x, None, kh,
                                            kt, dils)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dkh, dkt = torch.empty(kh.shape, **f32), torch.empty(kt.shape, **f32)
    ds = torch.empty((2 * kh.shape[0], kh.shape[4]), **f32)
    err = lib.cam_f2b_launch(
        ctypes.addressof(geo),
        *_ptrs(xpad, w0, w1, bnh, dst, ws, dx, dkh, dkt, ds), _stream(x))
    _build.check(err, "cam_f2_bwd")
    return (dx, dkh, dkt, ds), ws


def cam_f2_bwd(x, kh, kt, bnh, dst, dils):
    """F2b (replaces ``pallas_cam.py:_f2b_call``): (dx, dkh, dkt, dS).  On
    the card ``csrc/cam_wg.cuh``'s f2b_wg_kernel for phase 0 and
    dx_wg_kernel for dx; ``ValueError`` only for a largest dilation whose
    halo does not fit (:func:`tile_plan`)."""
    if not _dispatch(x, "cam_f2_bwd"):
        return cam_f2_bwd_plain(x, kh, kt, bnh, dst, dils)
    out, _ = _f2b_launch(x, kh, kt, bnh, dst, dils)
    cam_f2_bwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f2_bwd", (x, kh, kt, bnh, dst, dils), out,
                          cam_f2_bwd_plain)
    return out


def _f3b_launch(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils):
    """F3b's kernels on the card: ((dx, dkr, dkh, dkt, dSr, dSh, dSt,
    dgate), workspace)."""
    x, kr, kh, kt, g, bnr, bnh, bnt, gate = _check(
        x, kr, kh, kt, dils, (bnr, bnh, bnt, gate), bf16_args=(g,))
    if g.shape != x.shape:
        raise ValueError(f"g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    lib, geo, ws, w0, w1, xpad = _tile_call("f3b", "cam_f3_bwd", x, kr, kh,
                                            kt, dils)
    c = x.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dkr, dkh, dkt = (torch.empty(kr.shape, **f32),
                     torch.empty(kh.shape, **f32),
                     torch.empty(kt.shape, **f32))
    dsr, dst = torch.empty((2, c), **f32), torch.empty((2, c), **f32)
    dsh = torch.empty((2 * kh.shape[0], kh.shape[4]), **f32)
    dgate = torch.empty(gate.shape, **f32)
    err = lib.cam_f3b_launch(
        ctypes.addressof(geo),
        *_ptrs(xpad, w0, w1, bnr, bnh, bnt, gate, g, ws, dx, dkr, dkh, dkt,
               dsr, dsh, dst, dgate), _stream(x))
    _build.check(err, "cam_f3_bwd")
    return (dx, dkr, dkh, dkt, dsr, dsh, dst, dgate), ws


def cam_f3_bwd(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils):
    """F3b (replaces ``pallas_cam.py:_f3b_call``): (dx, dkr, dkh, dkt,
    dSr, dSh, dSt, dgate); image b's gate in both phases.  On the card
    ``csrc/cam_wg.cuh``'s f3b_wg_kernel for phase 0 and dx_wg_kernel for
    dx; ``ValueError`` only for a largest dilation whose halo does not fit
    (:func:`tile_plan`: 19 and up at C = 163)."""
    if not _dispatch(x, "cam_f3_bwd"):
        return cam_f3_bwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils)
    out, _ = _f3b_launch(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils)
    cam_f3_bwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f3_bwd",
                          (x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils), out,
                          cam_f3_bwd_plain)
    return out


# The per-pixel bf16 scratch that F2b's and F3b's phase 0 leaves in the
# workspace for phase 1 and the weight gradients, in carve order
# (csrc/cam_f2.cu:carve_f2b, csrc/cam_f3.cu:carve_f3b; each region
# 256-byte aligned), as (name, tile_plan key of its pitch): a =
# bf16(relu(z_i)) in column i hc + j, dt = bf16(dzt scale inv), dr =
# bf16(dzr scale inv), dc of branch i in columns i khc + j.
_SCRATCH = {"cam_f2_bwd": (_f2b_launch, (("a", "knh"), ("dt", "kc"),
                                         ("dc", "ldc"))),
            "cam_f3_bwd": (_f3b_launch, (("dr", "kc"), ("a", "knh"),
                                         ("dt", "kc"), ("dc", "ldc")))}


def _scratch(name, args):
    """Op ``name`` (F2b or F3b) on the card, launched as its wrapper
    launches it (uncounted): (outputs, {scratch name: (B, H, W, pitch)
    bf16 view of the workspace})."""
    launch, regions = _SCRATCH[name]
    out, ws = launch(*args)
    x, kh, dils = args[0], args[2 if name == "cam_f3_bwd" else 1], args[-1]
    b, h, w, c = x.shape
    p = tile_plan(name[4:6] + "b", b, h, w, c, dils, kh.shape[4])
    views, off = {}, 0
    for key, pitch in regions:
        n = b * h * w * p[pitch]
        views[key] = ws[off:off + 2 * n].view(torch.bfloat16).view(
            b, h, w, p[pitch])
        off += _up(2 * n, 256)
    return out, views


# ------------------------------------------------------------ weight grads
#
# The backwards' weight gradients (csrc/cam_core.cuh: wgrad_taps_kernel for
# dkh, wgrad_plain_kernel for dkr and dkt) run inside cam_f1b / cam_f2b /
# cam_f3b's launches; cam_wgrad runs them alone.  Their plan lives in
# cam_core.cuh:wg_plan only (cam_wgrad_plan exports it).


def wgrad_counts(reset: bool = False) -> Dict[str, Tuple[int, int]]:
    """The weight-gradient kernels' launches by each backward since the
    last reset, counted where the C side launches them: {"cam_f1_bwd":
    (wgrad_taps_kernel, wgrad_plain_kernel), "cam_f2_bwd": ...,
    "cam_f3_bwd": ...}; cam_f1_bwd's library also counts cam_wgrad's.
    ``reset`` sets them to 0 after reading.  Builds the libraries where
    they are not loaded yet."""
    out = {}
    for name in ("cam_f1", "cam_f2", "cam_f3"):
        n = (ctypes.c_longlong * 2)()
        _lib(name).cam_wgrad_counts(n, int(reset))
        out[f"{name}_bwd"] = (int(n[0]), int(n[1]))
    return out


def cam_wgrad_plain(u, v, d: int) -> torch.Tensor:
    """``cam_wgrad``'s plain version: the same sums in float32 through
    :func:`_wgrad` (d >= 1) or one einsum (d = 0)."""
    cam_wgrad_plain.calls += 1
    u32, v32 = u.float(), v.float()
    if d:
        return _wgrad(u32, v32, d)
    return torch.einsum("bhwk,bhwn->kn", u32, v32)


def cam_wgrad(u: torch.Tensor, v: torch.Tensor, d: int) -> torch.Tensor:
    """The backwards' weight-gradient kernels alone
    (``cam_core.cuh:wgrad_taps_kernel`` / ``wgrad_plain_kernel``; they
    stand for the weight-gradient sums of ``pallas_cam.py:_f1b_call`` /
    ``_f2b_call`` / ``_f3b_call``):
    u (B, H, W, K), v (B, H, W, N) bf16.  ``d`` >= 1: the 9 taps of a 3x3
    conv at dilation d, out[ti, tj] = sum over pixels of u shifted by
    ((ti - 1) d, (tj - 1) d) (zero outside the image) times v, (3, 3, K,
    N) float32 (N in slices of at most 40 columns); ``d`` = 0: the plain
    product u^T v, (K, N).  On
    the CPU its plain version; on the card the kernel and its fixed-order
    reduction."""
    if not _dispatch(u, "cam_wgrad"):
        return cam_wgrad_plain(u, v, d)
    if u.dim() != 4 or v.dim() != 4 or u.shape[:3] != v.shape[:3]:
        raise ValueError(f"cam_wgrad: u (B, H, W, K) and v (B, H, W, N) "
                         f"over the same pixels, got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if u.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"cam_wgrad takes bf16 operands, got {u.dtype}, "
                        f"{v.dtype}")
    if v.device != u.device:
        raise ValueError(f"cam_wgrad: v is on {v.device}, u on {u.device}")
    if int(d) < 0:
        raise ValueError(f"cam_wgrad takes d >= 0; got d {d}")
    b, h, w, k = u.shape
    n = v.shape[3]
    up = F.pad(u, (0, _up(k, 8) - k)).contiguous()
    vp = F.pad(v, (0, _up(n, 8) - n)).contiguous()
    prm = (ctypes.c_int * 8)(b, h, w, k, n, int(d), up.shape[3], vp.shape[3])
    lib = _lib("cam_f1")
    nbytes = lib.cam_wgrad_workspace(ctypes.addressof(prm))
    if nbytes < 0:
        raise ValueError("cam_wgrad: the kernel refuses this geometry")
    ws = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=u.device)
    out = torch.empty((3, 3, k, n) if d else (k, n), dtype=torch.float32,
                      device=u.device)
    err = lib.cam_wgrad_launch(ctypes.addressof(prm),
                               *_ptrs(up, vp, ws, out), _stream(u))
    _build.check(err, "cam_wgrad")
    cam_wgrad.launches += 1
    if _observe.active:
        _observe.launched("cam_wgrad", (u, v, d), (out,), cam_wgrad_plain)
    return out


cam_wgrad.launches = 0
cam_wgrad_plain.calls = 0


KERNELS = (cam_f1_fwd, cam_f1_bwd, cam_f2_fwd, cam_f2_bwd, cam_f3_fwd,
           cam_f3_bwd)
PLAIN = (cam_f1_fwd_plain, cam_f1_bwd_plain, cam_f2_fwd_plain,
         cam_f2_bwd_plain, cam_f3_fwd_plain, cam_f3_bwd_plain)
for _fn in KERNELS:
    _fn.launches = 0


# ------------------------------------------------------------ autograd ops

def _bn_param_grads(ds: torch.Tensor, bn: torch.Tensor) -> torch.Tensor:
    """(4k, w) cotangent of the BN row stack from the kernels' per-branch
    reductions ``ds`` = (2k, w) rows [S1z, S2z]:

        z = (c - mean) * inv * scale + bias
        d mean  = -scale * inv * S1z        d scale = inv * S2z
        d inv   =  scale * S2z              d bias  = S1z
    """
    rows = []
    for i in range(bn.shape[0] // 4):
        s1, s2 = ds[2 * i], ds[2 * i + 1]
        _, inv, scale, _ = bn[4 * i], bn[4 * i + 1], bn[4 * i + 2], \
            bn[4 * i + 3]
        rows += [-scale * inv * s1, scale * s2, inv * s2, s1]
    return torch.stack(rows)


class CamF1(torch.autograd.Function):
    """(s_r, s_h, gap mean) of F1, with F1b as its backward."""

    @staticmethod
    def forward(ctx, x, kr, kh, dils):
        s_r, s_h, gap = cam_f1_fwd(x, kr, kh, dils)
        ctx.save_for_backward(x, kr, kh)
        ctx.dils = dils
        return s_r, s_h, gap / (x.shape[1] * x.shape[2])

    @staticmethod
    def backward(ctx, dsr, dsh, dgap):
        x, kr, kh = ctx.saved_tensors
        # the kernel applies 1/(H W) itself: the mean's cotangent as is
        dx, dkr, dkh = cam_f1_bwd(x, kr, kh, dsr, dsh, dgap, ctx.dils)
        return dx, dkr.to(kr.dtype), dkh.to(kh.dtype), None


class CamF2(torch.autograd.Function):
    """s_t (2, C) of F2, with F2b as its backward."""

    @staticmethod
    def forward(ctx, x, kh, kt, bnh, dils):
        ctx.save_for_backward(x, kh, kt, bnh)
        ctx.dils = dils
        return cam_f2_fwd(x, kh, kt, bnh, dils)

    @staticmethod
    def backward(ctx, dst):
        x, kh, kt, bnh = ctx.saved_tensors
        dx, dkh, dkt, ds = cam_f2_bwd(x, kh, kt, bnh, dst, ctx.dils)
        return (dx, dkh.to(kh.dtype), dkt.to(kt.dtype),
                _bn_param_grads(ds, bnh), None)


class CamF3(torch.autograd.Function):
    """The CAM output of F3, with F3b as its backward."""

    @staticmethod
    def forward(ctx, x, kr, kh, kt, bnr, bnh, bnt, gate, dils):
        ctx.save_for_backward(x, kr, kh, kt, bnr, bnh, bnt, gate)
        ctx.dils = dils
        return cam_f3_fwd(x, kr, kh, kt, bnr, bnh, bnt, gate, dils)

    @staticmethod
    def backward(ctx, g):
        x, kr, kh, kt, bnr, bnh, bnt, gate = ctx.saved_tensors
        dx, dkr, dkh, dkt, dsr, dsh, dst, dgate = cam_f3_bwd(
            x, kr, kh, kt, bnr, bnh, bnt, gate, g, ctx.dils)
        return (dx, dkr.to(kr.dtype), dkh.to(kh.dtype), dkt.to(kt.dtype),
                _bn_param_grads(dsr, bnr), _bn_param_grads(dsh, bnh),
                _bn_param_grads(dst, bnt), dgate, None)


def cam_f1(dils, x, kr, kh):
    return CamF1.apply(x, kr, kh, tuple(dils))


def cam_f2(dils, x, kh, kt, bnh):
    return CamF2.apply(x, kh, kt, bnh, tuple(dils))


def cam_f3(dils, x, kr, kh, kt, bnr, bnh, bnt, gate):
    return CamF3.apply(x, kr, kh, kt, bnr, bnh, bnt, gate, tuple(dils))


def _global_sums(group, *args):
    """The statistic sums in ``args`` (tensors) and the local pixel count
    (the last argument) all-reduced over ``group`` in one collective;
    differentiable, so the backward's sums come out global too."""
    *sums, n = args
    flat = torch.cat([t.reshape(-1) for t in sums]
                     + [sums[0].new_full((1,), float(n))])
    flat = all_reduce_sum(flat, group)
    out, k = [], 0
    for t in sums:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return (*out, flat[k])


def fused_cam(x: torch.Tensor, kr: torch.Tensor, kh: torch.Tensor,
              kt: torch.Tensor, scales: Dict[str, torch.Tensor],
              biases: Dict[str, torch.Tensor],
              gate_fn: Callable[[torch.Tensor], torch.Tensor],
              dils: Sequence[int]):
    """One train-mode CAM application through the three fused ops
    (``pallas_cam.py:fused_cam``).

    :param x: (B, H, W, C) bf16.
    :param kr: (C, C) bf16; ``kh``: (nb, 3, 3, C, hc) bf16; ``kt``:
      (nb, hc, C) bf16.
    :param scales, biases: 'r', 't' -> (C,) and 'h' -> (nb, hc) float32.
    :param gate_fn: the mean gap (B, C) -> the SE gate (B, C) float32,
      differentiated by autograd.
    :returns: (out, stats): out (B, H, W, C) bf16; stats maps 'r' / 't'
      -> (mean, var) and 'h' -> ((nb, hc) means, (nb, hc) vars), the
      biased batch statistics for the running-stat update, those of the
      global batch inside ``global_batch_stats``.
    """
    dils = tuple(dils)
    b, h, w, _ = x.shape
    nb = kh.shape[0]
    n = b * h * w

    group = stats_group()
    s_r, s_h, gap = cam_f1(dils, x, kr, kh)
    if group is not None:
        # the global batch's sums and count, between the launches
        s_r, s_h, n = _global_sums(group, s_r, s_h, n)
    mean_r = s_r[0] / n
    var_r = s_r[1] / n - torch.square(mean_r)
    inv_r = torch.rsqrt(var_r + BN_EPS)
    mean_h = s_h[0::2] / n
    var_h = s_h[1::2] / n - torch.square(mean_h)
    inv_h = torch.rsqrt(var_h + BN_EPS)

    gate = gate_fn(gap)

    bnh = torch.cat([torch.stack([mean_h[i], inv_h[i], scales["h"][i],
                                  biases["h"][i]]) for i in range(nb)])
    s_t = cam_f2(dils, x, kh, kt, bnh)
    if group is not None:
        s_t, _ = _global_sums(group, s_t, b * h * w)
    mean_t = s_t[0] / n
    var_t = s_t[1] / n - torch.square(mean_t)
    inv_t = torch.rsqrt(var_t + BN_EPS)

    bnr = torch.stack([mean_r, inv_r, scales["r"], biases["r"]])
    bnt = torch.stack([mean_t, inv_t, scales["t"], biases["t"]])
    out = cam_f3(dils, x, kr, kh, kt, bnr, bnh, bnt, gate)
    stats = {"r": (mean_r, var_r), "t": (mean_t, var_t),
             "h": (mean_h, var_h)}
    return out, stats
