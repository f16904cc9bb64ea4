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
``cam_f3_bwd``), all on the 2-D tiles of ``csrc/cam_tile.cuh``.  Each
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
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.dist import all_reduce_sum, stats_group
from . import _build, _observe

BN_EPS = 1e-5
HC_MAX = 40      # the kernels' widest branch
NB_MAX = 6       # and most dilations

_P = ctypes.c_void_p
_SIGS = {
    "cam_f1": {"cam_f1_launch": [_P] * 8, "cam_f1b_launch": [_P] * 12},
    "cam_f2": {"cam_f2_launch": [_P] * 7, "cam_f2b_launch": [_P] * 12},
    "cam_f3": {"cam_f3_launch": [_P] * 9, "cam_f3b_launch": [_P] * 19},
}
_WORKSPACE = {"cam_f1": ("cam_f1_workspace", "cam_f1b_workspace"),
              "cam_f2": ("cam_f2_workspace", "cam_f2b_workspace"),
              "cam_f3": ("cam_f3b_workspace",)}


# ------------------------------------------------------------ plain versions

def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to bf16 and back."""
    return t.to(torch.bfloat16).float()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _conv(x32, k, d):
    """Dilated 3x3 conv, zero "same" padding: (B,H,W,C) f32, (3,3,C,hc)
    -> (B,H,W,hc) f32."""
    w = k.float().permute(3, 2, 0, 1)
    return _nhwc(F.conv2d(_nchw(x32), w, padding=d, dilation=d))


def _conv_t(dc32, k, d):
    """Its input-transpose: (B,H,W,hc) -> (B,H,W,C), the sum over taps of
    dc shifted by minus the tap offset times the tap's kernel^T."""
    w = k.float().permute(3, 2, 0, 1)
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


def _bn_fwd(c, mean, inv, scale, bias):
    z = (c - mean) * inv * scale + bias
    return torch.relu(z), z


def _sums(t):
    return torch.stack([t.sum((0, 1, 2)), (t * t).sum((0, 1, 2))])


def _branches(x32, kh, bnh, dils):
    """Recompute every branch: bf16(c_i), z_i, and t (the top conv's
    float32 input rows, pre-rounding, once kt is applied)."""
    hc = kh.shape[-1]
    cs, zs = [], []
    for i, d in enumerate(dils):
        c = _bf(_conv(x32, kh[i], d))
        _, z = _bn_fwd(c, *_bn_rows(bnh, i, hc))
        cs.append(c)
        zs.append(z)
    return cs, zs


def _top(zs, kt):
    t = None
    for i, z in enumerate(zs):
        p = _bf(torch.relu(z)) @ kt[i].float()
        t = p if t is None else t + p
    return t


def cam_f1_fwd_plain(x, kr, kh, dils) -> Tuple[torch.Tensor, ...]:
    """F1: s_r (2, C), s_h (2 nb, hc) and per-image sums of x (B, C)."""
    cam_f1_fwd_plain.calls += 1
    x32 = x.float()
    s_r = _sums(_bf(x32 @ kr.float()))
    s_h = torch.cat([_sums(_bf(_conv(x32, kh[i], d)))
                     for i, d in enumerate(dils)])
    return s_r, s_h, x32.sum((1, 2))


def cam_f1_bwd_plain(x, kr, kh, dsr, dsh, dgap, dils):
    """F1b: dx (x.dtype), dkr (C, C), dkh (nb, 3, 3, C, hc) float32;
    ``dgap`` is the cotangent of the mean gap (the 1/(H W) is applied
    here, as the kernel does)."""
    cam_f1_bwd_plain.calls += 1
    x32 = x.float()
    h, w = x.shape[1:3]
    dcs, dkh = [], []
    for i, d in enumerate(dils):
        c = _bf(_conv(x32, kh[i], d))
        dc = _bf(dsh[2 * i] + 2.0 * c * dsh[2 * i + 1])
        dcs.append(dc)
        dkh.append(_wgrad(x32, dc, d))
    rc = _bf(x32 @ kr.float())
    dr = _bf(dsr[0] + 2.0 * rc * dsr[1])
    dkr = torch.einsum("bhwc,bhwn->cn", x32, dr)
    dx = dr @ kr.float().t()
    for i, d in enumerate(dils):
        dx = dx + _conv_t(dcs[i], kh[i], d)
    dx = dx + dgap[:, None, None, :] * (1.0 / (h * w))
    return dx.to(x.dtype), dkr, torch.stack(dkh)


def cam_f2_fwd_plain(x, kh, kt, bnh, dils) -> torch.Tensor:
    """F2: s_t (2, C) of t = bf16(top conv of the normalised branches)."""
    cam_f2_fwd_plain.calls += 1
    _, zs = _branches(x.float(), kh, bnh, dils)
    return _sums(_bf(_top(zs, kt)))


def _branch_backward(x32, kh, kt, bnh, dils, cs, zs, dt_bf):
    """dkt, dS, dkh and the transposed-conv dx of the branches, given
    bf16(dt)."""
    hc = kh.shape[-1]
    dkt, ds, dkh, dx = [], [], [], None
    for i, d in enumerate(dils):
        a = torch.relu(zs[i])
        dkt.append(torch.einsum("bhwj,bhwc->jc", _bf(a), dt_bf))
        da = dt_bf @ kt[i].float().t()
        dz = torch.where(zs[i] > 0.0, da, torch.zeros_like(da))
        mean, inv, scale, _ = _bn_rows(bnh, i, hc)
        ds += [dz.sum((0, 1, 2)), (dz * (cs[i] - mean)).sum((0, 1, 2))]
        dc = _bf(dz * (scale * inv))
        dkh.append(_wgrad(x32, dc, d))
        p = _conv_t(dc, kh[i], d)
        dx = p if dx is None else dx + p
    return torch.stack(dkt), torch.stack(ds), torch.stack(dkh), dx


def cam_f2_bwd_plain(x, kh, kt, bnh, dst, dils):
    """F2b: dx (x.dtype), dkh, dkt (nb, hc, C), dS (2 nb, hc) float32."""
    cam_f2_bwd_plain.calls += 1
    x32 = x.float()
    cs, zs = _branches(x32, kh, bnh, dils)
    t = _bf(_top(zs, kt))
    dt_bf = _bf(dst[0] + 2.0 * t * dst[1])
    dkt, ds, dkh, dx = _branch_backward(x32, kh, kt, bnh, dils, cs, zs,
                                        dt_bf)
    return dx.to(x.dtype), dkh, dkt, ds


def _f3_recompute(x32, kr, kh, kt, bnr, bnh, bnt, dils):
    c = x32.shape[-1]
    rc = _bf(x32 @ kr.float())
    res, zr = _bn_fwd(rc, *_bn_rows(bnr, 0, c))
    cs, zs = _branches(x32, kh, bnh, dils)
    t_bf = _bf(_top(zs, kt))
    y, zt = _bn_fwd(t_bf, *_bn_rows(bnt, 0, c))
    return rc, res, zr, cs, zs, t_bf, y, zt


def cam_f3_fwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, dils):
    """F3: the CAM output relu(res + y * gate), (B, H, W, C) in x.dtype."""
    cam_f3_fwd_plain.calls += 1
    _, res, _, _, _, _, y, _ = _f3_recompute(x.float(), kr, kh, kt, bnr,
                                             bnh, bnt, dils)
    return torch.relu(res + y * gate[:, None, None, :]).to(x.dtype)


def cam_f3_bwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils):
    """F3b: dx (x.dtype), dkr, dkh, dkt, dSr (2, C), dSh (2 nb, hc),
    dSt (2, C), dgate (B, C) float32.  Image b's gate throughout."""
    cam_f3_bwd_plain.calls += 1
    x32 = x.float()
    c = x.shape[-1]
    rc, res, zr, cs, zs, t_bf, y, zt = _f3_recompute(
        x32, kr, kh, kt, bnr, bnh, bnt, dils)
    gt = gate[:, None, None, :]
    pre = res + y * gt
    zero = torch.zeros_like(pre)
    d_o = torch.where(pre > 0.0, g.float(), zero)
    dgate = (d_o * y).sum((1, 2))
    mean_r, inv_r, scale_r, _ = _bn_rows(bnr, 0, c)
    dzr = torch.where(zr > 0.0, d_o, zero)
    dsr = torch.stack([dzr.sum((0, 1, 2)),
                       (dzr * (rc - mean_r)).sum((0, 1, 2))])
    drc = _bf(dzr * (scale_r * inv_r))
    dkr = torch.einsum("bhwc,bhwn->cn", x32, drc)
    mean_t, inv_t, scale_t, _ = _bn_rows(bnt, 0, c)
    dzt = torch.where(zt > 0.0, d_o * gt, zero)
    dst = torch.stack([dzt.sum((0, 1, 2)),
                       (dzt * (t_bf - mean_t)).sum((0, 1, 2))])
    dt_bf = _bf(dzt * (scale_t * inv_t))
    dkt, dsh, dkh, dx_h = _branch_backward(x32, kh, kt, bnh, dils, cs, zs,
                                           dt_bf)
    dx = drc @ kr.float().t() + dx_h
    return dx.to(x.dtype), dkr, dkh, dkt, dsr, dsh, dst, dgate


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
    if len(dils) != nb or not 1 <= nb <= NB_MAX or hc > HC_MAX \
            or min(dils) < 1:
        raise ValueError(f"the CAM kernels take 1..{NB_MAX} dilations >= 1 "
                         f"(one per branch) and hc <= {HC_MAX}; got dils "
                         f"{tuple(dils)}, kh {tuple(kh.shape)}")
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
    for op in TILE_OPS:                    # cam_tile.cuh:tile_plan per op
        if f"cam_{op[:2]}" == name:
            plan = getattr(lib, f"cam_{op}_plan")
            plan.argtypes = [_P, ctypes.c_int]
            plan.restype = ctypes.c_longlong
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
    image), float32.  On the card the tile kernel of
    ``csrc/cam_tile.cuh``; ``ValueError`` for a geometry whose halo does
    not fit (:func:`tile_plan`; only where F1b's does not either)."""
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
    the card the tile kernel of ``csrc/cam_tile.cuh``; ``ValueError`` for
    a geometry whose halo does not fit (:func:`tile_plan`; only where
    F2b's does not either)."""
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
    (B, H, W, C) bf16.  On the card the tile kernel of
    ``csrc/cam_tile.cuh``; ``ValueError`` for a geometry whose halo does
    not fit (:func:`tile_plan`; only where F3b's does not either)."""
    if not _dispatch(x, "cam_f3_fwd"):
        return cam_f3_fwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, dils)
    x, kr, kh, kt, bnr, bnh, bnt, gate = _check(
        x, kr, kh, kt, dils, (bnr, bnh, bnt, gate))
    lib, geo, _, w0, _, xpad = _tile_call("f3", "cam_f3_fwd", x, kr, kh, kt,
                                          dils)
    out = torch.empty_like(x)
    err = lib.cam_f3_launch(
        ctypes.addressof(geo),
        *_ptrs(xpad, w0, bnr, bnh, bnt, gate, out), _stream(x))
    _build.check(err, "cam_f3_fwd")
    cam_f3_fwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f3_fwd",
                          (x, kr, kh, kt, bnr, bnh, bnt, gate, dils), (out,),
                          cam_f3_fwd_plain)
    return out


# ------------------------------------------------------------ the tiles
#
# The tile kernels (csrc/cam_tile.cuh) of the six ops walk 8 x 8 pixel
# tiles of one image, stage each tile's halo once at full
# channel depth, and read every weight in the order and layout the
# wrapper gives it once per call.  tile_plan and _tile_weights are that
# contract's Python side, per op ("f1", "f2", "f3", "f1b", "f2b", "f3b");
# the C side (make_tgeo, smem0_bytes, smem1_bytes, w0_elems, w1_elems,
# stage0) computes the same, and each wrapper checks the weight counts
# against it (cam_f{1,2,3}_plan, cam_f{1,2,3}b_plan) on every call.

TILE_TS = 8          # tile side (cam_tile.cuh:TS)
TILE_NC = 56         # channels of a phase-0 1x1-conv chunk (cam_core.cuh:NC)
TILE_NX = 168        # output channels of a dx block (cam_tile.cuh:NX)
TILE_ROW_WARPS = 4   # warps of 16 pixel rows (times 2 column groups)
TILE_NBUF = 3        # weight stages in shared memory (cam_tile.cuh:NBUF)
SMEM_MAX = 232448    # dynamic shared memory of an sm_90 block, bytes
# op -> (its phase 0 runs kr^T chunks, kt^T chunks, the branch backward),
# as cam_tile.cuh:make_tgeo sets res, top and bb; a backward ("...b") also
# has a phase 1 (dx), a forward none
TILE_OPS = {"f1b": (True, False, False), "f2b": (False, True, True),
            "f3b": (True, True, True), "f1": (True, False, False),
            "f3": (True, True, False), "f2": (False, True, False)}


def _up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def tile_plan(op: str, b: int, h: int, w: int, c: int, dils: Sequence[int],
              hc: int) -> Dict[str, int]:
    """Tiles, padded widths and pitches (bf16 elements), stage counts,
    shared memory (bytes; smem1 0 for a forward) and re-laid weight sizes
    (bf16 elements; w1_elems 0 for a forward) of ``op``'s tile kernels at
    x (b, h, w, c), ``dils``, branch width hc."""
    res, top, bb = TILE_OPS[op]
    bwd = op.endswith("b")
    nb = len(dils)
    nh = nb * hc
    kc, khc, knh = _up(c, 16), _up(hc, 16), _up(nh, 16)
    tiles_x, tiles_y = -(-w // TILE_TS), -(-h // TILE_TS)
    dmax = max(dils)
    hs = TILE_TS + 2 * dmax
    p = dict(tiles_x=tiles_x, tiles_y=tiles_y, tpi=tiles_x * tiles_y,
             n_tiles=b * tiles_x * tiles_y, dmax=dmax, hs=hs, hr=hs * hs,
             kc=kc, khc=khc, knh=knh, brows=_up(hc, 8),
             nchr=-(-c // TILE_NC), kw0=max(kc, knh) if top else kc,
             ldc=nb * khc, xp=kc + 8, nhp=knh + 8,
             nxr=min(TILE_NX, _up(c, 8)), nchx=-(-c // TILE_NX),
             nksr=-(-kc // khc) if res else 0)
    p["cp"] = p["ldc"] + 8
    p["nst0"] = (9 + bb) * nb + (res + top) * p["nchr"]
    p["nst1"] = p["nksr"] + 9 * nb
    tp, nwarps, nred = TILE_TS * TILE_TS, TILE_ROW_WARPS, 5
    rows = {"f1b": 2 * c + 2 * nh, "f2b": 2 * c + 4 * nh,
            "f3b": 9 * c + 4 * nh, "f1": 0, "f3": 9 * c + 4 * nh,
            "f2": 4 * nh}[op]
    el = p["hr"] * p["xp"] + TILE_NBUF * TILE_NC * (p["kw0"] + 8)
    if top:                                # sA
        el += tp * p["nhp"]
    if bb:                                 # sCb, sD
        el += tp * p["nhp"] + tp * p["xp"]
    if bb:                                 # the column-sum scratch
        rows += nwarps * nred * TILE_NC
    p["smem0"] = 2 * el + 4 * rows
    p["smem1"] = 2 * (tp * p["xp"] * res + p["hr"] * p["cp"]
                      + TILE_NBUF * p["nxr"] * (khc + 8)) if bwd else 0
    p["w0_elems"] = (9 + bb) * nb * p["brows"] * kc \
        + p["nchr"] * TILE_NC * (kc * res + knh * top)
    p["w1_elems"] = p["nchx"] * p["nst1"] * p["nxr"] * khc if bwd else 0
    return p


def _tile_weights(op: str, kr, kh, kt) -> Tuple[torch.Tensor, ...]:
    """kr, kh, kt (those ``op`` reads; None for the others) re-laid for
    its tile kernels, [n][k] with zeros padding n and k: w0, phase 0's
    stages in walking order (the branch taps, nb x 9 of kh[i, tap]^T
    [brows][kc]; then per chunk of TILE_NC output channels kr^T [NC][kc]
    (f1, f3, f1b, f3b) and kt^T [NC][knh] (f2, f3, f2b, f3b); then per
    branch kt[i] [brows][kc] (f2b, f3b), as ``cam_tile.cuh:stage0`` walks
    them); w1 (None for a forward), per chunk of TILE_NX output channels (nxr
    rows), nksr stages of kr's k slices [nxr][khc] (f1b, f3b) and then
    nb x 9 stages of kh[i, tap] [nxr][khc]."""
    res, top, bb = TILE_OPS[op]
    nb, _, _, c, hc = kh.shape
    p = tile_plan(op, 1, 1, 1, c, [1] * nb, hc)
    kc, khc, knh, br = p["kc"], p["khc"], p["knh"], p["brows"]
    nchr, nh = p["nchr"], nb * hc
    taps = kh.reshape(nb * 9, c, hc)
    cpad = nchr * TILE_NC
    w0 = [F.pad(taps.transpose(1, 2), (0, kc - c, 0, br - hc)).reshape(-1)]
    chunk = []
    if res:
        chunk.append(F.pad(kr.t(), (0, kc - c, 0, cpad - c)))
    if top:
        chunk.append(F.pad(kt.reshape(nh, c).t(), (0, knh - nh, 0, cpad - c)))
    w0.append(torch.cat([t.reshape(nchr, -1) for t in chunk], 1).reshape(-1))
    if bb:
        w0.append(F.pad(kt, (0, kc - c, 0, br - hc)).reshape(-1))
    w0 = torch.cat(w0).contiguous()
    if not op.endswith("b"):
        return w0, None
    nxr, nchx, nksr = p["nxr"], p["nchx"], p["nksr"]
    npad = nchx * nxr
    kht = F.pad(taps, (0, khc - hc, 0, npad - c))
    w1 = kht.reshape(nb * 9, nchx, nxr, khc).transpose(0, 1)
    if res:
        krt = F.pad(kr, (0, nksr * khc - c, 0, npad - c))
        krt = krt.reshape(nchx, nxr, nksr, khc).transpose(1, 2)
        w1 = torch.cat([krt, w1], 1)
    return w0, w1.reshape(-1).contiguous()


def _tile_call(op: str, name: str, x, kr, kh, kt, dils):
    """The plan, the library, the geometry, the workspace (None where
    ``op`` takes none), the re-laid weights (w1 None for a forward) and
    the channel-padded x of a tile-kernel call of ``op``; ``ValueError``
    when its halo and weight stages do not fit a block's shared memory."""
    b, h, w, c = x.shape
    plan = tile_plan(op, b, h, w, c, dils, kh.shape[4])
    if max(plan["smem0"], plan["smem1"]) > SMEM_MAX:
        raise ValueError(f"{name}: the tile kernels need {plan['smem0']} / "
                         f"{plan['smem1']} bytes of shared memory at C={c}, "
                         f"dils {tuple(dils)}, over {SMEM_MAX}")
    geo = _geo(x, kh, dils)
    lname = f"cam_{op[:2]}"
    lib = _lib(lname)
    ws_fn = f"cam_{op}_workspace"
    ws = (_workspace(lib, ws_fn, geo, x.device)
          if ws_fn in _WORKSPACE[lname] else None)
    w0, w1 = _tile_weights(op, kr, kh, kt)
    plan_fn = getattr(lib, f"cam_{op}_plan")
    for what, t in ((2, w0), (3, w1)):
        n = 0 if t is None else t.numel()
        if plan_fn(ctypes.addressof(geo), what) != n:
            raise RuntimeError(f"{name}: the re-laid weights and the "
                               "kernels' layout disagree")
    xpad = F.pad(x, (0, plan["kc"] - c))
    return lib, geo, ws, w0, w1, xpad


def cam_f1_bwd(x, kr, kh, dsr, dsh, dgap, dils):
    """F1b (replaces ``pallas_cam.py:_f1b_call``): (dx, dkr, dkh).  On
    the card the tile kernels of ``csrc/cam_tile.cuh``; ``ValueError``
    for a geometry whose halo does not fit (:func:`tile_plan`)."""
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


def cam_f2_bwd(x, kh, kt, bnh, dst, dils):
    """F2b (replaces ``pallas_cam.py:_f2b_call``): (dx, dkh, dkt, dS).  On
    the card the tile kernels of ``csrc/cam_tile.cuh``; ``ValueError``
    for a geometry whose halo does not fit (:func:`tile_plan`)."""
    if not _dispatch(x, "cam_f2_bwd"):
        return cam_f2_bwd_plain(x, kh, kt, bnh, dst, dils)
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
    cam_f2_bwd.launches += 1
    if _observe.active:
        _observe.launched("cam_f2_bwd", (x, kh, kt, bnh, dst, dils),
                          (dx, dkh, dkt, ds), cam_f2_bwd_plain)
    return dx, dkh, dkt, ds


def cam_f3_bwd(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils):
    """F3b (replaces ``pallas_cam.py:_f3b_call``): (dx, dkr, dkh, dkt,
    dSr, dSh, dSt, dgate); image b's gate in both phases.  On the card
    the tile kernels of ``csrc/cam_tile.cuh``; they take the geometries
    whose halo and weight stages fit a block's shared memory
    (:func:`tile_plan`; the train step's C = 163 with dilations 1-3 and
    C = 83 with 1-4 do) and raise ``ValueError`` on the others."""
    if not _dispatch(x, "cam_f3_bwd"):
        return cam_f3_bwd_plain(x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils)
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
    cam_f3_bwd.launches += 1
    out = (dx, dkr, dkh, dkt, dsr, dsh, dst, dgate)
    if _observe.active:
        _observe.launched("cam_f3_bwd",
                          (x, kr, kh, kt, bnr, bnh, bnt, gate, g, dils), out,
                          cam_f3_bwd_plain)
    return out


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
