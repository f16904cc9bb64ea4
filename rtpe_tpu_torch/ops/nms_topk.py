"""NMS + top-k: the CUDA kernel ``csrc/nms_topk.cu`` and its plain
PyTorch version.

Replaces ``rtpe_tpu/ops/pallas_decode.py:nms_topk_pallas`` (the Pallas
kernel ``_nms_topk_kernel``).  Per (image, joint) plane of ``det``
(B, H, W, J): a ksize x ksize same-padded max-pool with a -inf border,
``det`` kept where it equals the pool and 0.0 elsewhere, then the top-K
values with ties going to the smallest flat index ``y * W + x``.

:func:`nms_topk` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor — there is no fallback from one to the other.
``nms_topk.launches`` counts kernel launches.
"""

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build, _observe

_SIGS = {
    "nms_topk_tiles": [ctypes.c_int, ctypes.c_int],
    "nms_topk_launch": [ctypes.c_void_p] + [ctypes.c_longlong] * 4
    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6,
}

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def nms_topk_plain(det: torch.Tensor, max_people: int = 30,
                   ksize: int = 5) -> Result:
    """Plain version: ``det`` (B, H, W, J) -> val (B, J, K) f32,
    x, y (B, J, K) int32."""
    b, h, w, j = det.shape
    planes = det.float().permute(0, 3, 1, 2)                # (B, J, H, W)
    pooled = F.max_pool2d(planes, ksize, 1, ksize // 2)
    peaks = torch.where(pooled == planes, planes,
                        torch.zeros((), dtype=planes.dtype,
                                    device=planes.device))
    # a stable descending sort keeps equal values in flat-index order
    vals, idx = torch.sort(peaks.reshape(b, j, h * w), dim=-1,
                           descending=True, stable=True)
    idx = idx[..., :max_people].to(torch.int32)
    return (vals[..., :max_people].contiguous(), idx % w, idx // w)


def _nms_topk_cuda(det: torch.Tensor, max_people: int, ksize: int) -> Result:
    if det.dtype != torch.float32:
        raise TypeError(f"nms_topk kernel takes float32, got {det.dtype}")
    if ksize % 2 == 0 or ksize > 9:
        raise ValueError(f"nms_topk kernel takes odd ksize <= 9, not {ksize}")
    b, h, w, j = det.shape
    if h * w < max_people:
        raise ValueError(f"a {h}x{w} plane has fewer than {max_people} "
                         "pixels")
    lib = _build.load("nms_topk", _SIGS)
    n_cand = lib.nms_topk_tiles(h, w) * max_people
    dev = det.device
    cand_v = torch.empty((b * j, n_cand), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b * j, n_cand), dtype=torch.int32, device=dev)
    val = torch.empty((b, j, max_people), dtype=torch.float32, device=dev)
    x = torch.empty((b, j, max_people), dtype=torch.int32, device=dev)
    y = torch.empty((b, j, max_people), dtype=torch.int32, device=dev)
    sb, sy, sx, sj = det.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nms_topk_launch(
        det.data_ptr(), sb, sy, sx, sj, b, h, w, j, ksize, max_people,
        cand_v.data_ptr(), cand_i.data_ptr(), val.data_ptr(),
        x.data_ptr(), y.data_ptr(), stream)
    _build.check(err, "nms_topk")
    nms_topk.launches += 1
    if _observe.active:
        _observe.launched("nms_topk", (det,), (val,))
    return val, x, y


def nms_topk(det: torch.Tensor, max_people: int = 30,
             ksize: int = 5) -> Result:
    """Fused NMS + top-k: ``det`` (B, H, W, J), any strides ->
    (val, x, y), each (B, J, K) with K = ``max_people``."""
    if det.device.type == "cpu":
        return nms_topk_plain(det, max_people, ksize)
    if det.device.type != "cuda":
        raise ValueError(f"nms_topk: unsupported device {det.device}")
    return _nms_topk_cuda(det, max_people, ksize)


nms_topk.launches = 0
