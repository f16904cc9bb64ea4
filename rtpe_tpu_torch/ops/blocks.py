"""Fused BasicBlock chains: the CUDA kernel ``csrc/basicblock_chain.cu``
and its plain PyTorch version.

Replaces ``rtpe_tpu/ops/pallas_blocks.py:basicblock_chain`` (the Pallas
kernel ``_chain_kernel``): n BasicBlocks with folded BatchNorm over
``x``, each ``relu(conv3x3(x) + b1)`` -> bf16 -> ``conv3x3 + b2`` ->
bf16 -> ``+ x`` -> ``relu``, every conv accumulated in float32 with its
float32 bias added before the one rounding to the activation dtype.
Same layout as the JAX function: x (B, H, W, C) NHWC, weights
(n, 2, 3, 3, C, C) HWIO, biases (n, 2, C) float32.

:func:`basicblock_chain` runs the plain version for a CPU tensor and
the kernel for a CUDA tensor (bf16 only, as the TPU kernel) — there is
no fallback from one to the other.  ``basicblock_chain.launches``
counts chain launches: one per call, which launches the chain's 2n
convolutions from one C entry point.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_SIGS = {"basicblock_chain_launch": [ctypes.c_void_p] * 5
         + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
CHANNEL_MULTIPLE = 32    # the kernel's K step


def basicblock_chain_plain(x: torch.Tensor, weights: torch.Tensor,
                           biases: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 convolutions of the upcast activations and
    weights, the float32 bias, and a rounding to ``x.dtype`` at the
    points where the kernel rounds (what JAX's
    ``preferred_element_type=float32`` computes).  On a CUDA tensor the
    caller turns TF32 off (``rtpe_tpu_torch.device.set_tf32(False)``) to
    get float32 products."""
    _check_shapes(x, weights, biases)
    dtype = x.dtype
    cur = x.permute(0, 3, 1, 2)                              # NCHW view
    for i in range(weights.shape[0]):
        w1, w2 = (weights[i, c].permute(3, 2, 0, 1).float() for c in (0, 1))
        b1, b2 = biases[i, 0].float(), biases[i, 1].float()
        y = torch.relu(F.conv2d(cur.float(), w1, padding=1)
                       + b1[:, None, None]).to(dtype)
        y = (F.conv2d(y.float(), w2, padding=1) + b2[:, None, None]).to(dtype)
        cur = torch.relu(y + cur)
    return cur.permute(0, 2, 3, 1).contiguous()


def _check_shapes(x, weights, biases) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[3]
    n = weights.shape[0] if weights.dim() == 6 else -1
    if tuple(weights.shape) != (n, 2, 3, 3, c, c) or n < 1:
        raise ValueError(f"weights must be (n, 2, 3, 3, {c}, {c}), got "
                         f"{tuple(weights.shape)}")
    if tuple(biases.shape) != (n, 2, c):
        raise ValueError(f"biases must be ({n}, 2, {c}), got "
                         f"{tuple(biases.shape)}")


def _chain_cuda(x, weights, biases) -> torch.Tensor:
    _check_shapes(x, weights, biases)
    if x.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"basicblock_chain kernel takes bf16 activations and "
                        f"weights, got {x.dtype} and {weights.dtype}")
    if biases.dtype != torch.float32:
        raise TypeError(f"basicblock_chain kernel takes float32 biases, got "
                        f"{biases.dtype}")
    b, h, w, c = x.shape
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"basicblock_chain kernel takes C divisible by "
                         f"{CHANNEL_MULTIPLE}, got {c}")
    for name, t in (("x", x), ("weights", weights), ("biases", biases)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"basicblock_chain kernel takes {name} "
                             "contiguous (NHWC for x; a channels_last NCHW "
                             "tensor permuted to NHWC is) and 16-byte aligned")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    tmp = torch.empty_like(out)
    lib = _build.load("basicblock_chain", _SIGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.basicblock_chain_launch(
        x.data_ptr(), weights.data_ptr(), biases.data_ptr(), tmp.data_ptr(),
        out.data_ptr(), b, h, w, c, weights.shape[0], stream)
    _build.check(err, "basicblock_chain")
    basicblock_chain.launches += 1
    return out


def basicblock_chain(x: torch.Tensor, weights: torch.Tensor,
                     biases: torch.Tensor) -> torch.Tensor:
    """Run ``n`` BasicBlocks over ``x`` (B, H, W, C) -> (B, H, W, C) in
    ``x.dtype``, NHWC contiguous."""
    if x.device.type == "cpu":
        return basicblock_chain_plain(x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"basicblock_chain: unsupported device {x.device}")
    return _chain_cuda(x, weights, biases)


basicblock_chain.launches = 0
