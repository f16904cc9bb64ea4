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
convolutions (and, where :func:`chain_plan` splits K, their split
epilogues) from one C entry point.

:func:`chain_plan` is the Python side of the kernel's tiling
(``csrc/basicblock_chain.cu:make_plan``): 128-pixel tiles (256 where
the N tile is <= 96 and the grid still fills the card), an N tile of the
widest of 192, 96, 64, 32 channels that divides C, K = 9C in steps of
64, and the split of those steps that fills one wave of the card's 132
SMs.
"""

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import _build

_SIGS = {"basicblock_chain_launch": [ctypes.c_void_p] * 6
         + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
CHANNEL_MULTIPLE = 32    # the narrowest N tile
# basicblock_chain.cu's tiling constants
CHAIN_KC = 64            # K per copy stage
CHAIN_STAGES = 4         # the ring of copy stages
CHAIN_BNS = (192, 96, 64, 32)
CHAIN_SMS = 132          # the H100's SMs: the grid's target
CHAIN_MIN_SPLIT_STEPS = 2
# what= codes of basicblock_chain_plan, in order
PLAN_KEYS = ("bn", "tiles_m", "tiles_n", "splits", "nsteps", "smem",
             "ws_bytes", "bm")


def chain_plan(b: int, h: int, w: int, c: int) -> Dict[str, int]:
    """The kernel's tiling of one conv of a chain at x (b, h, w, c), as
    ``basicblock_chain_plan`` computes it: the N tile ``bn`` and its
    64-channel swizzle atoms ``na``, the pixel tile ``bm``, pixel and
    channel tiles, K steps of 64 over 9C (zero past it), the K splits
    (each split >= 2 steps; where the tiles alone leave SMs idle, as many
    splits as keep ``blocks`` = tiles x splits within one wave of the 132
    SMs), dynamic shared memory and the split workspace (f32 partials,
    bytes).
    ``ValueError`` for C not a multiple of 32."""
    if c <= 0 or c % CHANNEL_MULTIPLE or min(b, h, w) <= 0:
        raise ValueError(f"basicblock_chain kernel takes C divisible by "
                         f"{CHANNEL_MULTIPLE} and a non-empty x, got "
                         f"({b}, {h}, {w}, {c})")
    m = b * h * w
    bn = next(v for v in CHAIN_BNS if c % v == 0)
    na = -(-bn // 64)
    tiles_n = c // bn
    # two m64 row tiles a warpgroup where BN <= 96 and that alone still
    # gives the card's 132 blocks
    bm = 256 if bn <= 96 and -(-m // 256) * tiles_n >= CHAIN_SMS else 128
    tiles_m = -(-m // bm)
    nsteps = -(-9 * c // CHAIN_KC)
    base = tiles_m * tiles_n
    splits = 1                     # within one wave of the card
    if base < CHAIN_SMS:
        splits = max(1, min(CHAIN_SMS // base,
                            nsteps // CHAIN_MIN_SPLIT_STEPS))
    smem = CHAIN_STAGES * (bm * CHAIN_KC * 2
                           + CHAIN_KC // 8 * na * 1024) + 1024
    return dict(bn=bn, na=na, bm=bm, tiles_m=tiles_m, tiles_n=tiles_n,
                nsteps=nsteps, splits=splits, blocks=base * splits,
                smem=smem, ws_bytes=4 * splits * m * c if splits > 1 else 0)


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("basicblock_chain", _SIGS)
    lib.basicblock_chain_plan.argtypes = [ctypes.c_int] * 5
    lib.basicblock_chain_plan.restype = ctypes.c_longlong
    return lib


def chain_plan_c(b: int, h: int, w: int, c: int) -> Dict[str, int]:
    """The kernel's own plan (``basicblock_chain_plan``), built on first
    use like the kernel: for holding :func:`chain_plan` against it."""
    lib = _lib()
    return {k: int(lib.basicblock_chain_plan(b, h, w, c, i))
            for i, k in enumerate(PLAN_KEYS)}


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
    lib = _lib()
    # the split workspace as the kernel's own plan sizes it
    n_ws = lib.basicblock_chain_plan(b, h, w, c, PLAN_KEYS.index("ws_bytes"))
    if n_ws < 0:
        raise ValueError(f"basicblock_chain kernel refuses x {(b, h, w, c)}")
    tmp = torch.empty_like(out)
    ws = (torch.empty(n_ws, dtype=torch.uint8, device=x.device)
          if n_ws else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.basicblock_chain_launch(
        x.data_ptr(), weights.data_ptr(), biases.data_ptr(), tmp.data_ptr(),
        out.data_ptr(), 0 if ws is None else ws.data_ptr(), b, h, w, c,
        weights.shape[0], stream)
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
