"""Device resolution and float32 precision policy.

Every entry point of the port takes ``device`` and resolves it here:
``None`` means CUDA, and asking for CUDA on a machine without it raises
instead of quietly running on the CPU.  Tests pass ``device="cpu"``.

Precision: the serving forward runs in bf16, so TF32 does not touch it.
The TF32 flags are process-wide, so no module of the port sets them: the
entry point does, once.  The serving path's float32 work (the tag-map
resize matmuls) is exact under PyTorch's default of cuBLAS TF32 off; a
caller that runs a float32 forward as a reference (``chip_smoke.py``)
calls :func:`set_tf32` with ``False`` to turn TF32 off for cuDNN
convolutions as well.
"""

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def set_tf32(enabled: bool) -> None:
    """Set TF32 for cuDNN convolutions and cuBLAS matmuls together
    (PyTorch's defaults differ: cuDNN on, cuBLAS off)."""
    torch.backends.cudnn.allow_tf32 = bool(enabled)
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)


def default_dtype(device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The serving compute dtype: bf16 on CUDA, float32 on the CPU."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32
