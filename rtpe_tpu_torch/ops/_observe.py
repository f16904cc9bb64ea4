"""What the kernel wrappers report after a launch: to the FLOP count of
:func:`rtpe_tpu_torch.obs.profiling.flops_of` and to the NaN check of
:func:`rtpe_tpu_torch.utils.debug.nan_debugging`.

The port's kernels launch through ``ctypes`` with raw pointers, so no
``TorchDispatchMode`` sees them: ``FlopCounterMode`` counts nothing for
them, and a NaN check of every aten op's outputs never reads what a
kernel wrote.  Each wrapper, right after its launch, reads
:data:`active` (one module-level flag, False unless a count or a check
is on) and only then calls :func:`launched`, so a launch costs nothing
more while neither is on.

* The FLOP count: a wrapper whose plain version holds ops that
  ``FlopCounterMode`` counts (``ops/blocks.py``, ``ops/quant.py:qconv``
  and the six CAM ops) passes that plain version and its arguments; it
  runs on ``meta`` copies of them, which the active mode counts as it
  counts the plain version on the CPU.  The count is then the same
  whether a function runs on the plain versions or on the kernels, and
  each launch is counted once: on the CPU the wrappers launch nothing.
  The other wrappers pass none: their plain versions hold no counted op.
* The NaN check: each floating input and output of the kernel is
  checked and the error names the kernel.  The inputs too: a NaN that
  enters a kernel from outside the check (data made before it was
  turned on) may leave no trace in its outputs (the NMS pool drops NaN
  pixels).
"""

import threading
from typing import Callable, Optional, Sequence

import torch

active = False        # read by every wrapper after its launch
_counts = 0           # flops_of calls in progress (any thread)
_nan_check: Optional[tuple] = None   # (nans, infs) while NaN debugging
_lock = threading.Lock()


def _update() -> None:
    global active
    active = bool(_counts) or _nan_check is not None


def count_begin() -> None:
    global _counts
    with _lock:
        _counts += 1
        _update()


def count_end() -> None:
    global _counts
    with _lock:
        _counts -= 1
        _update()


def set_nan_check(check: Optional[tuple]) -> None:
    """Set ``(nans, infs)``; ``None`` turns the check off."""
    global _nan_check
    with _lock:
        _nan_check = check
        _update()


def nan_check() -> Optional[tuple]:
    return _nan_check


def _meta(obj):
    """``obj`` with every tensor replaced by an empty one of its shape
    and dtype on the ``meta`` device (tuples, lists, named tuples)."""
    if isinstance(obj, torch.Tensor):
        return torch.empty(obj.shape, dtype=obj.dtype, device="meta")
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_meta(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_meta(v) for v in obj)
    return obj


def bad_values(t: torch.Tensor, nans: bool, infs: bool) -> Optional[str]:
    """``"NaN"`` or ``"Inf"`` where a floating ``t`` holds one that the
    check looks for, else ``None`` (also for a tensor without values)."""
    if not t.is_floating_point() or t.device.type == "meta" \
            or t.numel() == 0:
        return None
    if nans and bool(torch.isnan(t).any()):
        return "NaN"
    if infs and bool(torch.isinf(t).any()):
        return "Inf"
    return None


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def launched(name: str, inputs: Sequence, outputs: Sequence,
             plain: Optional[Callable] = None,
             plain_args: Optional[tuple] = None) -> None:
    """Report a launch of kernel ``name`` on ``inputs`` (its plain
    version's arguments unless ``plain_args`` are given) that wrote
    ``outputs``: while a FLOP count is on, run ``plain`` on ``meta``
    copies of its arguments (its ``.calls`` counter, where it has one,
    left as it was); while NaN debugging is on, raise
    ``FloatingPointError`` naming the kernel if a floating input or
    output holds a NaN (an Inf with ``infs``)."""
    if _counts and plain is not None:
        calls = getattr(plain, "calls", None)
        plain(*_meta(inputs if plain_args is None else plain_args))
        if calls is not None:
            plain.calls = calls
    check = _nan_check
    if check is not None:
        for what, tree in (("input", inputs), ("output", outputs)):
            for i, t in enumerate(_tensors(tree)):
                bad = bad_values(t, *check)
                if bad:
                    raise FloatingPointError(
                        f"{bad} in {what} tensor {i} of the {name} kernel")
