"""Profiling and timing (port of ``rtpe_tpu/obs/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler`` writing a
  trace that TensorBoard's profile plugin or Perfetto opens.  On a card
  it records CUDA activity too, and CUPTI sees the port's kernels,
  which launch through ``ctypes``, under their own names.
* :func:`timeit`: host-clock timing with warm-up, synchronising the
  device the outputs live on after each call.
* :func:`flops_of`: ``FlopCounterMode``'s count of one call.  The mode
  sees only aten ops, so each kernel wrapper whose plain version holds
  counted ops reports that plain version's count when it launches
  (``ops/_observe.py``): a function has the same count on the plain
  versions (the CPU) and on the kernels (the card).
* :func:`memory_analysis`: argument, output and temporary bytes of one
  call.

JAX's ``flops_of`` and ``memory_analysis`` read XLA's analysis of the
compiled function without running it; these run it once.  Where JAX
counts a convolution's taps that fall in its padding as no work (XLA's
cost analysis), ``FlopCounterMode`` counts every tap: the two agree on
matmuls and unpadded convolutions.
"""

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..ops import _observe
from ..utils.debug import tree_leaves_with_path


def _tensors(tree) -> list:
    return [t for _, t in tree_leaves_with_path(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in _tensors(tree))


def _cuda_devices(tree) -> list:
    return sorted({t.device for t in _tensors(tree) if t.is_cuda},
                  key=lambda d: d.index or 0)


def _sync(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with trace(log_dir): run_steps()``, then open the
    ``*.pt.trace.json`` under ``log_dir`` in TensorBoard or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def timeit(fn: Callable, *args, warmup: int = 2, iters: int = 10
           ) -> Dict[str, float]:
    """:returns: dict with p50/mean/min seconds a call."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {"p50": float(np.median(times)),
            "mean": float(times.mean()),
            "min": float(times.min())}


def flops_of(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of ``fn(*args)``: ``FlopCounterMode``'s count,
    with each launch of a kernel counted as its plain version; ``None``
    where counting fails."""
    try:
        _observe.count_begin()
        try:
            with FlopCounterMode(display=False) as mode:
                fn(*args)
        finally:
            _observe.count_end()
        return float(mode.get_total_flops())
    except Exception:
        return None


def _cpu_peak_bytes(fn: Callable, args) -> tuple:
    """The outputs and the peak of the bytes allocated over one call on
    the CPU (above what was allocated before it), from
    ``torch.profiler``'s allocation events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            profile_memory=True) as prof:
        out = fn(*args)
    events = []

    def walk(nodes):
        for node in nodes:
            if type(node.extra_fields).__name__ == "_ExtraFields_Allocation":
                events.append((node.start_time_ns,
                               node.extra_fields.alloc_size))
            walk(node.children)

    walk(prof.profiler.kineto_results.experimental_event_tree())
    live = peak = 0
    for _, size in sorted(events):
        live += size
        peak = max(peak, live)
    return out, peak


def memory_analysis(fn: Callable, *args) -> Optional[Dict[str, float]]:
    """Bytes of one call of ``fn(*args)``, under JAX's four keys; ``None``
    where the measure fails.

    * ``argument_bytes``, ``output_bytes``: ``nbytes`` summed over the
      tensors of ``args`` and of the result (nested dicts, lists,
      tuples), on any device.
    * ``temp_bytes``: the peak allocated during the call less what was
      allocated before it and less the outputs.  On a card (an argument
      on CUDA) the caching allocator's peak over one synchronised call;
      on the CPU the running sum of ``torch.profiler``'s allocation
      events.
    * ``generated_code_bytes``: 0.  There is no compiled executable: the
      kernels' ``.so`` files load once a process, outside any call.
    """
    try:
        devs = _cuda_devices(args)
        if devs:
            dev = devs[0]
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = fn(*args)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - before
            out_here = sum(t.nbytes for t in _tensors(out)
                           if t.device == dev)
        else:
            out, peak = _cpu_peak_bytes(fn, args)
            out_here = sum(t.nbytes for t in _tensors(out)
                           if t.device.type == "cpu")
        return {"temp_bytes": float(max(peak - out_here, 0)),
                "argument_bytes": float(_nbytes(args)),
                "output_bytes": float(_nbytes(out)),
                "generated_code_bytes": 0.0}
    except Exception:
        return None
