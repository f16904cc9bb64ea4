"""Numerical-sanitation switches (port of ``rtpe_tpu/utils/debug.py``).

JAX's ``jax_debug_nans`` raises the moment a computation produces a
NaN.  Here the same switch is a ``TorchDispatchMode`` that checks the
floating outputs of every aten op and raises ``FloatingPointError``
naming the op; a device sync per op, for debugging only.

* Allocation ops (``empty``, ``empty_like``, ``empty_strided``,
  ``new_empty``) return uninitialised memory and are not checked: every
  kernel wrapper allocates its outputs so before its launch.
* The port's kernels launch through ``ctypes``, which no dispatch mode
  sees; each wrapper checks its own outputs after the launch while the
  check is on (``ops/_observe.py``), and the error names the kernel.
* Autograd's backward runs under the mode too (the engine carries the
  caller's dispatch modes into its threads), so a NaN made there is
  caught.
* JAX's flag is process-wide, but a dispatch mode is per thread: the
  check covers the thread that turned it on (and autograd's backward),
  not ``TrainPipeline``'s worker threads.  The kernels' own check is
  process-wide.
"""

import collections
import contextlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops import _observe

_aten = torch.ops.aten
ALLOCATION_OPS = frozenset({
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default})


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` when an aten op's floating output
    holds a NaN (an Inf with ``infs``)."""

    def __init__(self, nans: bool = True, infs: bool = False):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in ALLOCATION_OPS:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    bad = _observe.bad_values(t, self.nans, self.infs)
                    if bad:
                        raise FloatingPointError(
                            f"{bad} in the output of {func}")
        return out


_mode: Optional[NanCheckMode] = None


def enable_nan_debugging(nans: bool = True, infs: bool = False) -> None:
    """Raise the moment an op (or a kernel) produces a NaN (an Inf with
    ``infs``) from here on; ``enable_nan_debugging(False)`` turns the
    check off.  Costs a device sync per op: debugging only."""
    global _mode
    if _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None
    if nans or infs:
        _mode = NanCheckMode(nans, infs)
        _mode.__enter__()
    _observe.set_nan_check((nans, infs) if nans or infs else None)


def _state() -> Tuple[bool, bool]:
    return _observe.nan_check() or (False, False)


@contextlib.contextmanager
def nan_debugging(nans: bool = True, infs: bool = False) -> Iterator[None]:
    """:func:`enable_nan_debugging` inside the block; the previous state
    after it."""
    prev = _state()
    try:
        enable_nan_debugging(nans, infs)
        yield
    finally:
        enable_nan_debugging(*prev)


def tree_leaves_with_path(tree, path: str = ""):
    """``(path, leaf)`` over nested dicts, lists and tuples, in
    ``jax.tree_util``'s order (a dict's keys sorted, an ``OrderedDict``'s
    in order, ``None`` an empty subtree) and with its ``keystr``
    (``['a'][0]``, ``.field`` of a named tuple)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        keys = list(tree)
        if not isinstance(tree, collections.OrderedDict):
            keys = sorted(keys)
        for k in keys:
            yield from tree_leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_leaves_with_path(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() \
            or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over nested dicts, lists and tuples of
    tensors or numpy arrays (state dicts, metrics); floating leaves
    only.  The message names the first bad leaf as JAX's does
    (``tree['a'][0]``)."""
    for path, leaf in tree_leaves_with_path(tree):
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")
