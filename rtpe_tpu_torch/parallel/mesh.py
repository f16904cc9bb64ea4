"""Device meshes for single-process serving (port of
``rtpe_tpu/parallel/mesh.py``).

As in JAX, one process drives every device of a serving mesh.  A
:class:`Mesh` is a grid of ``torch.device``s with named axes (JAX's
``("data", "model")`` by default); a device may appear more than once,
so two or four shards can share one card.  A sharded batch is a list
of per-device chunks; replicated weights are one copy per distinct
device.  Training does not use a mesh: it runs one process per device
over ``torch.distributed`` (``parallel/dist.py``).
"""

import copy
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


class Mesh:
    """A named grid of devices (``jax.sharding.Mesh``'s ``devices``,
    ``axis_names`` and ``shape``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every CUDA
    device; raises where there is none).  Devices left over warn and
    stay idle, as in JAX."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= "
                               "(e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    used = n_data * n_model
    if used > len(devices) or used < 1:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {used} "
                         f"devices, {len(devices)} given")
    if used < len(devices):
        warnings.warn(
            f"mesh uses {used} of {len(devices)} devices "
            f"(n_data={n_data} x n_model={n_model}); the rest idle",
            stacklevel=2)
    arr = np.empty((n_data, n_model), dtype=object)
    for i in range(used):
        arr[i // n_model, i % n_model] = devices[i]
    return Mesh(arr, ("data", "model"))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, tuple):  # a NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """A tree of (B, ...) tensors -> the same tree with each tensor a
    list of its B / n row chunks, chunk i on device i of ``axis``.  B
    must divide by the axis size, as JAX's ``device_put`` requires."""
    devs = mesh.axis_devices(axis)
    n = len(devs)

    def put(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not shard over "
                             f"{n} devices of '{axis}'")
        m = x.shape[0] // n
        return [x[i * m:(i + 1) * m].to(d, non_blocking=True)
                for i, d in enumerate(devs)]

    return _tree_map(put, batch)


def replicate(tree, mesh: Mesh, axis: str = "data") -> list:
    """One copy of ``tree`` (a module, or a tree of tensors) for each
    device of ``axis``.  Devices that repeat share one copy: the
    replicas are read-only weights."""
    copies: Dict[torch.device, object] = {}
    out = []
    for d in mesh.axis_devices(axis):
        if d not in copies:
            if isinstance(tree, nn.Module):
                src = next(tree.parameters(), None)
                same = src is not None and src.device == d
                copies[d] = tree if same else copy.deepcopy(tree).to(d)
            else:
                copies[d] = _tree_map(
                    lambda x: x.to(d) if torch.is_tensor(x) else x, tree)
        out.append(copies[d])
    return out


def gather_rows(chunks: Sequence[torch.Tensor], device,
                dim: int = 0) -> torch.Tensor:
    """Concatenate per-device chunks on ``device``."""
    return torch.cat([c.to(device, non_blocking=True) for c in chunks], dim)

