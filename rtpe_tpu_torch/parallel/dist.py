"""Multi-process initialization and the data-parallel group's batch
statistics (port of ``rtpe_tpu/parallel/dist.py``).

JAX runs one program per host over a (hosts, data, model) mesh.  The
port trains with one process per device over ``torch.distributed``
(NCCL on cards, gloo on the CPU): :func:`initialize` starts the process
group from JAX's environment variables or from torchrun's, and
:func:`process_local_batch_slice` gives each process its rows of the
global batch.

Under JAX every batch reduction of the data-sharded step runs over the
global batch, because the step is one program.  Per-process training
reduces over each process's rows unless told otherwise, so while
:class:`global_batch_stats` is active the three batch reductions of the
train step run over the group instead: train-mode BatchNorm's sums
(``models/layers.py``), the fused CAM's statistics (``ops/cam.py``) and
the min-max normalization of the detection loss (``train/losses.py``).
The sums go through :func:`all_reduce_sum`, whose backward all-reduces
the cotangents, so their gradients are the global batch's too.
"""

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Start the default process group from the arguments or the
    environment; a no-op (returning False) when neither names a
    coordinator, or when the group is already up.

    JAX's variables (``COORDINATOR_ADDRESS`` = ``host:port``,
    ``NUM_PROCESSES``, ``PROCESS_ID``) win over torchrun's
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) where
    both are set.  An explicit ``process_id=0`` wins over the
    environment.  ``backend`` defaults to NCCL where CUDA is available
    and gloo elsewhere."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False  # single process
    if num_processes is None:
        num_processes = int(env.get("NUM_PROCESSES",
                                    env.get("WORLD_SIZE", 1)))
    if process_id is None:  # NOT `or`: an explicit rank 0 must win
        process_id = int(env.get("PROCESS_ID", env.get("RANK", 0)))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index among the processes of its host
    (``LOCAL_RANK`` as torchrun sets it; else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_device(device=None) -> torch.device:
    """The device of this process: ``cuda:{LOCAL_RANK}``; a device with
    an index (``"cuda:0"``) as given, or the CPU where the caller asks
    for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the port on the CPU")
    return dev if dev.index is not None else torch.device("cuda",
                                                          local_rank())


def make_multihost_mesh(n_model: int = 1, devices_per_process=None) -> Mesh:
    """(hosts, data, model) mesh: one ``hosts`` entry per process, and
    each process's ``data`` x ``model`` devices.  Every process of the
    port drives its own devices, so the mesh names them by process: the
    local CUDA devices (or ``devices_per_process``, a list of devices)
    for each of the ``world_size()`` processes."""
    local = list(devices_per_process if devices_per_process is not None
                 else [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())])
    n_hosts = world_size()
    n_data = len(local) // n_model
    if n_data < 1:
        raise ValueError(f"{len(local)} local devices cannot hold "
                         f"n_model={n_model}")
    arr = np.empty((n_hosts, n_data, n_model), dtype=object)
    for h in range(n_hosts):
        for d in range(n_data):
            for m in range(n_model):
                arr[h, d, m] = local[d * n_model + m]
    return Mesh(arr, ("hosts", "data", "model"))


def process_local_batch_slice(global_batch: int, group=None) -> slice:
    """This process's rows of the global batch, split over ``group``
    (default: every process).  JAX slices per host (each host feeds its
    chips); the port runs one process per device, so it slices per
    process.  The batch must split evenly."""
    n = world_size(group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split "
                         f"evenly over {n} processes")
    per = global_batch // n
    start = rank(group) * per
    return slice(start, start + per)


# ------------------------------------------------- global batch statistics

_STATS_GROUP: list = []


class global_batch_stats:
    """Context manager: while active, the train step's batch reductions
    run over the processes of ``group`` (``None`` or ``False`` leaves
    them per process).  Pass ``dist.group.WORLD`` for the default
    group."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        _STATS_GROUP.append(self.group)
        return self

    def __exit__(self, *exc):
        _STATS_GROUP.pop()
        return False


def stats_group():
    """The group of the innermost active :class:`global_batch_stats`,
    or None."""
    if not _STATS_GROUP or _STATS_GROUP[-1] in (None, False):
        return None
    return _STATS_GROUP[-1]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable: the backward
    sums the cotangents over the group too, so each process's sums get
    the gradient of every process's loss."""
    return _AllReduceSum.apply(t, group)


def all_reduce_extreme(t: torch.Tensor, group, op: str) -> torch.Tensor:
    """The elementwise ``"min"`` or ``"max"`` of ``t`` over ``group``
    (detached)."""
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN if op == "min"
                    else dist.ReduceOp.MAX, group=group)
    return out


def average_gradients(params, group) -> None:
    """Average the gradients of ``params`` over ``group`` in place, as
    DDP does: one all-reduce of their concatenation, then a division by
    the group's size.  Every process must hold gradients for the same
    parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    k = 0
    for g in grads:
        g.copy_(flat[k:k + g.numel()].view_as(g))
        k += g.numel()


def mean_over_group(values, group) -> torch.Tensor:
    """The mean over ``group`` of a stack of per-process scalars
    (detached; each process's mean weighs alike, as its rows do)."""
    t = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t / dist.get_world_size(group)


def check_equal_shards(rows: int, group, device) -> None:
    """Raise unless every process of ``group`` holds ``rows`` rows: the
    losses' means average to the global batch's only over equal
    shards."""
    t = torch.tensor([rows, -rows], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise ValueError(f"the global batch does not split evenly over the "
                         f"group: shards of {lo} to {hi} rows")
