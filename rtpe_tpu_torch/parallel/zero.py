"""ZeRO-1: the optimizer's momentum sharded over the data-parallel
processes (port of ``rtpe_tpu/parallel/zero.py``).

Under plain data parallelism every process keeps the SGD momentum of
every parameter.  ZeRO stage 1 keeps on each process only its share:
a momentum buffer of at least ``min_elems`` elements is split along its
first dimension that divides by the number of processes, smaller or
indivisible ones stay whole on every process (JAX's rule,
``zero1_state_sharding``).  Each process applies the SGD update
(``torch.optim.SGD``'s, decay before momentum) to its slices of the
averaged gradients, then the slices are all-gathered into the
parameters.  The update is elementwise and runs the same
``torch.optim.SGD`` code on the slices, so the parameters are bitwise
those of the replicated run.

A checkpoint holds the whole momentum: :meth:`Zero1SGD.gather` (every
process) assembles it, after which :meth:`Zero1SGD.state_dict` gives
``torch.optim.SGD``'s format, so a ZeRO-1 run resumes into a replicated
one and back.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def leaf_shard_dim(shape, n: int, min_elems: int = 2 ** 12
                   ) -> Optional[int]:
    """The dimension a momentum leaf of ``shape`` is sharded along over
    ``n`` processes: the first one that divides by ``n``, for leaves of
    at least ``min_elems`` elements; None (replicated) otherwise.  The
    port's layouts permute JAX's (OIHW against HWIO), so the dimension
    can differ while each process's share is the same size."""
    shape = tuple(shape)
    if int(np.prod(shape, dtype=np.int64)) >= min_elems:
        for d, s in enumerate(shape):
            if s > 0 and s % n == 0:
                return d
    return None


def zero1_state_sharding(state, mesh, axis: str = "data",
                         min_elems: int = 2 ** 12) -> Dict[str, Optional[int]]:
    """For each parameter the optimizer of ``state`` (a train state with
    ``model`` and ``optimizer``) updates, by its name in
    ``model.named_parameters()``: the dimension its momentum is sharded
    along over ``mesh``'s ``axis`` (a :class:`Mesh`, or the number of
    processes), or None where it stays replicated."""
    n = mesh.shape[axis] if isinstance(mesh, Mesh) else int(mesh)
    stepped = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    return {name: leaf_shard_dim(p.shape, n, min_elems)
            for name, p in state.model.named_parameters()
            if id(p) in stepped}


def momentum_bytes(optimizer) -> int:
    """The bytes of momentum this process holds."""
    if isinstance(optimizer, Zero1SGD):
        return optimizer.momentum_bytes()
    return sum(s["momentum_buffer"].numel()
               * s["momentum_buffer"].element_size()
               for s in optimizer.state.values()
               if s.get("momentum_buffer") is not None)


class Zero1SGD:
    """A ``torch.optim.SGD`` whose momentum is sharded over ``group``.

    Wraps the replicated optimizer (its param groups, lr and
    hyperparameters); :attr:`param_groups` are those of the inner SGD
    over the slices, so a caller sets each group's lr there as before.
    ``step()`` takes the gradients already averaged over the group."""

    def __init__(self, optimizer: torch.optim.SGD, group=None,
                 min_elems: int = 2 ** 12):
        self.base = optimizer
        self.group = group
        self.n = dist.get_world_size(group=group)
        self.r = dist.get_rank(group=group)
        held = optimizer.state_dict() if optimizer.state else None
        self.entries: List[tuple] = []   # (param, slice tensor, dim)
        groups = []
        for g in optimizer.param_groups:
            shards = []
            for p in g["params"]:
                d = leaf_shard_dim(p.shape, self.n, min_elems)
                if d is None:
                    s = p
                else:
                    s = torch.nn.Parameter(self._slice(p.detach(), d)
                                           .clone())
                self.entries.append((p, s, d))
                shards.append(s)
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": shards})
        self.inner = torch.optim.SGD(groups)
        self.base.state.clear()
        self._gathered: Optional[Dict[torch.Tensor, torch.Tensor]] = None
        if held is not None:
            self.load_state_dict(held)

    def _slice(self, t: torch.Tensor, d: int) -> torch.Tensor:
        m = t.shape[d] // self.n
        return t.narrow(d, self.r * m, m)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        for p, s, d in self.entries:
            if d is None:
                continue
            s.copy_(self._slice(p, d))
            s.grad = (None if p.grad is None
                      else self._slice(p.grad, d).contiguous())
        self.inner.step()
        self._gathered = None
        for p, s, d in self.entries:
            if d is None:
                continue
            parts = [torch.empty_like(s) for _ in range(self.n)]
            dist.all_gather(parts, s.detach().contiguous(), group=self.group)
            p.copy_(torch.cat(parts, d))

    def _buffer(self, s) -> Optional[torch.Tensor]:
        return self.inner.state.get(s, {}).get("momentum_buffer")

    def momentum_bytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in (self._buffer(s) for _, s, _ in self.entries)
                   if b is not None)

    @torch.no_grad()
    def gather(self) -> None:
        """Assemble the whole momentum on every process (a collective:
        every process of the group calls it) for :meth:`state_dict`."""
        full = {}
        for p, s, d in self.entries:
            b = self._buffer(s)
            if b is None:
                continue
            if d is not None:
                parts = [torch.empty_like(b) for _ in range(self.n)]
                dist.all_gather(parts, b.contiguous(), group=self.group)
                b = torch.cat(parts, d)
            full[p] = b
        self._gathered = full

    def state_dict(self) -> dict:
        """``torch.optim.SGD``'s state dict with the whole momentum, from
        the last :meth:`gather` (raises if none followed the last
        step)."""
        if self._gathered is None and self.n == 1:
            self.gather()
        if self._gathered is None:
            raise RuntimeError("Zero1SGD.state_dict needs gather() on every "
                               "process after the last step")
        for g, ig in zip(self.base.param_groups, self.inner.param_groups):
            g.update({k: v for k, v in ig.items() if k != "params"})
        for p, b in self._gathered.items():
            self.base.state[p] = {"momentum_buffer": b}
        try:
            return self.base.state_dict()
        finally:
            self.base.state.clear()

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load a replicated (or gathered ZeRO-1) state dict: each
        process keeps its slices."""
        self.base.load_state_dict(sd)
        for g, bg in zip(self.inner.param_groups, self.base.param_groups):
            g.update({k: v for k, v in bg.items() if k != "params"})
        self.inner.state.clear()
        for p, s, d in self.entries:
            b = self.base.state.get(p, {}).get("momentum_buffer")
            if b is None:
                continue
            self.inner.state[s]["momentum_buffer"] = (
                b if d is None else self._slice(b, d).clone())
        self.base.state.clear()
        self._gathered = None
