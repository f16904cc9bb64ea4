"""The Hungarian algorithm in plain PyTorch (minimisation), on any device.

Port of ``rtpe_tpu/decode/hungarian_jit.py``: the successive-shortest-
path / potentials formulation in float32, the argmin taking the
smallest column on ties.  It is the grouping's ``lap="xla"`` solver and
the oracle of the kernel self-check (``decode/fused.py``).

The JAX function indexes the row potentials by row; the Pallas LAP
kernel holds them per column (``u_col[j] = u[p[j]]``), which only moves
the same float32 values.  So one loop serves both here:
:func:`~..ops.lap.lap_columns`, the plain version of the LAP kernel,
which takes a batch and runs its matrices in lockstep (as ``vmap`` of
the JAX loops does).

On cost ties an arbitrary optimal assignment is returned: the total
cost matches munkres, the pairs may differ.
"""

import torch

from ..ops.lap import lap_columns, rows_to_columns


def hungarian_rect(cost: torch.Tensor) -> torch.Tensor:
    """Rectangular LAP: assign each row a distinct column at minimum
    total cost; columns may stay unmatched.

    :param cost: (n, m) or (B, n, m) costs with ``n <= m``.
    :returns: (n,) or (B, n) int32 — the column assigned to each row
      (-1 for the rows of a matrix whose costs are not finite, where
      the JAX loop never ends).
    """
    single = cost.dim() == 2
    if single:
        cost = cost[None]
    b, n, m = cost.shape
    if n > m:
        raise ValueError(f"hungarian_rect needs n <= m, got {n} x {m}")
    n_rows = torch.full((b,), n, dtype=torch.int64, device=cost.device)
    p = lap_columns(cost, n_rows)
    out = torch.where(p[:, :1] < 0, -1, rows_to_columns(p, n))
    out = out.to(torch.int32)
    return out[0] if single else out


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Square LAP.  :param cost: (n, n) or (B, n, n).
    :returns: (n,) or (B, n) int32 — the column assigned to each row.

    The square solve is the rectangular one with ``m == n``: the same
    loop, and every column ends up matched."""
    if cost.shape[-1] != cost.shape[-2]:
        raise ValueError(f"hungarian takes square costs, got "
                         f"{tuple(cost.shape)}")
    return hungarian_rect(cost)
