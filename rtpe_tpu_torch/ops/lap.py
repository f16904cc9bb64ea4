"""Rectangular LAP: the CUDA kernel ``csrc/lap_rect.cu`` and its plain
PyTorch version.

Replaces ``rtpe_tpu/ops/pallas_lap.py:hungarian_rect_pallas`` (the
Pallas kernel ``_lap_kernel``): assign every row of an (n, m) cost
matrix a distinct column at minimum total cost, by successive shortest
paths with the row potentials held per column, masked entries at 1e18
and the argmin taking the smallest column on ties.  The JAX function
solves one matrix and is vmapped over images; :func:`lap_rect` takes a
batch (B, n, m) and returns (B, n) int32 columns, so one launch serves
one joint of every image.

:func:`lap_rect` runs the plain version for CPU tensors and the kernel
for CUDA tensors; ``lap_rect.launches`` counts kernel launches.  The
plain version's core, :func:`lap_columns`, also serves the exact
solver of the grouping mega-kernel's plain version (``ops/group.py``),
as ``lap_core.cuh`` serves both kernels, and the plain Hungarian of
``decode/hungarian_jit.py``.
"""

import ctypes

import torch

from . import _build

MAX_ROWS = 32
MAX_COLS = 127
_INF = 1e18

_SIGS = {"lap_rect_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]}


def lap_columns(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """Plain successive-shortest-path solve of a batch.

    :param cost: (B, R, M) float32; rows ``0..n_rows[b]-1`` of matrix b
      are inserted, in order.
    :param n_rows: (B,) int64 row counts, each at most ``min(R, M)``.
    :returns: p (B, M + 1) int64: ``p[b, l]`` is the 1-indexed row
      assigned to cost column ``l - 1`` (0: none).  ``p[b, 0]`` is 0,
      or -1 when a row of matrix b found no free column below 1e18
      (costs that are not finite): that matrix stops there, as in the
      kernel, instead of looping for ever.

    The images run in lockstep, each masked out of a step once its own
    loop has ended (what ``vmap`` of the JAX loops does), with the
    kernel's float32 arithmetic step for step.  ``lap_columns.passes``
    counts the (matrix, Dijkstra step) pairs run: the work these
    inputs need (``chip_smoke.py`` bounds the kernel with it), and
    ``lap_columns.image_passes`` the same for each matrix of the batch,
    (B,) int64, summed over the calls since it was last set to None (a
    call of another batch starts it again): the longest matrix's chain
    of steps from one batched solve.
    """
    b, _, mc = cost.shape
    dev = cost.device
    f32 = torch.float32
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    lane = torch.arange(mc + 1, device=dev)
    valid = (lane >= 1)[None, :]
    # column l of a row is cost column l - 1; column 0 hosts the entering row
    crows = torch.cat([torch.full_like(cost[:, :, :1], _INF), cost.to(f32)],
                      dim=2)
    bi = torch.arange(b, device=dev)
    v = torch.zeros((b, mc + 1), dtype=f32, device=dev)
    u_col = torch.zeros_like(v)
    p = torch.zeros((b, mc + 1), dtype=torch.int64, device=dev)
    failed = torch.zeros(b, dtype=torch.bool, device=dev)
    n_max = int(n_rows.max()) if b else 0
    counts = lap_columns.image_passes
    if counts is None or counts.shape != (b,) or counts.device != dev:
        lap_columns.image_passes = torch.zeros(b, dtype=torch.int64,
                                               device=dev)
    for i in range(1, n_max + 1):
        p[:, 0] = i
        u_col[:, 0] = 0.0
        minv = torch.full_like(v, _INF)
        way = torch.zeros_like(p)
        used = torch.zeros((b, mc + 1), dtype=torch.bool, device=dev)
        j0 = torch.zeros(b, dtype=torch.int64, device=dev)
        act = (n_rows >= i) & ~failed
        pj0 = torch.where(act, i, 0)
        uj0 = torch.zeros(b, dtype=f32, device=dev)
        while True:
            n_act = int(act.sum())
            if not n_act:
                break
            lap_columns.passes += n_act
            lap_columns.image_passes += act
            used = used | (act[:, None] & (lane[None, :] == j0[:, None]))
            crow = crows[bi, (pj0 - 1).clamp(min=0)]
            cur = torch.where(valid & ~used, crow - uj0[:, None] - v, inf)
            better = act[:, None] & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(used | ~valid, inf, minv)
            j1 = torch.argmin(masked, dim=1)         # first (smallest) column
            delta = masked.gather(1, j1[:, None])
            stuck = act & ~(delta[:, 0] < _INF)
            failed = failed | stuck
            act = act & ~stuck
            on_used = act[:, None] & used
            u_col = torch.where(on_used, u_col + delta, u_col)
            v = torch.where(on_used, v - delta, v)
            minv = torch.where(act[:, None] & ~used, minv - delta, minv)
            j0 = torch.where(act, j1, j0)
            uj0 = torch.where(act, u_col[bi, j0], uj0)
            pj0 = torch.where(act, p[bi, j0], pj0)
            act = act & (pj0 != 0)
        # augmenting walk: move each (row, potential) one column forward
        walk = (j0 != 0) & ~failed
        while bool(walk.any()):
            j1 = way[bi, j0]
            p[bi, j0] = torch.where(walk, p[bi, j1], p[bi, j0])
            u_col[bi, j0] = torch.where(walk, u_col[bi, j1], u_col[bi, j0])
            j0 = torch.where(walk, j1, j0)
            walk = walk & (j0 != 0)
    p[:, 0] = torch.where(failed, -1, 0)
    return p


lap_columns.passes = 0
lap_columns.image_passes = None


def rows_to_columns(p: torch.Tensor, n: int) -> torch.Tensor:
    """p (B, M + 1) from :func:`lap_columns` -> (B, n) int64 column of
    each row (0 for a row left unassigned)."""
    b, mc1 = p.shape
    rows = p[:, 1:] - 1
    out = torch.zeros((b, n + 1), dtype=torch.int64, device=p.device)
    cols = torch.arange(mc1 - 1, device=p.device).expand(b, -1)
    out.scatter_(1, torch.where(rows >= 0, rows, n), cols)
    return out[:, :n]


def _check(cost: torch.Tensor) -> None:
    if cost.dim() != 3:
        raise ValueError(f"lap_rect takes (B, n, m) costs, got "
                         f"{tuple(cost.shape)}")
    _, n, m = cost.shape
    if not (1 <= n <= MAX_ROWS and n <= m <= MAX_COLS):
        raise ValueError(f"lap_rect takes 1 <= n <= {MAX_ROWS} and "
                         f"n <= m <= {MAX_COLS}, got n={n}, m={m}")


def lap_rect_plain(cost: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (B, n, m) -> (B, n) int32."""
    _check(cost)
    b, n, _ = cost.shape
    n_rows = torch.full((b,), n, dtype=torch.int64, device=cost.device)
    p = lap_columns(cost, n_rows)
    cols = torch.where(p[:, :1] < 0, -1, rows_to_columns(p, n))
    return cols.to(torch.int32)


def _lap_rect_cuda(cost: torch.Tensor) -> torch.Tensor:
    _check(cost)
    b, n, m = cost.shape
    c = cost.to(torch.float32).contiguous()
    out = torch.empty((b, n), dtype=torch.int32, device=c.device)
    if b == 0:
        return out
    lib = _build.load("lap_rect", _SIGS)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _build.check(lib.lap_rect_launch(c.data_ptr(), b, n, m, out.data_ptr(),
                                     stream), "lap_rect")
    lap_rect.launches += 1
    return out


def lap_rect(cost: torch.Tensor) -> torch.Tensor:
    """Batched rectangular LAP (plain on CPU, the kernel on CUDA).

    :param cost: (B, n, m) costs, ``n <= 32``, ``n <= m <= 127``.
    :returns: (B, n) int32, the column assigned to each row (-1 for the
      rows of a matrix the kernel could not solve: costs not finite).
    """
    if cost.device.type == "cpu":
        return lap_rect_plain(cost)
    if cost.device.type != "cuda":
        raise ValueError(f"lap_rect: unsupported device {cost.device}")
    return _lap_rect_cuda(cost)


lap_rect.launches = 0
