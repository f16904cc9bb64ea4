"""The port's rectangular LAP solvers against the JAX package's, on the CPU.

* ``decode/hungarian_jit.py`` (the ``lap="xla"`` solver, plain PyTorch)
  against JAX ``hungarian_rect`` / ``hungarian``;
* the plain version of the LAP kernel (``ops/lap.py``, the CPU side of
  ``csrc/lap_rect.cu``) against ``hungarian_rect_pallas(interpret=True)``.

On random costs, decode-shaped costs (quantised distances minus a
detection value, the BIG dummy columns) and costs full of planted ties,
the columns must be exactly equal and the total cost equal to scipy's.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from rtpe_tpu.decode.hungarian_jit import hungarian as j_hungarian
from rtpe_tpu.decode.hungarian_jit import hungarian_rect as j_hungarian_rect
from rtpe_tpu.ops.pallas_lap import hungarian_rect_pallas
from rtpe_tpu_torch.decode.hungarian_jit import hungarian, hungarian_rect
from rtpe_tpu_torch.ops.lap import lap_rect, lap_rect_plain


def lap_cost(kind: str, n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "random":
        return (rng.rand(n, m) * 10).astype(np.float32)
    if kind == "decode":
        cost = (rng.randint(0, 11, (n, m)) * 100.0
                - rng.rand(n, m)).astype(np.float32)
        cost[:, rng.randint(0, m):] = 2048.0
        return cost
    return rng.randint(0, 3, (n, m)).astype(np.float32)   # planted ties


def assert_optimal(cost: np.ndarray, cols: np.ndarray) -> None:
    n = cost.shape[0]
    assert len(set(cols.tolist())) == n                 # distinct columns
    rows, want = linear_sum_assignment(cost)
    assert cost[np.arange(n), cols].sum() == pytest.approx(
        cost[rows, want].sum(), rel=1e-5, abs=1e-3)


CASES = [(kind, n, m, seed)
         for seed, (n, m) in enumerate([(1, 1), (5, 9), (8, 8), (13, 30),
                                        (20, 41)])
         for kind in ("random", "decode", "ties")]


@pytest.mark.parametrize("kind,n,m,seed", CASES)
def test_hungarian_rect_matches_jax(kind, n, m, seed):
    cost = lap_cost(kind, n, m, seed)
    got = hungarian_rect(torch.from_numpy(cost))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_hungarian_rect(cost)))
    assert_optimal(cost, got.numpy())


@pytest.mark.parametrize("kind,n,m,seed", CASES)
def test_lap_rect_plain_matches_pallas_interpret(kind, n, m, seed):
    cost = lap_cost(kind, n, m, seed)
    got = lap_rect(torch.from_numpy(cost)[None])[0]
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(hungarian_rect_pallas(jnp.asarray(cost),
                                         interpret=True)))
    assert_optimal(cost, got.numpy())


def test_batched_solves_equal_one_matrix_at_a_time():
    """Matrices of a batch finish their loops at different steps; each
    must come out as if solved alone, in both solvers."""
    costs = np.stack([lap_cost(kind, 12, 25, seed)
                      for seed, kind in enumerate(["random", "decode",
                                                   "ties", "decode"])])
    batch_h = hungarian_rect(torch.from_numpy(costs))
    batch_k = lap_rect_plain(torch.from_numpy(costs))
    for i, cost in enumerate(costs):
        one = torch.from_numpy(cost)
        assert torch.equal(batch_h[i], hungarian_rect(one))
        assert torch.equal(batch_k[i], lap_rect_plain(one[None])[0])


def test_square_hungarian_matches_jax():
    for seed, kind in enumerate(["random", "decode", "ties"]):
        cost = lap_cost(kind, 10, 10, seed)
        got = hungarian(torch.from_numpy(cost))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_hungarian(cost)))
        assert_optimal(cost, got.numpy())
    with pytest.raises(ValueError):
        hungarian(torch.zeros((3, 4)))


def test_lap_rect_wrapper_on_the_cpu():
    """A CPU tensor takes the plain version (no launch is counted);
    shapes outside the kernel's envelope and other devices raise."""
    cost = torch.from_numpy(lap_cost("ties", 6, 9, 0))[None]
    before = lap_rect.launches
    assert torch.equal(lap_rect(cost), lap_rect_plain(cost))
    assert lap_rect.launches == before
    for bad in (torch.zeros((1, 33, 40)), torch.zeros((1, 5, 4)),
                torch.zeros((1, 4, 128)), torch.zeros((4, 4))):
        with pytest.raises(ValueError):
            lap_rect(bad)
    with pytest.raises(ValueError):
        lap_rect(cost.to("meta"))


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_plain_solvers_stop_on_costs_that_are_not_finite(bad):
    """A row with no free column below 1e18 marks its matrix with -1
    columns, as the kernel does, where the JAX loop never ends; the
    other matrices of the batch are solved as if alone."""
    costs = np.stack([lap_cost("random", 4, 6, 0),
                      lap_cost("decode", 4, 6, 1)])
    costs[1, 2] = bad
    t = torch.from_numpy(costs)
    for got in (lap_rect_plain(t), hungarian_rect(t)):
        assert got[1].tolist() == [-1] * 4
        assert torch.equal(got[0], lap_rect_plain(t[:1])[0])
