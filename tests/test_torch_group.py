"""The port's device grouping against the JAX package's, on the CPU.

* the plain version of the grouping mega-kernel (``ops/group.py``, the
  CPU side of ``csrc/group_mega.cu``) against
  ``match_by_tag_kernel(interpret=True)``, both solvers,
  ``ignore_too_much`` both ways, one and two tag dimensions, and the
  edge cases of the JAX tests: people and n_people exactly equal;
* its greedy solver against the port's lockstep grouping, row for row;
* both greedy groupings (the plain versions of ``csrc/group_lockstep.cu``
  and of ``csrc/group_mega.cu``'s greedy solver) on tags with planted
  NaNs against the interpret-mode kernels: a NaN cost keeps its NaN
  through the clamp and the row matches no one;
* ``decode/group_jit.py`` against JAX ``match_by_tag_jit`` with
  ``lap="xla"`` and the per-joint LAP kernel (``"pallas_interpret"``):
  exactly equal;
* the one-time kernel self-check of ``decode/fused.py``: it passes on
  its separated-clusters fixture, demotes ``lap="auto"`` to the
  per-joint LAP kernel and warns when the kernel is wrong, and is a
  no-op on the CPU.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpe_tpu.decode.group_jit import match_by_tag_jit as j_match_by_tag_jit
from rtpe_tpu.ops.pallas_group import match_by_tag_kernel as j_kernel
from rtpe_tpu.ops.pallas_group_lockstep import \
    match_by_tag_lockstep as j_lockstep
from rtpe_tpu_torch.decode import fused
from rtpe_tpu_torch.decode.group_jit import match_by_tag_jit
from rtpe_tpu_torch.ops import group as mega
from rtpe_tpu_torch.ops.group import match_by_tag_kernel
from rtpe_tpu_torch.ops.group_lockstep import match_by_tag_lockstep


def scene(b, j, k, d, seed, key_ties=True):
    rng = np.random.default_rng(seed)
    tags = (rng.normal(size=(b, j, k, d)) * 2).astype(np.float32)
    if key_ties:
        tags[..., 0] = np.round(tags[..., 0] * 2) / 2   # setdefault merges
    locs = rng.uniform(0, 64, size=(b, j, k, 2)).astype(np.float32)
    vals = rng.uniform(-0.2, 1.0, size=(b, j, k)).astype(np.float32)
    return tags, locs, vals


def edge_scenes():
    """The edge cases of ``tests/test_decode.py`` (group kernel, greedy
    and lockstep): an empty image, all joints sharing one exact key, and
    same-key new persons at the first joint."""
    j, k, d = 3, 4, 1
    rng = np.random.default_rng(1)
    tags = np.zeros((3, j, k, d), np.float32)
    tags[1] = 7.25
    tags[1, :, 2:, 0] = rng.normal(size=(j, k - 2)) * 5 + 100
    tags[2, 0, :2, 0] = 7.25
    tags[2, 0, 2:, 0] = 100.0 + np.arange(k - 2) * 50.0
    tags[2, 1:, :, 0] = 1e6
    locs = rng.uniform(0, 32, size=(3, j, k, 2)).astype(np.float32)
    vals = np.full((3, j, k), -1.0, np.float32)
    vals[1] = rng.uniform(0.4, 1.0, size=(j, k))
    vals[2, 0] = np.linspace(1.0, 0.4, k, dtype=np.float32)
    return tags, locs, vals


def as_torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def as_jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("solver", ["lap", "greedy"])
@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("shape,m,p_max", [((2, 4, 8, 1), 8, 24),
                                           ((2, 3, 6, 2), 8, 10)])
def test_kernel_plain_matches_pallas_interpret(solver, ignore_too_much,
                                               shape, m, p_max):
    arrays = scene(*shape, seed=sum(shape))
    kw = dict(max_num_people=m, ignore_too_much=ignore_too_much,
              p_max=p_max, solver=solver)
    p_j, n_j = j_kernel(*as_jax(arrays), interpret=True, **kw)
    before = match_by_tag_kernel.launches
    p_t, n_t = match_by_tag_kernel(*as_torch(arrays), **kw)
    assert match_by_tag_kernel.launches == before   # CPU: plain version
    assert n_t.dtype == torch.int32 and int(n_t.min()) > 0
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("solver", ["lap", "greedy"])
@pytest.mark.parametrize("ignore_too_much", [False, True])
def test_kernel_plain_edge_cases_match_pallas_interpret(solver,
                                                        ignore_too_much):
    arrays = edge_scenes()
    kw = dict(max_num_people=4, ignore_too_much=ignore_too_much, p_max=6,
              solver=solver)
    p_j, n_j = j_kernel(*as_jax(arrays), interpret=True, **kw)
    p_t, n_t = match_by_tag_kernel(*as_torch(arrays), **kw)
    assert int(n_t[0]) == 0 and torch.all(p_t[0] == 0)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("shape,m,p_max", [((3, 6, 12, 1), 12, 24),
                                           ((2, 5, 8, 2), 10, 6)])
def test_greedy_equals_lockstep_row_for_row(ignore_too_much, shape, m,
                                            p_max):
    tags, locs, vals = scene(*shape, seed=7)
    vals = np.sort(vals, axis=-1)[..., ::-1]      # top-k order
    args = as_torch((tags, locs, vals))
    kw = dict(max_num_people=m, ignore_too_much=ignore_too_much,
              p_max=p_max)
    p_g, n_g = match_by_tag_kernel(*args, solver="greedy", **kw)
    p_l, n_l = match_by_tag_lockstep(*args, **kw)
    assert torch.equal(n_g, n_l) and torch.equal(p_g, p_l)


def nan_scene(b, j, k, d, seed):
    """A scene in top-k order with NaN tags planted on active rows: a
    whole tag at the first joint (a new person whose mean stays NaN, so
    no later row can match it or anyone beside it), one dimension
    of a later row, and an image without NaN."""
    tags, locs, vals = scene(b, j, k, d, seed)
    vals = np.sort(vals, axis=-1)[..., ::-1].copy()
    tags[0, 0, 1] = np.nan
    tags[1, 2, 0, d - 1] = np.nan
    tags[1, 3, 2] = np.nan
    vals[:2, :, :3] = np.maximum(vals[:2, :, :3], 0.5)
    return tags, locs, vals


@pytest.mark.parametrize("grouping", ["lockstep", "greedy"])
@pytest.mark.parametrize("ignore_too_much", [False, True])
@pytest.mark.parametrize("shape,m,p_max", [((3, 5, 8, 1), 8, 24),
                                           ((3, 4, 6, 2), 8, 10)])
def test_nan_tags_match_pallas_interpret(grouping, ignore_too_much, shape,
                                         m, p_max):
    arrays = nan_scene(*shape, seed=5)
    kw = dict(max_num_people=m, ignore_too_much=ignore_too_much,
              p_max=p_max)
    if grouping == "lockstep":
        p_j, n_j = j_lockstep(*as_jax(arrays), interpret=True, **kw)
        p_t, n_t = match_by_tag_lockstep(*as_torch(arrays), **kw)
    else:
        p_j, n_j = j_kernel(*as_jax(arrays), interpret=True,
                            solver="greedy", **kw)
        p_t, n_t = match_by_tag_kernel(*as_torch(arrays), solver="greedy",
                                       **kw)
    assert torch.isnan(p_t[0]).any() and torch.isnan(p_t[1]).any()
    assert not torch.isnan(p_t[2]).any()
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("lap", ["xla", "pallas"])
@pytest.mark.parametrize("ignore_too_much", [False, True])
def test_match_by_tag_jit_matches_jax(lap, ignore_too_much):
    b, k = 2, 8
    tags, locs, vals = scene(b, 4, k, 1, seed=11)
    kw = dict(max_num_people=k, ignore_too_much=ignore_too_much, p_max=24)
    p_t, n_t = match_by_tag_jit(*as_torch((tags, locs, vals)), lap=lap,
                                **kw)
    j_lap = "xla" if lap == "xla" else "pallas_interpret"
    for i in range(b):
        p_j, n_j = j_match_by_tag_jit(*as_jax((tags[i], locs[i], vals[i])),
                                      lap=j_lap, **kw)
        assert int(n_t[i]) == int(n_j) > 0
        np.testing.assert_array_equal(p_t[i].numpy(), np.asarray(p_j))
    # one image without a batch axis: same answer
    p_1, n_1 = match_by_tag_jit(*as_torch((tags[1], locs[1], vals[1])),
                                lap=lap, **kw)
    assert torch.equal(p_1, p_t[1]) and torch.equal(n_1, n_t[1])


def test_match_by_tag_jit_edge_cases_match_jax():
    arrays = edge_scenes()
    kw = dict(max_num_people=4, p_max=6)
    p_t, n_t = match_by_tag_jit(*as_torch(arrays), **kw)
    for i in range(3):
        p_j, n_j = j_match_by_tag_jit(*as_jax([a[i] for a in arrays]), **kw)
        assert int(n_t[i]) == int(n_j)
        np.testing.assert_array_equal(p_t[i].numpy(), np.asarray(p_j))
    with pytest.raises(ValueError):
        match_by_tag_jit(*as_torch(arrays), lap="kernel", **kw)


@pytest.fixture
def fresh_selfcheck(monkeypatch):
    monkeypatch.setattr(fused, "_SELFCHECK_CACHE", {})
    monkeypatch.delenv("RTPE_LAP_SELFCHECK", raising=False)


@pytest.mark.parametrize("solver", ["lap", "greedy", "lockstep"])
def test_selfcheck_passes_its_fixture(fresh_selfcheck, solver):
    """The fixture has a unique optimal assignment, so every solver,
    exact or greedy, must agree with the 'xla' grouping on it."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fused.kernel_selfcheck(max_num_people=8, p_max=16,
                                      num_joints=4, d=1, solver=solver,
                                      device="cpu")
    assert fused._SELFCHECK_CACHE == {(8, 16, 4, 1, solver, "cpu"): True}


@pytest.mark.parametrize("single_image", [True, False])
def test_selfcheck_demotes_auto_to_the_lap_kernel(fresh_selfcheck,
                                                  monkeypatch, single_image):
    """A grouping kernel that returns wrong people fails the check:
    ``auto`` becomes ``"pallas"`` (the per-joint LAP kernel, never a
    plain version), with a warning, and the verdict is cached."""
    def wrong(*args, **kw):
        people, n = ref(*args, **kw)
        return people + 1.0, n

    ref = (mega.match_by_tag_kernel if single_image
           else fused.match_by_tag_lockstep)
    if single_image:
        monkeypatch.setattr(mega, "match_by_tag_kernel", wrong)
    else:
        monkeypatch.setattr(fused, "match_by_tag_lockstep", wrong)
    real = fused.kernel_selfcheck
    # the check runs only for CUDA; here it runs the plain versions
    monkeypatch.setattr(fused, "kernel_selfcheck",
                        lambda *a, **kw: real(*a, **{**kw, "device": "cpu"}))
    with pytest.warns(UserWarning, match="demoted to 'pallas'"):
        lap = fused._resolve_auto_lap(8, 16, 4, 1, single_image=single_image,
                                      device="cuda")
    assert lap == "pallas"
    solver = "greedy" if single_image else "lockstep"
    assert fused._SELFCHECK_CACHE == {(8, 16, 4, 1, solver, "cpu"): False}


def test_selfcheck_is_a_noop_on_the_cpu(fresh_selfcheck, monkeypatch):
    """On the CPU ``auto`` is the plain greedy (one image) or lockstep
    (batch) solver, and no check runs; ``RTPE_LAP_SELFCHECK=0`` skips
    it on the card too; shapes beyond the kernel's envelope demote."""
    def boom(*a, **kw):
        raise AssertionError("the self-check ran")

    monkeypatch.setattr(fused, "kernel_selfcheck", boom)
    assert fused._resolve_auto_lap(30, 90, 17, 1, single_image=True,
                                   device="cpu") == "greedy"
    assert fused._resolve_auto_lap(30, 90, 17, 1, single_image=False,
                                   device="cpu") == "lockstep"
    monkeypatch.setenv("RTPE_LAP_SELFCHECK", "0")
    assert fused._resolve_auto_lap(30, 90, 17, 1, single_image=True,
                                   device="cuda") == "greedy"
    assert fused._resolve_auto_lap(30, 97, 17, 1, device="cuda") == "pallas"
    assert fused._SELFCHECK_CACHE == {}
