"""The trainer's state on the CPU: checkpoints, part snapshots, configs
and the remat student.

* ``TrainCheckpointer``: 4 steps run through, against 2 steps, a save, a
  restore into a fresh model and optimizer and 2 more steps, on fixed
  batches: parameters, buffers and momentum bitwise equal.
  ``max_to_keep`` and ``latest_step``; the SIGTERM handler saves and
  raises ``SystemExit(143)`` (called in-process, the old handler
  restored after).
* Parts: the port's load through ``rtpe_tpu.io.checkpoint.
  load_student_parts`` into a JAX template, equal to the JAX variables
  of the same weights; JAX-written parts load into the port, equal to
  ``student_state_dict_from_jax``; the same for
  ``save_parts_by_toplevel``.
* Configs: defaults equal to ``rtpe_tpu.configs`` field for field, and
  a YAML written by either package loads in the other to equal dicts
  (skipped where PyYAML is absent).
* ``remat``: one float32 step with ``remat=True`` against ``remat=False``
  on the same batch: losses within rtol 1e-6, parameters within 1e-6,
  running statistics within 1e-7 (a second momentum step in the
  recompute moves them by far more, which the test shows by turning the
  guard off).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from rtpe_tpu import configs as j_configs
from rtpe_tpu.io import checkpoint as j_ckpt
from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
from rtpe_tpu_torch import configs
from rtpe_tpu_torch.io import checkpoint as ckpt
from rtpe_tpu_torch.io.jax_import import (
    jax_variables_from_student_state_dict, student_state_dict_from_jax)
from rtpe_tpu_torch.models import layers, students
from rtpe_tpu_torch.models.factory import get_attention_student
from rtpe_tpu_torch.train import (DistillConfig, DistillTrainState,
                                  make_distill_train_step)

B, HW, INPLANES, ALT = 2, 32, 8, 6


def _batch(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt = rng.random((B, HW, HW, 17)) ** 6
    gt[gt < 0.05] = 0.0
    return {k: torch.from_numpy(v) for k, v in {
        "img": rng.normal(size=(B, HW, HW, 3)).astype(f32),
        "img_alt": rng.random((B, HW, HW, 3)).astype(f32),
        "segm_mask": (rng.random((B, HW, HW, 1)) > 0.6).astype(f32),
        "gt_hms": gt.astype(f32),
        "teacher_hms": rng.random((B, HW, HW, 17)).astype(f32),
        "mask": (rng.random((B, HW, HW, 1)) > 0.1).astype(f32)}.items()}


def _trainer(**kw):
    model = get_attention_student(inplanes=INPLANES, alt_planes=ALT,
                                  device="cpu", **kw)
    cfg = DistillConfig()
    return (DistillTrainState.create(model, cfg),
            make_distill_train_step(model, cfg))


def _momentum(state):
    return [state.optimizer.state[p]["momentum_buffer"]
            for g in state.optimizer.param_groups for p in g["params"]]


def test_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    batches = [_batch(s) for s in range(4)]
    whole, step = _trainer()
    for b in batches:
        whole, _ = step(whole, b)

    first, step = _trainer()
    for b in batches[:2]:
        first, _ = step(first, b)
    ck = ckpt.TrainCheckpointer(str(tmp_path / "ck"))
    assert ck.latest_step() is None
    ck.save(first.step, first)
    fresh, step = _trainer(seed=7)
    fresh, got = ck.restore(fresh)
    assert got == 2 and fresh.step == 2
    for b in batches[2:]:
        fresh, _ = step(fresh, b)
    assert fresh.step == whole.step == 4
    for (k, a), (_, b) in zip(whole.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(_momentum(whole), _momentum(fresh)):
        assert torch.equal(a, b)


def test_retention_latest_step_and_sigterm(tmp_path):
    state, _ = _trainer()
    ck = ckpt.TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=3)
    for s in (1, 5, 3, 9, 12):
        state.step = s
        ck.save(s, state)
    assert ck.steps() == [5, 9, 12] and ck.latest_step() == 12
    assert sorted(os.listdir(ck.directory)) == ["step_12.pt", "step_5.pt",
                                                "step_9.pt"]
    old = signal.getsignal(signal.SIGTERM)
    try:
        state.step = 13
        ck.install_sigterm_save(lambda: state)
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(SystemExit) as exc:
            handler(signal.SIGTERM, None)
        assert exc.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ck.latest_step() == 13 and ck.steps() == [9, 12, 13]
    fresh, _ = _trainer(seed=3)
    fresh, step = ck.restore(fresh)
    assert step == 13
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k


# ----------------------------------------------------------------- parts

@pytest.fixture(scope="module")
def jax_variables():
    model = JaxStudent(inplanes=INPLANES, alt_planes=ALT, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3))
    return [jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(k), x, x, train=False))
        for k in (1, 2)]


def _port(variables):
    m = students.AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT)
    m.load_state_dict(student_state_dict_from_jax(variables), strict=True)
    return m


def _flat(variables):
    return {c: flatten_dict(variables[c]) for c in variables}


def _assert_same_variables(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for c in want:
        assert got[c].keys() == want[c].keys(), c
        for k in want[c]:
            np.testing.assert_array_equal(np.asarray(got[c][k]), want[c][k],
                                          err_msg="/".join(k))


def _merged(v_parts, v_rest):
    """``v_rest``'s stem under every other module of ``v_parts``: the
    parts cover all but the stem, in either granularity."""
    return {c: {top: (v_rest if top == "stem" else v_parts)[c][top]
                for top in v_rest[c]} for c in v_rest}


@pytest.mark.parametrize("toplevel", [False, True],
                         ids=["student_parts", "by_toplevel"])
def test_parts_cross_both_ways(jax_variables, tmp_path, toplevel):
    v1, v2 = jax_variables
    port_save = (ckpt.save_parts_by_toplevel if toplevel
                 else ckpt.save_student_parts)
    jax_save = (j_ckpt.save_parts_by_toplevel if toplevel
                else j_ckpt.save_student_parts)
    parts = (None if not toplevel else
             [t for t in v1["params"] if t != "stem"])

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    files = port_save(_port(v1), port_dir, "snap_")
    want_files = jax_save(v1, jax_dir, "snap_")
    assert sorted(map(os.path.basename, files)) == \
        sorted(map(os.path.basename, want_files))
    if not toplevel:
        assert len(files) == 7
    for f in files:
        with np.load(f) as a, np.load(os.path.join(
                jax_dir, os.path.basename(f))) as b:
            assert sorted(a.files) == sorted(b.files), f

    # the port's parts through JAX's loader: v1's parts over v2's stem
    loaded = j_ckpt.load_student_parts(v2, port_dir, "snap_", parts=parts)
    want = _merged(v1, v2)
    _assert_same_variables(loaded, want)

    # JAX's parts into the port
    m = _port(v2)
    ckpt.load_student_parts(m, jax_dir, "snap_", parts=parts)
    want_sd = student_state_dict_from_jax(want)
    for k, v in m.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    assert torch.equal(m.stem.conv1.weight,
                       _port(v2).stem.conv1.weight)


def test_student_variables_round_trip(jax_variables):
    v1, _ = jax_variables
    _assert_same_variables(
        jax_variables_from_student_state_dict(_port(v1).state_dict()), v1)


def test_load_student_parts_is_strict_within_a_part(jax_variables,
                                                    tmp_path):
    v1, _ = jax_variables
    d = str(tmp_path)
    ckpt.save_student_parts(_port(v1), d, "p_")
    path = os.path.join(d, "p_att_top.statedict.npz")
    with np.load(path) as z:
        arrs = dict(z)
    arrs["params/att_top/kernel"] = arrs["params/att_top/kernel"][:1]
    np.savez(path, **arrs)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_student_parts(_port(v1), d, "p_")
    arrs["params/att_top/extra"] = arrs.pop("params/att_top/kernel")
    np.savez(path, **arrs)
    with pytest.raises(KeyError, match="unknown key"):
        ckpt.load_student_parts(_port(v1), d, "p_")


# --------------------------------------------------------------- configs

def _fields(cfg):
    return [(f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)]


def test_config_defaults_match_jax():
    got, want = configs.FrameworkConfig(), j_configs.FrameworkConfig()
    assert configs.to_dict(got) == j_configs.to_dict(want)
    for (name, a), (wname, b) in zip(_fields(got), _fields(want)):
        assert name == wname
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    assert got.data.train_hw == (450, 450)
    assert got.augment.scale_range == (0.7, 1.3)
    assert got.distill.att_sgdr.period == 700.0


def test_yaml_loads_in_either_package(tmp_path):
    pytest.importorskip("yaml")
    cfg = configs.FrameworkConfig(
        data=configs.DataConfig(train_hw=(64, 96), teacher_dir="t"),
        distill=DistillConfig(distillation_alpha=0.5))
    p_port, p_jax = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    configs.save_yaml(cfg, p_port)
    back = configs.load_yaml(p_port)
    assert back == cfg and back.model.stage4.num_channels == (48, 96, 192,
                                                              384)
    assert j_configs.to_dict(j_configs.load_yaml(p_port)) == \
        configs.to_dict(cfg)
    j_configs.save_yaml(j_configs.load_yaml(p_port), p_jax)
    assert configs.to_dict(configs.load_yaml(p_jax)) == configs.to_dict(cfg)


# ----------------------------------------------------------------- remat

def _one_step(remat, batch):
    state, step = _trainer(remat=remat)
    state, m = step(state, batch)
    return state.model.state_dict(), m


def test_remat_step_matches_plain_step(monkeypatch):
    batch = _batch(11)
    plain, m0 = _one_step(False, batch)
    remat, m1 = _one_step(True, batch)
    for k in ("attention_loss", "keypoints_loss"):
        assert float(m1[k]) == pytest.approx(float(m0[k]), rel=1e-6), k
    stats = [k for k in plain if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k, v in plain.items():
        tol = 1e-7 if k in stats else 1e-6
        assert float((remat[k].float() - v.float()).abs().max()) <= tol, k

    # the guard is what keeps the recompute from a second update
    class _NoGuard:
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(students, "frozen_running_stats", _NoGuard)
    doubled, _ = _one_step(True, batch)
    worst = max(float((doubled[k] - plain[k]).abs().max()) for k in stats)
    assert worst > 1e-3, worst


def test_remat_turns_fused_cam_off():
    m = students.AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT,
                                       fused_cam=True, remat=True)
    cams = [c for c in m.modules()
            if isinstance(c, students.ContextAwareModule)]
    assert len(cams) == 6 and all(c.remat and not c.fused for c in cams)
    assert layers.bn_dtype_now() == torch.float32
