"""The port's training stack against the JAX package, on the CPU.

* The losses and SGDR on the cases of ``tests/test_train.py`` (which
  holds the JAX side to the reference torch code), and the
  ``label_params`` partition.
* The slice as a whole: two steps of the port's distillation step
  (cuDNN-path CAMs, and fused CAMs on their plain versions) against two
  steps of JAX's ``make_distill_train_step`` (float32 model; fused CAMs in
  interpret mode) from the same weights and batch: both losses, the
  updated parameters and the running statistics.  Unfused within 1e-4 of
  each update's scale (float32 sum order); fused within a quarter of it
  and aligned overall (bf16 roundings that land on the other side of a
  tie compound over two steps).
* The frozen parameters do not move; ``grad_accum=2`` on a duplicated
  batch is one step on its half.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
from rtpe_tpu.train import losses as jl
from rtpe_tpu.train import schedules as js
from rtpe_tpu.train import step as jstep
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models.students import AttentionStudentSteps
from rtpe_tpu_torch.train import (DistillConfig, DistillTrainState,
                                  SgdrConfig, bce_with_logits,
                                  distillation_bce_loss_keypoint_mining,
                                  distillation_loss_keypoint_mining,
                                  label_params, make_distill_train_step,
                                  masked_bce_with_logits, masked_mse,
                                  sgdr_schedule)


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def test_masked_mse_matches_jax():
    pred, gt = _rand((2, 4, 8, 8), 0), _rand((2, 4, 8, 8), 1)
    mask = (_rand((2, 4, 8, 8), 2) > 0.5).astype(np.float32)
    j, t = _pair(pred, gt, mask)
    assert float(masked_mse(*t)) == pytest.approx(float(jl.masked_mse(*j)),
                                                  rel=1e-6)


def test_masked_bce_matches_jax():
    pred = (_rand((2, 1, 8, 8), 3) - 0.5) * 8
    gt = (_rand((2, 1, 8, 8), 4) > 0.5).astype(np.float32)
    mask = (_rand((2, 1, 8, 8), 5) > 0.3).astype(np.float32)
    j, t = _pair(pred, gt, mask)
    want = float(jl.masked_bce_with_logits(*j, pos_weight=7.0))
    assert float(masked_bce_with_logits(*t, pos_weight=7.0)) == \
        pytest.approx(want, rel=1e-6)
    assert float(bce_with_logits(t[0], t[1], 7.0)) == pytest.approx(
        float(jl.bce_with_logits(j[0], j[1], 7.0)), rel=1e-6)


def test_distillation_losses_match_jax():
    student = (_rand((2, 17, 10, 10), 6) - 0.5) * 6
    teacher = _rand((2, 17, 10, 10), 7) * 1.4 - 0.2  # outside [0, 1]
    gt = _rand((2, 17, 10, 10), 8)
    gt[gt < 0.4] = 0.0
    mask = np.ones((2, 17, 10, 10), np.float32)
    j, t = _pair(student, teacher, gt, mask)
    kw = dict(alpha=0.8, background_factor=0.5)
    want = float(jl.distillation_bce_loss_keypoint_mining(
        *j[:3], mask=j[3], teacher_pos_weight=100.0, gt_pos_weight=100.0,
        **kw))
    got = float(distillation_bce_loss_keypoint_mining(
        *t[:3], mask=t[3], teacher_pos_weight=100.0, gt_pos_weight=100.0,
        **kw))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(distillation_loss_keypoint_mining(
        *t[:3], mask=t[3], **kw)) == pytest.approx(float(
            jl.distillation_loss_keypoint_mining(*j[:3], mask=j[3], **kw)),
        rel=1e-6)


@pytest.mark.parametrize("cfg,steps", [
    (SgdrConfig(0.025, 0.003, 100.0, 1.0, 1.0, 1.0), range(350)),
    (SgdrConfig(0.025, 0.003, 700.0, 1.02, 1.0, 1.01), range(0, 3000, 7)),
])
def test_sgdr_schedule_matches_jax(cfg, steps):
    jcfg = js.SgdrConfig(*dataclass_values(cfg))
    want, got = js.sgdr_schedule(jcfg), sgdr_schedule(cfg)
    for t in steps:
        a, b = float(got(t)), float(want(t))
        assert a == pytest.approx(b, rel=1e-6, abs=1e-9), t
        assert np.float32(got(t)) == got(t)


def dataclass_values(cfg):
    return [getattr(cfg, f) for f in ("max_lr", "min_lr", "period",
                                      "scale_max_lr", "scale_min_lr",
                                      "scale_period")]


# ------------------------------------------------------------ the step

B, HW, INPLANES, ALT = 2, 32, 8, 6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt = rng.random((B, HW, HW, 17)) ** 6
    gt[gt < 0.05] = 0.0
    return {"img": rng.normal(size=(B, HW, HW, 3)).astype(f32),
            "img_alt": rng.random((B, HW, HW, 3)).astype(f32),
            "segm_mask": (rng.random((B, HW, HW, 1)) > 0.6).astype(f32),
            "gt_hms": gt.astype(f32),
            "teacher_hms": (rng.random((B, HW, HW, 17)) * 1.2 - 0.1
                            ).astype(f32),
            "mask": (rng.random((B, HW, HW, 1)) > 0.1).astype(f32)}


@pytest.fixture(scope="module", params=["unfused", "fused"])
def jax_steps(request):
    """Two JAX steps from fresh variables: the variables before, the
    metrics of each step and the state after."""
    fused = request.param == "fused"
    model = JaxStudent(inplanes=INPLANES, alt_planes=ALT,
                       detach_att_for_det=True, dtype=jnp.float32,
                       fused_cam=fused)
    batch = _batch()
    x = jnp.zeros((1, HW, HW, 3))
    variables = model.init(jax.random.PRNGKey(0), x, x, train=False)
    cfg = jstep.DistillConfig()
    state = jstep.DistillTrainState.create(variables, cfg)
    step = jstep.make_distill_train_step(model, cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(2):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    after = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    return (fused, jax.tree_util.tree_map(np.asarray, variables), batch,
            metrics, after)


def _port_student(variables, fused):
    m = AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT,
                              detach_att_for_det=True, fused_cam=fused)
    m.load_state_dict(student_state_dict_from_jax(variables), strict=True)
    return m.train()


def _run_port(variables, batch, fused, steps=2, grad_accum=1):
    model = _port_student(variables, fused)
    cfg = DistillConfig()
    state = DistillTrainState.create(model, cfg)
    step = make_distill_train_step(model, cfg, grad_accum=grad_accum)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_train_steps_match_jax(jax_steps):
    fused, variables, batch, want_metrics, after = jax_steps
    state, metrics = _run_port(variables, batch, fused)
    assert state.step == 2
    loss_tol = 1e-3 if fused else 1e-5
    for got, want in zip(metrics, want_metrics):
        for k in ("attention_loss", "keypoints_loss"):
            assert got[k] == pytest.approx(want[k], rel=loss_tol), k
        for k in ("att_lr", "det_lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-7), k
    want_sd = student_state_dict_from_jax(after)
    before_sd = student_state_dict_from_jax(variables)
    # each update (and running-statistic change) against JAX's, held to
    # its own largest magnitude; the fused path's bf16 roundings compound
    # over the two steps (one step: within 2 %), so it also takes the
    # direction of the whole update
    tol = 0.25 if fused else 1e-4
    got_all, want_all = [], []
    for k, v in state.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        moved, want_moved = v - before_sd[k], want_sd[k] - before_sd[k]
        scale = max(float(want_moved.abs().max()),
                    1e-3 * float(before_sd[k].abs().max()), 1e-12)
        err = float((moved - want_moved).abs().max())
        assert err <= tol * scale + 1e-7, (k, err, scale)
        got_all.append(moved.flatten().double() / scale)
        want_all.append(want_moved.flatten().double() / scale)
    a, b = torch.cat(got_all), torch.cat(want_all)
    assert float(a @ b / (a.norm() * b.norm())) > 0.999


@pytest.mark.parametrize("jax_steps", ["unfused"], indirect=True)
def test_frozen_params_do_not_move(jax_steps):
    _, variables, batch, _, _ = jax_steps
    state, _ = _run_port(variables, batch, fused=False, steps=1)
    before = student_state_dict_from_jax(variables)
    labels = label_params(state.model.named_parameters())
    owned = {id(p) for g in state.optimizer.param_groups
             for p in g["params"]}
    for name, p in state.model.named_parameters():
        if labels[name] == "frozen":
            assert torch.equal(p.detach(), before[name]), name
            assert id(p) not in owned and p not in state.optimizer.state
        else:
            assert id(p) in owned, name


@pytest.mark.parametrize("jax_steps", ["unfused"], indirect=True)
def test_label_params_partition_matches_jax(jax_steps):
    _, variables, _, _, _ = jax_steps
    want = {}
    for path, lab in flatten_dict(jstep.label_params(
            variables["params"])).items():
        want.setdefault(path[0], set()).add(lab)
    model = _port_student(variables, False)
    got = {}
    for name, lab in label_params(model.named_parameters()).items():
        got.setdefault(name.split(".")[0], set()).add(lab)
    assert got == want
    assert {v for s in got.values() for v in s} == {"att", "det", "frozen"}


@pytest.mark.parametrize("jax_steps", ["unfused"], indirect=True)
def test_grad_accum_on_a_duplicated_batch_is_one_step_on_its_half(
        jax_steps):
    _, variables, batch, _, _ = jax_steps
    half = {k: v[:1] for k, v in batch.items()}
    dup = {k: np.concatenate([v, v]) for k, v in half.items()}
    one, m1 = _run_port(variables, half, False, steps=1)
    acc, m2 = _run_port(variables, dup, False, steps=1, grad_accum=2)
    for k in ("attention_loss", "keypoints_loss"):
        assert m2[0][k] == pytest.approx(m1[0][k], rel=1e-6)
    for (k, a), (_, b) in zip(one.model.named_parameters(),
                              acc.model.named_parameters()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7, msg=k)
