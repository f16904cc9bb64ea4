"""The port's legacy-student train step and loss scaling against the JAX
package, on the CPU.

* three steps of ``make_student_train_step`` on ``CamStudent`` (JAX's own
  test size, ``tests/test_extras.py:251-325``: inplanes 8, two stages, 5
  heatmaps + 1 AE channel, a batch of 2 at 64 x 64, ``out_hw`` 64 x 64)
  and one on ``MultistageStudent``, float32: the loss and the parameters
  within 1e-5, the learning rate and the step count exactly, the running
  statistics within 1e-5, the momentum as a whole within 1e-3 in
  relative L2 (1e-2 for the multistage step, where one ReLU unit sits
  within the packages' rounding of zero; its docstring), and
  ``mid_stem``'s momentum (its decay alone) within 1e-5 of its largest
  value;
  the frozen ``mid_stem`` decays and builds momentum as under optax, the
  stem keeps its values;
* the dynamic loss scale: a clean step equals the unscaled one, a batch
  with an ``inf`` keeps the parameters and the momentum bitwise, halves
  the scale and still advances the schedule and the running statistics,
  in both packages;
* the scaler's halving, and its doubling after 1000 clean steps, as
  JAX's (``tests/test_extras.py:181-208``), and its state through a
  checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtpe_tpu.models import CamStudent as JaxCam
from rtpe_tpu.models import MultistageStudent as JaxMultistage
from rtpe_tpu.train import legacy_steps as jls
from rtpe_tpu.train import loss_scaling as jscale
from rtpe_tpu_torch.io.checkpoint import TrainCheckpointer
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models import CamStudent, MultistageStudent
from rtpe_tpu_torch.train import legacy_steps as ls
from rtpe_tpu_torch.train import loss_scaling as scale_mod
from test_torch_legacy_students import seeded_variables

TOL = 1e-5
# the momentum (the gradient sums) as a whole, relative L2: a ReLU unit
# whose input sits within the packages' rounding of zero flips its
# gradient (the multistage step's docstring)
MOMENTUM_L2 = 1e-3


def _batch(seed=0, b=2, hw=64, c=6):
    rng = np.random.RandomState(seed)
    return {
        "img": rng.rand(b, hw, hw, 3).astype(np.float32),
        "gt_hms": (rng.rand(b, hw, hw, c) > 0.9).astype(np.float32),
        "teacher_hms": rng.rand(b, hw, hw, c).astype(np.float32),
        "mask": np.ones((b, hw, hw, 1), np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_momentum(state):
    """The optax trace of the non-stem parameters, as the port's keys."""
    trace = dict(state.opt_state.inner_states["train"].inner_state[1].trace)
    trace.pop("stem")
    return student_state_dict_from_jax({"params": _np_tree(trace)})


def _port_momentum(state):
    opt = state.optimizer
    return {name: opt.state[p]["momentum_buffer"]
            for name, p in state.model.named_parameters()
            if p in opt.state}


def _assert_close(got, want, what):
    want = want.to(got.dtype)
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def _assert_state_matches(pstate, jstate, what, momentum_l2=MOMENTUM_L2):
    assert pstate.step == int(jstate.step)
    want = student_state_dict_from_jax(_np_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for k, v in pstate.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], rtol=TOL, atol=TOL,
                                       msg=f"{what}: {k}")
    mj, mp = _jax_momentum(jstate), _port_momentum(pstate)
    assert sorted(mp) == sorted(mj)
    err = sum(float(((mp[k] - mj[k]) ** 2).sum()) for k in mj)
    norm = sum(float((mj[k] ** 2).sum()) for k in mj)
    assert (err / norm) ** 0.5 <= momentum_l2, (what, (err / norm) ** 0.5)


def _pair(jm, pm, bg, out_hw, dynamic=False, init_scale=2.0 ** 10):
    """JAX's and the port's states and steps from the same variables."""
    jcfg = jls.StudentDistillConfig(background_factor=bg)
    pcfg = ls.StudentDistillConfig(background_factor=bg)
    variables = seeded_variables(jm, (1, 64, 64, 3), 0)
    pm.load_state_dict(student_state_dict_from_jax(_np_tree(variables)),
                       strict=True)
    jstate = jls.StudentTrainState.create(
        variables, jcfg, dynamic_loss_scale=dynamic, init_scale=init_scale)
    pstate = ls.StudentTrainState.create(
        pm, pcfg, dynamic_loss_scale=dynamic, init_scale=init_scale)
    jstep = jls.make_student_train_step(jm, jcfg, out_hw=out_hw,
                                        dynamic_loss_scale=dynamic)
    pstep = ls.make_student_train_step(pm, pcfg, out_hw=out_hw,
                                       dynamic_loss_scale=dynamic)
    return jstate, pstate, jstep, pstep


def _cam_pair(**kw):
    return _pair(JaxCam(inplanes=8, num_stages=2, num_heatmaps=5, ae_dims=1,
                        dtype=jnp.float32),
                 CamStudent(inplanes=8, num_stages=2, num_heatmaps=5,
                            ae_dims=1), 0.01, (64, 64), **kw)


def test_cam_student_three_steps_match_jax():
    js, ps, jstep, pstep = _cam_pair()
    stem0 = {k: v.clone() for k, v in ps.model.stem.state_dict().items()
             if "running" not in k}
    mid0 = ps.model.mid_stem_conv.weight.detach().clone()
    for i in range(3):
        batch = _batch(seed=i)
        js, jm = jstep(js, batch)
        ps, pm = pstep(ps, _torch_batch(batch))
        assert pm["lr"] == float(jm["lr"])
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=TOL)
        _assert_state_matches(ps, js, f"step {i + 1}")
    # mid_stem gets no gradient, yet decays with momentum as under optax
    mid = ps.model.mid_stem_conv.weight.detach()
    assert not torch.equal(mid, mid0)
    mj, mp = _jax_momentum(js), _port_momentum(ps)
    for k in ("mid_stem_conv.weight", "mid_stem_bn.weight",
              "mid_stem_bn.bias"):
        assert float(mp[k].abs().max()) > 0 or k.endswith("bias"), k
        _assert_close(mp[k], mj[k], f"momentum {k}")
    for k, v in ps.model.stem.state_dict().items():
        if k in stem0:
            assert torch.equal(v, stem0[k]), k


def test_multistage_student_step_matches_jax():
    """One step; the momentum within 1e-2 in relative L2.  The frozen
    stem's output differs from JAX's by ~1e-5 of its largest value
    (float32 statistics), and on this input one ReLU input of stage 1's
    channel 40 lies within 1.5e-5 of zero, so the unit is on for one
    package and off for the other: that channel's bias gradient is
    7.60e-4 in JAX and 7.20e-4 here.  The stages' math recomputed in
    float64 (plain ops, jnp and torch agreeing to 1e-14) gives either
    value from either package's stem output, and central differences
    agree with it."""
    js, ps, jstep, pstep = _pair(
        JaxMultistage((2, 2), num_heatmaps=5, ae_dims=1, dtype=jnp.float32),
        MultistageStudent((2, 2), num_heatmaps=5, ae_dims=1), 0.0, (32, 32))
    batch = _batch(seed=4)
    js, jmet = jstep(js, batch)
    ps, pmet = pstep(ps, _torch_batch(batch))
    assert pmet["lr"] == float(jmet["lr"])
    assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=TOL)
    _assert_state_matches(ps, js, "multistage", momentum_l2=1e-2)


def test_dynamic_loss_scale_skips_an_overflow_as_jax():
    js, ps, jstep, pstep = _cam_pair(dynamic=True, init_scale=2.0 ** 10)
    batch = _batch(seed=0)
    js, jm = jstep(js, batch)
    ps, pm = pstep(ps, _torch_batch(batch))
    assert float(pm["overflow"]) == float(jm["overflow"]) == 0.0
    assert float(pm["loss_scale"]) == float(jm["loss_scale"]) == 2.0 ** 10
    _assert_state_matches(ps, js, "clean scaled step")

    bad = dict(batch)
    bad["img"] = batch["img"].copy()
    bad["img"][0, 0, 0, 0] = np.inf
    params = {k: v.clone() for k, v in ps.model.named_parameters()}
    stats = {k: v.clone() for k, v in ps.model.state_dict().items()
             if "running" in k}
    momentum = {k: v.clone() for k, v in _port_momentum(ps).items()}
    js, jm = jstep(js, bad)
    ps, pm = pstep(ps, _torch_batch(bad))
    assert float(pm["overflow"]) == float(jm["overflow"]) == 1.0
    assert float(ps.scaler.scale) == float(js.scaler.scale) == 2.0 ** 9
    assert float(pm["loss_scale"]) == 2.0 ** 9
    assert ps.step == int(js.step) == 2
    for k, p in ps.model.named_parameters():
        assert torch.equal(p, params[k]), k
    for k, m in _port_momentum(ps).items():
        assert torch.equal(m, momentum[k]), k
    moved = [k for k, v in ps.model.state_dict().items()
             if "running" in k and not torch.equal(v, stats[k])]
    assert moved, "the running statistics keep the forward's update"
    # the parameters and the momentum stayed; the statistics moved, NaN
    # where the inf reached them, in both packages alike
    want = student_state_dict_from_jax(_np_tree(
        {"params": js.params, "batch_stats": js.batch_stats}))
    for k, v in ps.model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v, want[k], rtol=TOL, atol=TOL,
                                       equal_nan=True, msg=k)


def test_scaler_halves_and_doubles_as_jax():
    state = scale_mod.init_dynamic_scaler(init_scale=16.0, device="cpu")
    jstate = jscale.init_dynamic_scaler(init_scale=16.0)
    good = {"w": torch.ones(3) * 32.0}
    bad = {"w": torch.tensor([1.0, float("inf"), 0.0])}
    for grads in (good, bad):
        g, state, overflow = scale_mod.scaled_grads_or_skip(grads, state)
        jg, jstate, jover = jscale.scaled_grads_or_skip(
            {"w": jnp.asarray(grads["w"].numpy())}, jstate)
        assert bool(overflow) == bool(jover)
        np.testing.assert_array_equal(g["w"].numpy(), np.asarray(jg["w"]))
        assert float(state.scale) == float(jstate.scale)
    assert float(state.scale) == 8.0
    for _ in range(999):
        state = scale_mod.update_scaler(state, torch.tensor(False))
    assert float(state.scale) == 8.0 and int(state.good_steps) == 999
    state = scale_mod.update_scaler(state, torch.tensor(False))
    assert float(state.scale) == 16.0 and int(state.good_steps) == 0
    floor = scale_mod.init_dynamic_scaler(init_scale=1.0, device="cpu")
    assert float(scale_mod.update_scaler(floor, torch.tensor(True)).scale) \
        == 1.0
    assert not bool(scale_mod.has_overflow([torch.ones(2), None]))
    static = scale_mod.StaticScaler(4.0)
    assert float(static.scale_loss(torch.tensor(2.0))) == 8.0
    assert float(static.unscale_grads([torch.tensor(8.0)])[0]) == 2.0


def test_checkpoint_keeps_the_scaler(tmp_path):
    """``TrainCheckpointer`` saves and restores a dynamic scaler's state
    with the model, the momentum and the step."""
    model = CamStudent(inplanes=8, num_stages=2, num_heatmaps=5, ae_dims=1)
    cfg = ls.StudentDistillConfig()
    state = ls.StudentTrainState.create(model, cfg, dynamic_loss_scale=True,
                                        init_scale=2.0 ** 7)
    step = ls.make_student_train_step(model, cfg, (64, 64),
                                      dynamic_loss_scale=True)
    for _ in range(2):
        state, _ = step(state, _torch_batch(_batch(seed=5)))
    state.scaler = scale_mod.update_scaler(state.scaler, torch.tensor(True))
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(state.step, state)
    fresh = ls.StudentTrainState.create(
        CamStudent(inplanes=8, num_stages=2, num_heatmaps=5, ae_dims=1), cfg,
        dynamic_loss_scale=True)
    fresh, n = ck.restore(fresh)
    assert n == 2 and fresh.step == 2
    assert float(fresh.scaler.scale) == 2.0 ** 6
    assert int(fresh.scaler.good_steps) == 0
    for a, b in zip(state.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    for pa, pb in zip(state.optimizer.param_groups[0]["params"],
                      fresh.optimizer.param_groups[0]["params"]):
        assert torch.equal(state.optimizer.state[pa]["momentum_buffer"],
                           fresh.optimizer.state[pb]["momentum_buffer"])
