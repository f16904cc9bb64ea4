"""Data-parallel training of the port over ``torch.distributed``: two gloo
ranks on the CPU against one process on the same global batch.

One spawn of two rank processes (this file run as a script; they import
torch and the port only, and talk over loopback) computes everything
and writes one results file per rank; the tests below read them.  Rank
0 also computes the one-process references, with no group.  Each rank
holds its half of every global batch.

* Global batch statistics, forward and backward: the port's train-mode
  ``BatchNorm2d`` (outputs, running statistics, input and parameter
  gradients), the fused CAM module on the plain versions of its ops
  (the same) and ``_minmax_normalize`` (exact) equal the one-process
  results on the whole batch; each rank's results without the group
  do not, so a missing reduction shows.
* Two data-parallel steps of a tiny ``AttentionStudentSteps`` (fused and
  cuDNN CAMs) and of a tiny legacy ``CamStudent`` against two
  one-process steps; ZeRO-1 ``torch.equal`` to the replicated run (also
  with every leaf sharded); a checkpoint saved under ZeRO-1 resumes
  replicated, and back, bitwise; each rank's momentum bytes equal the
  shard bytes of JAX's ``zero1_state_sharding`` on a 2-device mesh.
* ``TrainPipeline(shard=...)`` builds the rows the one-process pipeline
  builds, bitwise, with one loader thread and with three.
* ``cli.distillation.main`` under the two ranks (torchrun's variables):
  ``--mesh_data 3`` exits with status 2 on both, ``--zero1 --mesh_data
  2`` trains 2 steps with only rank 0 writing, ``--mesh_data 1`` trains
  on rank 0 while rank 1 stays idle.
"""

import contextlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GB = 4                      # the global batch of every data-parallel case
HW, INPLANES, ALT = 32, 8, 6
CHANS, DILS = 16, (1, 2)
# ZeRO-1's min_elems: JAX's default (which leaves every momentum leaf of
# the tiny student whole), and 1 (every leaf with an even dimension split)
ZERO_MIN_ELEMS = (2 ** 12, 1)
# one-process against two ranks, each update held to its largest
# magnitude: float32 sums in another order (the all-reduce adds the two
# ranks' partial sums); on the fused CAM path each rank's weight gradients
# are also rounded to bf16 before the all-reduce (the ops take bf16 copies
# of the float32 weights), one rounding of each half's sum instead of one
# of the whole, which two steps compound (the path's own JAX test holds
# updates to 0.25 of their scale): there every leaf within 1/2.  The
# whole update, each leaf over its scale, must be aligned (STEP_COS; the
# fused path's smallest updates, 1e-4 of a BN bias, are mostly that
# rounding).  The sound runs' worst leaf reads 1.6e-5 / 0.27 / 1.3e-7
# (unfused / fused / legacy); the control, each rank's batch statistics
# its own, 3.8 / 8.4 / 2.2, which the test requires the checks to refuse
STEP_RTOL = {"unfused": 1e-3, "fused": 0.5, "legacy": 1e-3}
STEP_COS = {"unfused": 0.99999, "fused": 0.99, "legacy": 0.99999}


# ------------------------------------------------------------------ ranks

def _rows(t, r):
    k = t.shape[0] // WORLD
    return t[r * k:(r + 1) * k]


def _bn_case(group, r, whole=False):
    from rtpe_tpu_torch.models.layers import BatchNorm2d
    from rtpe_tpu_torch.parallel.dist import global_batch_stats

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (GB, 5, 6, 7)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(GB, 5, 6, 7)).astype(np.float32))
    bn = BatchNorm2d(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.normal(1, .2, 5).astype(
            np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, .2, 5).astype(
            np.float32)))
    if not whole:
        x, w = _rows(x, r), _rows(w, r)
    x.requires_grad_(True)
    with global_batch_stats(group):
        y = bn(x)
    (y * w).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "mean": bn.running_mean,
            "var": bn.running_var, "dw": bn.weight.grad,
            "db": bn.bias.grad}


def _cam_case(group, r, whole=False):
    from rtpe_tpu_torch.models.students import ContextAwareModule
    from rtpe_tpu_torch.parallel.dist import global_batch_stats

    torch.manual_seed(3)
    m = ContextAwareModule(CHANS, DILS, dtype=torch.bfloat16,
                           fused=True).train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(GB, CHANS, 12, 10)).astype(
        np.float32)).to(torch.bfloat16)
    tgt = torch.from_numpy(rng.normal(size=(GB, CHANS, 12, 10)).astype(
        np.float32))
    if not whole:
        x, tgt = _rows(x, r), _rows(tgt, r)
    x.requires_grad_(True)
    with global_batch_stats(group):
        out = m(x)
    # each rank's share of the global batch's mean
    (torch.square(out.float() - tgt).sum() / tgt[0].numel() / GB).backward()
    res = {"out": out.detach().float(), "dx": x.grad.float()}
    res.update({f"grad:{k}": p.grad for k, p in m.named_parameters()})
    res.update({f"sd:{k}": v for k, v in m.state_dict().items()
                if "running" in k})
    return res


def _minmax_case(group, r, whole=False):
    from rtpe_tpu_torch.parallel.dist import global_batch_stats
    from rtpe_tpu_torch.train.losses import _minmax_normalize

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0.3, 2.0, (GB, 6, 6, 3)).astype(
        np.float32))
    # the extremes in different halves of the batch
    x[0, 1, 2, 0], x[GB - 1, 3, 3, 1] = -7.0, 9.0
    if not whole:
        x = _rows(x, r)
    with global_batch_stats(group):
        return {"y": _minmax_normalize(x)}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt = rng.random((GB, HW, HW, 17)) ** 6
    gt[gt < 0.05] = 0.0
    return {"img": rng.normal(size=(GB, HW, HW, 3)).astype(f32),
            "img_alt": rng.random((GB, HW, HW, 3)).astype(f32),
            "segm_mask": (rng.random((GB, HW, HW, 1)) > 0.6).astype(f32),
            "gt_hms": gt.astype(f32),
            "teacher_hms": (rng.random((GB, HW, HW, 17)) * 1.2 - 0.1
                            ).astype(f32),
            "mask": (rng.random((GB, HW, HW, 1)) > 0.1).astype(f32)}


def _student_state(kind):
    """The tiny student's train state and step maker, seeded alike on
    every rank."""
    from rtpe_tpu_torch.models.students import (AttentionStudentSteps,
                                                CamStudent)
    from rtpe_tpu_torch.train import (DistillConfig, DistillTrainState,
                                      StudentDistillConfig,
                                      StudentTrainState,
                                      make_distill_train_step,
                                      make_student_train_step)

    torch.manual_seed(0)
    if kind == "legacy":
        model = CamStudent(inplanes=8, num_stages=2, num_heatmaps=5,
                           ae_dims=1).train()
        cfg = StudentDistillConfig(background_factor=0.01)
        return (StudentTrainState.create(model, cfg),
                lambda g: make_student_train_step(model, cfg, out_hw=(HW, HW),
                                                  group=g))
    model = AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT,
                                  detach_att_for_det=True,
                                  fused_cam=kind == "fused").train()
    cfg = DistillConfig()
    return (DistillTrainState.create(model, cfg),
            lambda g: make_distill_train_step(model, cfg, group=g))


def _run_steps(kind, group, r, steps=2, zero=None, state=None, start=0):
    """``steps`` steps on this rank's rows (all rows without a group);
    ``zero``: ZeRO-1's ``min_elems``."""
    from rtpe_tpu_torch.parallel.zero import Zero1SGD

    fresh, make = _student_state(kind)
    state = state or fresh
    if zero is not None and not isinstance(state.optimizer, Zero1SGD):
        state.optimizer = Zero1SGD(state.optimizer, group, min_elems=zero)
    step = make(group)
    metrics = []
    for s in range(start, start + steps):
        b = {k: torch.from_numpy(v) for k, v in _batch(s).items()}
        if kind == "legacy":
            b = {k: b[k] for k in ("img", "gt_hms", "teacher_hms", "mask")}
        if group is not None:
            b = {k: _rows(v, r) for k, v in b.items()}
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@contextlib.contextmanager
def _per_rank_stats():
    """The control of the data-parallel steps: each rank's batch
    statistics its own, the gradients still averaged over the group."""
    from rtpe_tpu_torch.parallel.dist import global_batch_stats
    from rtpe_tpu_torch.train import legacy_steps, step

    saved = step.global_batch_stats, legacy_steps.global_batch_stats
    step.global_batch_stats = legacy_steps.global_batch_stats = \
        lambda group: global_batch_stats(None)
    try:
        yield
    finally:
        step.global_batch_stats, legacy_steps.global_batch_stats = saved


def _sd(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _ckpt_cases(group, r, tmp):
    """ZeRO-1 -> checkpoint -> replicated, and back, each against the
    uninterrupted run (every leaf sharded: min_elems 1)."""
    import torch.distributed as dist

    from rtpe_tpu_torch.io.checkpoint import TrainCheckpointer

    out = {}
    for name, first, second in (("zero_to_rep", 1, None),
                                ("rep_to_zero", None, 1)):
        d = os.path.join(tmp, name)
        ck = TrainCheckpointer(d)
        s1, _ = _run_steps("unfused", group, r, steps=1, zero=first)
        if first is not None:
            s1.optimizer.gather()
        if r == 0:
            ck.save(1, s1)
        dist.barrier(group)
        s2, _ = _student_state("unfused")
        if second is not None:
            from rtpe_tpu_torch.parallel.zero import Zero1SGD
            s2.optimizer = Zero1SGD(s2.optimizer, group, min_elems=second)
        s2, step = ck.restore(s2)
        s2, _ = _run_steps("unfused", group, r, steps=1, state=s2, start=1)
        out[name] = (step, _sd(s2))
        dist.barrier(group)
    return out


def _pipeline_cases(r, root):
    from rtpe_tpu_torch.data.dataset import CocoDistillationDataset
    from rtpe_tpu_torch.data.pipeline import TrainPipeline
    from rtpe_tpu_torch.parallel.dist import process_local_batch_slice

    ds = CocoDistillationDataset(root, "val2017", os.path.join(root,
                                                               "teacher"),
                                 remove_images_without_annotations=True,
                                 gt_stddevs_pix=[7.0],
                                 host_gt_heatmaps=False)
    out = {}
    for workers in (1, 3):
        for shard in (process_local_batch_slice(GB), None):
            if shard is None and r != 0:
                continue
            p = TrainPipeline(ds, batch_size=GB, out_hw=(48, 48),
                              canvas_hw=(96, 128), num_workers=workers,
                              device="cpu", shard=shard)
            out[(workers, shard is None)] = [
                {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else v.clone()) for k, v in b.items()} for b in p]
    return out


def _cli_cases(r, root, tmp):
    import io

    from rtpe_tpu_torch.cli import distillation

    def argv(out, *extra):
        return ["--coco_dir", root, "--teacher_dir",
                os.path.join(root, "teacher"), "--model_path",
                os.path.join(root, "w48.pth.tar"), "--device", "cpu",
                "--inplanes", "8", "--batch_size", "2", "--train_hw", "64",
                "64", "--canvas_hw", "96", "128", "--num_epochs", "1",
                "--snapshot_dir", os.path.join(out, "snaps"), "--log_dir",
                os.path.join(out, "log"), "--tb_dir", os.path.join(out, "tb"),
                "--diagnose_every", "1", "--num_workers", "1", *extra]

    res = {}
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            distillation.main(argv(os.path.join(tmp, "m3"), "--mesh_data",
                                   "3", "--max_steps", "2"))
        res["mesh3"] = None
    except SystemExit as e:
        res["mesh3"] = (e.code, err.getvalue())
    for name, extra in (("zero", ["--zero1", "--mesh_data", "2"]),
                        ("idle", ["--mesh_data", "1"])):
        t = distillation.main(argv(os.path.join(tmp, name), "--max_steps",
                                   "2", *extra))
        res[name] = None if t is None else (t.step, _sd(t.state))
    return res


def _rank_main(r, tmp, root):
    import torch.distributed as dist

    from rtpe_tpu_torch.parallel import dist as pdist
    from rtpe_tpu_torch.parallel.zero import momentum_bytes

    torch.set_num_threads(1)
    assert pdist.initialize(backend="gloo")
    group = dist.group.WORLD
    res = {"rank": r, "world": pdist.world_size()}
    t0 = time.time()
    for name, case in (("bn", _bn_case), ("cam", _cam_case),
                       ("minmax", _minmax_case)):
        res[name] = case(group, r)
        res[name + ":local"] = case(None, r)
        if r == 0:
            res[name + ":whole"] = case(None, r, whole=True)
    for kind in ("unfused", "fused", "legacy"):
        st, m = _run_steps(kind, group, r)
        res[kind] = (_sd(st), m)
        if r == 0:
            res[kind + ":init"] = _sd(_student_state(kind)[0])
            st, m = _run_steps(kind, None, r)
            res[kind + ":whole"] = (_sd(st), m)
        with _per_rank_stats():
            st, m = _run_steps(kind, group, r)
        res[kind + ":local"] = (_sd(st), m)
    for kind in ("unfused", "fused"):
        for me in ZERO_MIN_ELEMS:
            st, m = _run_steps(kind, group, r, zero=me)
            res[f"{kind}:zero{me}"] = (_sd(st), m,
                                       momentum_bytes(st.optimizer))
    rep, _ = _run_steps("unfused", group, r)
    res["rep_bytes"] = momentum_bytes(rep.optimizer)
    res["ckpt"] = _ckpt_cases(group, r, tmp)
    res["pipeline"] = _pipeline_cases(r, root)
    res["cli"] = _cli_cases(r, root, tmp)
    res["seconds"] = time.time() - t0
    torch.save(res, os.path.join(tmp, f"rank{r}.pt"))
    dist.destroy_process_group()


# ------------------------------------------------------------------- tests

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _coco_root(root):
    from test_data_eval import _make_coco_fixture

    from rtpe_tpu_torch.data.teacher_cache import save_teacher_prediction
    from rtpe_tpu_torch.models.stem import StemHRNet

    _make_coco_fixture(root, n_imgs=8, hw=(96, 128), jitter_per_image=True)
    teacher = os.path.join(root, "teacher")
    os.makedirs(teacher)
    rng = np.random.default_rng(0)
    for i in range(8):
        save_teacher_prediction(
            teacher, f"{1000 + i:012d}.jpg",
            rng.normal(size=(34, 24, 32)).astype(np.float32) * 0.01,
            rng.random((17, 48, 64)).astype(np.float32) ** 8)
    torch.manual_seed(5)
    stem = StemHRNet()
    for p in stem.parameters():
        torch.nn.init.normal_(p, std=0.05)
    torch.save({"1." + k: v.half() for k, v in stem.state_dict().items()},
               os.path.join(root, "w48.pth.tar"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; their results files, read back."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    root = os.path.join(tmp, "coco")
    _coco_root(root)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), tmp, root],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-6000:]
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return tmp, res, outs


def _cat(res, name, key):
    return torch.cat([res[r][name][key] for r in range(WORLD)])


@pytest.mark.parametrize("case", ["bn", "cam"])
def test_batch_statistics_are_the_global_batch(ranks, case):
    """Outputs and input gradients (rows), running statistics and the
    parameter gradients summed over the ranks, against the whole batch
    in one process: float32 within 1e-5 relative (BN); the fused CAM's
    bf16 outputs, input gradients and statistics within 2^-7 of their
    largest magnitude, its weight gradients within 2^-4 and aligned
    (cosine > 0.999: each rank rounds its half's sum to bf16, see
    STEP_RTOL).  Without the group each rank's statistics are its
    half's, which the same checks refuse."""
    _, res, _ = ranks
    whole = res[0][case + ":whole"]
    if case == "bn":
        def close(a, b, grad=False):
            return torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        def close(a, b, grad=False):
            a, b = a.double().flatten(), b.double().flatten()
            scale = max(float(b.abs().max()), 1e-6)
            if not grad:
                return float((a - b).abs().max()) <= 2.0 ** -7 * scale
            cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
            return float((a - b).abs().max()) <= 2.0 ** -4 * scale \
                and cos > 0.999
    for k in ("y", "dx") if case == "bn" else ("out", "dx"):
        assert close(_cat(res, case, k), whole[k]), k
        assert not close(_cat(res, case + ":local", k), whole[k]), k
    stats = [k for k in whole if k in ("mean", "var") or k.startswith("sd:")]
    grads = [k for k in whole if k in ("dw", "db") or k.startswith("grad:")]
    assert stats and grads
    for k in stats:
        for r in range(WORLD):
            assert close(res[r][case][k], whole[k]), (k, r)
    assert not all(close(res[1][case + ":local"][k], whole[k])
                   for k in stats)
    for k in grads:
        # each rank holds its rows' part of the gradient: their sum is
        # the one-process gradient (the step then averages over ranks)
        assert close(res[0][case][k] + res[1][case][k], whole[k],
                     grad=True), k
    assert not all(close(res[0][case + ":local"][k]
                         + res[1][case + ":local"][k], whole[k], grad=True)
                   for k in grads)


def test_minmax_normalize_takes_the_global_extremes(ranks):
    """Exact: the min and max are all-reduced, not summed."""
    _, res, _ = ranks
    whole = res[0]["minmax:whole"]["y"]
    assert torch.equal(_cat(res, "minmax", "y"), whole)
    assert not torch.equal(_cat(res, "minmax:local", "y"), whole)


def _step_errors(run, whole, init, tol):
    """A run's ``(sd, metrics)`` against the one-process run's: whether
    every loss is within ``tol`` relative, the worst leaf's update error
    over its scale (the change's largest magnitude), and the cosine of
    the whole change, each leaf over its scale."""
    (sd, m), (sd_w, m_w) = run, whole
    losses_ok = all(got[k] == pytest.approx(want[k], rel=tol, abs=1e-7)
                    for got, want in zip(m, m_w) for k in want)
    worst, got_all, want_all = ("", 0.0), [], []
    for k, v in sd_w.items():
        if k.endswith("num_batches_tracked"):
            continue
        moved, want_moved = sd[k] - init[k], v - init[k]
        scale = max(float(want_moved.abs().max()),
                    1e-3 * float(init[k].abs().max()), 1e-12)
        err = (float((moved - want_moved).abs().max()) - 1e-7) / scale
        worst = max(worst, (k, err), key=lambda t: t[1])
        got_all.append(moved.flatten().double() / scale)
        want_all.append(want_moved.flatten().double() / scale)
    a, b = torch.cat(got_all), torch.cat(want_all)
    return losses_ok, worst, float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("kind", ["unfused", "fused", "legacy"])
def test_data_parallel_steps_match_one_process(ranks, kind):
    """Two steps on two ranks against two steps of one process on the
    same global batches: the losses within STEP_RTOL, and each
    parameter's and running statistic's change within STEP_RTOL of its
    largest magnitude (as ``test_torch_train`` holds updates); the
    ranks' states equal.  The control, the same steps with each rank's
    batch statistics its own (gradients still averaged), fails these
    checks: a missing reduction shows."""
    _, res, _ = ranks
    sd0, sd1 = res[0][kind][0], res[1][kind][0]
    whole, init = res[0][kind + ":whole"], res[0][kind + ":init"]
    tol = STEP_RTOL[kind]
    for k in whole[0]:
        assert torch.equal(sd0[k], sd1[k]), k
    losses_ok, worst, cos = _step_errors(res[0][kind], whole, init, tol)
    assert losses_ok
    assert worst[1] <= tol, worst
    assert cos > STEP_COS[kind]
    losses_ok, worst_c, cos_c = _step_errors(res[0][kind + ":local"], whole,
                                             init, tol)
    assert not (losses_ok and worst_c[1] <= tol and cos_c > STEP_COS[kind]), \
        (worst_c, cos_c)


@pytest.mark.parametrize("kind", ["unfused", "fused"])
def test_zero1_is_bitwise_the_replicated_run(ranks, kind):
    _, res, _ = ranks
    want = res[0][kind][0]
    for r in range(WORLD):
        for me in ZERO_MIN_ELEMS:
            sd, m, _ = res[r][f"{kind}:zero{me}"]
            assert m == res[r][kind][1]
            for k, v in want.items():
                assert torch.equal(sd[k], v), (r, me, k)


@pytest.mark.parametrize("min_elems", ZERO_MIN_ELEMS)
def test_zero1_momentum_bytes_are_jax_shard_bytes(ranks, min_elems):
    """Each rank's momentum bytes equal the per-device bytes of JAX's
    ``zero1_state_sharding`` shards for the same student's optimizer
    state on a 2-device mesh (shapes only), at the same
    ``min_elems``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
    from rtpe_tpu.parallel import zero1_state_sharding
    from rtpe_tpu_torch.parallel import \
        zero1_state_sharding as port_zero1_sharding
    from rtpe_tpu.train import step as jstep

    model = JaxStudent(inplanes=INPLANES, alt_planes=ALT,
                       detach_att_for_det=True, dtype=jnp.float32)
    x = jnp.zeros((1, HW, HW, 3))
    state = jax.eval_shape(lambda: jstep.DistillTrainState.create(
        model.init(jax.random.PRNGKey(0), x, x, train=False),
        jstep.DistillConfig()))
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD, 1),
                ("data", "model"))
    sh = zero1_state_sharding(state, mesh, min_elems=min_elems)
    leaves = jax.tree_util.tree_leaves(state.opt_state)
    shards = jax.tree_util.tree_leaves(sh.opt_state)
    want = sum(int(np.prod(s.shard_shape(leaf.shape))) * 4
               for leaf, s in zip(leaves, shards)
               if leaf.dtype == jnp.float32)
    full = sum(int(np.prod(leaf.shape)) * 4 for leaf in leaves
               if leaf.dtype == jnp.float32)
    _, res, _ = ranks
    for r in range(WORLD):
        assert res[r][f"unfused:zero{min_elems}"][2] == want, r
        assert res[r]["rep_bytes"] == full
    assert (want < full) == (min_elems == 1)
    # the port's rule by parameter name, without a process group: the
    # same bytes a rank
    state, _ = _student_state("unfused")
    dims = port_zero1_sharding(state, WORLD, min_elems=min_elems)
    params = dict(state.model.named_parameters())
    assert sum(params[k].numel() * 4 // (1 if d is None else WORLD)
               for k, d in dims.items()) == want
    assert len(dims) == sum(len(g["params"])
                            for g in state.optimizer.param_groups)


@pytest.mark.parametrize("name", ["zero_to_rep", "rep_to_zero"])
def test_checkpoint_resumes_across_zero1(ranks, name):
    """A checkpoint of step 1 under one mode, resumed under the other
    for step 2, is bitwise the uninterrupted run."""
    _, res, _ = ranks
    want = res[0]["unfused"][0]
    for r in range(WORLD):
        step, sd = res[r]["ckpt"][name]
        assert step == 1
        # the uninterrupted two-step run starts at step 0 with the same
        # two batches: every tensor equal
        for k, v in want.items():
            assert torch.equal(sd[k], v), (r, k)


@pytest.mark.parametrize("workers", [1, 3])
def test_sharded_pipeline_builds_the_one_process_rows(ranks, workers):
    _, res, _ = ranks
    whole = res[0]["pipeline"][(workers, True)]
    parts = [res[r]["pipeline"][(workers, False)] for r in range(WORLD)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 0
    for i, b in enumerate(whole):
        for k, v in b.items():
            got = np.concatenate([np.asarray(p[i][k]) for p in parts])
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_cli_trains_under_two_ranks_and_only_rank_0_writes(ranks):
    tmp, res, outs = ranks
    code, err = res[0]["cli"]["mesh3"]
    assert code == 2 and "--mesh_data 3" in err
    assert res[1]["cli"]["mesh3"][0] == 2
    (s0, sd0), (s1, sd1) = res[0]["cli"]["zero"], res[1]["cli"]["zero"]
    assert s0 == s1 == 2
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    out = os.path.join(tmp, "zero")
    assert len(os.listdir(os.path.join(out, "log"))) == 1
    assert len(os.listdir(os.path.join(out, "tb"))) == 1
    assert os.listdir(os.path.join(out, "snaps", "train_state")) == \
        ["step_2.pt"]
    parts = [f for f in os.listdir(os.path.join(out, "snaps"))
             if f.endswith(".statedict.npz")]
    assert len(parts) == 7
    assert "data-parallel over 2 processes with ZeRO-1" in outs[0]
    assert "data-parallel" not in outs[1]
    # --mesh_data 1 of 2: rank 0 trains alone, rank 1 stays idle
    assert res[0]["cli"]["idle"][0] == 2 and res[1]["cli"]["idle"] is None
    assert "rank 1 idle" in outs[1]


if __name__ == "__main__":
    _rank_main(int(os.environ["RANK"]), sys.argv[1], sys.argv[2])
