"""The trainer's command-line entry points in-process on the CPU,
mirroring ``tests/test_scripts.py:133-160``.

On ``_make_coco_fixture`` (eight 96 x 128 images) with a teacher corpus
written by ``rtpe_tpu.data.teacher_cache.save_teacher_prediction`` and a
seeded stem in a ``.pth.tar`` (the stem keys of the reference's W48
state dict, behind its fp16 ``"1."`` prefix):

* ``cli.distillation.main`` (``--inplanes 8``, B=2, 64 x 64 crops on a
  96 x 128 canvas, 2 steps, the attention minival every step over a
  whitelist, diagnostics every step) writes the checkpoint of step 2,
  7 part files named ``{timestamp}_epoch0_step2{part}.statedict.npz``,
  its log and ``metrics.jsonl``; the frozen stem is the file's.  A second
  run with ``--max_steps 3`` logs ``resumed from checkpoint step 2`` and
  ends at step 3.
* ``cli.eval_attention.main`` on those parts logs a finite ``mean
  attention loss``; ``cli.dataloader_demo.main`` runs two batches and
  decodes the teacher corpus.
* ``--student cam|multistage`` build the JAX script's models, and two
  CPU steps of ``--student cam`` checkpoint, restore bitwise and resume.
* The data-parallel flags parse and pass ``check_flags``, and the
  default device is CUDA.
* Known behaviour kept (``ROADMAP.md`` Queue 3): ``--ae_dims 1`` fails
  at its first step, in the port as in JAX, because the distillation
  step's keypoint loss takes the teacher's 17 heatmaps.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_data_eval import _make_coco_fixture

from rtpe_tpu.data.teacher_cache import save_teacher_prediction
from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
from rtpe_tpu.train import step as jstep
from rtpe_tpu_torch.cli import dataloader_demo, distillation, eval_attention
from rtpe_tpu_torch.io.checkpoint import TrainCheckpointer
from rtpe_tpu_torch.models import CamStudent, MultistageStudent
from rtpe_tpu_torch.models.factory import get_legacy_student
from rtpe_tpu_torch.models.stem import StemHRNet
from rtpe_tpu_torch.train import StudentDistillConfig, StudentTrainState

N_IMGS = 8


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    _make_coco_fixture(root, n_imgs=N_IMGS, hw=(96, 128),
                       jitter_per_image=True)
    teacher = os.path.join(root, "teacher")
    os.makedirs(teacher)
    rng = np.random.default_rng(0)
    for i in range(N_IMGS):
        save_teacher_prediction(
            teacher, f"{1000 + i:012d}.jpg",
            rng.normal(size=(24, 32, 34)).astype(np.float32) * 0.01,
            rng.random((48, 64, 17)).astype(np.float32) ** 8)
    whitelist = os.path.join(root, "minival.txt")
    with open(whitelist, "w") as f:
        f.write("\n".join(f"{1000 + i:012d}" for i in (1, 3, 6)) + "\n")
    torch.manual_seed(5)
    stem = StemHRNet()
    for p in stem.parameters():
        torch.nn.init.normal_(p, std=0.05)
    w48 = os.path.join(root, "w48.pth.tar")
    torch.save({"1." + k: v.half() for k, v in stem.state_dict().items()},
               w48)
    return root, teacher, whitelist, w48, stem.state_dict()


def _args(coco, out, *extra):
    root, teacher, whitelist, w48, _ = coco
    return ["--coco_dir", root, "--teacher_dir", teacher, "--model_path", w48,
            "--device", "cpu", "--inplanes", "8", "--batch_size", "2",
            "--train_hw", "64", "64", "--canvas_hw", "96", "128",
            "--num_epochs", "1", "--snapshot_dir", os.path.join(out, "snaps"),
            "--log_dir", os.path.join(out, "log"),
            "--tb_dir", os.path.join(out, "tb"), "--diagnose_every", "1",
            "--minival_file", whitelist, "--minival_every", "1",
            "--num_workers", "1", *extra]


def _log(out):
    logs = sorted(os.listdir(os.path.join(out, "log")))
    with open(os.path.join(out, "log", logs[-1])) as f:
        return f.read()


@pytest.fixture(scope="module")
def trained(coco, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    first = distillation.main(_args(coco, out, "--max_steps", "2"))
    first_log = _log(out)
    second = distillation.main(_args(coco, out, "--max_steps", "3",
                                     "--num_workers", "3"))
    return out, first, first_log, second, _log(out)


def test_distillation_writes_checkpoints_parts_and_metrics(coco, trained):
    out, first, log, _, _ = trained
    assert first.start_step == 0 and first.step == first.state.step == 2
    snaps = os.path.join(out, "snaps")
    prefix = f"{first.timestamp}_epoch0_step2"
    names = sorted(os.path.basename(p) for p in first.parts)
    assert names == sorted(f"{prefix}{part}.statedict.npz" for part in (
        "mid_stem", "att_lo", "att_mid", "att_hi", "att_top", "steps",
        "alt_img_stem"))
    assert all(os.path.exists(os.path.join(snaps, n)) for n in names)
    assert "step_2.pt" in os.listdir(os.path.join(snaps, "train_state"))
    assert "epoch 0 step 2:" in log and "loaded pretrained stem" in log
    assert "MINIVAL att loss" in log
    assert [s for s, _, _ in first.minival] == [1, 2]
    assert all(np.isfinite(v) and d is None for _, v, d in first.minival)
    # the frozen stem's parameters are the file's (through its fp16 "1."
    # prefix); its BN statistics move in train mode, as in JAX
    _, _, _, _, stem = coco
    for k, v in first.state.model.stem.named_parameters():
        assert torch.equal(v.detach(), stem[k].half().float()), k
    with open(os.path.join(out, "tb", f"[distillation.py]_{first.timestamp}",
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tags = {(r.get("tag"), r.get("step")) for r in rows}
    for step in (1, 2):
        assert ("attention_loss", step) in tags
        assert ("keypoints_loss", step) in tags
        assert ("minival att loss", step) in tags
    assert any("hparams" in r for r in rows)


def test_distillation_resumes(trained):
    _, first, _, second, log = trained
    assert "resumed from checkpoint step 2" in log
    assert second.start_step == 2 and second.step == second.state.step == 3
    assert "epoch 0 step 3:" in log
    assert all(p.endswith(".statedict.npz") and "_epoch0_step3" in p
               for p in second.parts)


def test_eval_attention_on_the_parts(coco, trained, tmp_path, capsys):
    root, _, whitelist, w48, _ = coco
    out, first, _, _, _ = trained
    res = eval_attention.main([
        "--coco_dir", root, "--snapshot_dir", os.path.join(out, "snaps"),
        "--load_timestamp", first.timestamp, "--load_epoch", "0",
        "--load_step", "2", "--model_path", w48, "--inplanes", "8",
        "--whitelist", whitelist, "--save_every", "0",
        "--tb_dir", str(tmp_path / "tb"), "--device", "cpu"])
    printed = capsys.readouterr().out
    m = re.search(r"mean attention loss over 3 images: ([0-9.]+)", printed)
    assert m and np.isfinite(float(m.group(1)))
    assert float(m.group(1)) == pytest.approx(res.mean, abs=1e-5)
    assert list(res.img_ids) == [1001, 1003, 1006]


def test_dataloader_demo_runs_two_batches(coco, tmp_path, capsys):
    pytest.importorskip("cv2")
    root, teacher, _, _, _ = coco
    stats = dataloader_demo.main([
        "--coco_dir", root, "--teacher_dir", teacher, "--max_eval_images",
        "2", "--save_dir", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["dataloader_demo_0.jpg",
                                            "dataloader_demo_1.jpg"]
    assert len(stats) == 10 and all(np.isfinite(v) for v in stats.values())
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


@pytest.mark.parametrize("flags,item", [
    (["--zero1"], "Queue 1 item 6"),
    (["--mesh_data", "2"], "Queue 1 item 6"),
])
def test_refused_flags_exit_2(flags, item, capsys, monkeypatch):
    """The data-parallel flags the port once refused (naming ``item``)
    parse, pass ``check_flags`` and build the data-parallel setting: here
    a process of a group of 2 (``test_torch_parallel_dp.py`` trains under
    two real ranks)."""
    monkeypatch.setattr(distillation.pdist, "world_size", lambda: 2)
    parser = distillation.build_parser()
    args = parser.parse_args(["--device", "cpu", *flags])
    distillation.check_flags(parser, args)
    assert item not in capsys.readouterr().err
    assert args.zero1 == ("--zero1" in flags)
    assert args.mesh_data in (None, 2)
    # without a process group: one process, no group to shard over
    assert distillation.data_parallel_group(args) == (None, True)


@pytest.mark.parametrize("kind,cls", [("cam", CamStudent),
                                      ("multistage", MultistageStudent)])
def test_legacy_students_parse_and_build(kind, cls):
    """``--student cam|multistage`` parse without a refusal and build the
    JAX script's model (``scripts/distillation.py:158-170``)."""
    parser = distillation.build_parser()
    args = parser.parse_args(["--student", kind, "--device", "cpu"])
    distillation.check_flags(parser, args)
    model = get_legacy_student(kind, num_heatmaps=args.num_heatmaps,
                               ae_dims=args.ae_dims, device="cpu")
    assert type(model) is cls and model.training
    assert model.dtype == torch.float32
    if kind == "cam":
        assert model.mid_stem_conv.out_channels == 48
        assert model.hm_conv2.out_channels == 17
    else:
        assert [getattr(model, f"stage{i}").n for i in range(3)] == [3] * 3


def test_cam_student_trains_and_resumes_bitwise(coco, tmp_path):
    """Two CPU steps of ``--student cam``: the checkpoint of step 2
    restores the model, the momentum and the step bitwise, and a second
    run resumes from it to step 3; one part file a top-level module."""
    out = str(tmp_path)
    argv = [a for a in _args(coco, out, "--student", "cam")
            if a not in ("--minival_file", coco[2])]
    first = distillation.main(argv + ["--max_steps", "2"])
    assert first.start_step == 0 and first.step == first.state.step == 2
    assert first.minival == []
    assert all(np.isfinite(float(first.metrics[k])) for k in ("loss", "lr"))
    tops = sorted(os.path.basename(p)[len(first.timestamp) + len(
        "_epoch0_step2"):-len(".statedict.npz")] for p in first.parts)
    assert tops == ["cam0", "cam1", "cam2", "hm_conv2", "mid_stem_bn",
                    "mid_stem_conv"]
    fresh = StudentTrainState.create(
        get_legacy_student("cam", device="cpu", seed=3),
        StudentDistillConfig())
    fresh, step = TrainCheckpointer(os.path.join(
        out, "snaps", "train_state")).restore(fresh)
    assert step == 2 and fresh.step == 2
    for k, v in first.state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    opt_a, opt_b = first.state.optimizer, fresh.optimizer
    for pa, pb in zip(opt_a.param_groups[0]["params"],
                      opt_b.param_groups[0]["params"]):
        assert torch.equal(opt_a.state[pa]["momentum_buffer"],
                           opt_b.state[pb]["momentum_buffer"])
    second = distillation.main(argv + ["--max_steps", "3"])
    assert "resumed from checkpoint step 2" in _log(out)
    assert second.start_step == 2 and second.step == 3


def test_default_device_is_cuda(coco, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    argv = [a for a in _args(coco, str(tmp_path)) if a != "cpu"]
    argv.remove("--device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distillation.main(argv)


def test_ae_dims_students_fail_their_first_step_as_in_jax(coco, tmp_path):
    with pytest.raises(RuntimeError, match="must match the size"):
        distillation.main(_args(coco, str(tmp_path), "--max_steps", "1",
                                "--ae_dims", "1"))
    model = JaxStudent(inplanes=8, alt_planes=6, ae_dims=1,
                       detach_att_for_det=True, dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 3))
    state = jstep.DistillTrainState.create(
        model.init(jax.random.PRNGKey(0), x, x, train=False),
        jstep.DistillConfig())
    ones = np.ones((2, 32, 32, 1), np.float32)
    batch = {"img": np.zeros((2, 32, 32, 3), np.float32),
             "img_alt": np.zeros((2, 32, 32, 3), np.float32),
             "segm_mask": ones, "mask": ones,
             "gt_hms": np.zeros((2, 32, 32, 17), np.float32),
             "teacher_hms": np.zeros((2, 32, 32, 17), np.float32)}
    with pytest.raises(TypeError, match="incompatible shapes"):
        jstep.make_distill_train_step(model, jstep.DistillConfig())(
            state, batch)
