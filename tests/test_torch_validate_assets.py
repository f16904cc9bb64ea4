"""The runbook ``rtpe_tpu_torch.cli.validate_assets`` against
``scripts/validate_assets.py``, on the CPU.

* Every asset absent: both ``main``s print the same lines (the same
  skipped steps in the same order) and exit 0; the port's default
  device is CUDA.
* The COCO-gated steps with ``subprocess.run`` replaced by a recorder in
  both: the same child flags (the JAX script's after the script's path,
  the port's after ``-m <module>`` and before ``--device``), and the
  same records from the same canned JSON stats lines.
* Steps 2-5 on a narrow seeded HigherHRNet (the family the packed path
  takes) at ``input_size=64`` on two seeded images: the records that
  hold on any weights pass, the others carry finite values.
* ``main`` on a seeded full-width W48 ``.pth.tar`` with no images: the
  parameter count passes and everything else skips.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtpe_tpu_torch.cli import validate_assets as va
from rtpe_tpu_torch.models import PoseHigherHRNet, init_random_, w48_config
from test_torch_model import small_cfgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUIRED = ("packed_fp32_parity", "act_scales_file_roundtrip",
            "stream_matches_predict", "artifact_roundtrip_real_weights")


@pytest.fixture(scope="module")
def jva():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_assets", os.path.join(REPO, "scripts",
                                            "validate_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, capsys):
    with pytest.raises(SystemExit) as e:
        main()
    return e.value.code, capsys.readouterr().out.splitlines()


def test_every_asset_absent_skips_as_jax(jva, tmp_path, monkeypatch,
                                         capsys):
    gone = str(tmp_path / "absent")
    flags = ["-m", gone + ".pth.tar", "--coco_dir", gone,
             "--data_dir", gone]
    monkeypatch.setattr(sys, "argv", ["validate_assets", *flags])
    jcode, jout = _run_main(jva.main, capsys)
    code, out = _run_main(lambda: va.main([*flags, "--device", "cpu"]),
                          capsys)
    assert jcode == code == 0
    assert out == jout
    skipped = json.loads(out[-1])["skipped"]
    assert skipped == ["teacher_import", "packed_parity_real_weights",
                       "greedy_decode_parity", "stream_matches_predict",
                       "artifact_roundtrip_real_weights",
                       "decode_stack_minival_ap", "teacher_coco_ap"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            va.main(flags)


def _canned_aps():
    """AP lines for the six ``validate_hhrnet`` variants that exercise
    every delta gate both ways."""
    return [0.45, 0.66, 0.6631, 0.40, 0.46, 0.55]


def _coco_args(tmp_path, full):
    coco = tmp_path / "coco"
    (coco / "annotations").mkdir(parents=True, exist_ok=True)
    (coco / "annotations" / "person_keypoints_val2017.json").write_text("{}")
    (tmp_path / "teacher").mkdir(exist_ok=True)
    model = tmp_path / "w48.pth.tar"
    model.write_bytes(b"")
    wl = tmp_path / "minival.txt"
    wl.write_text("1\n")
    return dict(model_path=str(model), coco_dir=str(coco),
                teacher_dir=str(tmp_path / "teacher"),
                data_dir=str(tmp_path / "absent"), whitelist=str(wl),
                minival_images=8, full=full)


@pytest.mark.parametrize("full", [False, True])
def test_coco_steps_run_jax_children(jva, tmp_path, monkeypatch, capsys,
                                     full):
    kw = _coco_args(tmp_path, full)
    runs = {}

    def recorder(key):
        aps = iter(_canned_aps())

        def run(cmd, **_):
            runs[key].append(list(cmd))
            if any("dataloader_demo" in c for c in cmd[:3]):
                out = "decoded\n{'AP': 0.25, 'AR': 0.5}\n"
            else:
                out = "log\n" + json.dumps({"AP": next(aps), "AR": 0.5})
            return subprocess.CompletedProcess(cmd, 0, out, "")
        return run

    results = {}
    for key, mod, args in (
            ("jax", jva, argparse.Namespace(**kw)),
            ("port", va, argparse.Namespace(**kw, device="cpu"))):
        runs[key] = []
        monkeypatch.setattr(subprocess, "run", recorder(key))
        res = mod.Results()
        mod.step_decode_stack_ap(res, args)
        mod.step_teacher_coco_ap(res, args)
        results[key] = res
    capsys.readouterr()
    assert len(runs["jax"]) == len(runs["port"]) == 7
    for jcmd, cmd in zip(runs["jax"], runs["port"]):
        script = os.path.basename(jcmd[1])[:-3]
        assert jcmd[0] == cmd[0] == sys.executable
        assert cmd[1:3] == ["-m", f"rtpe_tpu_torch.cli.{script}"]
        assert cmd[-2:] == ["--device", "cpu"]
        assert cmd[3:-2] == jcmd[2:]
    assert ("--max_images" in runs["port"][1]) is not full
    for attr in ("passed", "failed", "skipped"):
        assert getattr(results["port"], attr) == \
            getattr(results["jax"], attr), attr
    names = {n for n, _ in results["port"].passed + results["port"].failed}
    assert {"int8_ap_delta", "int8_act_ap_delta", "tta_batched_equals_bs1",
            "tta_multiscale_sane"} <= names


def test_children_find_the_package(tmp_path, monkeypatch):
    """The children get the repository root first on their PYTHONPATH
    and keep the caller's entries after it."""
    seen = {}

    def run(cmd, env=None, **_):
        seen["env"] = env
        return subprocess.CompletedProcess(cmd, 0, "AP", "")
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setenv("PYTHONPATH", "elsewhere")
    args = argparse.Namespace(**_coco_args(tmp_path, False), device="cpu")
    va.step_decode_stack_ap(va.Results(), args)
    assert seen["env"]["PYTHONPATH"].split(os.pathsep) == [REPO,
                                                          "elsewhere"]


def _images():
    rng = np.random.default_rng(7)
    return [(rng.random((96, 128, 3)) * 255).astype(np.uint8)
            for _ in range(2)]


def test_steps_on_a_narrow_seeded_model():
    _, cfg = small_cfgs(17)
    model = init_random_(PoseHigherHRNet(cfg), seed=5).eval()
    args = va.build_parser().parse_args(["--device", "cpu"])
    res = va.Results()
    teacher = (model, model.state_dict())
    imgs = _images()
    va.step_packed_parity(res, args, teacher, imgs, input_size=64)
    va.step_greedy_decode_parity(res, args, teacher, imgs, input_size=64)
    va.step_stream_consistency(res, args, teacher, imgs, input_size=64)
    va.step_artifact_roundtrip(res, args, teacher, imgs, input_size=64)
    passed = dict(res.passed)
    for name in REQUIRED:
        assert name in passed, (name, res.failed)
    records = dict(res.passed + res.failed)
    assert len(records) == 8 and not res.skipped
    for name in ("packed_fp32_parity", "packed_bf16_parity",
                 "int8_forward_drift", "int8_act_forward_drift",
                 "greedy_decode_parity"):
        values = [float(v) for v in re.findall(
            r"[-+]?\d+\.\d+(?:e[-+]\d+)?", records[name])]
        assert values and np.isfinite(values).all(), records[name]


def test_main_on_a_full_width_state_dict(tmp_path, capsys):
    path = str(tmp_path / "w48.pth.tar")
    torch.save(init_random_(PoseHigherHRNet(w48_config()),
                            seed=0).state_dict(), path)
    code, out = _run_main(lambda: va.main(
        ["-m", path, "--coco_dir", str(tmp_path / "absent"),
         "--data_dir", str(tmp_path), "--device", "cpu"]), capsys)
    report = json.loads(out[-1])
    assert code == 0, out
    assert report["passed"] == ["teacher_param_count"]
    assert not report["failed"]
    assert report["skipped"] == [
        "packed_parity_real_weights", "greedy_decode_parity",
        "stream_matches_predict", "artifact_roundtrip_real_weights",
        "decode_stack_minival_ap", "teacher_coco_ap"]
