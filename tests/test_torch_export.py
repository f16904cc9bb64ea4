"""The port's serving-artifact export against the JAX package's, on the
CPU.

* ``jax_variables_from_state_dict`` inverts ``state_dict_from_jax``
  bitwise, both ways;
* an artifact the port writes passes JAX's ``load_serving_artifact``
  (its sha256 and array count checked) with the same variables, and
  JAX's ``from_artifact`` serves it as the port's does (the same people,
  float32, the canonical forward as in ``test_torch_packed``);
* an int8 artifact JAX writes is served by the port's ``from_artifact``
  as int8, with JAX's scales, bitwise as the port's own int8 predictor;
* ``python -m rtpe_tpu_torch.cli.export_serving`` (``main(argv)``) on the
  W48's layout at ``--device cpu``: int8 with ``--calib`` images, then
  with the scale file it shipped, each reloaded and verified bitwise;
  its refusals, and ``export_serving_artifact``'s.  The CLI builds the
  teacher from ``w48_config()``, which the test points at ``NARROW_W48``:
  every module, branch, block and conv of the W48 (so the 303 conv and
  65 fuse-output scales), at an eighth of its branch widths.  What the
  CLI checks (the calibration's coverage, the reload's bitwise forward,
  the reshipped scales) does not depend on the widths.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_data_eval import _make_coco_fixture

from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.eval.predictor import PosePredictor as JaxPredictor
from rtpe_tpu.io import export_serving_artifact as jax_export
from rtpe_tpu.io import load_serving_artifact as jax_load
from rtpe_tpu.models import hrnet_packed as j_packed
from rtpe_tpu_torch.cli import export_serving
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.io import (export_serving_artifact,
                               jax_variables_from_state_dict,
                               load_serving_artifact, state_dict_from_jax)
from rtpe_tpu_torch.io.jax_import import _flatten
from rtpe_tpu_torch.models import (HRNetConfig, PoseHigherHRNet, StageCfg,
                                   init_random_)
from rtpe_tpu_torch.models import factory as t_factory
from test_torch_model import seeded_variables, small_cfgs
from test_torch_slice import NUM_JOINTS, _assert_same_people


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in _flatten(tree)}


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_jax_variables_round_trip_bitwise():
    jcfg, tcfg = small_cfgs()
    variables = seeded_variables(jcfg, seed=3)
    sd = state_dict_from_jax(variables, tcfg)
    back = jax_variables_from_state_dict(sd, tcfg)
    _assert_same_tree(back, jax.device_get(variables))
    again = state_dict_from_jax(back, tcfg)
    assert again.keys() == sd.keys()
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    # the fp16 wrapper's prefix is taken; a missing key is refused
    _assert_same_tree(jax_variables_from_state_dict(
        {f"1.{k}": v for k, v in sd.items()}, tcfg), back)
    del sd["final_layers.1.bias"]
    with pytest.raises(KeyError, match="lacks"):
        jax_variables_from_state_dict(sd, tcfg)


def test_port_artifact_passes_jax_loader_and_serves_like_jax(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")
    jcfg, tcfg = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    model = PoseHigherHRNet(tcfg)
    model.load_state_dict(state_dict_from_jax(variables, tcfg))
    d = export_serving_artifact(
        str(tmp_path / "art"),
        jax_variables_from_state_dict(model.state_dict(), tcfg), tcfg,
        num_joints=NUM_JOINTS, input_size=128, packed=True,
        extra_meta={"source": "test"})
    art = jax_load(d, verify_hash=True)
    assert art.cfg == jcfg and art.meta["extra"] == {"source": "test"}
    _assert_same_tree(art.variables, jax.device_get(variables))
    assert art.predictor_kwargs["packed"] \
        and not art.predictor_kwargs["int8"]
    jp = JaxPredictor.from_artifact(d, dtype=jnp.float32, fused_decode=True,
                                    packed=False)
    tp = PosePredictor.from_artifact(d, device="cpu", packed=False)
    img = (np.random.default_rng(3).random((100, 90, 3)) * 255).astype(
        np.uint8)
    _assert_same_people(tp.predict(img), jp.predict(img))
    served = PosePredictor.from_artifact(d, device="cpu")
    assert served.packed and served.input_size == 128


def test_jax_int8_artifact_is_served_as_int8(tmp_path):
    jcfg, tcfg = small_cfgs()
    variables = seeded_variables(jcfg, seed=6)
    pk = j_packed.pack_w48_params(variables, jcfg, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    scales = j_packed.calibrate_act_scales(pk, [jnp.asarray(x)], jcfg,
                                           dtype=jnp.float32)
    d = jax_export(str(tmp_path / "art"), variables, jcfg,
                   num_joints=jcfg.num_joints, input_size=64, int8=True,
                   int8_act=True, act_scales=scales)
    got = PosePredictor.from_artifact(d, device="cpu", int8_min_batch=0)
    assert got.int8_params is not None and got.int8_act
    assert got.act_scales == scales
    want = PosePredictor.from_jax(variables, tcfg, device="cpu",
                                  num_joints=jcfg.num_joints, input_size=64,
                                  packed=True, int8=True, int8_act=True,
                                  act_scales=scales, int8_min_batch=0)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        for a, b in zip(got._forward(xt), want._forward(xt)):
            assert torch.equal(a, b)
    assert load_serving_artifact(d).predictor_kwargs["act_scales"] == scales


@pytest.mark.parametrize("kw,match", [
    (dict(int8_act=True), "requires int8=True"),
    (dict(int8=True, packed=False, act_scales={}), "requires packed=True"),
    (dict(int8=True), "without act_scales"),
    (dict(act_scales={"conv1": 1.0}), "int8=False"),
])
def test_export_refusals(tmp_path, kw, match):
    jcfg, tcfg = small_cfgs()
    variables = jax_variables_from_state_dict(
        PoseHigherHRNet(tcfg).state_dict(), tcfg)
    with pytest.raises(ValueError, match=match):
        export_serving_artifact(str(tmp_path / "art"), variables, tcfg, **kw)
    with pytest.raises(ValueError, match="no 'params'"):
        export_serving_artifact(str(tmp_path / "art"), {"batch_stats": {}},
                                tcfg)


# the W48's layout (modules, branches, blocks, the 4-block head) at an
# eighth of its branch widths
NARROW_W48 = HRNetConfig(
    stage2=StageCfg(1, 2, "BASIC", (4, 4), (6, 12)),
    stage3=StageCfg(4, 3, "BASIC", (4, 4, 4), (6, 12, 24)),
    stage4=StageCfg(3, 4, "BASIC", (4, 4, 4, 4), (6, 12, 24, 48)),
    deconv_chans=(6,))


@pytest.fixture(scope="module")
def w48(tmp_path_factory):
    """A seeded ``NARROW_W48`` state dict file and two calibration
    images."""
    root = str(tmp_path_factory.mktemp("export"))
    path = os.path.join(root, "w48.pth.tar")
    torch.save(init_random_(PoseHigherHRNet(NARROW_W48), seed=2)
               .state_dict(), path)
    _make_coco_fixture(root, n_imgs=2, hw=(96, 128))
    imgs = sorted(os.path.join(root, "images", "val2017", f)
                  for f in os.listdir(os.path.join(root, "images",
                                                   "val2017")))
    return root, path, imgs


def test_export_cli_int8_calibrates_verifies_and_reships(w48, capsys,
                                                        monkeypatch):
    root, path, imgs = w48
    monkeypatch.setattr(t_factory, "w48_config", lambda: NARROW_W48)
    out = os.path.join(root, "art")
    common = ["-m", path, "--device", "cpu", "--input_size", "128"]
    res = export_serving.main(common + ["-o", out, "--int8", "--int8_act",
                                        "--calib", *imgs])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res and res["verified"] is True
    assert res["int8"] and res["int8_act"] and res["packed"]
    art = jax_load(out, verify_hash=True)
    assert art.predictor_kwargs["int8_act"]
    scales = art.predictor_kwargs["act_scales"]
    n_out = sum(k.endswith(":out") for k in scales)    # the fuse convs
    assert len(scales) - n_out == 303 and n_out == 65
    # ship the scale file again instead of calibrating: the same scales
    again = export_serving.main(common + [
        "-o", os.path.join(root, "art2"), "--int8", "--act_scales",
        os.path.join(out, "act_scales.json"), "--no-verify"])
    assert again["verified"] is None
    assert load_serving_artifact(os.path.join(root, "art2")) \
        .predictor_kwargs["act_scales"] == scales


@pytest.mark.parametrize("argv", [
    ["--int8_act"], ["--int8", "--no-packed", "--calib", "a.jpg"],
    ["--int8"], ["--int8", "--act_scales", "absent.json"]])
def test_export_cli_refusals_exit_with_status_2(tmp_path, argv):
    with pytest.raises(SystemExit) as exc:
        export_serving.main(["-m", "absent.pth.tar", "-o",
                             str(tmp_path / "art"), "--device", "cpu", *argv])
    assert exc.value.code == 2
