"""The port's BN-folded serving forward against the JAX package's, on
the CPU.

Same seeded numpy weights on both sides (``test_torch_model``'s small
HigherHRNet), converted with ``state_dict_from_jax``:

* the fold: the port's ``fold_w48_params`` of the converted state dict
  equals JAX's ``fold_w48_params`` brought over by
  ``folded_params_from_jax`` (the BN scale on the transposed conv's
  output axis included), to float32 rounding (rtol 1e-6);
* ``packed_forward`` in float32, chains on and off, against JAX's
  row-packed ``packed_forward`` in float32: relative error <= 1e-4 (the
  bound of ``tests/test_rowpack.py``: another summation order); in bf16
  against JAX's bf16 packed forward: both round every activation to
  bf16 where JAX does, but torch's CPU bf16 conv rounds its output
  before the float32 bias is added (a second rounding), so they agree
  within 2^-4 of the output's largest magnitude;
* ``PosePredictor(packed=True, dtype=float32)`` against the JAX
  predictor with its forward patched to JAX's float32 packed forward
  (the JAX packed predictor is always bf16): n_people equal, people and
  scores within 1e-3, after the margin check of ``test_torch_slice``;
* ``PosePredictor.from_artifact`` on a directory written by JAX's
  ``export_serving_artifact``, and ``get_packed_teacher`` on a
  ``torch.save``d reference-format state dict with the fp16 ``"1."``
  prefix.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.eval.predictor import PosePredictor as JaxPredictor
from rtpe_tpu.io import export_serving_artifact
from rtpe_tpu.models import PoseHigherHRNet as JaxHRNet
from rtpe_tpu.models import hrnet_packed as j_packed
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.io import (folded_params_from_jax, load_serving_artifact,
                               state_dict_from_jax)
from rtpe_tpu_torch.models import PoseHigherHRNet, init_random_, w48_config
from rtpe_tpu_torch.models import factory
from rtpe_tpu_torch.models.hrnet_packed import (chain_key, fold_w48_params,
                                                pack_w48_params,
                                                packed_forward)
from rtpe_tpu_torch.ops.blocks import basicblock_chain
from rtpe_tpu_torch.ops.fold import fold_bn
from test_torch_model import seeded_variables, small_cfgs
from test_torch_slice import (HM_TOL, IMAGE_HW, NUM_JOINTS, TAG_TOL,
                              _assert_decode_margins, _assert_same_people)

REL_TOL = 1e-4
BF16_TOL = 2.0 ** -4


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = small_cfgs()
    variables = seeded_variables(jcfg, seed=6, in_hw=(64, 96))
    return jcfg, tcfg, variables


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def test_fold_bn_matches_jax_on_conv_and_tconv():
    from rtpe_tpu.ops.rowpack import fold_bn as j_fold_bn

    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)       # HWIO
    scale, bias, mean = (rng.normal(size=6).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    jw, jb = j_fold_bn(jnp.asarray(w), scale, bias, mean, var)
    bn = [torch.from_numpy(a) for a in (scale, bias, mean, var)]
    tw, tb = fold_bn(torch.from_numpy(w.transpose(3, 2, 0, 1)), *bn)
    np.testing.assert_allclose(tw.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jw), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)
    # a transposed conv's (in, out, kh, kw) weight: the scale on axis 1
    tw_t, _ = fold_bn(torch.from_numpy(w.transpose(2, 3, 0, 1)), *bn,
                      out_axis=1)
    np.testing.assert_allclose(tw_t.numpy().transpose(2, 3, 0, 1),
                               np.asarray(jw), rtol=1e-6, atol=0)


def test_fold_matches_jax_fold(weights):
    jcfg, tcfg, variables = weights
    want = folded_params_from_jax(
        jax.device_get(j_packed.fold_w48_params(variables, jcfg)), tcfg)
    got = fold_w48_params(state_dict_from_jax(variables, tcfg), tcfg)
    assert got.keys() == want.keys()
    assert "deconv0_tconv" in got and chain_key("stage4_0", 3) in got
    for key in got:
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == torch.float32, key
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    # the chain stack holds the per-conv weights, HWIO, block-major
    w, b = got[chain_key("stage3_1", 2)]
    assert w.shape == (2, 2, 3, 3, 32, 32) and b.shape == (2, 2, 32)
    conv = got["stage3_1/branch2_1/conv2"]
    assert torch.equal(w[1, 1], conv[0].permute(2, 3, 1, 0))
    assert torch.equal(b[1, 1], conv[1])


@pytest.mark.parametrize("chains", [False, True])
def test_packed_forward_matches_jax_f32(weights, chains):
    jcfg, tcfg, variables = weights
    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    pk_j = j_packed.pack_w48_params(variables, jcfg, dtype=jnp.float32)
    want = j_packed.packed_forward(pk_j, jnp.asarray(x), jcfg,
                                   dtype=jnp.float32)
    pk = pack_w48_params(state_dict_from_jax(variables, tcfg), tcfg,
                         torch.float32)
    before = basicblock_chain.launches
    with torch.inference_mode():
        got = packed_forward(pk, torch.from_numpy(x).permute(0, 3, 1, 2),
                             tcfg, torch.float32, pallas_chains=chains)
    assert basicblock_chain.launches == before       # CPU: plain version
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == np.shape(w) and np.abs(g).max() > 0.1
        assert _rel(g, w) <= REL_TOL, _rel(g, w)


@pytest.mark.parametrize("chains", [False, True])
def test_packed_forward_matches_jax_bf16(weights, chains):
    jcfg, tcfg, variables = weights
    x = np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    pk_j = j_packed.pack_w48_params(variables, jcfg)             # bf16
    want = j_packed.packed_forward(pk_j, jnp.asarray(x), jcfg)
    pk = pack_w48_params(state_dict_from_jax(variables, tcfg), tcfg)
    assert pk["conv1"][0].dtype == torch.bfloat16
    assert pk["conv1"][1].dtype == torch.float32
    with torch.inference_mode():
        got = packed_forward(pk, torch.from_numpy(x).permute(0, 3, 1, 2),
                             tcfg, pallas_chains=chains)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().permute(0, 2, 3, 1).numpy(), w) <= BF16_TOL


@pytest.fixture(scope="module")
def packed_predictors():
    """The JAX packed predictor serving JAX's float32 packed forward, and
    the port's packed predictor in float32, on the same weights."""
    jcfg, tcfg = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    jp = JaxPredictor(JaxHRNet(cfg=jcfg, dtype=jnp.float32), variables,
                      num_joints=NUM_JOINTS, input_size=128,
                      fused_decode=True, packed=True)
    pk_j = j_packed.pack_w48_params(variables, jcfg, dtype=jnp.float32)
    jp._fwd = jax.jit(lambda x: j_packed.packed_forward(
        pk_j, x, jcfg, dtype=jnp.float32))
    tp = PosePredictor.from_jax(variables, tcfg, device="cpu",
                                num_joints=NUM_JOINTS, input_size=128,
                                packed=True, dtype=torch.float32)
    rng = np.random.default_rng(0)
    images = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
              for h, w in IMAGE_HW]
    return jp, tp, images


def test_packed_predictor_matches_jax(packed_predictors, monkeypatch):
    jp, tp, images = packed_predictors
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")
    assert tp.packed and tp.dtype == torch.float32
    for im in images:
        x_j, _, _ = jp._preprocess(im)
        hms_j, tags_j = jp._decode_outputs(*jp._fwd(jnp.asarray(x_j[None])))
        with torch.inference_mode():
            x_t, _, _ = tp._preprocess(im)
            hms_t, tags_t = tp._decode_outputs(*tp._forward(x_t[None]))
        np.testing.assert_allclose(hms_t.numpy(), np.asarray(hms_j),
                                   rtol=0, atol=HM_TOL)
        np.testing.assert_allclose(tags_t.numpy(), np.asarray(tags_j),
                                   rtol=0, atol=TAG_TOL)
        params = tp.parser.params
        _assert_decode_margins(np.asarray(hms_j), params.detection_threshold,
                               params.max_num_people)
    out_t = tp.predict_batch(images)
    out_j = jp.predict_batch(images)
    assert len(out_t) == len(out_j) == len(images)
    for rt, rj in zip(out_t, out_j):
        _assert_same_people(rt, rj)
    for rt, rj in zip([tp.predict(images[0])] + list(tp.stream(images[:2])),
                      [out_j[0], out_j[0], out_j[1]]):
        _assert_same_people(rt, rj)


def test_from_artifact_serves_the_jax_artifact(weights, tmp_path):
    jcfg, tcfg, variables = weights
    d = export_serving_artifact(str(tmp_path / "art"), variables, jcfg,
                                num_joints=jcfg.num_joints, input_size=96,
                                packed=True)
    art = load_serving_artifact(d)
    assert art.cfg == tcfg
    assert art.predictor_kwargs["packed"] and art.variables.keys() == {
        "params", "batch_stats"}
    pred = PosePredictor.from_artifact(d, device="cpu")
    ref = PosePredictor.from_jax(variables, tcfg, device="cpu",
                                 num_joints=jcfg.num_joints, input_size=96,
                                 packed=True)
    assert pred.packed and pred.input_size == 96 and \
        pred.num_joints == jcfg.num_joints
    for key, (w, b) in ref.packed_params.items():
        assert torch.equal(pred.packed_params[key][0], w)
        assert torch.equal(pred.packed_params[key][1], b)
    img = (np.random.default_rng(4).random((90, 70, 3)) * 255).astype(
        np.uint8)
    got, want = pred.predict(img), ref.predict(img)
    assert len(got[0]) == len(want[0]) and got[1] == want[1]
    canonical = PosePredictor.from_artifact(d, device="cpu", packed=False)
    assert not canonical.packed and canonical.packed_params is None


@pytest.mark.parametrize("edit,exc", [
    (dict(int8=True), None),
    (dict(int8_act=True), None),
    (dict(format="other"), ValueError),
])
def test_artifact_refusals(weights, tmp_path, edit, exc):
    """Every artifact loads; one recorded with int8 (or int8_act) ships
    its calibrated scales and is served as recorded, quantized, and a
    foreign format is refused by the loader.  (Flip TTA, refused here
    until the port served it, is
    ``test_artifact_recorded_with_flip_serves_like_jax``.)"""
    jcfg, _, variables = weights
    int8 = {}
    if exc is None:
        x = np.random.default_rng(5).normal(size=(1, 64, 96, 3))
        scales = j_packed.calibrate_act_scales(
            j_packed.pack_w48_params(variables, jcfg, dtype=jnp.float32),
            [jnp.asarray(x, jnp.float32)], jcfg, dtype=jnp.float32)
        int8 = dict(act_scales=scales, **{"int8": True, **edit})
    d = export_serving_artifact(str(tmp_path / "art"), variables, jcfg,
                                num_joints=jcfg.num_joints, packed=True,
                                **int8)
    if exc is not None:
        mpath = os.path.join(d, "meta.json")
        with open(mpath) as f:
            meta = json.load(f)
        meta.update(edit)
        with open(mpath, "w") as f:
            json.dump(meta, f)
        with pytest.raises(exc, match="format"):
            PosePredictor.from_artifact(d, device="cpu")
        return
    assert load_serving_artifact(d).predictor_kwargs["act_scales"] == scales
    pred = PosePredictor.from_artifact(d, device="cpu")
    assert pred.int8_params is not None and pred.act_scales == scales
    assert pred.int8_act == bool(edit.get("int8_act"))
    people, scores = pred.predict_batch([np.zeros((64, 96, 3), np.uint8)])[0]
    assert len(people) == len(scores)


@pytest.mark.parametrize("mode", ["int8", "with_flip"])
def test_artifact_override_serves_like_jax(mode, tmp_path, monkeypatch):
    """An artifact recorded with int8 (its scales shipped) or with flip
    TTA, served by both packages with that mode overridden off: the
    same people (JAX's ``from_artifact(d, int8=False)`` drops the
    scales; the port's does too)."""
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")
    jcfg, _ = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    kw = (dict(packed=True, int8=True, act_scales={"stem/conv1": 1.0})
          if mode == "int8" else dict(with_flip=True))
    d = export_serving_artifact(str(tmp_path / "art"), variables, jcfg,
                                num_joints=NUM_JOINTS, input_size=128, **kw)
    off = {mode: False, "packed": False}
    jp = JaxPredictor.from_artifact(d, dtype=jnp.float32, fused_decode=True,
                                    **off)
    tp = PosePredictor.from_artifact(d, device="cpu", **off)
    assert jp.act_scales is None and not tp.packed
    img = (np.random.default_rng(3).random((100, 90, 3)) * 255).astype(
        np.uint8)
    _assert_same_people(tp.predict(img), jp.predict(img))


def test_artifact_recorded_with_flip_serves_like_jax(tmp_path, monkeypatch):
    """An artifact recorded with flip TTA serves as recorded in both
    packages (the canonical float32 forward): the same people."""
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")
    jcfg, _ = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    d = export_serving_artifact(str(tmp_path / "art"), variables, jcfg,
                                num_joints=NUM_JOINTS, input_size=128,
                                with_flip=True)
    jp = JaxPredictor.from_artifact(d, dtype=jnp.float32, fused_decode=True,
                                    packed=False)
    tp = PosePredictor.from_artifact(d, device="cpu", packed=False)
    assert jp.with_flip and tp.with_flip and tp.tta
    img = (np.random.default_rng(3).random((100, 90, 3)) * 255).astype(
        np.uint8)
    _assert_same_people(tp.predict(img), jp.predict(img))


def test_artifact_with_corrupt_weights_is_refused(weights, tmp_path):
    jcfg, _, variables = weights
    d = export_serving_artifact(str(tmp_path / "art"), variables, jcfg,
                                num_joints=jcfg.num_joints)
    with open(os.path.join(d, "weights.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(ValueError, match="sha256"):
        load_serving_artifact(d)


def test_get_packed_teacher_loads_a_reference_state_dict(tmp_path):
    """A reference-format state dict (fp16 ``network_to_half``, keys
    under ``"1."``) serves through the packed forward; with no path the
    weights are the seeded random ones."""
    model = init_random_(PoseHigherHRNet(w48_config()), seed=9).eval()
    path = str(tmp_path / "w48.pth.tar")
    torch.save({f"1.{k}": v.half() if v.is_floating_point() else v
                for k, v in model.state_dict().items()}, path)
    forward, pk = factory.get_packed_teacher(path, dtype=torch.float32,
                                             device="cpu")
    ref = {k: v.half().float() if v.is_floating_point() else v
           for k, v in model.state_dict().items()}
    want_pk = pack_w48_params(ref, w48_config(), torch.float32)
    assert pk.keys() == want_pk.keys()
    assert all(torch.equal(pk[k][0], want_pk[k][0]) for k in pk)
    model.load_state_dict(ref)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, 64, 64)).astype(np.float32))
    with torch.inference_mode():
        got, want = forward(pk, x), model(x)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= REL_TOL
    _, pk_a = factory.get_packed_teacher(device="cpu", dtype=torch.float32,
                                         seed=3)
    _, pk_b = factory.get_packed_teacher(device="cpu", dtype=torch.float32,
                                         seed=3)
    assert torch.equal(pk_a["final_1"][0], pk_b["final_1"][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory.get_packed_teacher()
