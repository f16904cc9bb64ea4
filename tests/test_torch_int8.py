"""The port's int8 serving against the JAX package's, on the CPU.

Same seeded numpy weights on both sides (``test_torch_model``'s small
HigherHRNet), float32 activations:

* ``calibrate_act_scales``, with absmax and with ``percentile=99.9``:
  the same keys (one a conv, ``":out"`` for the fuse convs) and values
  within CALIB_RTOL relative (measured 8.3e-7: the float32 forwards sum
  in another order);
* ``quantize_packed`` on the same folded weights: every int8 kernel equal
  to JAX's after the layout map, ``alpha``, ``inv_sx`` and ``inv_sy``
  bitwise.  JAX's row-packed transposed conv quantizes per output-row
  parity (each parity reads its own taps), and so does the port;
* the ``int8`` and ``int8_act`` forwards fed JAX's scales: every conv's
  int32 sums equal XLA's on the same int8 input, and the whole output
  bitwise equal to JAX's row-packed int8 forward (measured: the int32
  sums are exact, and the float32 steps around them are the same IEEE
  operations in the same order);
* the census of stored activations equal to JAX's ``STORE_TAP``, by
  consumer, size and dtype, in all three modes;
* the int8 predictors' people against JAX's on the scene of
  ``test_torch_slice``, both fed JAX's preprocessed images (the
  preprocessings differ by ~7e-7, which the first quantize can turn
  into a whole int8 step): the heatmaps bitwise equal, so the decode
  takes the same decisions without a margin, the resized tags within
  TAG_TOL, the people within 1e-3; the
  routing of each shape group, every refusal, and scale files read
  across the packages, including the JAX demo's swapped
  ``save_act_scales`` arguments.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpe_tpu.decode import fused as j_fused
from rtpe_tpu.eval.predictor import PosePredictor as JaxPredictor
from rtpe_tpu.models import PoseHigherHRNet as JaxHRNet
from rtpe_tpu.models import hrnet_packed as j_packed
from rtpe_tpu.ops import rowpack as rp
from rtpe_tpu_torch.cli import realtime_demo
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.eval import predictor as predictor_mod
from rtpe_tpu_torch.io import folded_params_from_jax, state_dict_from_jax
from rtpe_tpu_torch.models import PoseHigherHRNet
from rtpe_tpu_torch.models import hrnet_packed as packed
from rtpe_tpu_torch.ops import quant
from test_torch_model import seeded_variables, small_cfgs
from test_torch_slice import (IMAGE_HW, NUM_JOINTS, TAG_TOL,
                              _assert_same_people)

CALIB_RTOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    """The small model's variables, both packages' float32 folded
    params, calibration batches and JAX's absmax scales."""
    jcfg, tcfg = small_cfgs()
    variables = seeded_variables(jcfg, seed=6, in_hw=(64, 96))
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
          for _ in range(2)]
    pk_j = j_packed.pack_w48_params(variables, jcfg, dtype=jnp.float32)
    scales = j_packed.calibrate_act_scales(
        pk_j, [jnp.asarray(x) for x in xs], jcfg, dtype=jnp.float32)
    fold_j = jax.device_get(j_packed.fold_w48_params(variables, jcfg))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, xs=xs,
                pk_j=pk_j, scales=scales, fold_j=fold_j,
                pk_t=folded_params_from_jax(fold_j, tcfg))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibration_matches_jax(model, percentile):
    m = model
    want = (m["scales"] if percentile is None
            else j_packed.calibrate_act_scales(
                m["pk_j"], [jnp.asarray(x) for x in m["xs"]], m["jcfg"],
                dtype=jnp.float32, percentile=percentile))
    pk = packed.pack_w48_params(state_dict_from_jax(m["variables"],
                                                    m["tcfg"]),
                                m["tcfg"], torch.float32)
    got = packed.calibrate_act_scales(pk, [_nchw(x) for x in m["xs"]],
                                      m["tcfg"], torch.float32,
                                      percentile=percentile)
    assert got.keys() == want.keys()
    assert len([k for k in got if k.endswith(":out")]) == 19
    assert set(packed.conv_names(pk)) == {k for k in got
                                          if not k.endswith(":out")}
    for k, v in want.items():
        assert abs(got[k] - v) <= CALIB_RTOL * abs(v), (k, got[k], v)


def _port_kernel_as_jax(q: quant.QConv) -> np.ndarray:
    """A port kernel (cout, kh, kw, cpad) back in JAX's HWIO (the
    transposed conv's unflipped (kh, kw, in, out))."""
    k = q.kernel[..., :q.cin]
    if q.transposed:
        k = k.flip(1, 2)
    return k.permute(1, 2, 3, 0).numpy()


def test_quantize_packed_matches_jax(model):
    m = model
    want = j_packed.quantize_packed(j_packed.fold_w48_params(
        m["variables"], m["jcfg"]), m["scales"])
    tconv = "deconv0_tconv"
    want_rowpacked = j_packed.quantize_packed({tconv: m["pk_j"][tconv]},
                                              m["scales"])
    got = packed.quantize_packed(m["pk_t"], m["scales"])
    assert got.keys() == want.keys()
    for name, q in got.items():
        j = want[name]
        kernel = _port_kernel_as_jax(q)
        alpha = q.alpha.numpy()
        if q.transposed:
            # JAX's row-packed kernel: per output-row parity scales
            j = want_rowpacked[name]
            c0 = m["jcfg"].stage2.num_channels[0]
            kernel = np.asarray(rp.pack_tconv4x4s2_pp(
                jnp.asarray(kernel), (c0, q.cin - c0)))
            alpha = alpha.reshape(-1)
        np.testing.assert_array_equal(kernel, np.asarray(j.kernel),
                                      err_msg=name)
        np.testing.assert_array_equal(alpha, np.asarray(j.alpha),
                                      err_msg=name)
        assert q.inv_sx.numpy() == np.float32(j.inv_sx)
        assert (q.inv_sy is None) == (j.inv_sy is None)
        if q.inv_sy is not None:
            assert q.inv_sy.numpy() == np.float32(j.inv_sy)
        np.testing.assert_array_equal(
            q.bias.numpy(), np.asarray(j.bias)[:q.bias.numel()])
        assert q.kernel.dtype == torch.int8 and q.kernel.is_contiguous()


def _xla_int32(q: quant.QConv, xq: torch.Tensor, stride: int) -> np.ndarray:
    hwio = _port_kernel_as_jax(q)
    kh = hwio.shape[0]
    if q.transposed:
        args = ((1, 1), ((2, 2), (2, 2)), (2, 2))
        hwio = hwio[::-1, ::-1]
    else:
        p = (kh - 1) // 2
        args = ((stride, stride), ((p, p), (p, p)), None)
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(np.ascontiguousarray(hwio)), args[0], args[1],
        lhs_dilation=args[2], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("int8_act", [False, True])
def test_int8_forward_matches_jax(model, monkeypatch, int8_act):
    m = model
    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = j_packed.packed_forward(
        j_packed.quantize_packed(m["pk_j"], m["scales"]), jnp.asarray(x),
        m["jcfg"], dtype=jnp.float32, int8_act=int8_act)
    qp = packed.quantize_packed(m["pk_t"], m["scales"])
    calls = []

    def recording_qconv(xin, q, stride=1, padding=None):
        xq = xin if xin.dtype == torch.int8 else quant.quantize_act(
            xin, q.inv_sx)
        acc = quant.qconv_int32_plain(xq, q, stride, padding)
        calls.append((q, xq, stride, acc))
        return quant.dequantize(acc, q)

    monkeypatch.setattr(packed, "qconv", recording_qconv)
    with torch.inference_mode():
        got = packed.packed_forward(qp, _nchw(x), m["tcfg"], torch.float32,
                                    int8_act=int8_act)
    assert len(calls) == len(qp)            # each quantized conv once
    for q, xq, stride, acc in calls:
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                      _xla_int32(q, xq, stride))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == np.shape(w) and np.abs(g).max() > 0.1
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("int8_act", [False, True])
def test_int8_forward_with_consumers_apart_matches_jax(model, int8_act):
    """A scale set (as a scale file can hold) where two consumers of one
    tensor quantize it at different scales: the port's graph, which
    stores an int8 copy at one consumer's scale, makes the other's
    itself, and stays bitwise JAX's forward."""
    m = model
    scales = dict(m["scales"])
    for name, f in (("layer1_0/downsample", 1.5), ("transition2_2_0", 0.75)):
        assert name in scales
        scales[name] *= f
    x = np.random.default_rng(5).normal(size=(1, 64, 96, 3)).astype(
        np.float32)
    want = j_packed.packed_forward(
        j_packed.quantize_packed(m["pk_j"], scales), jnp.asarray(x),
        m["jcfg"], dtype=jnp.float32, int8_act=int8_act)
    qp = packed.quantize_packed(m["pk_t"], scales)
    assert qp["layer1_0/downsample"].inv_sx_value \
        != qp["layer1_0/conv1"].inv_sx_value
    with torch.inference_mode():
        got = packed.packed_forward(qp, _nchw(x), m["tcfg"], torch.float32,
                                    int8_act=int8_act)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(w))


@pytest.mark.parametrize("mode", ["float", "int8", "int8_act"])
def test_store_census_matches_jax(model, mode):
    m = model
    x = np.random.default_rng(4).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    pk_j, pk_t = m["pk_j"], m["pk_t"]
    if mode != "float":
        pk_j = j_packed.quantize_packed(pk_j, m["scales"])
        pk_t = packed.quantize_packed(pk_t, m["scales"])
    ia = mode == "int8_act"
    j_packed.STORE_TAP = []
    try:
        j_packed.packed_forward(pk_j, jnp.asarray(x), m["jcfg"],
                                dtype=jnp.float32, int8_act=ia)
        tap = j_packed.STORE_TAP
    finally:
        j_packed.STORE_TAP = None
    census = []
    with torch.inference_mode():
        packed.packed_forward(pk_t, _nchw(x), m["tcfg"], torch.float32,
                              int8_act=ia, census=census)
    want = [(c, int(np.prod(s)), d) for c, s, d in tap]
    got = [(c, int(np.prod(s)), str(d).replace("torch.", ""))
           for c, s, d in census]
    assert got == want
    n_int8 = sum(d == "int8" for _, _, d in got)
    assert (n_int8 > 0) == ia


@pytest.fixture(scope="module")
def scene():
    """``test_torch_slice``'s scene and model, JAX's int8 predictors with
    their scales calibrated (bf16, as JAX does) on the scene's images,
    serving JAX's float32 row-packed int8 forward, op by op."""
    jcfg, tcfg = small_cfgs(NUM_JOINTS)
    variables = seeded_variables(jcfg, seed=22, gain=0.8)
    rng = np.random.default_rng(0)
    images = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
              for h, w in IMAGE_HW]
    jps = {}
    pk32 = j_packed.pack_w48_params(variables, jcfg, dtype=jnp.float32)
    calib = dict(calibration_images=images)
    for ia in (False, True):
        jp = JaxPredictor(JaxHRNet(cfg=jcfg, dtype=jnp.float32), variables,
                          num_joints=NUM_JOINTS, input_size=128,
                          fused_decode=True, packed=True, int8=True,
                          int8_act=ia, int8_min_batch=0, **calib)
        calib = dict(act_scales=jp.act_scales)
        qp = j_packed.quantize_packed(pk32, jp.act_scales)
        # op by op: under jit XLA fuses the float steps around the int32
        # sums and rounds them otherwise, by ulps that a later quantize
        # can turn into whole int8 steps
        jp._fwd = (lambda x, qp=qp, ia=ia: j_packed.packed_forward(
            qp, x, jcfg, dtype=jnp.float32, int8_act=ia))
        jps[ia] = jp
    return jcfg, tcfg, variables, images, jps


def _port_predictor(scene, int8_act, **kw):
    _, tcfg, variables, _, jps = scene
    kw.setdefault("int8_min_batch", 0)
    return PosePredictor.from_jax(
        variables, tcfg, device="cpu", num_joints=NUM_JOINTS,
        input_size=128, packed=True, int8=True, int8_act=int8_act,
        act_scales=jps[int8_act].act_scales, dtype=torch.float32, **kw)


@pytest.mark.parametrize("int8_act", [False, True])
def test_int8_predictor_matches_jax(scene, monkeypatch, int8_act):
    monkeypatch.setattr(j_fused, "_resolve_auto_lap",
                        lambda *a, **k: "lockstep_interpret")
    images = scene[3][:2]                 # a decode compile a shape
    jp = scene[4][int8_act]
    tp = _port_predictor(scene, int8_act)
    assert tp.act_scales == jp.act_scales and tp.int8_act == int8_act

    def jax_preprocess(im):
        x, center, scale = jp._preprocess(im)
        return torch.from_numpy(np.asarray(x)), center, scale

    # the two preprocessings differ by ~7e-7, which the first quantize
    # turns into whole int8 steps: both forwards get JAX's input
    monkeypatch.setattr(tp, "_preprocess", jax_preprocess)
    for im in images:
        x_j, _, _ = jp._preprocess(im)
        hms_j, tags_j = jp._decode_outputs(*jp._fwd(jnp.asarray(x_j[None])))
        with torch.inference_mode():
            x_t, _, _ = tp._preprocess(im)
            hms_t, tags_t = tp._decode_outputs(*tp._forward(x_t[None]))
        # bitwise: the decode's peak and top-k decisions are the same ones
        # (quantized heatmaps hold exact ties, which both decodes break
        # by the flat index), so no margin is needed on them
        np.testing.assert_array_equal(hms_t.numpy(), np.asarray(hms_j))
        np.testing.assert_allclose(tags_t.numpy(), np.asarray(tags_j),
                                   rtol=0, atol=TAG_TOL)
    out_t, out_j = tp.predict_batch(images), jp.predict_batch(images)
    assert len(out_t) == len(out_j) == len(images)
    for rt, rj in zip(out_t, out_j):
        _assert_same_people(rt, rj)


def test_int8_routes_each_shape_group(scene, monkeypatch):
    """Shape groups below ``int8_min_batch`` are served by the float
    packed params, the others quantized; ``predict`` and ``stream`` count
    as batches of 1.  The people equal those of the predictor serving
    every call quantized, or of the float packed predictor."""
    _, tcfg, variables, images, _ = scene
    served = []
    real = predictor_mod.packed_forward

    def spy(pk, x, *a, **k):
        served.append((x.shape[0], any(isinstance(v, quant.QConv)
                                       for v in pk.values())))
        return real(pk, x, *a, **k)

    routed = _port_predictor(scene, False, int8_min_batch=2)
    quantized = _port_predictor(scene, False)
    floats = PosePredictor.from_jax(variables, tcfg, device="cpu",
                                    num_joints=NUM_JOINTS, input_size=128,
                                    packed=True, dtype=torch.float32)
    # the second and third images share their post-resize shape
    batch = [images[0], images[1], images[1], images[2]]
    monkeypatch.setattr(predictor_mod, "packed_forward", spy)
    out = routed.predict_batch(batch)
    groups = sorted(served)
    assert groups == [(1, False), (1, False), (2, True)], groups
    assert not routed.routes_to_bf16(2) and routed.routes_to_bf16(1)
    served.clear()
    one = routed.predict(images[0])
    streamed = list(routed.stream(images[:2]))
    assert served == [(1, False)] * 3
    monkeypatch.setattr(predictor_mod, "packed_forward", real)
    want_q = quantized.predict_batch(batch)
    want_f = floats.predict_batch(batch)
    for i, got in enumerate(out):
        _assert_same_people(got, (want_q if i in (1, 2) else want_f)[i],
                            tol=0)
    _assert_same_people(one, want_f[0], tol=0)
    for got, want in zip(streamed, floats.predict_batch(images[:2])):
        _assert_same_people(got, want, tol=0)


def _tiny(**kw):
    return PosePredictor(PoseHigherHRNet(small_cfgs()[1]), device="cpu",
                         num_joints=5, input_size=64, **kw)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(int8=True, allow_synthetic_calibration=True), ValueError,
     "requires packed=True"),
    (dict(packed=True, int8_act=True), ValueError, "requires int8=True"),
    (dict(packed=True, int8=True, act_scales={"conv1": 1.0},
          calibration_images=[np.zeros((8, 8, 3))]), ValueError,
     "mutually exclusive"),
    (dict(packed=True, int8=True), ValueError,
     "allow_synthetic_calibration=True"),
    (dict(packed=True, int8=True, act_scales={"conv1": 1.0}), ValueError,
     "act_scales is missing"),
    (dict(packed=True, mesh=object()), NotImplementedError, "later slice"),
])
def test_int8_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        _tiny(**kw)


def test_packed_forward_refusals(model):
    m = model
    qp = packed.quantize_packed(m["pk_t"], m["scales"])
    x = torch.zeros((1, 3, 64, 64))
    with pytest.raises(ValueError, match="bf16-only"):
        packed.packed_forward(qp, x, m["tcfg"], torch.float32,
                              pallas_chains=True)
    with pytest.raises(ValueError, match="bf16-only"):
        packed.packed_forward(m["pk_t"], x, m["tcfg"], torch.float32,
                              pallas_chains=True, int8_act=True)
    with pytest.raises(ValueError, match="QConv entries"):
        packed.packed_forward(m["pk_t"], x, m["tcfg"], torch.float32,
                              int8_act=True)


def test_synthetic_calibration_covers_every_conv():
    pred = _tiny(packed=True, int8=True, allow_synthetic_calibration=True,
                 int8_min_batch=0)
    names = packed.conv_names(pred.packed_params)
    assert set(pred.int8_params) == set(names)
    assert set(pred.act_scales) >= set(names)
    assert all(v > 0 for v in pred.act_scales.values())
    people, scores = pred.predict(np.zeros((40, 30, 3), np.uint8))
    assert len(people) == len(scores)


def test_scale_files_cross_read(model, tmp_path):
    scales = model["scales"]
    port_file, jax_file = str(tmp_path / "port.json"), str(tmp_path / "j.json")
    packed.save_act_scales(port_file, scales)
    j_packed.save_act_scales(jax_file, scales)
    assert j_packed.load_act_scales(port_file) == scales
    assert packed.load_act_scales(jax_file) == scales
    with open(port_file) as f, open(jax_file) as g:
        assert f.read() == g.read()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not an activation-scale file"):
        packed.load_act_scales(str(bad))
    payload = json.loads(open(port_file).read())
    payload["num_entries"] += 1
    bad.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="truncated"):
        packed.load_act_scales(str(bad))


def test_jax_demo_swaps_save_act_scales_and_the_port_does_not(tmp_path):
    """``scripts/realtime_demo.py:133`` passes ``save_act_scales`` the
    scales first and the path second, which raises; the port's demo
    calibrates on the frames, writes the file, and JAX reads it."""
    with open(os.path.join(REPO, "scripts", "realtime_demo.py")) as f:
        assert "save_act_scales(pred.act_scales, args.act_scales)" in f.read()
    path = str(tmp_path / "scales.json")
    with pytest.raises(AttributeError):
        j_packed.save_act_scales({"conv1": 1.0}, path)
    frames = [(np.random.default_rng(i).random((64, 48, 3)) * 255).astype(
        np.uint8) for i in range(3)]
    args = argparse.Namespace(device="cpu", input_size=64, packed=True,
                              int8=True, int8_act=False, act_scales=path,
                              flip=False)
    model = PoseHigherHRNet(small_cfgs()[1])
    pred = realtime_demo.make_predictor(model, frames, args)
    assert j_packed.load_act_scales(path) == pred.act_scales
    again = realtime_demo.make_predictor(model, frames, args)
    assert again.act_scales == pred.act_scales       # read, not calibrated
    assert again.routes_to_bf16(1)
