"""The port's three command-line entry points, in-process on the CPU.

Each ``main(argv)`` runs on ``_make_coco_fixture`` (two 96 x 128
images) with ``--device cpu --input_size 128`` and a reference-format
``.pth.tar`` of the full-width W48, written from a seeded state dict
(both packages' ``get_hrnet_w48_teacher`` read it).  Its final layers
are rescaled: the tags to a hundredth, and the heatmaps to
``(raw - 193) / 71``, which puts about the top 1 % of pixels above the
detection threshold (a few live peaks a plane).

* ``validate_hhrnet``: the port's people against the same library calls
  of ``rtpe_tpu`` that ``scripts/validate_hhrnet.py`` makes, in float32
  (the JAX script itself forwards in bf16), with both host groupings on
  the same assignment solver (native where both libraries load, else
  scipy).  As in ``tests/test_torch_slice.py``, the test first
  asserts that the two forwards' maps agree within HM_TOL / TAG_TOL and
  that every decision the decode takes on them has a margin of more
  than 10 x HM_TOL; the people must then agree within 1e-3.  W48 is
  far deeper than that test's model, so HM_TOL is its float32 sum-order
  spread here (the maps are offsets of raw values near 200).  The
  stats must equal JAX's ``ds.evaluate`` of the port's people.
* ``teacher_inference``: the ``.npz`` files against the ones
  ``rtpe_tpu.data.teacher_cache.save_teacher_prediction`` writes from
  the JAX float32 forward: the same members in the same order, the
  joint names byte-equal, the maps within OUT_TOL of their largest
  magnitude.
* ``realtime_demo``: the stats line has the JAX script's keys.
* The int8 flags run (``--int8`` / ``--int8_act`` / ``--act_scales``,
  the scale files read by JAX's loader); the missing-model refusal and
  the JAX scripts' int8 parser errors exit with status 2, and the
  default device is CUDA.
"""

import ast
import json
import os
import zipfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from test_data_eval import _make_coco_fixture

from rtpe_tpu.data import dataset as j_dataset
from rtpe_tpu.data import preprocess as j_pre
from rtpe_tpu.data import teacher_cache as j_cache
from rtpe_tpu.decode import HeatmapParser as JaxParser
from rtpe_tpu.models import hrnet_packed as j_packed
from rtpe_tpu.models.factory import get_hrnet_w48_teacher as jax_teacher
from rtpe_tpu.ops.resize import resize_bilinear as j_resize
from rtpe_tpu_torch.cli import realtime_demo, teacher_inference
from rtpe_tpu_torch.cli import validate_hhrnet
from rtpe_tpu_torch.cli.common import model_input
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.models import PoseHigherHRNet, init_random_, w48_config
from rtpe_tpu_torch.ops.resize import resize_bilinear
from test_torch_native import same_solver  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HM_TOL = 1.5e-5
TAG_TOL = 3e-5
MARGIN = 10 * HM_TOL
TOL = 1e-3
OUT_TOL = 1e-5
SEED, HM_SHIFT, HM_SCALE, TAG_SCALE = 1, 193.0, 1.0 / 71.0, 0.01


@pytest.fixture(scope="module")
def w48_path(tmp_path_factory):
    model = init_random_(PoseHigherHRNet(w48_config()), seed=SEED)
    sd = model.state_dict()
    with torch.no_grad():
        sd["final_layers.1.weight"] *= HM_SCALE
        sd["final_layers.1.bias"].sub_(HM_SHIFT).mul_(HM_SCALE)
        sd["final_layers.0.weight"][17:] *= TAG_SCALE
        sd["final_layers.0.bias"][17:] *= TAG_SCALE
    path = str(tmp_path_factory.mktemp("w48") / "w48.pth.tar")
    torch.save(sd, path)
    return path


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    _make_coco_fixture(root, n_imgs=2, hw=(96, 128))
    return root


@pytest.fixture(scope="module")
def jax_forward(w48_path):
    """The JAX package's float32 packed W48 forward on the same file."""
    model, variables = jax_teacher(w48_path, dtype=jnp.float32)
    cfg = model.cfg
    pk = j_packed.pack_w48_params(variables, cfg, dtype=jnp.float32)
    # the weights as an argument, not as constants folded into the program
    fwd = jax.jit(lambda p, x: j_packed.packed_forward(p, x, cfg,
                                                       dtype=jnp.float32))
    return lambda x: fwd(pk, x)


def _common(coco_root, w48_path):
    return ["--device", "cpu", "--input_size", "128", "-m", w48_path]


def _assert_margins(hms: np.ndarray, det_thr: float = 0.1, k: int = 30):
    """``tests/test_torch_slice.py``'s margin rule at this HM_TOL."""
    t = torch.from_numpy(np.array(hms)).permute(0, 3, 1, 2)
    pooled = F.max_pool2d(t, 5, 1, 2)
    peaks = torch.where(pooled == t, t, torch.zeros(()))
    vals = torch.sort(peaks.flatten(2), dim=-1, descending=True).values
    relevant = t > det_thr - MARGIN
    near_peak = (pooled != t) & (pooled - t < MARGIN)
    assert not (near_peak & relevant).any(), "peak test within margin"
    top = vals[..., :k + 1]
    live = top > det_thr - MARGIN
    assert int(live.sum()) > 20, "too few live peaks to test the decode"
    assert not (live & ((top - det_thr).abs() < MARGIN)).any()
    gaps = top[..., :-1] - top[..., 1:]
    assert not (live[..., :-1] & (gaps < MARGIN)).any(), "top-k order"


def test_validate_matches_jax_library_calls(coco_root, w48_path, jax_forward,
                                           monkeypatch, capsys,
                                           same_solver):  # noqa: F811
    argv = ["--coco_dir", coco_root, "--save_every", "0",
            *_common(coco_root, w48_path)]
    res = validate_hhrnet.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res.stats and len(printed) == 10

    # the JAX script's calls (validate_hhrnet.py:178-227), float32
    ds_j = j_dataset.CocoDistillationDataset(coco_root, "val2017",
                                             host_gt_heatmaps=False)
    samples = [ds_j[i] for i in range(len(ds_j))]
    xb = np.stack([j_pre.normalize_image(j_pre.resize_align_multi_scale(
        s["img"] * 255.0, 128, 1, 1)[0] / 255.0) for s in samples])
    coarse, refined = jax_forward(jnp.asarray(xb))
    hms_j = j_resize(refined[..., :17].astype(jnp.float32), (96, 128))
    aes_j = j_resize(coarse[..., 17:].astype(jnp.float32), (96, 128))
    parser = JaxParser(num_joints=17, max_num_people=30)
    grouped, scores = parser.parse_batch(hms_j, aes_j, adjust=True,
                                         refine=True)

    # the maps the port decoded, by its own library calls
    pred = PosePredictor(PoseHigherHRNet(w48_config()),
                         torch.load(w48_path), device="cpu",
                         input_size=128, packed=True)
    with torch.inference_mode():
        x = torch.stack([model_input(s["img"] * 255.0, 128, "cpu")
                         for s in samples])
        c_t, r_t = pred._forward_nhwc(x)
        hms_t = resize_bilinear(r_t[..., :17], (96, 128))
        aes_t = resize_bilinear(c_t[..., 17:], (96, 128))
    np.testing.assert_allclose(hms_t.numpy(), np.asarray(hms_j), rtol=0,
                               atol=HM_TOL)
    np.testing.assert_allclose(aes_t.numpy(), np.asarray(aes_j), rtol=0,
                               atol=TAG_TOL)
    _assert_margins(np.asarray(hms_j))

    assert len(res.preds) == len(grouped) == 2
    for people_t, scores_t, people_j, scores_j in zip(
            res.preds, res.scores, grouped, scores):
        people_j = [p for p in people_j if np.asarray(p).size > 0]
        assert len(people_t) == len(people_j) > 0
        np.testing.assert_allclose(scores_t, scores_j, rtol=0, atol=TOL)
        for pt, pj in zip(people_t, people_j):
            np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
    assert res.stats == ds_j.evaluate(res.preds, res.scores)


@pytest.mark.parametrize("extra", [["--flip", "--scales", "1,2",
                                    "--ae_mode", "first", "--max_images",
                                    "1"],
                                   ["--no-packed", "--ae_mode", "mean",
                                    "--batch_size", "1"]])
def test_validate_options_run(coco_root, w48_path, extra):
    res = validate_hhrnet.main(["--coco_dir", coco_root, "--save_every",
                                "0", *_common(coco_root, w48_path), *extra])
    assert len(res.stats) == 10
    assert all(np.isfinite(v) for v in res.stats.values())
    assert len(res.preds) == (1 if "--max_images" in extra else 2)


def _images(coco_root):
    d = os.path.join(coco_root, "images", "val2017")
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def test_teacher_inference_matches_jax_corpus(coco_root, w48_path,
                                              jax_forward, tmp_path):
    from PIL import Image
    paths = _images(coco_root)
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    info = teacher_inference.main(["-I", *paths, "-o", out_t, "-m", w48_path,
                                   "-C", "--input_size", "128"])
    assert info["images"] == 2
    # the JAX script's calls (teacher_inference.py:99-175), float32
    os.makedirs(out_j)
    xs = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), dtype=np.float32)
        xs.append(j_pre.normalize_image(j_pre.resize_align_multi_scale(
            img, 128, 1, 1)[0] / 255.0))
    coarse, refined = jax_forward(jnp.asarray(np.stack(xs)))
    coarse, refined = (np.asarray(coarse, np.float32),
                       np.asarray(refined, np.float32))
    for k, p in enumerate(paths):
        name = os.path.basename(p)
        want = j_cache.save_teacher_prediction(out_j, name, coarse[k],
                                               refined[k])
        got = j_cache.prediction_path(out_t, name)
        with zipfile.ZipFile(got) as zg, zipfile.ZipFile(want) as zw:
            assert zg.namelist() == zw.namelist()
            assert zg.read("heatmaps_order.npy") == \
                zw.read("heatmaps_order.npy")
        npz_t, npz_j = np.load(got), np.load(want)
        for key in ("pred_heatmaps", "embeddings", "heatmaps_refined"):
            a, b = npz_t[key], npz_j[key]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.abs(a - b).max() <= OUT_TOL * np.abs(b).max(), key
        assert npz_t["pred_heatmaps"].shape == (17, 32, 48)
        assert npz_t["heatmaps_refined"].shape == (17, 64, 96)


def _jax_script_stats_keys():
    """The keys of the ``stats`` dict literal in the JAX script."""
    with open(os.path.join(REPO, "scripts", "realtime_demo.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "stats"
                        for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError("no stats dict in scripts/realtime_demo.py")


@pytest.mark.parametrize("flip", [False, True])
def test_realtime_demo_stats_have_the_jax_keys(coco_root, w48_path, capsys,
                                               flip):
    argv = ["-I", *_images(coco_root), "-m", w48_path, "-C",
            "--input_size", "128", "--loops", "2"] + (["--flip"] if flip
                                                       else [])
    stats = realtime_demo.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == stats
    assert list(stats) == _jax_script_stats_keys()
    assert stats["frames"] == 4 and stats["flip"] is flip
    assert stats["backend"] == "cpu" and stats["path"] == "packed"


def test_refusals_exit_with_status_2(coco_root, tmp_path, capsys, caplog):
    missing = str(tmp_path / "absent.pth.tar")
    img = _images(coco_root)[0]
    runs = [
        (validate_hhrnet.main, ["--coco_dir", coco_root, "-m", missing,
                                "--device", "cpu"], "not found"),
        (teacher_inference.main, ["-I", img, "-o", str(tmp_path), "-m",
                                  missing, "-C"], "not found"),
        (realtime_demo.main, ["-I", img, "-m", missing, "-C"], "not found"),
        (validate_hhrnet.main, ["--coco_dir", coco_root, "--int8",
                                "--no-packed"], "--int8 requires --packed"),
        (validate_hhrnet.main, ["--coco_dir", coco_root, "--int8_act"],
         "--int8_act requires --int8"),
        (teacher_inference.main, ["-I", img, "-o", str(tmp_path), "-m",
                                  missing, "--int8", "--no-packed"],
         "--int8 requires --packed"),
        (realtime_demo.main, ["-I", img, "-m", missing, "--int8_act"],
         "--int8_act requires --int8"),
    ]
    for main, argv, msg in runs:
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2, argv
        # the missing-model refusal is logged, the int8 ones the parser's
        assert msg in capsys.readouterr().err + caplog.text, argv


@pytest.mark.parametrize("cli", ["validate_int8", "validate_int8_act",
                                 "teacher_int8", "demo_int8"])
def test_int8_flags_run(cli, coco_root, w48_path, tmp_path, capsys):
    """The int8 flags of the three CLIs, run on the CPU: ten stats, the
    ``.npz`` files with the scales written to ``--act_scales`` (and read
    by JAX's loader), and a stream calibrated on its frames whose scale
    file the JAX loader reads, with ``routed_bf16`` set."""
    imgs = _images(coco_root)
    scales = str(tmp_path / "scales.json")
    if cli.startswith("validate"):
        flags = ["--int8"] + (["--int8_act"] if cli.endswith("act") else [])
        res = validate_hhrnet.main(["--coco_dir", coco_root, "--save_every",
                                    "0", *flags, *_common(coco_root,
                                                          w48_path)])
        assert len(res.stats) == 10
        assert all(np.isfinite(v) for v in res.stats.values())
        return
    if cli == "teacher_int8":
        out = str(tmp_path / "npz")
        teacher_inference.main(["-I", *imgs, "-o", out, "--int8",
                                "--act_scales", scales,
                                *_common(coco_root, w48_path)])
        assert len(os.listdir(out)) == len(imgs)
    else:
        stats = realtime_demo.main(["-I", *imgs, "--int8", "--act_scales",
                                    scales, *_common(coco_root, w48_path)])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == stats and stats["routed_bf16"] is True
        assert stats["path"] == "int8" and list(stats) == \
            _jax_script_stats_keys()
    assert len(j_packed.load_act_scales(scales)) == 303 + 65


def test_the_default_device_is_cuda(coco_root, w48_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        realtime_demo.main(["-I", _images(coco_root)[0], "-m", w48_path])
