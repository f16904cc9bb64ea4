"""The port's training data path against the JAX package's, on the CPU.

On ``_make_coco_fixture`` (four 96 x 128 images, teacher ``.npz`` maps
written by ``rtpe_tpu.data.teacher_cache.save_teacher_prediction``),
64 x 64 crops on a 96 x 128 canvas, B=2:

* ``sample_affine_matrices``: bitwise JAX's for five seeds, with sources
  larger and smaller than the crop (the padded crop).
* ``TrainPipeline`` against ``rtpe_tpu.data.pipeline.TrainPipeline``
  with ``num_workers`` 1 and 3, ``compact_transfer`` True and False,
  with and without ``cache_dir``.  Both pipelines read the port's
  dataset (the datasets are held to each other in
  ``tests/test_torch_eval.py``), so every host array is bitwise JAX's:
  the canvases, the joints, the matrices and ``img_id``.  The planes
  before the warp are held to JAX's own ops on the same host batch:
  ``img`` and the rest within 1e-5, ``img_alt`` within 1e-3 (LAB spans
  0-100).  After the warp the outputs are held to JAX's pipeline within
  that plus the warp's coordinate bound: XLA contracts the inverse
  matrix's multiply-adds into FMAs and PyTorch does not, which moves a
  sample coordinate by up to 4 float32 ulps (3.1e-5 below 128,
  measured); COORD_TOL is twice that, times the plane's largest step
  between neighbouring pixels (a noise image's is ~4 after
  normalization).  The worst element of each plane is printed.
* JAX's own checks: shapes, the segmentation under the heatmaps
  (``tests/test_pipeline_ckpt.py:18-47``), determinism, the refusals
  (a canvas too small, non-binary masks in compact mode, a stale
  cache), and an abandoned epoch releases its threads.
* A cache that JAX's pipeline filled serves the port's pipeline bitwise
  without calling the dataset.
* The windowed renderer is bitwise the broadcast renderer it replaces.
* The slice as a whole: one batch of the port's dataset and pipeline
  through the port's train step against one of JAX's dataset and
  pipeline through JAX's step (unfused CAMs, float32): both losses
  within rtol 1e-4.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_data_eval import _make_coco_fixture

from rtpe_tpu.data import dataset as j_dataset
from rtpe_tpu.data import pipeline as j_pipeline
from rtpe_tpu.data import augment as j_augment
from rtpe_tpu.data import targets as j_targets
from rtpe_tpu.data.preprocess import normalize_image as j_normalize
from rtpe_tpu.data.teacher_cache import save_teacher_prediction
from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
from rtpe_tpu.ops import color as j_color
from rtpe_tpu.train import step as jstep
from rtpe_tpu_torch.data import (AugmentConfig, CocoDistillationDataset,
                                 TrainPipeline, sample_affine_matrices)
from rtpe_tpu_torch.data import pipeline as t_pipeline
from rtpe_tpu_torch.data.targets import render_heatmaps
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models.students import AttentionStudentSteps
from rtpe_tpu_torch.train import (DistillConfig, DistillTrainState,
                                  make_distill_train_step)

CANVAS, OUT, B = (96, 128), (64, 64), 2
COORD_TOL = 2 * 4 * 2.0 ** -18       # twice 4 ulps of a coordinate < 128
TOL = {"img": 1e-5, "img_alt": 1e-3, "mask": 1e-5, "segm_mask": 1e-5,
       "gt_hms": 1e-5, "teacher_hms": 1e-5, "teacher_ae": 1e-5}
NAMES = ("imgs", "masks", "segms", "t_hms", "t_ae", "joints", "mats",
         "img_ids")


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The fixture root, its teacher corpus and the port's dataset."""
    root = str(tmp_path_factory.mktemp("coco"))
    _make_coco_fixture(root, n_imgs=4, hw=CANVAS, jitter_per_image=True)
    teacher = os.path.join(root, "teacher")
    os.makedirs(teacher)
    rng = np.random.default_rng(0)
    for i in range(4):
        save_teacher_prediction(
            teacher, f"{1000 + i:012d}.jpg",
            rng.normal(size=(24, 32, 34)).astype(np.float32),
            rng.random((48, 64, 17)).astype(np.float32))
    ds = CocoDistillationDataset(root, "val2017", teacher,
                                 remove_images_without_annotations=True,
                                 gt_stddevs_pix=[2.0],
                                 host_gt_heatmaps=False)
    return root, teacher, ds


def _kw(**kw):
    return {**dict(batch_size=B, out_hw=OUT, sigma=2.0, canvas_hw=CANVAS,
                   seed=3), **kw}


@pytest.mark.parametrize("seed", range(5))
def test_sample_affine_matrices_bitwise_jax(seed):
    for in_hw in ((480, 640), (96, 128), (40, 30), (450, 300)):
        cfg = AugmentConfig(out_hw=(64, 64) if in_hw[0] < 200
                            else (450, 450))
        jcfg = j_augment.AugmentConfig(out_hw=cfg.out_hw)
        got = sample_affine_matrices(np.random.RandomState(seed), 6, in_hw,
                                     cfg)
        want = j_augment.sample_affine_matrices(
            np.random.RandomState(seed), 6, in_hw, jcfg)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert AugmentConfig() == AugmentConfig(**vars(j_augment.AugmentConfig()))


def _tensors(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays[:6]]


def _jax_planes(arrays, sigma=2.0):
    """The pre-warp planes by JAX's ops on the host batch."""
    imgs, masks, segms, t_hms, t_ae, joints = (jnp.asarray(a)
                                               for a in arrays[:6])
    imgs = (imgs.astype(jnp.float32) / 255.0 if imgs.dtype == jnp.uint8
            else imgs.astype(jnp.float32))
    return np.asarray(jnp.concatenate([
        j_normalize(imgs), j_color.rgb_to_lab(imgs),
        masks.astype(jnp.float32)[..., None],
        segms.astype(jnp.float32)[..., None],
        j_targets.render_heatmaps(joints, tuple(imgs.shape[1:3]), sigma),
        t_hms.astype(jnp.float32), t_ae.astype(jnp.float32)], axis=-1))


def _plane_slices():
    sizes = {"img": 3, "img_alt": 3, "mask": 1, "segm_mask": 1,
             "gt_hms": 17, "teacher_hms": 17, "teacher_ae": 17}
    out, c = {}, 0
    for k, n in sizes.items():
        out[k] = slice(c, c + n)
        c += n
    return out


def _steps(planes):
    """Largest step between neighbouring pixels, per channel, the warp's
    zero border included."""
    p = np.pad(planes, ((0, 0), (1, 1), (1, 1), (0, 0)))
    gx = np.abs(np.diff(p, axis=2)).max(axis=(0, 1, 2))
    gy = np.abs(np.diff(p, axis=1)).max(axis=(0, 1, 2))
    return gx + gy


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "f32"])
@pytest.mark.parametrize("workers", [1, 3])
def test_pipeline_matches_jax(coco, tmp_path, workers, compact, cached):
    _, _, ds = coco

    def both(tag):
        kw = _kw(num_workers=workers, compact_transfer=compact)
        jkw, tkw = dict(kw), dict(kw)
        if cached:
            jkw["cache_dir"] = str(tmp_path / f"j{tag}")
            tkw["cache_dir"] = str(tmp_path / f"t{tag}")
        return (j_pipeline.TrainPipeline(ds, **jkw),
                TrainPipeline(ds, device="cpu", **tkw))

    jp, tp = both("host")
    j_host, t_host = list(jp.host_batches()), list(tp.host_batches())
    assert len(t_host) == len(j_host) == len(tp) == 2
    for got, want in zip(t_host, j_host):
        for name, a, b in zip(NAMES, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)

    jp, tp = both("dev")
    j_batches, t_batches = list(jp), list(tp)
    sl = _plane_slices()
    for arrays, got, want in zip(t_host, t_batches, j_batches):
        planes = t_pipeline._augment_planes(*_tensors(arrays), (2.0,),
                                            "LAB").numpy()
        want_planes = _jax_planes(arrays)
        steps = _steps(planes)
        np.testing.assert_array_equal(got["img_id"], want["img_id"])
        assert isinstance(got["img_id"], np.ndarray)
        for name, s in sl.items():
            pre = float(np.abs(planes[..., s] - want_planes[..., s]).max())
            assert pre <= TOL[name], (name, pre)
            g, w = got[name].numpy(), np.asarray(want[name])
            assert g.shape == w.shape == (B, *OUT, s.stop - s.start)
            bound = TOL[name] + COORD_TOL * float(steps[s].max())
            worst = float(np.abs(g - w).max())
            print(f"{name}: worst {worst:.3g} (bound {bound:.3g}); "
                  f"before the warp {pre:.3g}")
            assert worst <= bound, (name, worst, bound)


def test_pipeline_batch_shapes_and_geometry(coco):
    _, _, ds = coco
    b = next(iter(TrainPipeline(ds, device="cpu", **_kw(seed=0))))
    assert set(b) == {"img", "img_alt", "mask", "segm_mask", "gt_hms",
                      "teacher_hms", "teacher_ae", "img_id"}
    for k, c in (("img", 3), ("img_alt", 3), ("gt_hms", 17), ("mask", 1),
                 ("teacher_hms", 17), ("teacher_ae", 17),
                 ("segm_mask", 1)):
        assert b[k].shape == (B, *OUT, c) and b[k].dtype == torch.float32
        assert torch.isfinite(b[k]).all()
    # the heatmaps sit on the segmentation: both went through one matrix
    from scipy.ndimage import binary_dilation
    hm = b["gt_hms"].amax(-1).numpy()
    seg = b["segm_mask"][..., 0].numpy()
    for i in range(B):
        if hm[i].max() > 0.5:
            ys, xs = np.where(hm[i] > 0.5)
            assert binary_dilation(seg[i] > 0.5, iterations=6)[ys, xs] \
                .mean() > 0.6


def test_pipeline_deterministic_with_seed(coco):
    _, _, ds = coco

    def run(seed, workers):
        pipe = TrainPipeline(ds, device="cpu",
                             **_kw(num_workers=workers, seed=seed))
        return torch.cat([b["img"] for b in pipe])

    a = run(1, 1)
    assert torch.equal(a, run(1, 1))
    assert (a - run(2, 1)).abs().max() > 0
    assert torch.equal(run(1, 3), run(1, 2))


class _SoftMask(CocoDistillationDataset):
    def __getitem__(self, idx):
        s = super().__getitem__(idx)
        s["mask"] = s["mask"] * 0.5
        return s


def test_pipeline_refusals(coco, tmp_path):
    root, teacher, ds = coco
    with pytest.raises(ValueError, match="exceeds"):
        next(TrainPipeline(ds, device="cpu", **_kw(canvas_hw=(64, 128)))
             .host_batches())
    soft = _SoftMask(root, "val2017", teacher,
                     remove_images_without_annotations=True,
                     host_gt_heatmaps=False)
    with pytest.raises(ValueError, match="non-binary"):
        next(TrainPipeline(soft, device="cpu", **_kw()).host_batches())
    b = next(TrainPipeline(soft, device="cpu",
                           **_kw(compact_transfer=False)).host_batches())
    assert b[1].max() == 0.5
    cache = str(tmp_path / "cache")
    TrainPipeline(ds, device="cpu", **_kw(cache_dir=cache))
    with pytest.raises(ValueError, match="different"):
        TrainPipeline(ds, device="cpu", **_kw(cache_dir=cache,
                                              canvas_hw=(128, 128)))
    np.save(os.path.join(cache, "joints.npy"), np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stale or corrupt"):
        TrainPipeline(ds, device="cpu", **_kw(cache_dir=cache))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainPipeline(ds, **_kw())


class _NoReads(CocoDistillationDataset):
    def __getitem__(self, idx):
        raise AssertionError("the cache should serve every sample")


def test_jax_filled_cache_serves_the_port(coco, tmp_path):
    root, teacher, ds = coco
    cache = str(tmp_path / "cache")
    jds = j_dataset.CocoDistillationDataset(
        root, "val2017", teacher, remove_images_without_annotations=True,
        gt_stddevs_pix=[2.0], host_gt_heatmaps=False)
    jp = j_pipeline.TrainPipeline(jds, **_kw(cache_dir=cache))
    want = list(jp.host_batches())
    files = {n: open(os.path.join(cache, n), "rb").read()
             for n in sorted(os.listdir(cache))}
    served = _NoReads(root, "val2017", teacher,
                      remove_images_without_annotations=True,
                      host_gt_heatmaps=False)
    tp = TrainPipeline(served, device="cpu", **_kw(cache_dir=cache))
    got = list(tp.host_batches())
    for g, w in zip(got, want):
        for name, a, b in zip(NAMES, g, w):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(list(tp)) == 2
    for n, data in files.items():
        with open(os.path.join(cache, n), "rb") as f:
            assert f.read() == data, f"{n} was rewritten"


def _broadcast_renderer(joints, out_hw, sigma):
    """The renderer the windowed one replaced (JAX's broadcast)."""
    h, w = out_hw
    x = joints[..., 0].to(torch.int32)
    y = joints[..., 1].to(torch.int32)
    vis = ((joints[..., 2] > 0) & (x >= 0) & (y >= 0) & (x < w) & (y < h))
    dx = torch.arange(w, dtype=torch.int32)[None, None, None, None, :] \
        - x[..., None, None]
    dy = torch.arange(h, dtype=torch.int32)[None, None, None, :, None] \
        - y[..., None, None]
    win = 3 * sigma + 1
    inside = (dx.abs() <= win) & (dy.abs() <= win) & vis[..., None, None]
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2) / (2.0 * sigma ** 2))
    g = torch.where(inside, g, torch.zeros(()))
    return g.amax(dim=1).permute(0, 2, 3, 1)


@pytest.mark.parametrize("sigma", [2.0, 7.0, 2.5])
def test_windowed_renderer_is_the_broadcast_one(sigma):
    rng = np.random.RandomState(int(sigma * 10))
    for hw in ((96, 128), (33, 21)):
        j = (rng.rand(3, 30, 17, 3) * [hw[1] * 1.2, hw[0] * 1.2, 1.0]
             - [5, 5, 0]).astype(np.float32)
        j[..., 2] = rng.rand(3, 30, 17) > 0.4
        j[0, 0, 0] = (-0.4, 10.0, 1.0)   # truncates onto column 0
        j[0, 0, 1] = (12.0, -0.9, 1.0)   # and onto row 0
        t = torch.from_numpy(j)
        got = render_heatmaps(t, hw, sigma)
        assert got.is_contiguous() and got.shape == (3, *hw, 17)
        assert torch.equal(got, _broadcast_renderer(t, hw, sigma))


def test_abandoned_epoch_releases_its_threads(coco):
    _, _, ds = coco
    before = threading.active_count()
    for workers in (1, 3):
        pipe = TrainPipeline(ds, device="cpu", **_kw(num_workers=workers,
                                                     prefetch=1))
        it = iter(pipe)
        next(it)
        it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before


# ------------------------------------------------- the slice as a whole

INPLANES, ALT = 8, 6


@pytest.fixture(scope="module")
def jax_student():
    model = JaxStudent(inplanes=INPLANES, alt_planes=ALT,
                       detach_att_for_det=True, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3))
    variables = model.init(jax.random.PRNGKey(0), x, x, train=False)
    return model, variables


def test_pipeline_and_step_match_jax(coco, jax_student):
    root, teacher, ds = coco
    model, variables = jax_student
    jds = j_dataset.CocoDistillationDataset(
        root, "val2017", teacher, remove_images_without_annotations=True,
        gt_stddevs_pix=[2.0], host_gt_heatmaps=False)
    jb = next(iter(j_pipeline.TrainPipeline(jds, **_kw())))
    jb.pop("img_id")
    cfg = jstep.DistillConfig()
    jstate = jstep.DistillTrainState.create(variables, cfg)
    _, jm = jstep.make_distill_train_step(model, cfg)(jstate, jb)

    tb = next(iter(TrainPipeline(ds, device="cpu", **_kw())))
    tb.pop("img_id")
    student = AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT,
                                    detach_att_for_det=True)
    student.load_state_dict(student_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    state = DistillTrainState.create(student.train(), DistillConfig())
    _, tm = make_distill_train_step(student, DistillConfig())(state, tb)
    for k in ("attention_loss", "keypoints_loss"):
        got, want = float(tm[k]), float(jm[k])
        print(f"{k}: port {got!r} JAX {want!r}")
        assert got == pytest.approx(want, rel=1e-4), k
