"""The port's COCO data and evaluation layer against the JAX package.

* ``KeypointEvaluator``: the ten stats ``==`` to ``rtpe_tpu``'s on the
  100 randomized scenes of ``tests/test_cocoeval_differential.py``.
* RLE encode / decode and ``segmentation_to_mask``: bitwise on random
  masks, uncompressed counts and a polygon.
* ``CocoDistillationDataset`` on ``_make_coco_fixture``: every key of
  every sample equal to JAX's (with and without teacher maps), the
  ``img_alt`` planes (LAB, HSV) and the refusal of another colorspace,
  and the evaluation cases of
  ``tests/test_data_eval.py`` (perfect, a missing person, crowds, jitter,
  mismatched ids) with the same stats as JAX on the same predictions.
* ``HeatmapGenerator`` / ``render_heatmaps``, ``resize_bilinear_np``,
  the teacher ``.npz`` corpus both ways (members byte-equal), the
  minival split and the heatmap grid.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_cocoeval_differential import _random_scene
from test_data_eval import _make_coco_fixture
from test_torch_native import jax_native_lib

from rtpe_tpu.data import coco as j_coco
from rtpe_tpu.data import dataset as j_dataset
from rtpe_tpu.data import minival as j_minival
from rtpe_tpu.data import rle as j_rle
from rtpe_tpu.data import targets as j_targets
from rtpe_tpu.data import teacher_cache as j_cache
from rtpe_tpu.eval import cocoeval as j_cocoeval
import rtpe_tpu.native as j_native
from rtpe_tpu.obs import vis as j_vis
from rtpe_tpu.ops import resize as j_resize
from rtpe_tpu_torch import native
from rtpe_tpu_torch.data import coco, minival, rle, targets, teacher_cache
from rtpe_tpu_torch.data.dataset import CocoDistillationDataset
from rtpe_tpu_torch.eval import cocoeval
from rtpe_tpu_torch.obs import vis
from rtpe_tpu_torch.ops.resize import resize_bilinear_np


# ------------------------------------------------------------- cocoeval

def _write_scene(tmp_path, img_ids, gts, tag):
    data = {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 512,
                        "width": 512} for i in img_ids],
            "annotations": gts,
            "categories": [{"id": 1, "name": "person",
                            "keypoints": ["k"] * 17}]}
    path = os.path.join(str(tmp_path), f"ann_{tag}.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


@pytest.mark.parametrize("block", range(5))
def test_cocoeval_stats_equal_jax(tmp_path, block):
    """20 scenes per block, 100 in all: every stat ``==``."""
    for seed in range(block * 20, block * 20 + 20):
        img_ids, gts, dts = _random_scene(seed)
        path = _write_scene(tmp_path, img_ids, gts, seed)
        got = cocoeval.KeypointEvaluator(coco.CocoAnnotations(path),
                                         img_ids=img_ids).evaluate(
            [dict(d) for d in dts])
        want = j_cocoeval.KeypointEvaluator(j_coco.CocoAnnotations(path),
                                            img_ids=img_ids).evaluate(
            [dict(d) for d in dts])
        assert list(got) == list(want) == cocoeval.STATS_NAMES
        assert got == want, (seed, got, want)


def test_cocoeval_empty_scene_equal_jax(tmp_path):
    path = _write_scene(tmp_path, [1, 2], [], "empty")
    got = cocoeval.KeypointEvaluator(coco.CocoAnnotations(path)).evaluate([])
    want = j_cocoeval.KeypointEvaluator(
        j_coco.CocoAnnotations(path)).evaluate([])
    assert got == want
    np.testing.assert_array_equal(cocoeval.KPT_OKS_SIGMAS,
                                  j_cocoeval.KPT_OKS_SIGMAS)


# ------------------------------------------------------------------ RLE

def test_rle_bitwise_jax_on_random_masks():
    rng = np.random.RandomState(0)
    for shape in ((23, 31), (1, 7), (40, 3), (64, 64)):
        for p in (0.1, 0.6, 0.97):
            mask = (rng.rand(*shape) > p).astype(np.uint8)
            for compress in (True, False):
                got = rle.rle_encode(mask, compress=compress)
                assert got == j_rle.rle_encode(mask, compress=compress)
                np.testing.assert_array_equal(rle.rle_decode(got),
                                              j_rle.rle_decode(got))
                np.testing.assert_array_equal(rle.rle_decode(got), mask)
            counts = j_rle.rle_encode(mask)["counts"]
            assert rle.decode_rle_counts(counts) == \
                j_rle.decode_rle_counts(counts)
            assert rle.mask_area(mask) == j_rle.mask_area(mask)
    assert rle.rle_encode(np.ones((3, 2), np.uint8))["counts"] == \
        j_rle.rle_encode(np.ones((3, 2), np.uint8))["counts"]


def test_segmentation_to_mask_bitwise_jax():
    raw = {"size": [3, 3], "counts": [1, 2, 3, 3]}
    comp = j_rle.rle_encode((np.arange(35).reshape(5, 7) % 3 == 0)
                            .astype(np.uint8))
    poly = [[2, 2, 8, 2, 8, 8, 2, 8], [10.4, 1.2, 13.6, 4.5, 9.9, 6.1],
            [1, 1, 2, 2]]  # the last has too few points and is skipped
    for segm, h, w in ((raw, 3, 3), (comp, 5, 7), (poly, 12, 16)):
        got = rle.segmentation_to_mask(segm, h, w)
        want = j_rle.segmentation_to_mask(segm, h, w)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        rle.segmentation_to_mask("polygon", 3, 3)


# -------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    truth = _make_coco_fixture(root, n_imgs=3, hw=(96, 128),
                               jitter_per_image=True)
    return root, truth


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "hms":
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


def test_dataset_samples_equal_jax(fixture_root):
    root, _ = fixture_root
    kw = dict(gt_stddevs_pix=[2.0, 7.0],
              remove_images_without_annotations=True)
    ds = CocoDistillationDataset(root, "val2017", **kw)
    ds_j = j_dataset.CocoDistillationDataset(root, "val2017", **kw)
    assert ds.ids == ds_j.ids and len(ds) == 3
    for i in range(len(ds)):
        _assert_same_sample(ds[i], ds_j[i])
    white = [ds.ids[2], 999, ds.ids[0]]
    ds_w = CocoDistillationDataset(root, "val2017", whitelist_ids=white,
                                   host_gt_heatmaps=False)
    ds_jw = j_dataset.CocoDistillationDataset(root, "val2017",
                                              whitelist_ids=white,
                                              host_gt_heatmaps=False)
    assert ds_w.ids == ds_jw.ids == [ds.ids[2], ds.ids[0]]
    _assert_same_sample(ds_w[0], ds_jw[0])


def test_dataset_teacher_maps_equal_jax(fixture_root, tmp_path, monkeypatch):
    """Teacher maps written by the port, read by both datasets and
    upsampled to image size.  Where both packages' native resizes load
    (the same source, the same flags) the maps are held bitwise; else
    one side may run numpy, so within float32 rounding.  The rest
    exactly."""
    root, _ = fixture_root
    lib = jax_native_lib()
    both = lib is not None and native.available()
    if both:
        monkeypatch.setattr(j_native, "_LIB", lib)
        monkeypatch.setattr(j_native, "_LIB_TRIED", True)
    rng = np.random.default_rng(5)
    ds = CocoDistillationDataset(root, "val2017", teacher_output_dir=str(
        tmp_path))
    for img_id in ds.ids:
        teacher_cache.save_teacher_prediction(
            str(tmp_path), f"{img_id:012d}.jpg",
            rng.normal(size=(34, 24, 32)).astype(np.float32),
            rng.random((17, 48, 64)).astype(np.float32))
    ds_j = j_dataset.CocoDistillationDataset(
        root, "val2017", teacher_output_dir=str(tmp_path))
    for i in range(len(ds)):
        got, want = ds[i], ds_j[i]
        for key in ("teacher_hms", "teacher_ae"):
            assert got[key].shape == want[key].shape == (96, 128, 17)
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=0 if both else 1e-6)
            got[key] = want[key]
        _assert_same_sample(got, want)


def test_dataset_refuses_alt_colorspace(fixture_root):
    """A colorspace other than LAB or HSV is refused; those two are
    served as JAX's ``img_alt`` (``ops/color.py``'s tolerances)."""
    root, _ = fixture_root
    with pytest.raises(ValueError, match="YUV"):
        CocoDistillationDataset(root, "val2017", alt_colorspace="YUV")
    for space, atol in (("LAB", 1e-3), ("HSV", 1e-6)):
        ds, ds_j = _both(root, alt_colorspace=space, host_gt_heatmaps=False)
        got, want = ds[0], ds_j[0]
        assert got["img_alt"].dtype == np.float32
        np.testing.assert_allclose(got["img_alt"], want["img_alt"], rtol=0,
                                   atol=atol)
        got["img_alt"] = want["img_alt"]
        _assert_same_sample(got, want)


def _perfect(truth, ids, n_people=2, jitter=None):
    preds, scores = [], []
    for img_id in ids:
        people = []
        for kps in truth[img_id][:n_people]:
            arr = np.asarray(kps, dtype=np.float64).reshape(17, 3)
            if jitter is not None:
                arr[:, :2] += jitter.randn(17, 2) * 1.5
            arr[:, 2] = 0.9
            people.append(arr)
        preds.append(people)
        scores.append([0.9] * len(people))
    return preds, scores


def _both(root, **kw):
    return (CocoDistillationDataset(root, "val2017", **kw),
            j_dataset.CocoDistillationDataset(root, "val2017", **kw))


@pytest.mark.parametrize("case", ["perfect", "missing", "jitter"])
def test_evaluate_equal_jax(tmp_path, case):
    """``tests/test_data_eval.py``'s cases: AP = AR = 1 for the truth, a
    missing person halves the recall, jitter costs AP; the port's stats
    equal JAX's on the same predictions."""
    root = str(tmp_path)
    truth = _make_coco_fixture(root)
    ds, ds_j = _both(root)
    preds, scores = _perfect(
        truth, ds.ids, n_people=1 if case == "missing" else 2,
        jitter=np.random.RandomState(1) if case == "jitter" else None)
    stats = ds.evaluate(preds, scores, output_dir=str(tmp_path / "port"))
    assert stats == ds_j.evaluate(preds, scores,
                                  output_dir=str(tmp_path / "jax"))
    res = os.path.join("results", "keypoints_val2017_results.json")
    with open(tmp_path / "port" / res) as f, open(tmp_path / "jax" / res) as g:
        assert f.read() == g.read()
    if case == "perfect":
        assert stats["AP"] == pytest.approx(1.0)
        assert stats["AR"] == pytest.approx(1.0)
    elif case == "missing":
        assert stats["AR"] == pytest.approx(0.5, abs=1e-6)
        assert 0.4 < stats["AP"] <= 0.51
    else:
        assert 0.0 < stats["AP"] < 1.0


def test_evaluate_ignores_crowds_as_jax(tmp_path):
    root = str(tmp_path)
    truth = _make_coco_fixture(root)
    anno_path = os.path.join(root, "annotations",
                             "person_keypoints_val2017.json")
    with open(anno_path) as f:
        data = json.load(f)
    next_id = max(a["id"] for a in data["annotations"]) + 1
    # test_data_eval.py's crowd, with a 50-pixel mask (its one run of
    # zeros is an empty mask), so that the ignore mask shows it too
    for im in data["images"]:
        data["annotations"].append({
            "id": next_id, "image_id": im["id"], "category_id": 1,
            "keypoints": [0] * 51, "num_keypoints": 0, "iscrowd": 1,
            "area": 400.0, "bbox": [0, 0, 20, 20],
            "segmentation": {"size": [im["height"], im["width"]],
                             "counts": [10, 50,
                                        im["height"] * im["width"] - 60]},
        })
        next_id += 1
    with open(anno_path, "w") as f:
        json.dump(data, f)
    ds, ds_j = _both(root)
    preds, scores = _perfect(truth, ds.ids)
    for people, s in zip(preds, scores):
        stray = np.zeros((17, 3))
        stray[:, 0] = 5 + np.arange(17) % 4
        stray[:, 1] = 5 + np.arange(17) // 4
        stray[:, 2] = 0.8
        people.append(stray)
        s.append(0.8)
    stats = ds.evaluate(preds, scores)
    assert stats == ds_j.evaluate(preds, scores)
    assert stats["AP"] == pytest.approx(1.0)
    assert stats["AR"] == pytest.approx(1.0)
    _assert_same_sample(ds[0], ds_j[0])  # the crowd's RLE in the masks
    assert ds[0]["mask"].min() == 0.0


def test_evaluate_refuses_mismatched_ids_as_jax(tmp_path):
    root = str(tmp_path)
    _make_coco_fixture(root, n_imgs=4, hw=(64, 64))
    ds, ds_j = _both(root, remove_images_without_annotations=True)
    for d in (ds, ds_j):
        with pytest.raises(ValueError, match="img_ids"):
            d.evaluate([[]], [[]])
        with pytest.raises(ValueError, match="score lists"):
            d.evaluate([[], []], [[]], img_ids=ds.ids[:2])
    assert ds.evaluate([[]], [[]], img_ids=[ds.ids[0]]) == \
        ds_j.evaluate([[]], [[]], img_ids=[ds.ids[0]])


# ------------------------------------------------- targets and resizing

@pytest.mark.parametrize("sigma", [2.0, 7.0])
def test_heatmap_targets_match_jax(sigma):
    rng = np.random.RandomState(5)
    joints = rng.rand(3, 17, 3) * 90
    joints[..., 2] = (rng.rand(3, 17) > 0.3).astype(float)
    joints[0, 0] = (-0.4, 10.0, 1.0)   # truncates onto column 0
    joints[0, 1] = (12.0, -0.9, 1.0)   # and onto row 0
    joints[0, 2] = (-1.5, 20.0, 1.0)   # outside: dropped
    host = targets.HeatmapGenerator(17, sigma)(joints, (80, 96))
    np.testing.assert_array_equal(
        host, j_targets.HeatmapGenerator(17, sigma)(joints, (80, 96)))
    dev = targets.render_heatmaps(torch.from_numpy(joints[None]), (80, 96),
                                  sigma).numpy()
    want = np.asarray(j_targets.render_heatmaps(jnp.asarray(joints[None]),
                                                (80, 96), sigma))
    assert dev.dtype == np.float32 and dev.shape == want.shape
    np.testing.assert_allclose(dev, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dev[0].transpose(2, 0, 1), host, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_np_matches_jax(align_corners):
    x = np.random.default_rng(2).normal(size=(24, 32, 5)).astype(np.float32)
    for out_hw in ((96, 128), (13, 7), (24, 32), (1, 5)):
        got = resize_bilinear_np(x, out_hw, align_corners)
        np.testing.assert_allclose(
            got, j_resize.resize_bilinear_np(x, out_hw, align_corners),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            got, np.asarray(j_resize.resize_bilinear(
                jnp.asarray(x[None]), out_hw, align_corners))[0],
            rtol=0, atol=1e-6)


# ------------------------------------------------------- teacher corpus

def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_teacher_cache_round_trips_with_jax(tmp_path):
    """The port writes CHW (its NCHW forward's layout), JAX writes from
    HWC: each loader reads the other's file, and the members are equal
    byte for byte."""
    rng = np.random.default_rng(3)
    coarse = rng.normal(size=(34, 20, 24)).astype(np.float32)
    refined = rng.normal(size=(17, 40, 48)).astype(np.float32)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir(), jax_dir.mkdir()
    p = teacher_cache.save_teacher_prediction(
        str(port_dir), "000000000042.jpg", coarse, refined)
    q = j_cache.save_teacher_prediction(str(jax_dir), "000000000042.jpg",
                                        coarse.transpose(1, 2, 0),
                                        refined.transpose(1, 2, 0))
    assert os.path.basename(p) == os.path.basename(q) == \
        "000000000042.jpg_w48_predictions.npz"
    got, want = _members(p), _members(q)
    assert list(got) == list(want) == [
        "pred_heatmaps.npy", "embeddings.npy", "heatmaps_refined.npy",
        "heatmaps_order.npy"]
    assert got == want
    for loader, d in ((teacher_cache.load_teacher_prediction, jax_dir),
                      (j_cache.load_teacher_prediction, port_dir)):
        t_hms, t_ae = loader(str(d), "000000000042")
        np.testing.assert_array_equal(t_hms, refined.transpose(1, 2, 0))
        np.testing.assert_array_equal(t_ae, coarse[17:].transpose(1, 2, 0))
    names = np.load(p)["heatmaps_order"]
    assert list(names) == coco.COCO_JOINT_NAMES == j_coco.COCO_JOINT_NAMES


# --------------------------------------------------------------- the rest

def test_minival_split_and_coco_tables_equal_jax(fixture_root, tmp_path):
    root, _ = fixture_root
    val = os.path.join(root, "images", "val2017")
    for seed in (0, 5):
        got = minival.make_rand_minival_split(val, 2, seed=seed)
        assert got == j_minival.make_rand_minival_split(val, 2, seed=seed)
    minival.write_minival_file(got[0], str(tmp_path / "a.txt"))
    j_minival.write_minival_file(got[0], str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == \
        (tmp_path / "b.txt").read_bytes()
    assert coco.read_whitelist(str(tmp_path / "a.txt")) == \
        j_coco.read_whitelist(str(tmp_path / "a.txt"))
    assert coco.COCO_FLIP_PAIRS == j_coco.COCO_FLIP_PAIRS
    assert coco.COCO_NUM_JOINTS == j_coco.COCO_NUM_JOINTS


def test_vis_equal_jax(tmp_path):
    import cv2
    rng = np.random.default_rng(4)
    hms = rng.random((20, 24, 17)).astype(np.float32)
    np.testing.assert_array_equal(vis.heatmaps_grid(hms),
                                  j_vis.heatmaps_grid(hms))
    img = rng.random((60, 80, 3)).astype(np.float32)
    people = [np.concatenate([rng.uniform(0, 60, (17, 2)),
                              rng.integers(0, 2, (17, 1))], axis=1)
              for _ in range(3)]
    vis.save_valid_image(img, people, str(tmp_path / "a.png"), seed=1)
    j_vis.save_valid_image(img, people, str(tmp_path / "b.png"), seed=1)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "b.png")))
