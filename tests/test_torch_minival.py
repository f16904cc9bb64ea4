"""The in-training minival and the student evaluation engine against the
JAX package's, on the CPU.

On ``_make_coco_fixture`` (three 96 x 128 images, per-image jitter) with
``alt_colorspace="LAB"``, JAX students (``inplanes=8``, ``alt_planes=6``,
float32) carried to the port through ``student_state_dict_from_jax``:

* ``attention_minival``: JAX's within rtol 1e-5; batched equals bs=1;
  the model's train/eval mode is restored.
* ``detection_minival`` (``ae_dims=1``) and ``eval_student``: the ten
  stats equal to JAX's within 1e-6, both host groupings on the same
  assignment solver (native where both libraries load, else scipy: the
  two break exact ties differently); batched equals
  bs=1; an oracle student emitting the ideal maps reaches AP@.5 = 1
  (``tests/test_minival.py``'s engine-isolation strategy).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_data_eval import _make_coco_fixture
from test_e2e_ap import _render_ideal

from rtpe_tpu.data import dataset as j_dataset
from rtpe_tpu.decode import HeatmapParser as JaxParser
from rtpe_tpu.eval import engine as j_engine
from rtpe_tpu.eval import minival as j_minival
from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
from rtpe_tpu.ops.resize import resize_bilinear as j_resize
from rtpe_tpu_torch.data.dataset import CocoDistillationDataset
from rtpe_tpu_torch.data.preprocess import normalize_image
from rtpe_tpu_torch.decode import HeatmapParser
from rtpe_tpu_torch.eval import engine
from rtpe_tpu_torch.eval.minival import attention_minival, detection_minival
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models.students import AttentionStudentSteps
from rtpe_tpu_torch.ops.resize import resize_bilinear
from test_torch_native import same_solver  # noqa: F401

INPLANES, ALT = 8, 6


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("minival_coco"))
    _make_coco_fixture(root, n_imgs=3, hw=(96, 128), jitter_per_image=True)
    kw = dict(remove_images_without_annotations=False, gt_stddevs_pix=[2.0],
              alt_colorspace="LAB", host_gt_heatmaps=False)
    return (CocoDistillationDataset(root, "val2017", **kw),
            j_dataset.CocoDistillationDataset(root, "val2017", **kw))


@pytest.fixture(scope="module", params=[0, 1], ids=["ae0", "ae1"])
def students(request):
    """A JAX student with ``ae_dims`` 0 or 1 and the port's copy."""
    model = JaxStudent(inplanes=INPLANES, alt_planes=ALT,
                       ae_dims=request.param, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3))
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), x, x, train=False))
    port = AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT,
                                 ae_dims=request.param)
    port.load_state_dict(student_state_dict_from_jax(v), strict=True)
    return model, v, port.train()


@pytest.fixture
def scipy_grouping(same_solver):  # noqa: F811
    """Both host groupings on the same solver (the fixture keeps its
    name; native where both libraries load)."""
    return same_solver


@pytest.mark.parametrize("students", [0], indirect=True, ids=["ae0"])
def test_attention_minival_matches_jax(datasets, students):
    ds, ds_j = datasets
    model, v, port = students
    want = j_minival.attention_minival(model, v["params"], v["batch_stats"],
                                       ds_j, batch_size=2)
    got = attention_minival(port, ds, batch_size=2)
    assert port.training, "the model's mode is restored"
    assert got == pytest.approx(want, rel=1e-5)
    port.eval()
    assert attention_minival(port, ds, batch_size=1) == pytest.approx(
        got, rel=1e-6)
    assert not port.training
    port.train()
    assert attention_minival(port, ds, max_images=2) == pytest.approx(
        j_minival.attention_minival(model, v["params"], v["batch_stats"],
                                    ds_j, max_images=2), rel=1e-5)


def _assert_stats(got, want, tol=1e-6):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=tol), k


@pytest.mark.parametrize("students", [1], indirect=True, ids=["ae1"])
def test_detection_minival_matches_jax(datasets, students, scipy_grouping):
    ds, ds_j = datasets
    model, v, port = students
    want = j_minival.detection_minival(model, v["params"], v["batch_stats"],
                                       ds_j, batch_size=2)
    got = detection_minival(port, ds, batch_size=2)
    assert port.training
    _assert_stats(got, want)
    assert all(np.isfinite(x) for x in got.values())
    _assert_stats(detection_minival(port, ds, batch_size=1), got)


@pytest.mark.parametrize("students", [1], indirect=True, ids=["ae1"])
def test_eval_student_matches_jax(datasets, students, scipy_grouping):
    ds, ds_j = datasets
    model, v, port = students
    port.eval()

    def j_apply(img, out_hw):
        x = (img - jnp.asarray([0.485, 0.456, 0.406])) / jnp.asarray(
            [0.229, 0.224, 0.225])
        _, det = model.apply(v, x, x, train=False)
        return j_resize(det, tuple(out_hw), align_corners=True)

    def apply(img, out_hw):
        x = normalize_image(img).permute(0, 3, 1, 2)
        _, det = port(x, x)
        return resize_bilinear(det.permute(0, 2, 3, 1), tuple(out_hw),
                               align_corners=True)

    parser_kw = dict(num_joints=17, tag_per_joint=False)
    want = j_engine.eval_student(j_apply, JaxParser(**parser_kw), ds_j)
    got = engine.eval_student(apply, HeatmapParser(**parser_kw), ds,
                              device="cpu")
    _assert_stats(got, want)


class _OracleStudent(torch.nn.Module):
    """Emits each image's ideal detection heatmaps and tags at image
    resolution, picked by the pixel sum of its normalized image (the
    fixture's images have distinct sums), so the batched, padded minival
    can be held to AP@.5 = 1."""

    def __init__(self, dataset, num_joints=17):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))
        samples = [dataset[i] for i in range(len(dataset))]
        self.sums = torch.tensor([float(normalize_image(s["img"]).sum())
                                  for s in samples])
        table = []
        for s in samples:
            det, tag = _render_ideal(s["joints"], s["mask"].shape,
                                     num_joints)
            table.append(np.concatenate([det, tag], axis=-1))
        self.table = torch.from_numpy(np.stack(table).astype(np.float32))

    def forward(self, img, alt):
        key = img.float().sum(dim=(1, 2, 3))
        idx = (key[:, None] - self.sums[None]).abs().argmin(dim=1)
        out = self.table[idx].permute(0, 3, 1, 2)
        att = torch.zeros((img.shape[0], 1, out.shape[2] // 4,
                           out.shape[3] // 4))
        return att, out


def test_detection_minival_reaches_ap_and_batches(datasets):
    ds, _ = datasets
    oracle = _OracleStudent(ds)
    stats = detection_minival(oracle, ds)
    assert stats["Ap .5"] == pytest.approx(1.0)
    assert stats["AP"] > 0.5
    _assert_stats(detection_minival(oracle, ds, batch_size=2),
                  detection_minival(oracle, ds, batch_size=1))
