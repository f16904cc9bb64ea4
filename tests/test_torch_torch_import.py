"""The importers of the reference's torch state dicts, and the
``visualize_stem`` core, against the JAX package on the CPU.

The reference-named state dicts are written here from the key layout of
JAX's own translators: JAX's importer is asked for a state dict it lacks
a key of, the key it names is added with a seeded OIHW value (conv
kernels (O, I, kh, kw), linear weights (out, in), BN variances
positive), and so on until it loads.  The same dict then goes into both
packages (small students, 64 x 64 inputs): the port's state dict equals
JAX's imported variables bitwise, and the eval forwards agree within
1e-4 of their largest output.  Both packages refuse the same missing
key (``KeyError``), the same extra stem key (``ValueError``) and the
same shape mismatch (``ValueError``).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from rtpe_tpu.data import preprocess as jpre
from rtpe_tpu.io import torch_import as jti
from rtpe_tpu.models import students as jst
from rtpe_tpu.models.stem import StemHRNet as JaxStem
from rtpe_tpu_torch.cli import visualize_stem
from rtpe_tpu_torch.io import torch_import as ti
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models import (AttentionStudent, AttentionStudentSteps,
                                   CamStudent, MultistageStudent,
                                   RefinerStudent)
from test_torch_students import _close, _nchw, _np

_MISSING = re.compile(r"torch statedict missing (\S+) \(for \(([^)]*)\)\)")


def _leaf_shape(template, path):
    node = template
    for p in path:
        node = node[p]
    shape = tuple(np.shape(node))
    if len(shape) == 4:  # HWIO -> OIHW
        return (shape[3], shape[2], shape[0], shape[1])
    if len(shape) == 2:  # Dense (in, out) -> torch (out, in)
        return (shape[1], shape[0])
    return shape


def _reference_sd(importer, template, seed, rename=lambda k: k):
    """A reference-named state dict that JAX's ``importer`` consumes
    whole: each key it asks for, with a seeded value of its shape."""
    rng = np.random.default_rng(seed)
    sd = {}
    for _ in range(5000):
        try:
            importer(template, sd)
            return sd
        except KeyError as exc:
            m = _MISSING.search(str(exc))
            assert m, exc
            key = m.group(1)
            path = tuple(p.strip().strip("'") for p in m.group(2).split(","))
            shape = _leaf_shape(template, path)
            if key.endswith("running_var"):
                val = 0.5 + rng.random(shape)
            elif key.endswith("running_mean") or path[-1] == "bias":
                val = 0.1 * rng.normal(size=shape)
            elif path[-1] == "scale":
                val = 1.0 + 0.1 * rng.normal(size=shape)
            else:
                fan_in = int(np.prod(shape[1:]))
                val = rng.normal(size=shape) / np.sqrt(fan_in)
            sd[rename(key)] = val.astype(np.float32)
    raise AssertionError("the importer never loaded")


def _cases():
    x = (1, 32, 32, 3)
    return {
        "steps": (jst.AttentionStudentSteps(inplanes=8, alt_planes=6,
                                            dtype=jnp.float32),
                  AttentionStudentSteps(inplanes=8, alt_planes=6),
                  jti.import_attention_steps_statedict,
                  ti.import_attention_steps_statedict, 2),
        "attention": (jst.AttentionStudent(inplanes=8, dtype=jnp.float32),
                      AttentionStudent(inplanes=8),
                      jti.import_attention_student_statedict,
                      ti.import_attention_student_statedict, 1),
        "cam": (jst.CamStudent(inplanes=8, num_stages=2, dtype=jnp.float32),
                CamStudent(inplanes=8, num_stages=2),
                lambda v, sd: jti.import_student_statedict(v, sd, "cam"),
                lambda m, sd, **kw: ti.import_student_statedict(
                    m, sd, "cam", **kw), 1),
        "refiner": (jst.RefinerStudent((2, 2), dtype=jnp.float32),
                    RefinerStudent((2, 2)),
                    lambda v, sd: jti.import_student_statedict(
                        v, sd, "refiner"),
                    lambda m, sd, **kw: ti.import_student_statedict(
                        m, sd, "refiner", **kw), 1),
        "multistage": (jst.MultistageStudent((2, 2), dtype=jnp.float32),
                       MultistageStudent((2, 2)),
                       lambda v, sd: jti.import_student_statedict(
                           v, sd, "multistage"),
                       lambda m, sd, **kw: ti.import_student_statedict(
                           m, sd, "multistage", **kw), 1),
    }, x


def _init(jm, n_inputs, shape):
    """JAX's variable template (zeros of each leaf's shape: the importers
    read only shapes and dtypes), traced abstractly, which is much
    cheaper than running flax's initialisers op by op."""
    xs = [jnp.zeros(shape)] * n_inputs
    tree = jax.eval_shape(lambda k: jm.init(k, *xs, train=False),
                          jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), tree)


@pytest.mark.parametrize("name", ["steps", "attention", "cam", "refiner",
                                  "multistage"])
def test_importers_load_like_jax(name):
    cases, shape = _cases()
    jm, pm, jimp, pimp, n_in = cases[name]
    template = _init(jm, n_in, shape)
    sd = _reference_sd(jimp, template, seed=len(name))
    if name == "attention":
        # the reference's det_mid branch, which both importers drop
        sd["det_mid.1.residual.0.weight"] = np.zeros((8, 8, 1, 1),
                                                     np.float32)
    jv = jax.tree_util.tree_map(np.asarray, jimp(template, sd))
    pimp(pm, {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    want = student_state_dict_from_jax(jv)
    for k, v in pm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k

    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
          for _ in range(n_in)]
    want = jax.jit(lambda v, *x: jm.apply(v, *x, train=False))(
        jv, *[jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pm.eval()(*[_nchw(x) for x in xs])
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w, 1e-4, name)


def test_attention_steps_accepts_both_stem_layouts():
    cases, shape = _cases()
    jm, _, jimp, pimp, n_in = cases["steps"]
    template = _init(jm, n_in, shape)
    flat = _reference_sd(jimp, template, seed=7)  # identity-wrapped stem
    assert any(k.startswith("stem.conv1.") for k in flat)
    wrapped = {re.sub(r"^stem\.", "stem.1.", k): v for k, v in flat.items()}
    a = pimp(AttentionStudentSteps(inplanes=8, alt_planes=6),
             {k: torch.from_numpy(v) for k, v in flat.items()}, strict=True)
    b = pimp(AttentionStudentSteps(inplanes=8, alt_planes=6),
             {k: torch.from_numpy(v) for k, v in wrapped.items()},
             strict=True)
    jb = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jimp(template, wrapped)))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, jb[k]), k


def test_both_packages_refuse_the_same_keys():
    cases, shape = _cases()
    jm, pm, jimp, pimp, n_in = cases["cam"]
    template = _init(jm, n_in, shape)
    sd = _reference_sd(jimp, template, seed=9)
    key = "cams.1.hdcs.3.0.weight"
    missing = {k: v for k, v in sd.items() if k != key}
    with pytest.raises(KeyError, match=re.escape(key)):
        jimp(template, missing)
    with pytest.raises(KeyError, match=re.escape(key)):
        pimp(pm, missing)
    bad = dict(sd, **{key: np.zeros((1, 1, 3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        jimp(template, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        pimp(pm, bad)
    # an extra key: the student importers ignore it, as JAX's do, unless
    # strict; the stem importer refuses an extra stem key in both
    extra = dict(sd, **{"cams.9.residual.0.weight": sd[key]})
    pimp(pm, extra)
    with pytest.raises(ValueError, match="unconsumed"):
        pimp(pm, extra, strict=True)
    stem_sd = {k[len("stem.1."):]: v for k, v in sd.items()
               if k.startswith("stem.1.")}
    stem_sd["layer1.4.conv1.weight"] = stem_sd["layer1.3.conv1.weight"]
    with pytest.raises(ValueError, match="unconsumed stem keys"):
        jti.import_stem_statedict(template, stem_sd)
    with pytest.raises(ValueError, match="unconsumed"):
        ti.import_stem_statedict(pm, stem_sd)


def test_stem_and_parts_importers(tmp_path):
    """``import_stem_statedict`` from an fp16-wrapped teacher state dict,
    and ``import_attention_student_parts`` from the reference's five part
    files, into both packages."""
    cases, shape = _cases()
    jm, pm, jimp, _, n_in = cases["attention"]
    template = _init(jm, n_in, shape)
    sd = _reference_sd(jimp, template, seed=11)
    teacher = {"1." + k[len("stem.1."):]: v for k, v in sd.items()
               if k.startswith("stem.1.")}
    teacher["1.final_layers.0.weight"] = np.zeros((3,), np.float32)
    jv = jti.import_stem_statedict(template, teacher)
    ti.import_stem_statedict(pm, {k: torch.from_numpy(v)
                                  for k, v in teacher.items()})
    want = student_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jv))
    for k, v in pm.stem.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want["stem." + k]), k

    parts = {"mid_stem": "mid_stem.", "att_top": "att_top.",
             "att_hi": "att_hi.", "att_mid": "att_mid.", "att_lo": "att_lo."}
    for part, pre in parts.items():
        torch.save({k[len(pre):]: torch.from_numpy(v)
                    for k, v in sd.items() if k.startswith(pre)},
                   str(tmp_path / f"snap_{part}.statedict"))
    jv = jax.tree_util.tree_map(np.asarray, jti.import_attention_student_parts(
        template, str(tmp_path), "snap_"))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    ti.import_attention_student_parts(pm, str(tmp_path), "snap_")
    want = student_state_dict_from_jax(jv)
    for k, v in pm.state_dict().items():
        if k.startswith(("det_", "stem.")):
            assert torch.equal(v, before[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k


def test_load_torch_statedict(tmp_path):
    sd = {"a.weight": torch.ones(2, dtype=torch.float16),
          "a.num_batches_tracked": torch.tensor(3)}
    path = str(tmp_path / "m.pth")
    torch.save(sd, path)
    got = ti.load_torch_statedict(path)
    want = jti.load_torch_statedict(path)
    assert got["a.weight"].dtype == torch.float32
    np.testing.assert_array_equal(got["a.weight"].numpy(), want["a.weight"])
    assert int(got["a.num_batches_tracked"]) == 3


class _JaxStemHolder(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        return JaxStem(dtype=jnp.float32, name="stem")(x, train)


def test_visualize_stem_planes_match_jax(tmp_path):
    """The planes of a 64 x 64 image from a seeded fp16-wrapped state
    dict: the stem's features within 1e-4 of JAX's, so the uint8 planes
    within one grey level; a missing file gives a random stem."""
    rng = np.random.default_rng(12)
    img = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    jm = _JaxStemHolder()
    template = _init(jm, 1, (1, 64, 64, 3))
    cases, shape = _cases()
    cam, _, jimp, _, n_in = cases["cam"]
    sd = _reference_sd(jimp, _init(cam, n_in, shape), seed=13)
    path = str(tmp_path / "w48.pth.tar")
    torch.save({"1." + k[len("stem.1."):]: torch.from_numpy(v).half()
                for k, v in sd.items() if k.startswith("stem.1.")}, path)
    jv = jti.import_stem_statedict(template, jti.load_torch_statedict(path))
    resized, _, _ = jpre.resize_align_multi_scale(
        img.astype(np.float32), 64, 1, 1)
    x = jnp.asarray(jpre.normalize_image(np.asarray(resized) / 255.0)[None])
    feats = _np(jm.apply(jv, x))[0]
    want = []
    for p in range(feats.shape[-1]):
        f = feats[:, :, p]
        f = (f - f.min()) / (f.max() - f.min() + 1e-9)
        want.append((f * 255).astype(np.uint8))
    want = np.stack(want)

    holder = visualize_stem.load_stem(path, "cpu")
    planes = visualize_stem.stem_planes(holder, img, 64, "cpu")
    assert planes.shape == want.shape and planes.dtype == np.uint8
    assert np.abs(planes.astype(int) - want.astype(int)).max() <= 1
    assert (planes == want).mean() > 0.99
    got = holder.stem(visualize_stem.model_input(
        img.astype(np.float32), 64, "cpu")[None].permute(0, 3, 1, 2),
        torch.float32)
    _close(got.detach().permute(0, 2, 3, 1)[0], feats, 1e-4, "features")
    rand = visualize_stem.load_stem(str(tmp_path / "none.pth"), "cpu")
    assert np.isfinite(visualize_stem.stem_planes(rand, img, 64, "cpu",
                                                  max_planes=4)).all()
    assert os.path.exists(path)
