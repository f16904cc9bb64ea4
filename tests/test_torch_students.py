"""The port's student modules against the JAX package, on the CPU.

Weights are carried across by
``rtpe_tpu_torch.io.jax_import.student_state_dict_from_jax``; inputs are
made with numpy.  Float32 unless named: the layers within 1e-5 (sum
order), the modules within 1e-4 of their largest output (float32 convs
in another order), bf16 modules within 2^-6 (one bf16 rounding of an
activation may land on the other side of a tie and move a ReLU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtpe_tpu.models import layers as jlayers
from rtpe_tpu.models import students as jst
from rtpe_tpu.models.stem import StemHRNet as JaxStem
from rtpe_tpu.ops import pooling as jpool
from rtpe_tpu.ops import resize as jresize
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models import layers
from rtpe_tpu_torch.models.factory import (get_attention_student,
                                           get_hrnet_w48_teacher,
                                           load_pretrained_stem)
from rtpe_tpu_torch.models.stem import StemHRNet
from rtpe_tpu_torch.models.students import (AttentionStudentSteps,
                                            ContextAwareModule, SELayer)
from rtpe_tpu_torch.ops.pooling import avg_pool, global_avg_pool
from rtpe_tpu_torch.ops.resize import resize_nearest


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _nchw(a, dtype=torch.float32):
    return _t(a, dtype).permute(0, 3, 1, 2)


def _close(got: torch.Tensor, want, tol, what=""):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _sd(variables, prefix=None):
    """Port state dict of JAX ``variables``, optionally nested under a
    module name (the JAX tree of a lone submodule has no prefix)."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    if prefix:
        v = {col: {prefix: tree} for col, tree in v.items()}
    return student_state_dict_from_jax(v)


class _Holder(torch.nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, m in mods.items():
            setattr(self, k, m)


def _randomize_bn(variables, seed):
    """Non-trivial BN scale/bias/running statistics, so that a mapping or
    layout fault shows."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if name == "var":
            return 1.0 + 0.5 * rng.random(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fix, variables)


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pool_and_global_pool_match_jax(dtype):
    x = np.random.default_rng(0).normal(size=(2, 29, 23, 5)).astype(
        np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    want = jpool.avg_pool(jnp.asarray(x).astype(jd), 3, 2, 1,
                          count_include_pad=False)
    got = avg_pool(_t(x, td), 3, 2, 1, count_include_pad=False)
    assert got.dtype == td and got.shape == (2, 15, 12, 5)
    _close(got, want, tol)
    _close(global_avg_pool(_t(x, td)),
           jpool.global_avg_pool(jnp.asarray(x).astype(jd)), tol)


def test_resize_nearest_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 29, 29, 3)).astype(
        np.float32)
    want = _np(jresize.resize_nearest(jnp.asarray(x), (113, 113)))
    got = resize_nearest(_t(x), (113, 113)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bn_dtype", [None, "bfloat16"])
def test_train_mode_batchnorm_matches_flax(bn_dtype):
    """Output and running statistics on a 3 x 3 x 16 map, where the
    biased and the unbiased variance differ by 12 %."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(1, 3, 3, 16)) * 2 + 0.5).astype(np.float32)
    bn = jlayers.batch_norm(name="bn")
    with jlayers.bn_compute_dtype(getattr(jnp, bn_dtype or "float32")):
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                    use_running_average=False)
        v = _randomize_bn(v, 3)
        want, mut = bn.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
    m = layers.BatchNorm2d(16)
    _Holder(bn=m).load_state_dict(_sd(v, "bn"), strict=True)
    m = m.train()
    with layers.bn_compute_dtype(getattr(torch, bn_dtype)
                                 if bn_dtype else None):
        got = m(_nchw(x)).permute(0, 2, 3, 1)
    assert got.dtype == (torch.bfloat16 if bn_dtype else torch.float32)
    _close(got, want, 1e-5 if bn_dtype is None else 2.0 ** -8)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               _np(mut["batch_stats"]["mean"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(),
                               _np(mut["batch_stats"]["var"]), rtol=1e-6,
                               atol=1e-6)
    # the unbiased update of nn.BatchNorm2d would differ: n = 9
    unbiased = torch.nn.BatchNorm2d(16, momentum=0.1)
    unbiased.load_state_dict(m.state_dict())
    unbiased.running_var.copy_(_t(v["batch_stats"]["var"]))
    unbiased.train()(_nchw(x))
    assert not np.allclose(unbiased.running_var.numpy(), m.running_var,
                           rtol=1e-3)


# ------------------------------------------------------------ modules

def test_stem_matches_jax_train_and_eval():
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = JaxStem(dtype=jnp.float32)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    port = _Holder(stem=StemHRNet())
    port.load_state_dict(_sd(v, "stem"), strict=True)
    want, mut = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    got = port.train().stem(_nchw(x), torch.float32)
    _close(got.permute(0, 2, 3, 1), want, 1e-4, "train")
    new = _sd({"params": v["params"], "batch_stats": mut["batch_stats"]},
              "stem")
    for k, val in port.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(val, new[k], rtol=1e-4, atol=1e-5)
    port.load_state_dict(_sd(v, "stem"))
    _close(port.eval().stem(_nchw(x), torch.float32).permute(0, 2, 3, 1),
           jm.apply(v, jnp.asarray(x), False), 1e-4, "eval")


def test_se_layer_matches_jax_bf16():
    x = np.random.default_rng(6).normal(size=(2, 7, 9, 16)).astype(
        np.float32)
    jm = jst.SELayer(16, dtype=jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(1), xj)
    port = _Holder(se=SELayer(16, dtype=torch.bfloat16))
    port.load_state_dict(_sd(v, "se"), strict=True)
    got = port.se(_nchw(x, torch.bfloat16))
    assert got.shape == (2, 16, 1, 1) and got.dtype == torch.bfloat16
    _close(got[:, :, 0, 0], jm.apply(v, xj)[:, 0, 0, :], 2.0 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_cam_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.random((2, 11, 13, 12)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6
    jm = jst.ContextAwareModule(12, (1, 2, 3), dtype=jd)
    xj = jnp.asarray(x).astype(jd)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(2), xj, train=False), 8)
    port = ContextAwareModule(12, (1, 2, 3), dtype=td)
    port.load_state_dict(_sd(v), strict=True)
    want, mut = jm.apply(v, xj, train=True, mutable=["batch_stats"])
    _close(port.train()(_nchw(x, td)).permute(0, 2, 3, 1), want, tol,
           "train")
    new = _sd({"params": v["params"], "batch_stats": mut["batch_stats"]})
    for k, val in port.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(val, new[k], rtol=1e-3, atol=1e-4)
    port.load_state_dict(_sd(v))
    _close(port.eval()(_nchw(x, td)).permute(0, 2, 3, 1),
           jm.apply(v, xj, train=False), tol, "eval")


@pytest.fixture(scope="module")
def tiny_student():
    """A tiny AttentionStudentSteps (inplanes=8, alt_planes=6) on 32 x 32
    images in float32: JAX's variables, outputs and new running stats."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    alt = rng.random((2, 32, 32, 3)).astype(np.float32)
    jm = jst.AttentionStudentSteps(inplanes=8, alt_planes=6,
                                   dtype=jnp.float32,
                                   detach_att_for_det=True)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(alt),
                train=False)
    v = _randomize_bn(v, 10)
    div = jnp.float32(7.5)
    train = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), jnp.asarray(alt), att_divisor=div, train=True,
        mutable=["batch_stats"]))(v)
    evl = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(alt),
                                     att_divisor=div, train=False))(v)
    return x, alt, v, train, evl


def test_attention_student_matches_jax(tiny_student):
    x, alt, v, ((att, det), mut), (att_e, det_e) = tiny_student
    port = AttentionStudentSteps(inplanes=8, alt_planes=6,
                                 detach_att_for_det=True)
    port.load_state_dict(_sd(v), strict=True)
    div = torch.tensor(7.5)
    ta, td = port.train()(_nchw(x), _nchw(alt), att_divisor=div)
    assert ta.shape == (2, 1, 8, 8) and td.shape == (2, 17, 8, 8)
    _close(ta.permute(0, 2, 3, 1), att, 1e-4, "att")
    _close(td.permute(0, 2, 3, 1), det, 1e-4, "det")
    new = _sd({"params": v["params"], "batch_stats": mut["batch_stats"]})
    for k, val in port.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(val, new[k], rtol=1e-4, atol=1e-5,
                                       msg=k)
    port.load_state_dict(_sd(v))
    with torch.no_grad():
        ea, ed = port.eval()(_nchw(x), _nchw(alt), att_divisor=div)
    _close(ea.permute(0, 2, 3, 1), att_e, 1e-4, "eval att")
    _close(ed.permute(0, 2, 3, 1), det_e, 1e-4, "eval det")


def test_student_tree_and_factory():
    """The port's parameter names are the JAX tree's, and the factory
    builds the seeded student in train mode on the CPU."""
    m = get_attention_student(inplanes=8, alt_planes=6, device="cpu",
                              seed=3)
    again = get_attention_student(inplanes=8, alt_planes=6, device="cpu",
                                  seed=3)
    assert m.training and m.dtype == torch.float32
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    names = set(m.state_dict())
    for key in ("att.hi.hdc0_conv.weight", "att.lo.se.fc2.bias",
                "step2.hdc_top_bn.running_var", "stem.layer1.0.downsample.0"
                ".weight", "alt_stem_bn1.running_mean", "det_top.bias"):
        assert key in names, key


def test_load_pretrained_stem_from_a_w48_state_dict():
    _, sd = get_hrnet_w48_teacher(seed=1)
    student = get_attention_student(inplanes=8, alt_planes=6, device="cpu")
    fp16_wrapped = {f"1.{k}": v for k, v in sd.items()}
    load_pretrained_stem(student, fp16_wrapped)
    for k, v in student.stem.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError):
        load_pretrained_stem(student, {"conv1.weight": sd["conv1.weight"]})
