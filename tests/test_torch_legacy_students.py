"""The port's legacy students and ``ResidualStepBlock`` against the JAX
package, on the CPU.

Each module gets JAX's variables (BN statistics randomised) through
``student_state_dict_from_jax`` and the same seeded numpy input (64 x 64
images, ``inplanes=8``, two stages), in float32.  Outputs are held
within 1e-4 of their largest value, the tolerance of
``tests/test_torch_students.py`` (where the bf16 layers these students
are built of are held to JAX's); the running statistics a train-mode
forward leaves, within 1e-5 (tighter than that file's 1e-4 for a whole
student: each statistic is a float32 mean over the map, summed in
another order, 3.1e-6 at worst here).  Also: the frozen parts get no
gradient and keep their train-mode BN updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtpe_tpu.models import rsb as jrsb
from rtpe_tpu.models import students as jst
from rtpe_tpu_torch.models import (AttentionStudent, CamStudent,
                                   MultistageStudent, RefinerStudent,
                                   ResidualStepBlock, init_student_)
from test_torch_students import _close, _nchw, _randomize_bn, _sd

STAT_TOL = 1e-5
OUT_HW = (24, 20)


def _cases():
    return {
        "rsb": (lambda d: jrsb.ResidualStepBlock(16, dtype=d),
                lambda d: ResidualStepBlock(16, 16, dtype=d), (2, 9, 11, 16),
                None),
        "rsb_down": (lambda d: jrsb.ResidualStepBlock(24, stride=2,
                                                      downsample=True,
                                                      dtype=d),
                     lambda d: ResidualStepBlock(16, 24, stride=2,
                                                 downsample=True, dtype=d),
                     (2, 9, 11, 16), None),
        "refiner": (lambda d: jst.RefinerStudent((2, 2), dtype=d),
                    lambda d: RefinerStudent((2, 2), dtype=d),
                    (2, 64, 64, 3), OUT_HW),
        "multistage": (lambda d: jst.MultistageStudent((2, 2), dtype=d),
                       lambda d: MultistageStudent((2, 2), dtype=d),
                       (2, 64, 64, 3), OUT_HW),
        "cam": (lambda d: jst.CamStudent(inplanes=8, num_stages=2, dtype=d),
                lambda d: CamStudent(inplanes=8, num_stages=2, dtype=d),
                (2, 64, 64, 3), OUT_HW),
        "attention": (lambda d: jst.AttentionStudent(inplanes=8, dtype=d),
                      lambda d: AttentionStudent(inplanes=8, dtype=d),
                      (2, 64, 64, 3), None),
    }


def seeded_variables(jm, shape, seed):
    """JAX's variable tree of ``jm`` (traced abstractly: flax's
    initialisers run op by op are slow) filled from numpy with the
    initialisers' laws: kernels N(0, 1 / fan_in), biases 0, BN scale 1,
    mean 0, var 1."""
    tree = jax.eval_shape(lambda k: jm.init(k, jnp.zeros(shape),
                                            train=False),
                          jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return np.full(leaf.shape, 1.0 if name in ("scale", "var") else 0.0,
                       np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _run_jax(jm, v, x, out_hw, train):
    kw = {} if out_hw is None else {"out_hw": out_hw}
    if train:
        out, mut = jm.apply(v, x, train=True, mutable=["batch_stats"], **kw)
        return _as_tuple(out), mut
    return _as_tuple(jm.apply(v, x, train=False, **kw)), None


def _run_port(pm, x, out_hw):
    return _as_tuple(pm(x) if out_hw is None else pm(x, out_hw=out_hw))


@pytest.mark.parametrize("name", list(_cases()))
def test_forward_matches_jax(name):
    """Train mode (batch statistics, running-statistic update) and eval
    mode, from the same variables, in float32."""
    make_j, make_p, shape, out_hw = _cases()[name]
    jd, td = jnp.float32, torch.float32
    tol = 1e-4
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    jm = make_j(jd)
    xj = jnp.asarray(x)
    v = _randomize_bn(seeded_variables(jm, shape, 3), 12)
    pm = make_p(td)
    pm.load_state_dict(_sd(v), strict=True)

    want, mut = _run_jax(jm, v, xj, out_hw, train=True)
    got = _run_port(pm.train(), _nchw(x), out_hw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == td, (i, g.dtype)
        _close(g.permute(0, 2, 3, 1), w, tol, f"train {i}")
    new = _sd({"params": v["params"], "batch_stats": mut["batch_stats"]})
    for k, val in pm.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(val, new[k], rtol=STAT_TOL,
                                       atol=STAT_TOL, msg=k)

    pm.load_state_dict(_sd(v))
    want, _ = _run_jax(jm, v, xj, out_hw, train=False)
    with torch.no_grad():
        got = _run_port(pm.eval(), _nchw(x), out_hw)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1), w, tol, f"eval {i}")


@pytest.mark.parametrize("cls,frozen", [
    (RefinerStudent, ("stem.",)),
    (CamStudent, ("stem.", "mid_stem_")),
    (AttentionStudent, ("stem.", "mid_stem_"))])
def test_frozen_parts_get_no_gradient(cls, frozen):
    """The stem (and the ``mid_stem`` the reference runs in its
    ``no_grad`` block) get no gradient, every other parameter does, and
    the frozen BNs still update their running statistics."""
    kw = {} if cls is RefinerStudent else {"inplanes": 8}
    m = init_student_(cls(**kw), seed=4).train()
    before = m.stem.bn1.running_mean.clone()
    x = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, 3, 64, 64)).astype(np.float32))
    out = m(x)
    sum(o.float().square().mean() for o in (out if isinstance(out, tuple)
                                            else (out,))).backward()
    for name, p in m.named_parameters():
        if name.startswith(frozen):
            assert p.grad is None, name
        else:
            assert p.grad is not None, name
    assert not torch.equal(before, m.stem.bn1.running_mean)
