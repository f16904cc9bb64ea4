"""The port's HigherHRNet against the JAX package's, on the CPU.

Both sides get the same seeded numpy weights: the JAX variables tree is
filled from a numpy generator and converted with
``rtpe_tpu_torch.io.state_dict_from_jax``.  Both forwards run in
float32; the tolerance (rtol/atol 1e-4) covers the different
convolution summation orders of XLA and PyTorch on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpe_tpu.models import HRNetConfig as JaxCfg
from rtpe_tpu.models import PoseHigherHRNet as JaxHRNet
from rtpe_tpu.models import StageCfg as JaxStage
from rtpe_tpu_torch.io import state_dict_from_jax, strip_fp16_prefix
from rtpe_tpu_torch.models import (HRNetConfig, PoseHigherHRNet, StageCfg,
                                   w48_config)

# Every pytest-xdist worker imports this module (each collects every test
# file).  PyTorch's intra-op pool starts one OpenMP thread per core in each
# worker process, and the threads spin while they wait, so six workers ran
# several times as many busy threads as there are cores: the port's heavy
# files took up to 30x their one-process time.  One thread a worker keeps
# them within the cores.
torch.set_num_threads(1)

TOL = 1e-4


def small_cfgs(num_joints=5):
    """The same small HigherHRNet for both packages (narrow widths, a
    few blocks), as in ``tests/test_teacher_parity.py``."""
    kw = dict(num_joints=num_joints, tag_per_joint=True, final_conv_ksize=1,
              num_deconvs=1, deconv_chans=(8,), deconv_ksize=(4,),
              deconv_num_blocks=2, deconv_cat=(True,),
              with_ae_loss=(True, False))
    stages = [(1, 2, "BASIC", (2, 2), (8, 16)),
              (2, 3, "BASIC", (2, 2, 2), (8, 16, 32)),
              (1, 4, "BASIC", (2, 2, 2, 2), (8, 16, 32, 64))]
    jcfg = JaxCfg(stage2=JaxStage(*stages[0]), stage3=JaxStage(*stages[1]),
                  stage4=JaxStage(*stages[2]), **kw)
    tcfg = HRNetConfig(stage2=StageCfg(*stages[0]),
                       stage3=StageCfg(*stages[1]),
                       stage4=StageCfg(*stages[2]), **kw)
    return jcfg, tcfg


def seeded_variables(jcfg, seed=0, in_hw=(64, 64), gain=1.0):
    """A JAX variables tree (numpy leaves) drawn from a numpy seed:
    kernels N(0, gain^2/fan_in), BN with non-trivial statistics."""
    model = JaxHRNet(cfg=jcfg, dtype=jnp.float32)
    tpl = model.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, *in_hw, 3)), train=False)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = np.shape(leaf)
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) * gain / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.5 * rng.random(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(tpl))


def port_model(tcfg, variables):
    model = PoseHigherHRNet(tcfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, tcfg))
    return model


def test_small_forward_matches_jax():
    jcfg, tcfg = small_cfgs()
    variables = seeded_variables(jcfg, seed=1, in_hw=(64, 96))
    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    j_out = JaxHRNet(cfg=jcfg, dtype=jnp.float32).apply(
        variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        t_out = port_model(tcfg, variables)(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(j_out) == len(t_out) == 2
    for j, t in zip(j_out, t_out):
        t = t.permute(0, 2, 3, 1).numpy()
        assert t.shape == np.shape(j)
        assert np.abs(t).max() > 0.1  # non-degenerate outputs
        np.testing.assert_allclose(t, np.asarray(j), rtol=TOL, atol=TOL)


def test_w48_parameter_count_and_keys():
    with torch.device("meta"):
        model = PoseHigherHRNet(w48_config())
    assert sum(p.numel() for p in model.parameters()) == 63_827_139
    keys = set(model.state_dict())
    for k in ("layer1.0.conv1.weight", "layer1.0.downsample.0.weight",
              "stage2.0.branches.1.3.bn2.running_var",
              "stage4.2.fuse_layers.0.3.0.weight",
              "stage3.0.fuse_layers.2.0.1.0.weight",
              "transition3.3.0.0.weight", "final_layers.0.bias",
              "final_layers.1.weight", "deconv_layers.0.0.0.weight",
              "deconv_layers.0.4.0.bn2.bias"):
        assert k in keys, k


def test_state_dict_from_jax_consumes_every_leaf():
    """Every JAX leaf lands on exactly one port key (strict both ways),
    with the layout conversions checked on one conv and the tconv."""
    jcfg, tcfg = small_cfgs()
    variables = seeded_variables(jcfg, seed=3)
    sd = state_dict_from_jax(variables, tcfg)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_tracked = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_tracked == n_leaves
    k = np.asarray(variables["params"]["conv1"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    kt = np.asarray(variables["params"]["deconv0_tconv"]["kernel"])
    np.testing.assert_array_equal(sd["deconv_layers.0.0.0.weight"].numpy(),
                                  kt.transpose(2, 3, 0, 1))
    mean = np.asarray(variables["batch_stats"]["bn1"]["mean"])
    np.testing.assert_array_equal(sd["bn1.running_mean"].numpy(), mean)
    # a tree that lacks a leaf, or carries an unknown one, is refused
    broken = jax.tree_util.tree_map(lambda a: a, variables)
    del broken["params"]["final_1"]
    with pytest.raises(KeyError):
        state_dict_from_jax(broken, tcfg)
    broken = jax.tree_util.tree_map(lambda a: a, variables)
    broken["params"]["bogus"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError):
        state_dict_from_jax(broken, tcfg)


def test_strip_fp16_prefix_and_load():
    _, tcfg = small_cfgs()
    sd = PoseHigherHRNet(tcfg).state_dict()
    wrapped = {f"1.{k}": v for k, v in sd.items()}
    assert strip_fp16_prefix(wrapped).keys() == sd.keys()
    assert strip_fp16_prefix(sd).keys() == sd.keys()
    PoseHigherHRNet(tcfg).load_state_dict(strip_fp16_prefix(wrapped))


def test_bf16_compute_dtype_keeps_bn_fp32():
    _, tcfg = small_cfgs()
    model = PoseHigherHRNet(tcfg).eval().set_compute_dtype(torch.bfloat16)
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.bn1.weight.dtype == torch.float32
    assert model.bn1.running_var.dtype == torch.float32
    with torch.no_grad():
        coarse, refined = model(torch.randn(1, 3, 64, 64))
    assert coarse.dtype == refined.dtype == torch.bfloat16
    assert torch.isfinite(coarse.float()).all()
