"""Package rules of the PyTorch port, on the CPU.

* Import hygiene: importing every ``rtpe_tpu_torch`` module pulls in
  neither JAX nor any module of the JAX package, nor ``cv2`` or ``PIL``
  (the card's machine has neither: the modules that draw or read image
  files import them where they use them).  Checked in a fresh
  interpreter, so this test process's own imports do not count.
* Device resolution: ``device=None`` means CUDA and raises where there
  is none; the CPU is used only when the caller asks for it.
"""

import os
import subprocess
import sys

import pytest
import torch

from rtpe_tpu_torch.data.preprocess import resize_align_multi_scale
from rtpe_tpu_torch.device import default_dtype, resolve_device, set_tf32
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.models import HRNetConfig, PoseHigherHRNet, StageCfg
from rtpe_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HYGIENE = r"""
import importlib, pkgutil, sys
import rtpe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtpe_tpu_torch.__path__,
                                               "rtpe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "cv2", "PIL")
             or m == "rtpe_tpu" or m.startswith("rtpe_tpu."))
for name in ("rtpe_tpu_torch.cli.validate_hhrnet",
             "rtpe_tpu_torch.cli.teacher_inference",
             "rtpe_tpu_torch.cli.export_serving", "rtpe_tpu_torch.ops.quant",
             "rtpe_tpu_torch.cli.realtime_demo", "rtpe_tpu_torch.eval.tta",
             "rtpe_tpu_torch.eval.cocoeval", "rtpe_tpu_torch.data.dataset",
             "rtpe_tpu_torch.data.rle", "rtpe_tpu_torch.obs.vis"):
    assert name in names, name
print(len(names), "modules")
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_rtpe_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # the package, its subpackages and every module in them
    assert int(res.stdout.split()[0]) >= 20, res.stdout


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_cfg():
    return HRNetConfig(num_joints=3,
                       stage2=StageCfg(1, 2, "BASIC", (1, 1), (4, 8)),
                       stage3=StageCfg(1, 3, "BASIC", (1, 1, 1), (4, 8, 16)),
                       stage4=StageCfg(1, 4, "BASIC", (1, 1, 1, 1),
                                       (4, 8, 16, 32)),
                       deconv_chans=(4,), deconv_num_blocks=1)


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    image = torch.zeros((40, 30, 3)).numpy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PosePredictor(PoseHigherHRNet(_tiny_cfg()), num_joints=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resize_align_multi_scale(image, 64)
    pred = PosePredictor(PoseHigherHRNet(_tiny_cfg()), device="cpu",
                         num_joints=3, input_size=64)
    assert pred.device.type == "cpu" and pred.dtype == torch.float32
    assert next(pred.model.parameters()).device.type == "cpu"


def test_later_slices_raise_not_implemented():
    """Data-parallel and spatially sharded serving wait for a later
    slice; the int8 modes are served, with the JAX predictor's
    refusals (``ValueError``)."""
    for kw, item in ((dict(mesh=object()), "Queue 1 item 6"),
                     (dict(spatial_mesh=object()), "Queue 1 item 6")):
        with pytest.raises(NotImplementedError, match="later slice") as exc:
            PosePredictor(PoseHigherHRNet(_tiny_cfg()), device="cpu",
                          num_joints=3, **kw)
        assert item in str(exc.value)
    for kw, msg in ((dict(int8=True), "requires packed=True"),
                    (dict(packed=True, int8_act=True), "requires int8=True"),
                    (dict(packed=True, int8=True), "synthetic"),
                    (dict(act_scales={"conv1": 1.0},
                          calibration_images=[]), "mutually exclusive")):
        with pytest.raises(ValueError, match=msg):
            PosePredictor(PoseHigherHRNet(_tiny_cfg()), device="cpu",
                          num_joints=3, **kw)


def test_tta_options_are_served_on_the_cpu():
    """``with_flip`` and ``scales`` are this slice's: the flip doubles
    the tag dimension, and the scales must include 1.0."""
    image = torch.zeros((40, 30, 3)).numpy()
    for kw in (dict(with_flip=True), dict(scales=(1.0, 0.5)),
               dict(with_flip=True, scales=(0.5, 1.0), packed=True)):
        pred = PosePredictor(PoseHigherHRNet(_tiny_cfg()), device="cpu",
                             num_joints=3, input_size=128, **kw)
        assert pred.tta
        people, scores = pred.predict(image)
        assert len(people) == len(scores)
    pred = PosePredictor(PoseHigherHRNet(_tiny_cfg()), device="cpu",
                         num_joints=3, input_size=64, scales=(0.5, 2.0))
    with pytest.raises(ValueError, match="must include 1.0"):
        pred.predict(image)


def test_packed_predictor_serves_on_the_cpu():
    """``packed=True`` is this slice's: the weights are folded once, in
    the predictor's dtype, and the module stays where it was."""
    pred = PosePredictor(PoseHigherHRNet(_tiny_cfg()), device="cpu",
                         num_joints=3, input_size=64, packed=True)
    assert pred.packed and pred.dtype == torch.float32
    w, b = pred.packed_params["stage4_0/branch0_0/conv1"]
    assert w.dtype == torch.float32 and b.dtype == torch.float32
    people, scores = pred.predict(torch.zeros((40, 30, 3)).numpy())
    assert len(people) == len(scores)


def test_precision_policy():
    assert default_dtype(torch.device("cuda")) == torch.bfloat16
    assert default_dtype(torch.device("cpu")) == torch.float32
    assert default_dtype(torch.device("cuda"), torch.float32) == \
        torch.float32
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    try:
        set_tf32(False)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def test_kernel_sources_and_build_command():
    """Every kernel source is found, and the build is the plain-C nvcc
    route for sm_90a (compiled only where ``nvcc`` exists)."""
    assert _build.sources() == ["basicblock_chain", "cam_f1", "cam_f2",
                                "cam_f3", "group_lockstep", "group_mega",
                                "lap_rect", "nms_topk", "qconv", "qfuse",
                                "warp_step_probe"]
    assert _build.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert os.path.basename(_build.BUILD_DIR) == "_build"
