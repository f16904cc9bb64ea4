"""``rtpe_tpu_torch.utils.debug`` against ``rtpe_tpu.utils.debug``, on
the CPU.

* ``nan_debugging`` raises on ``torch.log(torch.zeros(2) - 1)`` and the
  previous state comes back after the block, as JAX's does in
  ``tests/test_pipeline_ckpt.py``; ``enable_nan_debugging`` holds until
  turned off; ``infs``.
* No false alarm: the allocation ops are not checked (a ``torch.empty``
  over freed NaN memory raises nothing); a narrow packed forward, the
  decode's solvers and the packed predictor run clean.  NaN planes raise, and a kernel's own check (what a wrapper
  runs after its launch on the card) names the kernel.
* A NaN made in autograd's backward is caught.
* ``assert_all_finite`` gives JAX's message on the same nested trees.
"""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpe_tpu.utils import debug as jdebug
from rtpe_tpu_torch.decode.fused import decode_full_batch
from rtpe_tpu_torch.eval import PosePredictor
from rtpe_tpu_torch.models import PoseHigherHRNet, init_random_
from rtpe_tpu_torch.models import hrnet_packed as packed
from rtpe_tpu_torch.ops import _observe
from rtpe_tpu_torch.ops.nms_topk import nms_topk
from rtpe_tpu_torch.ops.resize import resize_bilinear
from rtpe_tpu_torch.utils import debug
from test_torch_model import small_cfgs


def test_nan_debugging_context():
    with pytest.raises(FloatingPointError):
        debug.assert_all_finite({"a": np.array([1.0, np.nan])})
    debug.assert_all_finite({"a": np.ones(3)})

    with debug.nan_debugging():
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.zeros(2) - 1.0)
    # restored afterwards
    assert torch.isnan(torch.log(torch.zeros(2) - 1.0)).all()
    assert not _observe.active
    # JAX's context, side by side
    with jdebug.nan_debugging():
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.zeros(2) - 1.0).block_until_ready()


def test_enable_holds_until_turned_off_and_infs():
    debug.enable_nan_debugging()
    try:
        with pytest.raises(FloatingPointError):
            torch.sqrt(torch.tensor([-1.0]))
        torch.exp(torch.tensor([1000.0]))          # inf: not checked
        with debug.nan_debugging(nans=False, infs=True):
            with pytest.raises(FloatingPointError, match="Inf"):
                torch.exp(torch.tensor([1000.0]))
            torch.sqrt(torch.tensor([-1.0]))        # nan: not checked
        # the outer state is back
        with pytest.raises(FloatingPointError):
            torch.sqrt(torch.tensor([-1.0]))
    finally:
        debug.enable_nan_debugging(False)
    torch.sqrt(torch.tensor([-1.0]))
    assert not _observe.active


def test_no_alarm_from_allocations_or_a_clean_decode():
    assert torch.ops.aten.empty.memory_format in debug.ALLOCATION_OPS
    assert torch.ops.aten.empty_like.default in debug.ALLOCATION_OPS
    det = torch.from_numpy(np.random.default_rng(0).random(
        (2, 32, 24, 17)).astype(np.float32))
    want = nms_topk(det)
    blocks = [torch.full((1024,), float("nan")) for _ in range(4)]
    with debug.nan_debugging():
        while blocks:
            blocks.pop()
            torch.empty(1024)       # may reuse the NaN block: not checked
        torch.empty_like(det)
        got = nms_topk(det)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_no_alarm_over_a_packed_forward_and_every_decode():
    _, cfg = small_cfgs(17)
    model = init_random_(PoseHigherHRNet(cfg), seed=4).eval()
    pk = packed.pack_w48_params(model.state_dict(), cfg, torch.float32,
                                "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 128, 128)).astype(np.float32))
    image = (np.random.default_rng(2).random((100, 130, 3)) * 255
             ).astype(np.uint8)
    pred = PosePredictor(model, device="cpu", num_joints=17,
                         input_size=128, packed=True)
    with torch.inference_mode(), debug.nan_debugging():
        coarse, refined = packed.packed_forward(pk, x, cfg, torch.float32)
        hms = refined[:, :17].permute(0, 2, 3, 1)
        tags = resize_bilinear(coarse[:, 17:].permute(0, 2, 3, 1),
                               tuple(hms.shape[1:3]))
        # the greedy solvers and the plain Hungarian; the exact kernels'
        # plain versions ("kernel", "pallas") take ~6 s each under the
        # check here and are left out
        for lap in ("auto", "greedy", "lockstep", "xla"):
            _, n, _ = decode_full_batch(hms, tags, lap=lap)
            assert (n > 0).all(), lap
        people, _ = pred.predict(image)
        assert len(pred.predict_batch([image, image])) == 2
    assert people


def test_nan_planes_raise_and_kernel_checks_name_the_kernel():
    det = torch.zeros((1, 32, 24, 17))
    det[0, 5, 7, 3] = float("nan")
    with debug.nan_debugging():
        with pytest.raises(FloatingPointError):
            nms_topk(det)
        # a NaN input is reported though the NMS pool drops it
        v = nms_topk(torch.nan_to_num(det))
        with pytest.raises(FloatingPointError,
                           match="NaN in input tensor 0 of the nms_topk"):
            _observe.launched("nms_topk", (det,), v[:1])
        with pytest.raises(FloatingPointError,
                           match="NaN in output tensor 1 of the group"):
            _observe.launched("group_mega", (), (v[0], det))
        _observe.launched("nms_topk", (torch.zeros(3),), v[:1])
        # integer tensors hold no NaN
        _observe.launched("lap_rect", (), (torch.zeros(3, dtype=torch.int32),))
    _observe.launched("nms_topk", (det,), ())   # off: nothing checked


def test_nan_made_in_backward_is_caught():
    x = torch.zeros(3, requires_grad=True)
    with debug.nan_debugging():
        y = (torch.sqrt(x) * 0.0).sum()         # finite forward
        assert torch.isfinite(y)
        with pytest.raises(FloatingPointError):
            y.backward()                        # 0 / (2 sqrt(0)) = NaN
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()
    assert torch.isnan(x.grad).all()


Pair = collections.namedtuple("Pair", ["left", "right"])


def _trees(nan, inf):
    """The same trees with numpy leaves (for JAX) and tensor leaves."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    return [
        ({"b": [1.0, {"c": np.array([nan])}], "a": [np.ones(2)]},
         {"b": [1.0, {"c": t([nan])}], "a": [t(np.ones(2))]}),
        ({"z": np.array([inf]), "a": (np.ones(2), np.array([1.0, nan]))},
         {"z": t([inf]), "a": (t(np.ones(2)), t([1.0, nan]))}),
        (collections.OrderedDict([("z", np.array([nan])),
                                  ("a", np.array([nan]))]),
         collections.OrderedDict([("z", t([nan])), ("a", t([nan]))])),
        ({"p": Pair(np.ones(1), np.array([inf])), "n": None,
          "i": np.array([3])},
         {"p": Pair(t(np.ones(1)), t([inf])), "n": None,
          "i": torch.tensor([3])}),
        ([{"w": np.ones(2)}, [np.array([nan])]],
         [{"w": t(np.ones(2))}, [t([nan]).to(torch.bfloat16)]]),
    ]


def test_assert_all_finite_matches_jax_messages():
    for jtree, ttree in _trees(float("nan"), float("inf")):
        with pytest.raises(FloatingPointError) as want:
            jdebug.assert_all_finite(jtree, "metrics")
        with pytest.raises(FloatingPointError) as got:
            debug.assert_all_finite(ttree, "metrics")
        assert str(got.value) == str(want.value)
    for jtree, ttree in _trees(0.0, 0.0):
        jdebug.assert_all_finite(jtree)
        debug.assert_all_finite(ttree)
