"""The int8 graph's fused elementwise pass (``rtpe_tpu_torch/ops/qfuse.py``,
``csrc/qfuse.cu``) on the CPU.

* ``fuse_sum_plain`` (the graph's ops) held bitwise to a walk of the
  kernel's arithmetic: each output element reads each operand at its
  nearest-upsampling index (factors 1, 2, 4, 8), dequantizes an int8 one
  by a true division, rounds it to the dtype, adds in order with a
  rounding after each add, then the ReLU and the stores (int8 by
  round-half-even, clamped to +-127), on bf16 and float32 sums;
* and to the float graph's own fuse-sum expression (the nearest
  upsampling of a float32 conv output, then the cast, the sum in the
  dtype, the ReLU, ``quantize_act``);
* the one-pass quantize into a padded buffer bitwise ``quantize_act``,
  the head's two halves written apart bitwise the concat quantized.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtpe_tpu_torch.ops import qfuse
from rtpe_tpu_torch.ops.qfuse import Operand
from rtpe_tpu_torch.ops.quant import quantize_act


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def fuse_walk(ops, dtype, relu, q_inv):
    """The kernel's arithmetic element by element (vectorized over the
    output): gather, dequantize, round, add, round, ReLU, store."""
    t0, _, f0 = ops[0]
    b, c = t0.shape[:2]
    h, w = t0.shape[2] * f0, t0.shape[3] * f0
    rnd = _bf16 if dtype == torch.bfloat16 else (lambda v: v)
    yy = torch.arange(h)[:, None]
    xx = torch.arange(w)[None, :]
    s = None
    for t, inv, f in ops:
        v = t[:, :, yy // f, xx // f].to(torch.float32)
        if t.dtype == torch.int8:
            v = v / inv
        v = rnd(v)
        s = v if s is None else rnd(s + v)
    if relu:
        s = torch.where(s < 0, torch.zeros_like(s), s)
    q = None
    if q_inv is not None:
        q = torch.round(s * q_inv).clamp(-127, 127).to(torch.int8)
    return s.to(dtype), q


def _operands(kinds, c=8, h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    ops = []
    for kind, f in kinds:
        shape = (2, c, h // f, w // f)
        if kind == "int8":
            t = torch.from_numpy(rng.integers(-127, 128, size=shape)
                                 .astype(np.int8))
            ops.append(Operand(t, torch.tensor(0.3 + 0.11 * len(ops)), f))
        else:
            # values on bf16 ties and half-integers, and random ones
            v = rng.integers(-400, 401, size=shape) + 0.5 * (
                rng.random(shape) < 0.3)
            v = v * (1.0 if len(ops) % 2 else rng.random(shape) * 3)
            t = torch.from_numpy(v.astype(np.float32))
            ops.append(Operand(t.to(torch.bfloat16 if kind == "bf16"
                                    else torch.float32), None, f))
    return ops


CASES = {
    "bf16-x1248": ("bf16", [("bf16", 1), ("bf16", 2), ("bf16", 4),
                            ("bf16", 8)]),
    "int8-x1248": ("bf16", [("int8", 1), ("int8", 2), ("int8", 4),
                            ("int8", 8)]),
    "mixed-x12": ("bf16", [("int8", 1), ("bf16", 2)]),
    "f32-x1248": ("f32", [("f32", 1), ("f32", 2), ("f32", 4), ("f32", 8)]),
    "f32-int8": ("f32", [("int8", 1), ("f32", 4)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_fuse_sum_plain_matches_the_kernels_arithmetic(name, relu):
    dt, kinds = CASES[name]
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    ops = _operands(kinds)
    q_inv = torch.tensor(0.5)
    got = qfuse.fuse_sum(ops, dtype, relu=relu, q_inv=q_inv)
    want = fuse_walk(ops, dtype, relu, q_inv)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert {-127, 127} <= set(want[1].unique().tolist()) or relu
    if dtype == torch.bfloat16:
        # the rounding after each add matters on these values
        once = fuse_walk(ops, torch.float32, relu, None)[0]
        assert not torch.equal(_bf16(once), want[0].float())


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
def test_fuse_sum_plain_matches_the_float_graphs_expression(factor):
    """The float graph's fuse sum: a fuse conv's float32 output upsampled
    then cast (``_conv(..., upsample).to(dtype)``), added to the branch's
    own activation in the dtype, the ReLU; then ``quantize_act`` at the
    consumer's scale.  The pass takes the operand at its low resolution
    and upsamples it in the read."""
    rng = np.random.default_rng(factor)
    own = torch.from_numpy(rng.normal(size=(1, 8, 16, 16)).astype(
        np.float32) * 30).to(torch.bfloat16)
    low = torch.from_numpy(rng.normal(size=(1, 8, 16 // factor,
                                            16 // factor)).astype(np.float32)
                           * 30)
    inv = torch.tensor(1.7)
    acc = own + F.interpolate(low, scale_factor=factor,
                              mode="nearest").to(torch.bfloat16)
    want = torch.relu(acc)
    got, q = qfuse.fuse_sum([Operand(own), Operand(low.to(torch.bfloat16),
                                                   None, factor)],
                            torch.bfloat16, relu=True, q_inv=inv)
    assert torch.equal(got, want)
    assert torch.equal(q, quantize_act(want, inv))


def test_one_pass_quantize_and_the_head_halves():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
                         * 200).to(torch.bfloat16)
    inv = torch.tensor(0.61)
    q = qfuse.quantize(x, inv, 16)
    assert torch.equal(q, quantize_act(x, inv))
    assert q.shape == (2, 3, 8, 8) and q.stride(1) == 64
    base = q.as_strided((2, 16, 8, 8), (1024, 64, 8, 1))
    assert int(base[:, 3:].abs().sum()) == 0
    # the head: [x0 (int8 at its reader's scale, read as float32), y0]
    x0 = torch.from_numpy(rng.integers(-127, 128, size=(2, 5, 8, 8))
                          .astype(np.int8))
    y0 = x[:, :2].float().to(torch.bfloat16)
    s0 = torch.tensor(0.83)
    cat = torch.cat([x0.float() / s0, y0.float()], dim=1)
    buf = torch.full((2, 16, 8, 8), 7, dtype=torch.int8)
    qfuse.fuse_sum([Operand(x0, s0)], torch.float32, store=False, q_inv=inv,
                   out_q=buf)
    qfuse.fuse_sum([Operand(y0)], torch.float32, store=False, q_inv=inv,
                   out_q=buf, q_off=5, q_zero=9)
    assert torch.equal(buf[:, :7], quantize_act(cat, inv))
    assert int(buf[:, 7:].abs().sum()) == 0
