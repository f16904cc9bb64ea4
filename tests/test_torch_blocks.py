"""The port's BasicBlock chain against the JAX package's, on the CPU.

The plain version of ``csrc/basicblock_chain.cu`` (``ops/blocks.py``)
against ``rtpe_tpu.ops.pallas_blocks.basicblock_chain`` run in
interpret mode, on the same numpy inputs:

* float32 on the three shapes of ``tests/test_pallas_blocks.py``, at
  that test's tolerance (rtol 1e-4, atol 1e-5): the two sum each conv in
  another order;
* bf16 activations and weights: both accumulate each conv in float32
  and round at the same points, so they differ only where the order of
  a float32 sum flips a bf16 rounding (2^-8 relative), and such a flip
  carries into the next convs of the chain: every element within
  2^-6 (|want| + 1).

The CUDA wrapper takes the plain version for a CPU tensor, counts no
launch there, and refuses shapes the chain does not have.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtpe_tpu.ops.pallas_blocks import basicblock_chain as j_chain
from rtpe_tpu_torch.ops.blocks import basicblock_chain, basicblock_chain_plain

BF16_TOL = 2.0 ** -6


def chain_inputs(shape, n, seed=0):
    """The inputs of ``tests/test_pallas_blocks.py``."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32) * 0.1
    w = rng.randn(n, 2, 3, 3, c, c).astype(np.float32) * 0.05
    b = rng.randn(n, 2, c).astype(np.float32) * 0.1
    return x, w, b


@pytest.mark.parametrize("shape,n", [((2, 16, 16, 96), 2),
                                     ((1, 8, 24, 128), 4),
                                     ((2, 12, 8, 192), 1)])
def test_plain_chain_matches_pallas_interpret(shape, n):
    x, w, b = chain_inputs(shape, n)
    want = np.asarray(j_chain(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), interpret=True))
    before = basicblock_chain.launches
    got = basicblock_chain(*(torch.from_numpy(a) for a in (x, w, b)))
    assert basicblock_chain.launches == before      # CPU: plain version
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,n", [((2, 10, 12, 32), 2),
                                     ((1, 6, 7, 64), 4)])
def test_plain_chain_matches_pallas_interpret_in_bf16(shape, n):
    rng = np.random.default_rng(1)
    c = shape[-1]
    # activations of order 1 through the chain
    xb = rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    wb = (rng.normal(size=(n, 2, 3, 3, c, c)) / np.sqrt(9 * c)).astype(
        ml_dtypes.bfloat16)
    b = (rng.normal(size=(n, 2, c)) * 0.1).astype(np.float32)
    want = np.asarray(j_chain(jnp.asarray(xb), jnp.asarray(wb),
                              jnp.asarray(b), interpret=True),
                      np.float32)
    got = basicblock_chain_plain(
        torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(wb.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert 0.5 < np.abs(want).max() < 50
    assert (np.abs(got - want) <= BF16_TOL * (np.abs(want) + 1)).all(), \
        np.abs(got - want).max()
    # most elements agree exactly: only flipped roundings differ
    assert (got == want).mean() > 0.9


def test_plain_chain_takes_a_channels_last_view():
    """The packed forward hands the chain the NHWC view of its
    channels_last NCHW activations."""
    x, w, b = (torch.from_numpy(a) for a in chain_inputs((2, 5, 6, 32), 2))
    nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    view = nchw.permute(0, 2, 3, 1)
    assert view.data_ptr() == nchw.data_ptr() and view.is_contiguous()
    assert torch.equal(basicblock_chain(view, w, b),
                       basicblock_chain(x, w, b))


def test_chain_refuses_bad_shapes_and_devices():
    x, w, b = (torch.from_numpy(a) for a in chain_inputs((1, 4, 4, 32), 2))
    with pytest.raises(ValueError):
        basicblock_chain(x, w[:, :1], b)
    with pytest.raises(ValueError):
        basicblock_chain(x, w, b[:1])
    with pytest.raises(ValueError):
        basicblock_chain(x[0], w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        basicblock_chain(x.to("meta"), w.to("meta"), b.to("meta"))
