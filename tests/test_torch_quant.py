"""The port's int8 quantization (``rtpe_tpu_torch/ops/quant.py``) against
``rtpe_tpu.ops.quant``, on the CPU.

* ``quantize_weight`` and ``quantize_act`` bitwise equal to JAX's, on
  values that tie at .5 (round half to even) and beyond +-127;
* the plain ``qconv``'s int32 sums bitwise equal to
  ``jax.lax.conv_general_dilated(..., preferred_element_type=int32)`` at
  every geometry of the port's dense graph (3 x 3 at stride 1 and 2,
  1 x 1, Cin = 3, Cout = 17 and 34, the 1 x 1 then nearest upsampling
  against JAX's repeat-kernel "fuseup", and the 4 x 4 transposed conv
  with its 82-channel concat against JAX's lhs-dilated, flipped
  "tconv"), on int8 inputs with +-127 everywhere; the float32 result
  ``acc * alpha + bias`` bitwise equal to JAX's ``qconv`` too (XLA's
  CPU does not contract the epilogue into an FMA here);
* a PyTorch walk of the kernel's tiling (``csrc/qconv.cu``): 128-pixel
  by BN-channel tiles, K in 16-channel segments two at a time, the
  gather's padding, dilation and channel masks, the zero segments past
  the last tap and the rows past Cout, then the epilogue, held exactly
  to the plain version; with the dilation's parity mask left out it is
  not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from rtpe_tpu.ops import quant as jq
from rtpe_tpu_torch.ops import quant

# (cout, cin, k, stride, h, w, transposed, upsample)
GEOMETRIES = {
    "conv1-cin3-s2": (64, 3, 3, 2, 21, 18, False, 1),
    "3x3-s1": (48, 48, 3, 1, 11, 13, False, 1),
    "3x3-s2": (96, 48, 3, 2, 12, 9, False, 1),
    "3x3-s2-wide": (40, 192, 3, 2, 6, 7, False, 1),
    "1x1": (256, 64, 1, 1, 7, 5, False, 1),
    "1x1-cout17": (17, 48, 1, 1, 9, 10, False, 1),
    "1x1-cout34": (34, 48, 1, 1, 6, 8, False, 1),
    "fuseup-x2": (48, 96, 1, 1, 5, 6, False, 2),
    "fuseup-x8": (48, 384, 1, 1, 3, 2, False, 8),
    "tconv-cin82": (48, 82, 4, 2, 7, 6, True, 1),
}


def _int8(rng, shape):
    """Random int8 values with +-127 planted in every row."""
    a = rng.integers(-127, 128, size=shape).astype(np.int8)
    flat = a.reshape(-1, shape[-1])
    flat[::2, 0] = 127
    flat[1::2, -1] = -127
    return a


def _case(name, b=2, seed=0):
    """int8 x (B, H, W, Cin), int8 weights in the port's layout, f32
    alpha and bias, and the port's QConv."""
    cout, cin, k, _, h, w, tr, _ = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    x = _int8(rng, (b, h, w, cin))
    wq = _int8(rng, (cin, cout, k, k) if tr else (cout, cin, k, k))
    alpha = (rng.random(cout) * 1e-3).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    kernel, c = quant.kernel_layout(torch.from_numpy(wq), tr)
    q = quant.QConv(kernel, torch.from_numpy(bias), torch.from_numpy(alpha),
                    torch.tensor(1.0), c, tr)
    return x, wq, alpha, bias, q


def _jax_int32(name, x, wq):
    """XLA's int32 sums for the geometry, in JAX's kinds: dense, fuseup
    (a kernel of f x f copies of the 1 x 1, lhs-dilated by f) or tconv
    (lhs-dilated by 2, padded 2, the kernel flipped)."""
    _, _, k, s, _, _, tr, up = GEOMETRIES[name]
    if tr:
        hwio = np.transpose(wq, (2, 3, 0, 1))[::-1, ::-1]
        args = ((1, 1), ((2, 2), (2, 2)), (2, 2))
    elif up > 1:
        hwio = np.broadcast_to(np.transpose(wq, (2, 3, 1, 0)),
                               (up, up) + wq.shape[1::-1])
        args = ((1, 1), ((up - 1, up - 1),) * 2, (up, up))
    else:
        hwio = np.transpose(wq, (2, 3, 1, 0))
        p = (k - 1) // 2
        args = ((s, s), ((p, p), (p, p)), None)
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(np.ascontiguousarray(hwio)), args[0],
        args[1], lhs_dilation=args[2],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


def _port(name, x, q, int32=True):
    """The port's plain version in its graph's geometry: NCHW in, NHWC
    out, the fuse conv's nearest upsampling after the 1 x 1."""
    _, _, _, s, _, _, tr, up = GEOMETRIES[name]
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    stride, pad = (2, 1) if tr else (s, None)
    y = (quant.qconv_int32_plain(xc, q, stride, pad) if int32
         else quant.qconv(xc, q, stride, pad))
    if up > 1:
        y = F.interpolate(y.float() if int32 else y, scale_factor=up,
                          mode="nearest")
        y = y.to(torch.int32) if int32 else y
    return y.permute(0, 2, 3, 1).numpy()


def test_quantize_weight_matches_jax_on_ties_and_layouts():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 5, 6)).astype(np.float32)            # HWIO
    # channel 0: absmax 127 -> s_w = 1, so k + 0.5 ties; channel 1 all 0
    w[..., 0] = np.resize(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 126.5,
                                    -1.5, 4.5], np.float32), (3, 3, 5))
    w[..., 1] = 0.0
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = quant.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(tw.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    assert set(np.unique(tw[0].numpy())) >= {2, -4, 0, 126, -2, 4, 127}
    # a transposed conv's (in, out, kh, kw): the scale over axis 1
    tw_t, ts_t = quant.quantize_weight(
        torch.from_numpy(w.transpose(2, 3, 0, 1)), out_axis=1)
    np.testing.assert_array_equal(tw_t.numpy().transpose(2, 3, 0, 1),
                                  np.asarray(jw))
    np.testing.assert_array_equal(ts_t.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_act_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = np.concatenate([
        np.arange(-130, 131, dtype=np.float32) + 0.5,        # ties
        np.array([300.0, -1000.0, 127.4, -127.6, 0.0, -0.0]),
        rng.normal(scale=50.0, size=500)]).astype(np.float32)
    for inv in (1.0, 0.37, 3.0):
        jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                   else jnp.float32)
        want = np.asarray(jq.quantize_act(jx, jnp.float32(inv)))
        tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                    else torch.float32)
        got = quant.quantize_act(tx, torch.tensor(inv, dtype=torch.float32))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_qconv_int32_matches_xla(name):
    x, wq, _, _, q = _case(name)
    want = _jax_int32(name, x, wq)
    got = _port(name, x, q)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 127 * 127     # saturated products summed


@pytest.mark.parametrize("name", [n for n in sorted(GEOMETRIES)
                                  if GEOMETRIES[n][7] == 1])
def test_plain_qconv_f32_matches_jax_qconv(name):
    """The whole ``qconv`` on an int8 input: the f32 dequantized result
    bitwise equal to JAX's (no FMA contraction on either side).  JAX's
    ``qconv`` has no upsampling; the fuse convs' sums are
    :func:`test_plain_qconv_int32_matches_xla`'s."""
    _, _, k, s, _, _, tr, _ = GEOMETRIES[name]
    x, wq, alpha, bias, q = _case(name, seed=3)
    hwio = np.transpose(wq, (2, 3, 0, 1) if tr else (2, 3, 1, 0))
    jconv = jq.QConv(jnp.asarray(np.ascontiguousarray(hwio)),
                     jnp.asarray(bias), jnp.asarray(alpha), jnp.float32(1.0))
    if tr:
        want = jq.qconv(jnp.asarray(x), jconv, (1, 1), ((2, 2), (2, 2)),
                        lhs_dilation=(2, 2), flip=True)
    else:
        p = (k - 1) // 2
        want = jq.qconv(jnp.asarray(x), jconv, (s, s), ((p, p), (p, p)))
    np.testing.assert_array_equal(_port(name, x, q, int32=False),
                                  np.asarray(want))


# ------------------------------------------------ the kernel's tiling

BM = 128


def kernel_walk(xq: torch.Tensor, q: quant.QConv, stride: int,
                padding: int, parity: bool = True) -> torch.Tensor:
    """``csrc/qconv.cu`` in PyTorch, tile by tile: the block's 128
    output pixels x BN channels, K two 16-channel segments a step, each
    segment one tap's channels c0..c0+15 gathered from the NHWC input
    (zero where the tap falls in the padding or, for the dilated input,
    on an odd row or column, past Cin, or past the last tap), the weight
    rows past Cout zero, int32 sums, then acc.float() * alpha + bias.
    ``parity=False`` leaves out the dilation's parity mask."""
    x = xq.permute(0, 2, 3, 1).contiguous()
    b, h, w, cin = x.shape
    cout, kh, kw, _ = q.kernel.shape
    plan = quant.qconv_plan(cin, cout, kh, kw)
    bn, cseg, nseg = plan["bn"], plan["cseg"], plan["nseg"]
    s, pad, dil, ho, wo = quant._geometry(q, h, w, stride, padding)
    m = b * ho * wo
    mi = torch.arange(m)
    pb, r = mi // (ho * wo), mi % (ho * wo)
    oy, ox = r // wo, r % wo
    wflat = q.kernel.reshape(cout, -1).long()
    out = torch.empty((m, cout), dtype=torch.float32)
    for m0 in range(0, m, BM):
        rows = slice(m0, min(m0 + BM, m))
        nr = rows.stop - m0
        for n0 in range(0, cout, bn):
            nv = min(bn, cout - n0)
            acc = torch.zeros((nr, bn), dtype=torch.long)
            for ks in range(plan["ksteps"]):
                a = torch.zeros((nr, 32), dtype=torch.long)
                bt = torch.zeros((bn, 32), dtype=torch.long)
                for h2 in range(2):
                    seg = ks * 2 + h2
                    if seg >= nseg:
                        continue
                    tap, c0 = seg // cseg, (seg % cseg) * 16
                    ky, kx = tap // kw, tap % kw
                    iy = oy[rows] * s + ky - pad
                    ix = ox[rows] * s + kx - pad
                    ok = (iy >= 0) & (ix >= 0)
                    if dil == 2:
                        if parity:
                            ok &= (iy % 2 == 0) & (ix % 2 == 0)
                        iy, ix = iy // 2, ix // 2
                    ok &= (iy < h) & (ix < w)
                    nb = min(16, cin - c0)
                    vals = x[pb[rows], iy.clamp(0, h - 1), ix.clamp(0, w - 1),
                             c0:c0 + nb].long()
                    a[:, h2 * 16:h2 * 16 + nb] = vals * ok[:, None]
                    bt[:nv, h2 * 16:h2 * 16 + 16] = \
                        wflat[n0:n0 + nv, seg * 16:seg * 16 + 16]
                acc += a @ bt.T
            assert int(acc.abs().max()) < 2 ** 31
            out[rows, n0:n0 + nv] = (acc[:, :nv].to(torch.float32)
                                     * q.alpha[n0:n0 + nv]
                                     + q.bias[n0:n0 + nv])
    return out.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_kernel_walk_matches_plain(name):
    _, _, _, s, _, _, tr, _ = GEOMETRIES[name]
    x, _, _, _, q = _case(name, b=3, seed=5)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    stride, pad = (2, 1) if tr else (s, (q.kernel.shape[1] - 1) // 2)
    want = quant.qconv_plain(xc, q, stride, pad)
    got = kernel_walk(xc, q, stride, pad)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    if tr:       # the walk sees the dilation's holes
        assert not torch.equal(kernel_walk(xc, q, stride, pad, parity=False),
                               want)


def test_qconv_plan_at_the_w48_shapes():
    """The N tile pads Cout least (the larger tile on a tie); K is 16
    channels a segment, padded channels included, and two segments a
    step."""
    bns = {c: quant.qconv_plan(48, c, 3, 3)["bn"]
           for c in (17, 34, 48, 64, 96, 192, 256, 384)}
    assert bns == {17: 32, 34: 48, 48: 48, 64: 64, 96: 48, 192: 64,
                   256: 64, 384: 64}
    assert quant.qconv_plan(3, 64, 3, 3) == {"bn": 64, "cseg": 1,
                                             "nseg": 9, "ksteps": 5}
    assert quant.qconv_plan(82, 48, 4, 4) == {"bn": 48, "cseg": 6,
                                              "nseg": 96, "ksteps": 48}
    kernel, cin = quant.kernel_layout(torch.ones((82, 48, 4, 4),
                                                 dtype=torch.int8), True)
    assert cin == 82 and kernel.shape == (48, 4, 4, 96)
    kernel, cin = quant.kernel_layout(torch.ones((64, 3, 3, 3),
                                                 dtype=torch.int8))
    assert cin == 3 and kernel.shape == (64, 3, 3, 16)
    assert int(kernel[..., 3:].abs().sum()) == 0


def test_qconv_takes_the_plain_version_on_the_cpu_only():
    x, _, _, _, q = _case("3x3-s1")
    before = quant.qconv.launches
    y = quant.qconv(torch.from_numpy(x).permute(0, 3, 1, 2), q)
    assert quant.qconv.launches == before and y.dtype == torch.float32
    with pytest.raises(ValueError, match="unsupported device"):
        quant.qconv(torch.empty((1, 48, 4, 4), device="meta"), q)
