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
  by BN-channel tiles (BN the s8 ``wgmma`` N), K stages of 128 bytes
  whose 16-byte chunks find their own taps, the gather's padding mask,
  the zero chunks past K and the rows past Cout, the split-K partials
  summed by the last block, and the transposed conv's four sub-pixel
  phases (2 x 2 convs over the undilated input), then the epilogue,
  held exactly to the plain version at every geometry; with a phase
  reading its neighbour's taps it is not;
* a walk of the kernel's epilogue, one float32 step and one rounding at
  a time in the kernel's order, held bitwise to ``epilogue_plain`` (the
  graph's own ops) in every mode on values at bf16 ties, at the clamp's
  edges and on round-half-even points;
* the plan against the kernel's geometry rules at the W48's shapes, and
  the launch fields against the C sources' enums.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from rtpe_tpu.ops import quant as jq
from rtpe_tpu_torch.ops import qfuse, quant

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


def _phase_geometry(q, phase, stride, padding, swap=False):
    """A phase's (s, pady, padx, ky0, kx0, kst, taps_w): the transposed
    conv's phase (py, px) reads input row my + ty + py - 1 with weight
    row py + 2 ty (``swap``: its vertical neighbour's taps)."""
    if not q.transposed:
        return stride, padding, padding, 0, 0, 1, q.kernel.shape[2]
    py, px = divmod(phase, 2)
    ky0 = 1 - py if swap else py
    return 1, 1 - py, 1 - px, ky0, px, 2, 2


def kernel_walk(xq: torch.Tensor, q: quant.QConv, stride: int,
                padding: int, splits=None, swap_phases=False
                ) -> torch.Tensor:
    """``csrc/qconv.cu`` in PyTorch, tile by tile, on the plan of
    :func:`quant.qconv_plan`: for each phase, 128-pixel x BN-channel
    tile and K split, the stages of 128 bytes, each 16-byte chunk one
    tap's channels c..c+15 gathered from the NHWC input (zero where the
    tap falls outside the image or past K), the weight rows past Cout
    zero; the splits' int32 partials summed, then acc.float() * alpha +
    bias.  ``splits`` overrides the plan's."""
    x = xq.permute(0, 2, 3, 1)
    b, h, w, cin = x.shape
    cout, kh, kw, cpad = q.kernel.shape
    plan = quant.qconv_plan(b, h, w, cin, cout, kh, kw, stride, padding,
                            q.transposed)
    bn, taps, nsteps = plan["bn"], plan["taps"], plan["nsteps"]
    s_all = splits or plan["splits"]
    xp = torch.zeros((b, h, w, cpad), dtype=torch.long)
    xp[..., :cin] = x.long()
    wk = q.kernel.long()
    if q.transposed:
        ho, wo, hm, wm = 2 * h, 2 * w, h, w
    else:
        ho = (h + 2 * padding - kh) // stride + 1
        wo = (w + 2 * padding - kw) // stride + 1
        hm, wm = ho, wo
    acc_all = torch.zeros((b, ho, wo, cout), dtype=torch.long)
    ktot = taps * cpad
    for phase in range(plan["phases"]):
        s, pady, padx, ky0, kx0, kst, tw = _phase_geometry(
            q, phase, stride, padding, swap_phases)
        py, px = divmod(phase, 2)
        m = b * hm * wm
        mi = torch.arange(m)
        pb, r = mi // (hm * wm), mi % (hm * wm)
        my, mx = r // wm, r % wm
        for m0 in range(0, m, quant.BM):
            rows = slice(m0, min(m0 + quant.BM, m))
            for n0 in range(0, cout, bn):
                nv = min(bn, cout - n0)
                parts = []
                for sp in range(s_all):
                    s0, s1 = sp * nsteps // s_all, (sp + 1) * nsteps // s_all
                    part = torch.zeros((rows.stop - m0, bn), dtype=torch.long)
                    for step in range(s0, s1):
                        a = torch.zeros((rows.stop - m0, quant.KC),
                                        dtype=torch.long)
                        bt = torch.zeros((bn, quant.KC), dtype=torch.long)
                        for ch in range(quant.KC // quant.SEGMENT):
                            kk = step * quant.KC + ch * quant.SEGMENT
                            if kk >= ktot:
                                continue
                            tap, c = kk // cpad, kk % cpad
                            ty, tx = tap // tw, tap % tw
                            iy = my[rows] * s - pady + ty
                            ix = mx[rows] * s - padx + tx
                            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                            cols = slice(ch * 16, ch * 16 + 16)
                            a[:, cols] = xp[pb[rows], iy.clamp(0, h - 1),
                                            ix.clamp(0, w - 1),
                                            c:c + 16] * ok[:, None]
                            bt[:nv, cols] = wk[n0:n0 + nv, ky0 + kst * ty,
                                               kx0 + kst * tx, c:c + 16]
                        part += a @ bt.T
                    parts.append(part)
                acc = sum(parts)          # the last block of the tile
                assert int(acc.abs().max()) < 2 ** 31
                oy = 2 * my[rows] + py if q.transposed else my[rows]
                ox = 2 * mx[rows] + px if q.transposed else mx[rows]
                acc_all[pb[rows], oy, ox, n0:n0 + nv] = acc[:, :nv]
    return quant.dequantize(acc_all.permute(0, 3, 1, 2), q)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_kernel_walk_matches_plain(name):
    _, _, _, s, _, _, tr, _ = GEOMETRIES[name]
    x, _, _, _, q = _case(name, b=3, seed=5)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    stride, pad = (2, 1) if tr else (s, (q.kernel.shape[1] - 1) // 2)
    want = quant.qconv_plain(xc, q, stride, pad)
    plan = quant.qconv_plan(3, *x.shape[1:3], q.cin, q.kernel.shape[0],
                            *q.kernel.shape[1:3], stride, pad, tr)
    # the small shapes split K wherever it has two stages a split
    two = plan["nsteps"] >= 2 * quant.MIN_SPLIT_STEPS
    assert (plan["splits"] > 1) == two
    got = kernel_walk(xc, q, stride, pad)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(kernel_walk(xc, q, stride, pad, splits=1), want)


def test_kernel_walk_phase_reads_its_own_taps():
    """Each sub-pixel phase reads its own taps: a walk in which a phase
    takes its vertical neighbour's differs from the plain version."""
    x, _, _, _, q = _case("tconv-cin82", b=1, seed=6)
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = quant.qconv_plain(xc, q, 2, 1)
    assert torch.equal(kernel_walk(xc, q, 2, 1), want)
    assert not torch.equal(kernel_walk(xc, q, 2, 1, swap_phases=True), want)


def test_qconv_plan_at_the_w48_shapes():
    """The N tile covers Cout in the fewest tiles of at most 64 (Cout
    17 -> 24, 34 -> 48, 96 in two of 48, 384 in six of 64); K is taps x
    Cpad in stages of 128 bytes; the transposed conv is 4 phases of 4
    taps; K splits only where the tiles leave SMs idle, within one wave
    of 132."""
    tiles = {c: (quant.qconv_plan(8, 40, 40, 48, c, 3, 3, 1, 1)["bn"],
                 quant.qconv_plan(8, 40, 40, 48, c, 3, 3, 1, 1)["tiles_n"])
             for c in (17, 34, 48, 64, 96, 192, 256, 384)}
    assert tiles == {17: (24, 1), 34: (48, 1), 48: (48, 1), 64: (64, 1),
                     96: (48, 2), 192: (64, 3), 256: (64, 4), 384: (64, 6)}
    p = quant.qconv_plan(8, 640, 640, 3, 64, 3, 3, 2, 1)
    assert (p["cpad"], p["taps"], p["nsteps"], p["splits"]) == (16, 9, 2, 1)
    assert p["tiles_m"] == 8 * 320 * 320 // 128
    p = quant.qconv_plan(8, 160, 160, 82, 48, 4, 4, 2, 1, True)
    assert (p["phases"], p["taps"], p["cpad"], p["nsteps"]) == (4, 4, 96, 3)
    assert p["tiles_m"] == 8 * 160 * 160 // 128 and p["splits"] == 1
    # the 40^2 and 20^2 convs: B = 8 one wave or less unsplit; B = 1 split
    assert quant.qconv_plan(8, 40, 40, 192, 192, 3, 3, 1, 1)["splits"] == 1
    p = quant.qconv_plan(1, 40, 40, 192, 192, 3, 3, 1, 1)
    assert (p["tiles_m"], p["tiles_n"], p["nsteps"], p["splits"]) == \
        (13, 3, 14, 3)
    p = quant.qconv_plan(1, 20, 20, 384, 384, 3, 3, 1, 1)
    assert (p["tiles_m"], p["tiles_n"], p["splits"]) == (4, 6, 5)
    assert p["ws_bytes"] == 4 * 24 * 5 * 128 * 64 and p["counters"] == 24
    assert p["tiles_m"] * p["tiles_n"] * p["splits"] <= 132
    assert quant.qconv_plan(1, 5, 5, 48, 48, 3, 3, 1, 1, True) is None
    kernel, cin = quant.kernel_layout(torch.ones((82, 48, 4, 4),
                                                 dtype=torch.int8), True)
    assert cin == 82 and kernel.shape == (48, 4, 4, 96)
    kernel, cin = quant.kernel_layout(torch.ones((64, 3, 3, 3),
                                                 dtype=torch.int8))
    assert cin == 3 and kernel.shape == (64, 3, 3, 16)
    assert int(kernel[..., 3:].abs().sum()) == 0


@pytest.mark.parametrize("src,fields", [("qconv", quant.LAUNCH_FIELDS),
                                        ("qfuse", qfuse.LAUNCH_FIELDS)])
def test_launch_fields_follow_the_kernels_enum(src, fields):
    """The wrappers' int64 launch arrays name the C sources' fields in
    their order."""
    path = os.path.join(os.path.dirname(quant.__file__), "..", "csrc",
                        f"{src}.cu")
    with open(path) as f:
        body = re.search(r"enum Field \{(.*?)\};", f.read(), re.S).group(1)
    names = [n.strip()[2:].lower() for n in body.split(",") if n.strip()]
    assert names[-1] == "count"
    assert tuple(names[:-1]) == fields


def test_qconv_takes_the_plain_version_on_the_cpu_only():
    x, _, _, _, q = _case("3x3-s1")
    before = quant.qconv.launches
    y = quant.qconv(torch.from_numpy(x).permute(0, 3, 1, 2), q)
    assert quant.qconv.launches == before and y.dtype == torch.float32
    with pytest.raises(ValueError, match="unsupported device"):
        quant.qconv(torch.empty((1, 48, 4, 4), device="meta"), q)


# ------------------------------------------------ the kernel's epilogue

def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def epilogue_walk(acc: torch.Tensor, alpha: torch.Tensor,
                  bias: torch.Tensor, e: quant.Epilogue):
    """``csrc/qconv.cu``'s epilogue, one float32 step at a time with
    each rounding written out: ``fadd(fmul(acc, alpha), bias)``, ReLU,
    ``rnd(fadd(rnd(y), res))`` (an int8 residual ``rnd(fdiv(r8,
    res_inv))``), ReLU, the store rounded to the dtype, and int8 as
    ``clamp(rint(fmul(v, q_inv)))`` of the rounded or float32 value."""
    bf = e.dtype == torch.bfloat16
    rnd = _bf16 if bf else (lambda v: v)
    y = acc.to(torch.float32) * alpha[:, None, None]
    y = y + bias[:, None, None]
    if e.relu:
        y = torch.where(y < 0, torch.zeros_like(y), y)
    if e.res is not None:
        r = e.res.to(torch.float32)
        if e.res.dtype == torch.int8:
            r = rnd(r / e.res_inv)
        y = rnd(rnd(y) + r)
    if e.relu_after:
        y = torch.where(y < 0, torch.zeros_like(y), y)
    q = None
    if e.q_inv is not None:
        v = rnd(y) if e.q_rounded else y
        q = torch.round(v * e.q_inv).clamp(-127, 127).to(torch.int8)
    return (y.to(e.dtype) if e.store else None), q


def _epilogue_inputs(seed: int = 0):
    """int32 sums and f32 alpha / bias / residuals, a third of them
    exact (alpha 1, bias 0) so that the residual sums land on bf16 ties
    (odd integers past 256) and the int8 stores on +-126.5, +-127.5 and
    other half-integers at q_inv 0.5, the rest random."""
    rng = np.random.default_rng(seed)
    c, h, w = 12, 16, 16
    acc = rng.integers(-300, 301, size=(1, c, h, w)).astype(np.int32)
    acc[0, :4].flat[:8] = [253, 255, -253, -255, 254, -254, 257, -257]
    alpha = np.ones(c, np.float32)
    alpha[4:] = rng.random(c - 4).astype(np.float32) * 2
    bias = np.zeros(c, np.float32)
    bias[8:] = rng.normal(size=c - 8).astype(np.float32) * 50
    r8 = rng.integers(-127, 128, size=(1, c, h, w)).astype(np.int8)
    res_f = (rng.integers(-200, 201, size=(1, c, h, w)) + 0.5 * (
        rng.random((1, c, h, w)) < 0.2)).astype(np.float32)
    t = torch.from_numpy
    return t(acc), t(alpha), t(bias), t(r8), t(res_f)


def _modes(r8, res_f):
    half = torch.tensor(0.5)
    two = torch.tensor(2.0)
    bf, f32 = torch.bfloat16, torch.float32
    E = quant.Epilogue
    return {
        "f32-store": E(f32),
        "bf16-store": E(bf),
        "relu+bf16+q": E(bf, relu=True, q_inv=half),
        "relu+q-of-f32": E(bf, relu=True, store=False, q_inv=half,
                           q_rounded=False),
        "relu+q-of-bf16": E(bf, relu=True, store=False, q_inv=two),
        "res-bf16+relu+q": E(bf, res=res_f.to(bf), relu_after=True,
                             q_inv=half),
        "res-int8+relu+q": E(bf, res=r8, res_inv=half, relu_after=True,
                             store=False, q_inv=half),
        "res-int8-noexact": E(bf, res=r8, res_inv=torch.tensor(0.37),
                              relu_after=True, q_inv=half),
        "res-f32+relu+q": E(f32, res=res_f, relu_after=True, q_inv=half),
        "res-int8-f32": E(f32, res=r8, res_inv=half, q_inv=two),
    }


@pytest.mark.parametrize("mode", sorted(_modes(torch.zeros(1),
                                               torch.zeros(1))))
def test_epilogue_walk_matches_the_graphs_ops(mode):
    acc, alpha, bias, r8, res_f = _epilogue_inputs()
    e = _modes(r8, res_f)[mode]
    q = quant.QConv(torch.zeros((12, 1, 1, 16), dtype=torch.int8), bias,
                    alpha, torch.tensor(1.0), 16, False)
    want = quant.epilogue_plain(quant.dequantize(acc, q), e)
    got = epilogue_walk(acc, alpha, bias, e)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    if e.q_inv is not None and float(e.q_inv) == 0.5 and not e.relu \
            and not e.relu_after:
        assert {-127, 127} <= set(want[1].unique().tolist())
    if e.res is not None and e.dtype == torch.bfloat16:
        # the sum's rounding matters here: rounding once at the end (an
        # FMA-like contraction of the residual add) would differ
        y = acc.float() * alpha[:, None, None] + bias[:, None, None]
        r = (_bf16(e.res.float() / e.res_inv) if e.res.dtype == torch.int8
             else e.res.float())
        ties = (y + r)[(y + r).abs() > 256]
        assert bool((ties != _bf16(ties)).any())
