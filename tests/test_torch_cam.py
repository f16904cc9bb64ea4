"""The fused CAM ops of the port against the JAX package, on the CPU.

* Each of the six kernels' plain versions (``rtpe_tpu_torch.ops.cam``)
  against the JAX kernel it replaces (``rtpe_tpu/ops/pallas_cam.py``,
  interpret mode), on the same inputs made with numpy: the sizes of
  ``tests/test_pallas_cam.py`` (B=2, 21x21, C=12, dils (1, 2, 3)) and one
  with four dilations.  Float32 outputs within 1e-5 of their largest
  magnitude (sum order); bf16 outputs within 2^-8 (one rounding may land
  on the other side of a tie).
* The F3b gate fault of the TPU kernel (``pallas_cam.py:507`` reads image
  0's gate in phase 1): with per-image gates of both signs, the port's
  dx equals autograd of the unfused math on every image, and JAX's only
  on image 0 or when the gate rows are equal.
* ``ContextAwareModule(fused=True)`` against JAX's: forward, running
  statistics, parameter gradients and dx on image 0; against the port's
  own unfused module; eval mode takes the unfused path.

JAX's interpret runs are module-scoped fixtures, one per shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtpe_tpu.models.students import ContextAwareModule as JaxCAM
from rtpe_tpu.ops import pallas_cam as pc
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models.students import ContextAwareModule
from rtpe_tpu_torch.ops import cam

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8

SHAPES = {"dils3": (2, 21, 21, 12, (1, 2, 3), 3),
          "dils4": (2, 13, 11, 16, (1, 2, 3, 4), 4)}


def _inputs(b, h, w, c, dils, hc, seed):
    rng = np.random.default_rng(seed)
    nb = len(dils)

    def rows(k, width):
        out = []
        for _ in range(k):
            out += [0.3 * rng.normal(size=width), 1.0 + rng.random(width),
                    1.0 + 0.1 * rng.normal(size=width),
                    0.1 * rng.normal(size=width)]
        return np.stack(out).astype(np.float32)

    f32 = np.float32
    return {
        "x": rng.random((b, h, w, c)).astype(f32),
        "kr": (rng.normal(size=(c, c)) / np.sqrt(c)).astype(f32),
        "kh": (rng.normal(size=(nb, 3, 3, c, hc)) / np.sqrt(9 * c)
               ).astype(f32),
        "kt": (rng.normal(size=(nb, hc, c)) / np.sqrt(nb * hc)).astype(f32),
        "bnh": rows(nb, hc), "bnr": rows(1, c), "bnt": rows(1, c),
        # gates of both signs, distinct per image
        "gate": rng.normal(size=(b, c)).astype(f32),
        "g": rng.normal(size=(b, h, w, c)).astype(f32),
        "dsr": rng.normal(size=(2, c)).astype(f32),
        "dsh": rng.normal(size=(2 * nb, hc)).astype(f32),
        "dgap": rng.normal(size=(b, c)).astype(f32),
        "dst": rng.normal(size=(2, c)).astype(f32),
    }


_BF16 = ("x", "kr", "kh", "kt", "g")


def _args(inp, names, to):
    return [to(inp[n], n in _BF16) for n in names]


def _jax(a, bf):
    return jnp.asarray(a).astype(jnp.bfloat16) if bf else jnp.asarray(a)


def _torch(a, bf):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if bf else t


_OPS = {
    "f1": (pc._f1_call, cam.cam_f1_fwd, ("x", "kr", "kh")),
    "f1b": (pc._f1b_call, cam.cam_f1_bwd,
            ("x", "kr", "kh", "dsr", "dsh", "dgap")),
    "f2": (pc._f2_call, cam.cam_f2_fwd, ("x", "kh", "kt", "bnh")),
    "f2b": (pc._f2b_call, cam.cam_f2_bwd, ("x", "kh", "kt", "bnh", "dst")),
    "f3": (pc._f3_call, cam.cam_f3_fwd,
           ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate")),
    "f3b": (pc._f3b_call, cam.cam_f3_bwd,
            ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate", "g")),
}


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def ops_run(request):
    """Every op on the JAX side (interpret mode) and the port's side,
    with equal gate rows added for F3b."""
    b, h, w, c, dils, hc = SHAPES[request.param]
    inp = _inputs(b, h, w, c, dils, hc, seed=sum((b, h, w, c)))
    runs = {}
    for name, (jfn, tfn, names) in _OPS.items():
        runs[name] = (_tuple(jfn(*_args(inp, names, _jax), dils)),
                      _tuple(tfn(*_args(inp, names, _torch), dils)))
    same = dict(inp, gate=np.repeat(inp["gate"][:1], b, 0))
    jfn, tfn, names = _OPS["f3b"]
    runs["f3b_equal_gates"] = (_tuple(jfn(*_args(same, names, _jax), dils)),
                               _tuple(tfn(*_args(same, names, _torch), dils)))
    return inp, dils, runs


def _close(got: torch.Tensor, want, what):
    tol = BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("op", ["f1", "f1b", "f2", "f2b", "f3",
                                "f3b_equal_gates"])
def test_plain_op_matches_jax_interpret(ops_run, op):
    _, _, runs = ops_run
    want, got = runs[op]
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        _close(g, w, f"{op}[{i}]")


def test_f3b_matches_jax_except_dx_of_later_images(ops_run):
    """Distinct gates: every output but dx equals JAX's, and dx on
    image 0."""
    _, _, runs = ops_run
    want, got = runs["f3b"]
    _close(got[0][0], want[0][0], "f3b dx image 0")
    for i in range(1, 8):
        _close(got[i], want[i], f"f3b[{i}]")


def _f3_unfused(x, inp, dils):
    """The math of F3 in plain float32 autograd (no bf16 roundings but
    the operands'), as a function of x with every BN row and the gate
    fixed."""
    t = {k: _torch(v, k in _BF16).float() for k, v in inp.items()}
    c = x.shape[-1]

    def bn(v, rows, i, width):
        m, inv, s, b_ = (rows[4 * i + k].reshape(1, 1, 1, width)
                         for k in range(4))
        return torch.relu((v - m) * inv * s + b_)

    xb = x.permute(0, 3, 1, 2)
    res = bn(x @ t["kr"], t["bnr"], 0, c)
    top = None
    hc = t["kh"].shape[-1]
    for i, d in enumerate(dils):
        w = t["kh"][i].permute(3, 2, 0, 1)
        ci = F.conv2d(xb, w, padding=d, dilation=d).permute(0, 2, 3, 1)
        p = bn(ci, t["bnh"], i, hc) @ t["kt"][i]
        top = p if top is None else top + p
    y = bn(top, t["bnt"], 0, c)
    return torch.relu(res + y * t["gate"][:, None, None, :])


def test_f3b_gate_fault_is_not_copied(ops_run):
    """The port's dx is image b's gradient on every image; JAX's (image
    0's gate in phase 1) departs from it on the later images.

    The bf16 roundings of the fused ops move a few ReLU masks (a
    pre-activation within a rounding of 0), each an outlier of one
    cotangent, so the measure is the mean error and the cosine per
    image."""
    inp, dils, runs = ops_run
    want_jax, got = runs["f3b"]
    x = _torch(inp["x"], True).float().requires_grad_(True)
    _f3_unfused(x, inp, dils).backward(_torch(inp["g"], True).float())
    auto = x.grad
    dx_port = got[0].float()
    dx_jax = torch.from_numpy(np.array(jnp.asarray(want_jax[0],
                                                     jnp.float32)))
    scale = float(auto.abs().mean())
    for b in range(x.shape[0]):
        a = auto[b].flatten().double()

        def cos(v):
            v = v.flatten().double()
            return float(v @ a / (v.norm() * a.norm()))

        port_err = float((dx_port[b] - auto[b]).abs().mean())
        jax_err = float((dx_jax[b] - auto[b]).abs().mean())
        assert port_err <= 0.02 * scale and cos(dx_port[b]) > 0.99, \
            (b, port_err, scale)
        if b == 0:
            assert jax_err <= 0.02 * scale
        else:
            assert jax_err > 0.1 * scale and cos(dx_jax[b]) < 0.99, \
                (b, jax_err, port_err, scale)


# ------------------------------------------------------------ the module

CHANS, DILS, B, HW = 12, (1, 2, 3), 2, 21


@pytest.fixture(scope="module")
def module_run():
    """JAX's fused module (interpret mode): output, running statistics,
    parameter and input gradients of a squared-error loss; the port's
    module built from the same variables."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, HW, HW, CHANS).astype(np.float32)
    tgt = np.random.RandomState(7).rand(B, HW, HW, CHANS).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    fus = JaxCAM(chans=CHANS, hdc_dilations=DILS, dtype=jnp.bfloat16,
                 fused=True)
    variables = fus.init(jax.random.PRNGKey(3), xj, train=False)

    def loss(params, xx):
        out, mut = fus.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             xx, train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.square(out.astype(jnp.float32) - tgt)), (
            out, mut["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], xj)
    sd = student_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables))
    new_sd = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], "batch_stats": stats}))
    grads = student_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": gp}))
    return {"x": x, "tgt": tgt, "sd": sd, "out": np.asarray(out, np.float32),
            "stats": new_sd, "grads": grads,
            "gx": np.asarray(gx, np.float32)}


def _port_module(sd, fused):
    m = ContextAwareModule(CHANS, DILS, dtype=torch.bfloat16, fused=fused)
    m.load_state_dict(sd, strict=True)
    return m.train()


def _port_run(r, fused):
    m = _port_module(r["sd"], fused)
    x = torch.from_numpy(r["x"]).to(torch.bfloat16).permute(0, 3, 1, 2)
    x.requires_grad_(True)
    out = m(x).permute(0, 2, 3, 1)
    loss = torch.mean(torch.square(out.float() - torch.from_numpy(r["tgt"])))
    loss.backward()
    return m, out.detach().float(), x.grad.permute(0, 2, 3, 1).float()


def _grad_close(a, b, what):
    """Gradients through bf16 roundings: within 2^-5 of the largest
    magnitude, and aligned (cosine > 0.999)."""
    a, b = a.flatten().double(), b.flatten().double()
    scale = max(float(b.abs().max()), 1e-12)
    assert float((a - b).abs().max()) <= 2.0 ** -5 * scale, what
    cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
    assert cos > 0.999, (what, cos)


def test_fused_module_matches_jax(module_run):
    r = module_run
    m, out, gx = _port_run(r, fused=True)
    want = torch.from_numpy(r["out"])
    assert float((out - want).abs().max()) <= 2.0 ** -6 * float(
        want.abs().max())
    sd = m.state_dict()
    for k, v in r["stats"].items():
        if "running" in k:
            torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5,
                                       msg=k)
    params = dict(m.named_parameters())
    assert sorted(params) == sorted(r["grads"])
    for k, g in r["grads"].items():
        _grad_close(params[k].grad, g, k)
    _grad_close(gx[0], torch.from_numpy(r["gx"][0]), "dx image 0")


def test_fused_module_matches_unfused(module_run):
    """The port's fused module against its cuDNN-path module: the same
    parameters, the same function up to the bf16 BN-output rounding of
    the unfused path."""
    r = module_run
    mf, out_f, gx_f = _port_run(r, fused=True)
    mu, out_u, gx_u = _port_run(r, fused=False)
    assert float((out_f - out_u).abs().max()) <= 0.05
    assert float((out_f - out_u).abs().mean()) <= 5e-3
    for (k, pf), (_, pu) in zip(mf.named_parameters(), mu.named_parameters()):
        a, b = pf.grad.flatten().double(), pu.grad.flatten().double()
        assert float(a @ b / (a.norm() * b.norm())) > 0.99, k
    sf, su = mf.state_dict(), mu.state_dict()
    for k in sf:
        if "running" in k:
            torch.testing.assert_close(sf[k], su[k], rtol=2e-2, atol=2e-3)


def test_eval_mode_takes_the_unfused_path(module_run):
    r = module_run
    fused = _port_module(r["sd"], True).eval()
    plain = _port_module(r["sd"], False).eval()
    x = torch.from_numpy(r["x"]).to(torch.bfloat16).permute(0, 3, 1, 2)
    before = [f.calls for f in cam.PLAIN]
    with torch.no_grad():
        assert torch.equal(fused(x), plain(x))
    assert [f.calls for f in cam.PLAIN] == before
