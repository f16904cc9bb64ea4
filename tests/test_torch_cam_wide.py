"""The fused-CAM kernels at every student width, on the CPU: the plan of
``csrc/cam_wg.cuh``'s wgmma kernels (``ops/cam.py:tile_plan``) and the
port's ``fused_cam`` and student step at those widths against the JAX
package.

* The width grid: the ``AttentionStudentSteps`` CAMs at ``--inplanes``
  96, 128 and 256 (step: C = 2 inplanes + 3 with dilations 1-3; pyramid:
  C = inplanes + 3 with 1-4; hc = C // 4), C = 163 with six dilations up
  to 6 and 8, and the train step's two shapes.  ``tile_plan`` of all six
  ops fits a block's shared memory at each of them: every op's phase 0
  on the wgmma plan of ``csrc/cam_wg.cuh`` (whole branches of up to 128
  columns) and every backward's phase 1 on its ``dx_wg_kernel``; their
  own tests, the re-laid weights' included, are
  ``tests/test_torch_cam_wg.py``, ``tests/test_torch_cam_wgf2.py``,
  ``tests/test_torch_cam_wgb.py`` and ``tests/test_torch_cam_wgb0.py``.
* ``fused_cam`` (the plain versions, on the CPU) against
  ``rtpe_tpu.ops.pallas_cam.fused_cam`` in interpret mode at two wide
  shapes, forward and gradients, with ``tests/test_torch_cam.py``'s
  tolerances.
* One distillation step of ``AttentionStudentSteps(inplanes=96,
  fused_cam=True)`` against JAX's: the whole update's cosine gap held to
  what JAX's own step moves when its input images move by 1e-6
  (relative; at this width the fused CAMs' bf16 roundings turn such a
  change into updates up to ~30 % of their size apart, cosine ~0.996),
  each tensor's update by its cosine.

On the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 17)
the kernels themselves are held to their plain versions at the grid.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtpe_tpu.models.students import AttentionStudentSteps as JaxStudent
from rtpe_tpu.ops import pallas_cam as pc
from rtpe_tpu.train import step as jstep
from rtpe_tpu_torch.io.jax_import import student_state_dict_from_jax
from rtpe_tpu_torch.models.students import AttentionStudentSteps
from rtpe_tpu_torch.ops import cam
from rtpe_tpu_torch.train import (DistillConfig, DistillTrainState,
                                  make_distill_train_step)

OPS = ("f3b", "f1b", "f2b", "f1", "f3", "f2")

# (B, H, W, C, dilations, hc)
STEPS_CAM = (16, 113, 113, 163, (1, 2, 3), 40)
PYRAMID_CAM = (16, 113, 113, 83, (1, 2, 3, 4), 20)
GRID = {"step96": (16, 113, 113, 195, (1, 2, 3), 48),
        "step128": (16, 113, 113, 259, (1, 2, 3), 64),
        "step256": (16, 113, 113, 515, (1, 2, 3), 128),
        "pyramid96": (16, 113, 113, 99, (1, 2, 3, 4), 24),
        "pyramid128": (16, 113, 113, 131, (1, 2, 3, 4), 32),
        "pyramid256": (16, 113, 113, 259, (1, 2, 3, 4), 64),
        "dils6": (16, 113, 113, 163, (1, 2, 3, 4, 5, 6), 40),
        "dils8": (16, 113, 113, 163, (1, 2, 3, 4, 5, 8), 40),
        "steps": STEPS_CAM, "pyramid": PYRAMID_CAM}
# the train step's own shapes at the default --inplanes 80
TRAIN = {"steps", "pyramid"}


def by_op(names, ops=OPS):
    return [pytest.param(op, n, id=f"{op}-{n}") for op in ops for n in names]


@pytest.mark.parametrize("op,name", by_op(GRID))
def test_tile_plan_fits_every_width(op, name):
    """Every op at every shape of the grid: phase 0 on the wgmma plan,
    within SMEM_MAX in both phases: slices of at most 128 columns covering
    hc, chunks of at most the widest that fits covering kc and knh (F1's
    and F1b's read no a), a backward's phase 1 on dx_wg_kernel; at the
    train step's shapes one slice of 48 (hc 40) or 32 (hc 20) columns and
    the halo whole."""
    b, h, w, c, dils, hc = shape = GRID[name]
    p = cam.tile_plan(op, *shape)
    assert p["ok"] and p["wg"]
    assert max(p["smem0"], p["smem1"]) <= cam.SMEM_MAX
    assert p["dx_wg"] == op.endswith("b")
    assert p["nsl"] * p["sw"] >= hc > (p["nsl"] - 1) * p["sw"]
    assert p["sw"] <= 8 * max(cam.WG_NTB) and p["sw"] % 8 == 0
    chunks = [(p["kc"], p["kq"], p["nq"])]
    if op not in ("f1", "f1b"):
        chunks.append((p["knh"], p["kqa"], p["nqa"]))
    for k, width, n in chunks:
        assert width % 16 == 0 and 0 < k - (n - 1) * width <= width
    if name in TRAIN:
        assert (p["nsl"], p["nq"], p["kq"]) == (1, 1, p["kc"])
        assert p["sw"] == {40: 48, 20: 32}[hc]


# the grid's weight shapes (the layout depends on C, the dilations'
# count and largest one, and hc), and two with narrow K chunks forced by
# a wide dilation (several chunks of x, a branch wider than 40 columns
# beside a dilation of 11)
WEIGHT_SHAPES = dict(GRID)
WEIGHT_SHAPES.update({"chunks": (1, 11, 10, 150, (1, 12), 20),
                      "chunks_slices": (2, 9, 9, 100, (2, 11, 3), 44)})


def _weights(c, nb, hc, seed):
    rng = np.random.default_rng(seed)

    def draw(*s):
        return torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).to(torch.bfloat16)

    return draw(c, c), draw(nb, 3, 3, c, hc), draw(nb, hc, c)


# ------------------------------------------------------------ fused_cam

BF16_GRAD = 2.0 ** -5
# a batch statistic against JAX's: tests/test_torch_cam.py holds the
# running statistics at rtol 1e-4, and they move by 0.1 (the momentum) of
# the batch's
STAT_RTOL = 1e-3
FUSED_SHAPES = {"step96": (2, 9, 13, 195, (1, 2, 3), 48),
                "pyramid256": (1, 8, 8, 259, (1, 2, 3, 4), 64)}


def _fused_inputs(shape, seed):
    b, h, w, c, dils, hc = shape
    nb = len(dils)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "x": rng.random((b, h, w, c)).astype(f32),
        "kr": (rng.normal(size=(c, c)) / np.sqrt(c)).astype(f32),
        "kh": (rng.normal(size=(nb, 3, 3, c, hc)) / np.sqrt(9 * c)
               ).astype(f32),
        "kt": (rng.normal(size=(nb, hc, c)) / np.sqrt(nb * hc)).astype(f32),
        "sr": (1 + 0.1 * rng.normal(size=c)).astype(f32),
        "st": (1 + 0.1 * rng.normal(size=c)).astype(f32),
        "sh": (1 + 0.1 * rng.normal(size=(nb, hc))).astype(f32),
        "br": (0.1 * rng.normal(size=c)).astype(f32),
        "bt": (0.1 * rng.normal(size=c)).astype(f32),
        "bh": (0.1 * rng.normal(size=(nb, hc))).astype(f32),
        "gw": (rng.normal(size=c)).astype(f32),
        "gb": (0.1 * rng.normal(size=c)).astype(f32),
        "tgt": rng.random((b, h, w, c)).astype(f32),
    }


# what the loss differentiates: bf16 operands, float32 BN scales, biases
# and the gate's own parameters (gate = sigmoid(gap gw + gb))
_BF = ("x", "kr", "kh", "kt")
_DIFF = ("x", "kr", "kh", "kt", "sr", "st", "sh", "br", "bt", "bh", "gw",
         "gb")


def _jax_fused(inp, dils):
    def loss(p):
        out, stats = pc.fused_cam(
            p["x"], p["kr"], p["kh"], p["kt"],
            {"r": p["sr"], "t": p["st"], "h": p["sh"]},
            {"r": p["br"], "t": p["bt"], "h": p["bh"]},
            lambda gap: jax.nn.sigmoid(gap * p["gw"] + p["gb"]), dils)
        err = jnp.mean(jnp.square(out.astype(jnp.float32) - inp["tgt"]))
        return err, (out, stats)

    p = {k: (jnp.asarray(inp[k]).astype(jnp.bfloat16) if k in _BF
             else jnp.asarray(inp[k])) for k in _DIFF}
    (_, (out, stats)), g = jax.value_and_grad(loss, has_aux=True)(p)
    return (np.asarray(out, np.float32),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   stats),
            {k: np.asarray(v, np.float32) for k, v in g.items()})


def _port_fused(inp, dils):
    p = {k: torch.from_numpy(inp[k]) for k in _DIFF}
    p = {k: (v.to(torch.bfloat16) if k in _BF else v).requires_grad_(True)
         for k, v in p.items()}
    out, stats = cam.fused_cam(
        p["x"], p["kr"], p["kh"], p["kt"],
        {"r": p["sr"], "t": p["st"], "h": p["sh"]},
        {"r": p["br"], "t": p["bt"], "h": p["bh"]},
        lambda gap: torch.sigmoid(gap * p["gw"] + p["gb"]), dils)
    torch.mean(torch.square(out.float() - torch.from_numpy(inp["tgt"]))
               ).backward()
    return (out.detach().float(), stats,
            {k: v.grad.float() for k, v in p.items()})


def _stat_close(got, want, n, what):
    """A batch statistic elementwise within ``STAT_RTOL`` and one bf16
    step at its largest magnitude over the pixel count ``n``: a
    conv output that the two sides round to neighbouring bf16 values (a
    tie that float32 sums in another order put on the other side) moves
    a mean over n pixels by one bf16 step over n."""
    m = float(want.abs().max())
    step = 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0
    torch.testing.assert_close(got, want, rtol=STAT_RTOL, atol=step / n,
                               msg=lambda e: f"{what}: {e}")


def _grad_close(a, b, what):
    """Gradients through bf16 roundings (``tests/test_torch_cam.py``):
    within 2^-5 of the largest magnitude, and aligned (cosine > 0.999)."""
    a, b = a.flatten().double(), b.flatten().double()
    scale = max(float(b.abs().max()), 1e-12)
    assert float((a - b).abs().max()) <= BF16_GRAD * scale, what
    cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
    assert cos > 0.999, (what, cos)


@pytest.mark.parametrize("name", sorted(FUSED_SHAPES))
def test_fused_cam_matches_jax_at_wide_widths(name):
    """The output within 2^-6 of its largest magnitude and every gradient
    (x, the three kernels, the BN scales and biases, the gate's
    parameters) within 2^-5 and aligned: ``tests/test_torch_cam.py``'s
    tolerances for the fused module; the batch statistics (means and
    variances of bf16-rounded conv outputs over 64 or 234 pixels)
    elementwise by :func:`_stat_close`.  The gates are sigmoids
    (positive), where F3b's gate fault
    of the TPU kernel (``pallas_cam.py:507``) does not show, so dx is
    held on every image."""
    shape = FUSED_SHAPES[name]
    dils = shape[4]
    inp = _fused_inputs(shape, seed=sum(shape[:4]))
    jout, jstats, jg = _jax_fused(inp, dils)
    out, stats, g = _port_fused(inp, dils)
    want = torch.from_numpy(jout)
    assert float((out - want).abs().max()) <= 2.0 ** -6 * float(
        want.abs().max())
    n = shape[0] * shape[1] * shape[2]
    for k in ("r", "t", "h"):
        for what, got_s, want_s in zip(("mean", "var"), stats[k], jstats[k]):
            _stat_close(got_s.detach().float(),
                        torch.from_numpy(np.array(want_s)), n, f"{k} {what}")
    for k in _DIFF:
        _grad_close(g[k], torch.from_numpy(jg[k]), k)


# ------------------------------------------------------------ the student

B, HW, INPLANES, ALT = 2, 32, 96, 6
# a tensor's update against JAX's, 1 - cosine
TENSOR_GAP = 0.25


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt = rng.random((B, HW, HW, 17)) ** 6
    gt[gt < 0.05] = 0.0
    return {"img": rng.normal(size=(B, HW, HW, 3)).astype(f32),
            "img_alt": rng.random((B, HW, HW, 3)).astype(f32),
            "segm_mask": (rng.random((B, HW, HW, 1)) > 0.6).astype(f32),
            "gt_hms": gt.astype(f32),
            "teacher_hms": (rng.random((B, HW, HW, 17)) * 1.2 - 0.1
                            ).astype(f32),
            "mask": (rng.random((B, HW, HW, 1)) > 0.1).astype(f32)}


def _updates(after, before):
    """Each tensor's update (and running-statistic change) over the step,
    by state-dict name."""
    return {k: after[k] - before[k] for k in after
            if not k.endswith("num_batches_tracked")}


def _gaps(got, want, before):
    """(each tensor's 1 - cosine between its update and ``want``'s, over
    the tensors ``want`` moves; 1 - the cosine of the whole updates, each
    tensor over its scale: its update's largest magnitude or 1e-3 of its
    largest value, as ``tests/test_torch_train.py`` scales them)."""
    per, ga, wa = {}, [], []
    for k, w in want.items():
        g, w = got[k].flatten().double(), w.flatten().double()
        if float(w.norm()) > 0.0:
            per[k] = 1.0 - float(g @ w / max(float(g.norm() * w.norm()),
                                             1e-300))
        scale = max(float(w.abs().max()),
                    1e-3 * float(before[k].abs().max()), 1e-12)
        ga.append(g / scale)
        wa.append(w / scale)
    a, b = torch.cat(ga), torch.cat(wa)
    return per, 1.0 - float(a @ b / (a.norm() * b.norm()))


def test_student_step_matches_jax_at_inplanes_96():
    """One distillation step of ``AttentionStudentSteps(inplanes=96,
    fused_cam=True)`` (step CAMs at C = 195, hc = 48; pyramid CAMs at
    C = 99, hc = 24) against JAX's (float32 model, fused CAMs in
    interpret mode) from the same weights and batch: both losses within
    1e-3 (relative), as ``tests/test_torch_train.py`` holds its fused
    steps; the whole update's cosine gap (1 - cos) within three times a
    control's, JAX's same step on the images moved by 1e-6 (relative),
    ~4e-3: a bf16 rounding that lands on the other side of a tie moves a
    ReLU mask or a small batch's statistics; and each tensor's update
    within ``TENSOR_GAP`` of JAX's in 1 - cos.  The port's worst tensor
    reads 0.094 (a conv of ``att.lo``, the pyramid's lowest level, whose
    batch statistics here are means over a few pixels); one branch of
    the step CAMs' dkh zeroed in F3b, or half of its columns, reads
    0.39-1.24 at the tensors it hits (1 - cos of the whole 0.39-0.57)."""
    model = JaxStudent(inplanes=INPLANES, alt_planes=ALT,
                       detach_att_for_det=True, dtype=jnp.float32,
                       fused_cam=True)
    batch = _batch()
    x = jnp.zeros((1, HW, HW, 3))
    variables = model.init(jax.random.PRNGKey(0), x, x, train=False)
    cfg = jstep.DistillConfig()
    step = jstep.make_distill_train_step(model, cfg)
    noise = np.random.default_rng(5).normal(size=batch["img"].shape)
    runs = []
    for eps in (0.0, 1e-6):
        b = dict(batch, img=(batch["img"] * (1 + eps * noise)).astype(
            np.float32))
        state = jstep.DistillTrainState.create(variables, cfg)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        runs.append(({k: float(v) for k, v in m.items()},
                     student_state_dict_from_jax(jax.tree_util.tree_map(
                         np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats}))))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    before = student_state_dict_from_jax(variables)

    port = AttentionStudentSteps(inplanes=INPLANES, alt_planes=ALT,
                                 detach_att_for_det=True, fused_cam=True)
    port.load_state_dict(before, strict=True)
    port.train()
    pcfg = DistillConfig()
    pstate = DistillTrainState.create(port, pcfg)
    pstep = make_distill_train_step(port, pcfg)
    calls = [f.calls for f in cam.PLAIN]
    pstate, pm = pstep(pstate, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
    # the six plain versions ran: the CPU's side of the kernels
    assert all(f.calls > c for f, c in zip(cam.PLAIN, calls))
    want_metrics, want_sd = runs[0]
    for k in ("attention_loss", "keypoints_loss"):
        assert float(pm[k]) == pytest.approx(want_metrics[k], rel=1e-3), k
    want = _updates(want_sd, before)
    per, gap = _gaps(_updates(pstate.model.state_dict(), before), want,
                     before)
    _, ctl_gap = _gaps(_updates(runs[1][1], before), want, before)
    assert ctl_gap > 0.0                          # the control moved
    assert gap <= 3.0 * ctl_gap, (gap, ctl_gap)
    worst = max(per, key=per.get)
    assert per[worst] <= TENSOR_GAP, (worst, per[worst])
