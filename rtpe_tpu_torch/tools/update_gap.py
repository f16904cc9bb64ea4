"""How far the fused-CAM train step's parameter updates lie from the
cuDNN step's, beside how far a sound change of rounding and planted
kernel faults move them: the readings behind ``chip_smoke.py``'s
``WIDE_UPDATE_TOL`` and ``WIDE_TENSOR_TOL``.

    python -m rtpe_tpu_torch.tools.update_gap

on one card, run from the root of the checkout (beside ``chip_smoke.py``,
whose ``--inplanes`` (``WIDE_INPLANES``) and seeded train batch it
uses).  For each of ``SEEDS`` seeds, a seeded ``AttentionStudentSteps``
as the trainer CLI builds it (``detach_att_for_det``) takes ``STEPS``
steps of ``make_distill_train_step`` (B=16, 450 x 450, a batch of its
own a step) from the same weights, as ``chip_smoke.py:trainer_wide``
runs the CLI:

* ``cudnn``: the unfused CAMs, BN outputs bf16 (``--no_fused_cam``), the
  reference of every gap below;
* ``fused``: the CAM kernels (``--fused_cam``), the sound reading;
* ``cudnn_bn_f32``: the unfused CAMs with float32 BN outputs
  (``--no_fused_cam --bn_f32``), a sound change of rounding points;
* ``fused`` with each planted fault of ``FAULTS`` in F3b's outputs at the
  step CAMs (C = 2 inplanes + 3): what a limit can refuse, and what it
  cannot see.

Each reading is :func:`gap` (the relative L2 of the whole trainable
update) and :func:`worst_cosine` (the worst tensor's 1 - cosine between
its update and ``cudnn``'s), the two figures ``trainer_wide`` holds.  The last line
printed is one JSON object of every reading.
"""

import functools
import json
import time
from typing import Dict

import torch

from ..ops import cam


def gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
        ) -> float:
    """|got - want| / |want| over the concatenated updates of ``want``'s
    tensors."""
    a = torch.cat([got[k].double().flatten() for k in want])
    b = torch.cat([want[k].double().flatten() for k in want])
    return float((a - b).norm() / b.norm())


def worst_cosine(got, want) -> tuple:
    """(the largest 1 - cosine of one tensor's update against ``want``'s,
    that tensor's name) over the tensors ``want`` moves."""
    worst, name = 0.0, None
    for k, w in want.items():
        w, g = w.double().flatten(), got[k].double().flatten()
        if float(w.norm()) == 0.0:
            continue
        d = 1.0 - float(g @ w / max(float(g.norm() * w.norm()), 1e-300))
        if d > worst:
            worst, name = d, k
    return worst, name


def _dkh_slice(out):
    """One 32-column slice of branch 0's dkh zeroed."""
    out = tuple(out)
    dkh = out[2].clone()
    dkh[0, ..., :32] = 0
    return out[:2] + (dkh,) + out[3:]


def _dx_edge(out):
    """dx zeroed on the last row of tiles (the image's bottom 1-8 rows)."""
    dx = out[0].clone()
    dx[:, (dx.shape[1] - 1) // 8 * 8:] = 0
    return (dx,) + tuple(out[1:])


def _dx_slice(out):
    """dx of the first 32 input channels 2 % too large."""
    dx = out[0].clone()
    dx[..., :32] *= 1.02
    return (dx,) + tuple(out[1:])


FAULTS = {"dkh_slice_zeroed": _dkh_slice, "dx_edge_tiles_zeroed": _dx_edge,
          "dx_slice_2pct": _dx_slice}
SEEDS, STEPS = 5, 2


def run(inplanes: int, seed: int, steps: int, fused: bool, bn_dtype,
        batches, dev, fault=None) -> Dict[str, torch.Tensor]:
    """The trainable parameters' updates over ``steps`` steps from the
    seeded student; with ``fault``, F3b's outputs at the step CAMs pass
    through it."""
    from ..models.factory import get_attention_student
    from .. import train as train_mod
    model = get_attention_student(inplanes=inplanes,
                                  detach_att_for_det=True, fused_cam=fused,
                                  device=dev, seed=seed)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    cfg = train_mod.DistillConfig()
    state = train_mod.DistillTrainState.create(model, cfg)
    step = train_mod.make_distill_train_step(model, cfg, bn_dtype=bn_dtype)
    labels = train_mod.label_params(model.named_parameters())
    real = cam.cam_f3_bwd

    # the wrapper counts its launches on the function its module's name
    # holds: the planted one carries its counters
    @functools.wraps(real)
    def planted(x, *args):
        out = real(x, *args)
        return fault(out) if x.shape[-1] == 2 * inplanes + 3 else out

    if fault is not None:
        cam.cam_f3_bwd = planted
    try:
        for i in range(steps):
            state, _ = step(state, batches[i])
    finally:
        if fault is not None:
            real.launches = planted.launches
        cam.cam_f3_bwd = real
    return {k: (p.detach() - init[k]).double()
            for k, p in model.named_parameters() if labels[k] != "frozen"}


def main() -> None:
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    cs.phase_card()
    inplanes = cs.WIDE_INPLANES
    t0 = time.perf_counter()
    out = {}
    for seed in range(SEEDS):
        batches = [cs.train_batch(dev, seed=100 * seed + i)
                   for i in range(STEPS)]
        ref = run(inplanes, seed, STEPS, False, torch.bfloat16, batches, dev)
        runs = {"fused": (True, torch.bfloat16, None),
                "cudnn_bn_f32": (False, None, None)}
        runs.update({f"fused+{k}": (True, torch.bfloat16, f)
                     for k, f in FAULTS.items()})
        row = {}
        for name, (fused, bn, fault) in runs.items():
            u = run(inplanes, seed, STEPS, fused, bn, batches, dev, fault)
            c, t = worst_cosine(u, ref)
            row[name] = {"gap": gap(u, ref), "worst_1_minus_cos": c,
                         "worst_tensor": t}
            del u
        out[seed] = row
        print(f"seed {seed}: {json.dumps(row)}", flush=True)
        del ref
        torch.cuda.empty_cache()
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"inplanes": inplanes, "steps": STEPS,
                      "readings": out}))


if __name__ == "__main__":
    main()
