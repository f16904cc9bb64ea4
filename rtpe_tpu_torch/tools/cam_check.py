"""The fused-CAM ops' check: each output of the six kernels
(``ops/cam.py``) held to a float64 evaluation of its plain version, the
same bf16 rounding points in float64 arithmetic, by limits that come
from a control and not from what the kernels read.

* **Exact sums** (:func:`exact_check`).  On inputs whose every
  per-pixel value is exact in float32 (small integers, weights in
  {-1, 0, 1}, dyadic BN rows, gates and cotangents) every per-pixel
  output (``PIXEL``: each backward's dx, F3's output) is
  ``torch.equal`` to the float32 plain version's at any B, H and W, and
  so is the float64 evaluation's.  Each reduction over pixels (the
  statistics, dS, dgate, dkr, dkh, dkt) outgrows float32's exact range
  at the train step's 204,304 pixels: it is held within ``SUM_TOL`` of
  its float64 sum of |terms| (``terms=True`` of the plain versions).
* **Random inputs** (:func:`random_check`).  For each output, the worst
  and the mean |error| as fractions of max |f64| and the share of
  elements off by more than ``OFF`` of it, for kernel - f64 and for the
  controls: the float32 plain version - f64, evaluated once on the
  card's float32 units (TF32 off) and once on its tensor cores (TF32
  on).  Every operand of a conv or a product in the plain versions is a
  bf16 value, which TF32 holds exactly, so both are correct float32
  evaluations with the same rounding points; they differ in how they
  accumulate, and the tensor cores accumulate as the kernels' bf16 MMAs
  do.  The kernel's limits come from the controls' figures, the larger
  of the two for each, by :func:`limits`.  F2b's and F3b's outputs
  carry the ReLU masks' flips (a pre-activation that a float32 sum and a
  bf16 rounding put on the other side of 0 moves the cotangent behind it
  by its own size), which come few and large: for them the rule holds
  the figures against float64 with each evaluation's own masks pinned
  (the kernel's read from the scratch its phase 0 leaves,
  :func:`kernel_masks`), and the count of mask elements that differ
  from float64's; kernel - f64 itself within ``CAPS``.
* **The mechanism** (:func:`mechanism`, the ops with ReLU masks: F2b, F3,
  F3b).  Every element where a float32 evaluation (or the kernel) is
  off the float64 one by more than ``OFF`` of max |f64| lies downstream
  of a mask element whose pre-activation (zr, zt, z_i or pre) has
  another sign there than in float64; with the masks aligned (float64's
  pinned into float32, or the kernel's into float64) the gap comes
  within ``PINNED_TOL``.

Imported by ``chip_smoke.py`` (``phase_cam``) and the tests; it runs on
whatever device the inputs are on.  On the card,

    python -m rtpe_tpu_torch.tools.cam_check [--seeds N]

run from the root of the checkout (beside ``chip_smoke.py``, whose
seeded inputs it uses) sweeps N seeds at the train step's two CAM shapes
and the ragged one and prints, per op and output, the largest ratio of
the kernel's figure to the controls' and to its limit, and the faults.
"""

import argparse
import contextlib
import json
import time
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import cam

# an element is "off" past this fraction of its output's max |f64|
OFF = 2.0 ** -5
# exact sums: a pixel reduction within this fraction of its sum of |terms|
# (float32 sums, 2^-24 a step, of at most ~2e5 pixels in per-tile partial
# rows and a fixed-order reduction of them)
SUM_TOL = 2.0 ** -14
# the forward statistics (F1's s_r, s_h, gap; F2's s_t): the worst element
# of kernel - f64 within this of max |f64| (2^-8 before the float64 check;
# over main's sweep on the H100 the kernels read under a tenth of it)
STAT_TOL = 2.0 ** -12
# Random inputs, the rule: each figure of kernel - f64 within FACTOR times
# the controls' (the larger of the two), or within FLOORS where that is
# under them; the share of elements off also SHARE_SLACK elements more.
# The worst floor is two bf16 steps of the largest element (its last
# rounding and one upstream rounding that lands on the other side); the
# mean floor 2^-14.  No limit exceeds CAPS, the limits every activation
# and gradient was held to before the controls existed (worst 2^-2, mean
# 2^-8, share 1e-4).
FACTOR = 2.0
FLOORS = {"worst": 2.0 ** -6, "mean": 2.0 ** -14}
SHARE_SLACK = 4
CAPS = {"worst": 2.0 ** -2, "mean": 2.0 ** -8, "share": 1e-4}
# an evaluation and float64 with their masks aligned: the worst element
# within this of max |f64|
PINNED_TOL = 2.0 ** -7
# F2b and F3b, whose masks the kernel's scratch shows: the mask elements
# that differ from float64's, at most FLIP_FACTOR times the controls' and
# FLIP_SLACK more (the kernel flips where a float32 sum lands a conv or
# top-conv output on the other side of a bf16 rounding and that moves a
# pre-activation across 0, as the tensor-core control does)
FLIP_FACTOR = 2.0
FLIP_SLACK = 8

OUTPUTS = {"cam_f1_fwd": ("s_r", "s_h", "gap"),
           "cam_f1_bwd": ("dx", "dkr", "dkh"),
           "cam_f2_fwd": ("s_t",),
           "cam_f2_bwd": ("dx", "dkh", "dkt", "dS"),
           "cam_f3_fwd": ("out",),
           "cam_f3_bwd": ("dx", "dkr", "dkh", "dkt", "dSr", "dSh", "dSt",
                          "dgate")}
PIXEL = ("dx", "out")                    # per-pixel outputs; the rest sum
STATS = ("cam_f1_fwd", "cam_f2_fwd")     # ops whose outputs are statistics
MASKED = ("cam_f2_bwd", "cam_f3_fwd", "cam_f3_bwd")
SCRATCH = ("cam_f2_bwd", "cam_f3_bwd")   # their masks read from the kernel
CONTROLS = ("tf32_off", "tf32_on")
FIGURES = ("worst", "mean", "share")


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuBLAS and cuDNN on or off inside, as it was after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def evaluate(name: str, args: Sequence, dtype=torch.float32,
             masks=None) -> Tuple[tuple, Dict[str, torch.Tensor]]:
    """The plain version of op ``name`` on ``args`` (its arguments, dils
    last) in ``dtype``, ``masks`` pinned: (outputs, the masks it used)."""
    out, used = cam._evaluate(name, tuple(args), dtype, masks)
    return as_tuple(out), used


def evaluations(name: str, args: Sequence) -> Tuple[list, tuple]:
    """The controls, float32 with TF32 off and on, and the float64
    evaluation of op ``name``: ([(outputs, masks)] * 2, (outputs,
    masks))."""
    ctl = []
    for on in (False, True):
        with tf32(on):
            ctl.append(evaluate(name, args))
    return ctl, evaluate(name, args, torch.float64)


def figures(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """worst and mean |got - ref| as fractions of max |ref|, and the share
    of elements off by more than ``OFF`` of it."""
    d = (got.double() - ref.double()).abs()
    scale = max(float(ref.double().abs().max()), 1e-30)
    return {"worst": float(d.max()) / scale, "mean": float(d.mean()) / scale,
            "share": float((d > OFF * scale).double().mean())}


def limits(control: Dict[str, float], n: int, stat: bool = False,
           caps: Dict[str, float] = CAPS) -> Dict[str, float]:
    """The rule: an output of ``n`` elements whose controls read
    ``control`` (the larger of the two, figure by figure) may read at
    most these for kernel - f64, each within ``caps``; a statistic's
    worst element at most ``STAT_TOL``."""
    worst = max(FACTOR * control["worst"], FLOORS["worst"])
    return {"worst": min(worst, STAT_TOL if stat else caps["worst"]),
            "mean": min(max(FACTOR * control["mean"], FLOORS["mean"]),
                        caps["mean"]),
            "share": min(FACTOR * control["share"] + SHARE_SLACK / n,
                         caps["share"])}


def within(fig: Dict[str, float], lim: Dict[str, float]) -> bool:
    return all(fig[k] <= lim[k] for k in lim)


def decisive(name: str, args: Sequence,
             masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The masks of op ``name`` as far as its outputs depend on them: F3b's
    outputs see zr and zt only where pre holds and g is not 0, so there
    they become zr & pre & (g != 0), zt & ... and pre their union (the
    outputs do not change); the others' as they are."""
    if name != "cam_f3_bwd":
        return dict(masks)
    live = masks["pre"] & (args[8] != 0)
    zr, zt = masks["zr"] & live, masks["zt"] & live
    return dict(masks, zr=zr, zt=zt, pre=zr | zt)


def kernel_masks(name: str, args: Sequence) -> Tuple[tuple, dict]:
    """The kernel of op ``name`` (in ``SCRATCH``) launched on the card as
    its wrapper launches it, and the masks its phase 0 used, read from
    the scratch it leaves for phase 1 (``ops/cam.py:_scratch``): z_i
    where a = bf16(relu(z_i)) > 0; F3b's zr and zt where dr and dt are
    not 0, in :func:`decisive` form (dt is 0 wherever the gate is, so
    there zt reads as off; no gate is 0 on random inputs).  Returns
    (outputs, masks)."""
    out, sc = cam._scratch(name, args)
    x, dils = args[0], args[-1]
    hc = args[2 if name == "cam_f3_bwd" else 1].shape[4]
    masks = {f"z{i}": sc["a"][..., i * hc:(i + 1) * hc] > 0
             for i in range(len(dils))}
    if name == "cam_f3_bwd":
        c = x.shape[3]
        zr, zt = sc["dr"][..., :c] != 0, sc["dt"][..., :c] != 0
        masks.update(zr=zr, zt=zt, pre=zr | zt)
    return as_tuple(out), masks


def gated(name: str, args: Sequence,
          masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``masks`` in :func:`decisive` form, F3b's zt off where the gate is 0
    (where :func:`kernel_masks` cannot read it)."""
    masks = decisive(name, args, masks)
    if name == "cam_f3_bwd":
        masks["zt"] = masks["zt"] & (args[7] != 0)[:, None, None, :]
    return masks


def n_differ(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> int:
    """Mask elements that differ between ``a`` and ``b``."""
    return sum(int((a[k] != b[k]).sum()) for k in b)


def random_check(name: str, args: Sequence, got, controls, f64,
                 caps: Dict[str, float] = CAPS) -> Tuple[dict, List[str]]:
    """Op ``name`` on random ``args``: its outputs ``got`` = (outputs,
    masks or None) against the float64 evaluation ``f64`` = (outputs,
    masks) beside the float32 ``controls`` [(outputs, masks)].  Each
    output's figures, kernel - f64 within the rule on the controls'.
    For F2b and F3b given the kernel's masks (:func:`kernel_masks`): the
    kernel - f64 figures within ``caps``, and the rule applied twice,
    once to the figures against float64 with each one's own masks
    pinned (``own_masks``: what the float32 sums and bf16 roundings
    leave), once to the count of mask elements that differ from float64's
    (``masks_differ``: at most ``FLIP_FACTOR`` times the controls' and
    ``FLIP_SLACK`` more).  Returns ({"outputs": {output: {"kernel",
    "controls", "limit"[, "own_masks"]}}[, "masks_differ"]}, [fault])."""
    (out, mk), (out64, m64) = got, f64
    own = mk is not None and name in SCRATCH
    res, faults = {"outputs": {}}, []
    if own:
        mk, m64 = decisive(name, args, mk), decisive(name, args, m64)
        mcs = [decisive(name, args, c[1]) for c in controls]
        ref_k = evaluate(name, args, torch.float64, mk)[0]
        ref_cs = [evaluate(name, args, torch.float64, m)[0] for m in mcs]
        n_k, n_cs = n_differ(mk, m64), [n_differ(m, m64) for m in mcs]
        lim = FLIP_FACTOR * max(n_cs) + FLIP_SLACK
        res["masks_differ"] = {"kernel": n_k, "controls": n_cs, "limit": lim}
        if n_k > lim:
            faults.append(f"{name}: {n_k} mask elements differ from "
                          f"float64's, beyond {lim} (controls {n_cs})")
    for j, (oname, a, r) in enumerate(zip(OUTPUTS[name], out, out64)):
        k = figures(a, r)
        cs = [figures(c[0][j], r) for c in controls]
        row = {"kernel": k, "controls": cs}
        if own:
            row["limit"] = dict(caps)
            ko = figures(a, ref_k[j])
            co = [figures(c[0][j], rc[j]) for c, rc in zip(controls, ref_cs)]
            lim = limits({q: max(c[q] for c in co) for q in FIGURES},
                         a.numel(), False, caps)
            row["own_masks"] = {"kernel": ko, "controls": co, "limit": lim}
            ok = within(k, caps) and within(ko, lim)
        else:
            row["limit"] = limits({q: max(c[q] for c in cs) for q in FIGURES},
                                  a.numel(), name in STATS, caps)
            ok = within(k, row["limit"])
        res["outputs"][oname] = row
        if not (ok and bool(torch.isfinite(a.float()).all())):
            faults.append(f"{name} {oname}: beyond the rule: {row}")
    return res, faults


def exact_check(name: str, got: Sequence[torch.Tensor],
                plain32: Sequence[torch.Tensor], f64: Sequence[torch.Tensor],
                terms: Sequence[torch.Tensor],
                every_output_bitwise: bool = False) -> Tuple[dict, List[str]]:
    """Op ``name`` on exact-sum inputs: each per-pixel output ``torch.equal``
    to the float32 plain version's and to the float64 one's; each
    reduction within ``SUM_TOL`` of its float64 sum of |terms| (and, with
    ``every_output_bitwise``, ``torch.equal`` to the float32 plain one's
    too).  Returns ({reduction: worst |got - f64| / sum |terms|},
    [fault])."""
    ratios, faults = {}, []
    for oname, a, p, r, t in zip(OUTPUTS[name], got, plain32, f64, terms):
        if oname in PIXEL or every_output_bitwise:
            if not torch.equal(a, p):
                faults.append(f"{name} {oname} differs from the float32 "
                              "plain version on exact sums")
        if oname in PIXEL:
            if not torch.equal(p, r.to(p.dtype)):
                faults.append(f"{name} {oname}: the float32 and float64 "
                              "plain versions differ on exact sums")
            continue
        err = (a.double() - r.double()).abs()
        ratios[oname] = float((err / t.double().clamp(min=1e-300)).max())
        if not bool((err <= SUM_TOL * t.double()).all()):
            faults.append(f"{name} {oname}: off the float64 sums by "
                          f"{ratios[oname]:.3g} of sum |terms| (limit "
                          f"{SUM_TOL})")
    return ratios, faults


def mechanism(name: str, args: Sequence, ev, ev64,
              aligned) -> Tuple[dict, List[str]]:
    """For op ``name`` (in ``MASKED``) on ``args``: ``ev`` = (outputs,
    masks) of a float32 evaluation or of the kernel, ``ev64`` float64's,
    and ``aligned`` = (outputs, reference) once the two agree on every
    mask (:func:`aligned`).  How many mask elements differ between ``ev``
    and float64 (by pre-activation, in :func:`decisive` form); how many
    elements of each output ``ev`` puts past ``OFF`` of max |f64|
    ("far"), and how many of those lie downstream of no differing mask
    element (the sums of |terms| with every differing element of every
    mask on exceed those with it off nowhere there: must be 0); and the
    worst gap of ``aligned`` as a fraction of max |f64| (must be within
    ``PINNED_TOL``).  Returns (figures, [fault])."""
    (out, m), (out64, m64) = ev, ev64
    m, m64 = decisive(name, args, m), decisive(name, args, m64)
    differ = {k: m[k] != m64[k] for k in m64}
    fig = {"masks_differ": {k: int(v.sum()) for k, v in differ.items()}}
    far = []
    for a, r in zip(out, out64):
        scale = float(r.double().abs().max())
        far.append((a.double() - r.double()).abs() > OFF * scale)
    fig["far"] = {o: int(f.sum()) for o, f in zip(OUTPUTS[name], far)}
    faults = []
    if any(bool(f.any()) for f in far):
        lo = as_tuple(cam._evaluate(name, tuple(args), torch.float64,
                                    {k: m[k] & m64[k] for k in m64},
                                    absolute=True)[0])
        hi = as_tuple(cam._evaluate(name, tuple(args), torch.float64,
                                    {k: m[k] | m64[k] for k in m64},
                                    absolute=True)[0])
        stray = {o: int((f & ~(h > l)).sum())
                 for o, f, l, h in zip(OUTPUTS[name], far, lo, hi)}
        del lo, hi
    else:
        stray = {o: 0 for o in OUTPUTS[name]}
    fig["far_not_downstream"] = stray
    for o, n in stray.items():
        if n:
            faults.append(f"{name} {o}: {n} elements past {OFF} of max "
                          "|f64| downstream of no mask that differs")
    fig["aligned_worst"] = {
        o: figures(a, r)["worst"]
        for o, a, r in zip(OUTPUTS[name], *aligned)}
    for o, w in fig["aligned_worst"].items():
        if w > PINNED_TOL:
            faults.append(f"{name} {o}: off by {w:.3g} of max |f64| with "
                          f"the masks aligned (limit {PINNED_TOL})")
    return fig, faults


def aligned(name: str, args: Sequence, ev, ev64, on_tensor_cores=None):
    """(outputs, reference) of ``ev`` and float64 with their masks
    aligned: a float32 control (TF32 as ``on_tensor_cores`` says)
    evaluated again with float64's masks pinned, against f64; the kernel
    (``on_tensor_cores`` None) against float64 with the kernel's masks
    pinned."""
    if on_tensor_cores is None:
        return ev[0], evaluate(name, args, torch.float64, ev[1])[0]
    with tf32(on_tensor_cores):
        return evaluate(name, args, torch.float32, ev64[1])[0], ev64[0]


def run_kernel(name: str, kernel, args: Sequence) -> Tuple[tuple, dict]:
    """The kernel of op ``name`` through its wrapper on ``args``, TF32 off:
    (outputs, for F2b and F3b the masks of :func:`kernel_masks`, from a
    second launch whose outputs must repeat the first's bitwise; else
    None)."""
    with tf32(False):
        out = as_tuple(kernel(*args))
        if name not in SCRATCH:
            return out, None
        again, masks = kernel_masks(name, args)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise RuntimeError(f"{name}: the kernel does not repeat itself")
    return out, masks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10,
                    help="seeds at each shape (default 10)")
    args = ap.parse_args()
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    print(cs.phase_card(), flush=True)
    t0 = time.perf_counter()
    top: Dict[str, Dict[str, float]] = {}
    faults, flips = [], {}

    def keep(key, what, v):
        t = top.setdefault(key, {})
        t[what] = max(t.get(what, 0.0), v)

    for shape, signed in ((cs.STEPS_CAM, False), (cs.PYRAMID_CAM, False),
                          (cs.RAGGED_CAM, True)):
        for seed in range(1000, 1000 + args.seeds):
            k = cs.cam_case(cam, shape, seed, dev, signed_gates=signed)
            for name, kernel, _, a in cs.cam_calls(cam, k):
                got = run_kernel(name, kernel, a)
                ctl, f64 = evaluations(name, a)
                res, bad = random_check(name, a, got, ctl, f64)
                for o, r in res["outputs"].items():
                    for q in FIGURES:
                        keep(f"{name} {o}", f"{q}_vs_limit",
                             r["kernel"][q] / r["limit"][q])
                        if "own_masks" in r:
                            w = r["own_masks"]
                            keep(f"{name} {o}", f"own_masks_{q}_vs_limit",
                                 w["kernel"][q] / w["limit"][q])
                    if bad and any(f.startswith(f"{name} {o}:")
                                   for f in bad) and any(
                            c[q] > CAPS[q] for c in r["controls"]
                            for q in FIGURES):
                        bad.append(f"{name} {o}: a control breaks the caps "
                                   "there too")
                if "masks_differ" in res:
                    d = res["masks_differ"]
                    keep(name, "masks_differ_vs_limit",
                         d["kernel"] / d["limit"])
                    flips.setdefault(f"{name} {shape[:4]}", []).append(
                        [d["kernel"], *d["controls"]])
                faults += [f"{f} at {shape[:4]}, seed {seed}" for f in bad]
                del got, ctl, f64
            del k
            torch.cuda.empty_cache()
    print(json.dumps({"masks_differing_kernel_tf32_off_on": flips}),
          flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      "seeds": args.seeds, "largest_vs_limit": top,
                      "faults": faults}))


if __name__ == "__main__":
    main()
