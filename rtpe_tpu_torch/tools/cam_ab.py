"""The fused-CAM kernels, the BasicBlock-chain kernel, the grouping
kernels, the NMS + top-k kernel and the LAP kernel of two checkouts of
this repository on the same inputs, on one card: outputs compared,
per-launch times side by side.

    python -m rtpe_tpu_torch.tools.cam_ab --parent <checkout> [--out DIR]
        [--only cam|chain|group|nms|lap|qconv|step]

run from the root of the checkout under test (beside ``chip_smoke.py``,
whose seeded inputs it uses). ``<checkout>`` is another tree of the
repository, e.g. the parent commit unpacked with ``git archive`` into a
gitignored directory. The inputs (``chip_smoke.cam_case``: the train
step's two CAM shapes at B=16, the step CAM of ``--inplanes`` 128 at
B=16 (``step128``), a ragged signed-gate case, the card tests' shapes,
the width grid (``chip_smoke.WIDE_CAMS``, B=2, 21 x 19), and exact-sum
cases, two of them at the width grid) are made once and saved; then each
tree runs the six CAM ops (``cam_f1_fwd``, ``cam_f3_fwd``,
``cam_f2_fwd`` and the three backwards) on them in a process of its own
(its root first on ``sys.path``, its kernels built into its own
``rtpe_tpu_torch/_build/``), in turns parent, new, new, parent, saving
its outputs (under --out, default the gitignored ``_tree/cam_ab``),
CUDA-event times and a ``torch.profiler`` breakdown by kernel at the two
train shapes and at ``step128``. The last line printed is one JSON
object: for each op and
case, whether each output is ``torch.equal`` to the parent's (else its
largest difference of max |parent|), whether each tree repeats itself
bitwise, and each turn's times (device ms, and at the timed shapes each
call's host ms while the card is busy).

The chain (``blocks.basicblock_chain``) runs on ``chip_smoke.chain_inputs``:
4-block chains at the three branch shapes of a 640 x 640 forward at B=8
and B=1 (timed), and exact-sum cases (``chain_exact*``).

The grouping kernels (``group_lockstep``, and ``group_mega`` with each
solver) run on ``chip_smoke.lockstep_input``, on the top-k of the main
path's own heatmaps (``main_path_topk``: eight 640 x 640 images through
the seeded full-width W48 predictor) and on ``chip_smoke``'s NaN scene,
at B=8 and B=1 (timed), and on small cases that reach the kernels'
other instances (D of 2, 3 and 8, more than 32 candidate people,
saturation, exact cost ties, costs at -0 and +0).  Their outputs
(``people``, ``n_people``) must be ``torch.equal`` to the parent's, NaN
for NaN.

The NMS + top-k kernel (``nms_topk``) runs on ``chip_smoke.nms_input``
and on the main path's own heatmaps (``main_path_heatmaps``) at B=8 and
B=1 (timed), on ``chip_smoke.nms_extra_inputs`` (a ragged and a wide
plane, and NaN planes) and at ksize 3 and 9.  The LAP kernel
(``lap_rect``) runs on the 17 cost matrices the main path's heatmaps give
it under ``decode_full_batch(lap="pallas")``, at B=8 and B=1 (timed, ms a
launch), and on ``chip_smoke.decode_costs`` at m in {30, 60, 63, 64, 127}
and with signed zero costs.  Each tree also runs the plain version of
both on the card, and the change must equal it everywhere.  Outputs must
be ``torch.equal`` to the parent's, except on the NaN planes, where the
parent's pool dropped the NaN (``nan`` cases: compared, not held).

The int8 conv (``--only qconv``) runs ``quant.qconv`` (its float32
contract, which both trees keep) at every call geometry of a 640 x 640
int8 forward of the seeded full-width W48, at B = 8 and B = 1, on
``chip_smoke.qconv_case``'s random int8 inputs (+-127 in every row),
timed; then the bf16, int8 and int8-act packed forwards at B = 8 and 1
(the int8 params quantized by each tree from the same state and the
same calibrated scales), timed, with a ``torch.profiler`` breakdown by
part (``qconv``, ``qfuse``, and everything else: PyTorch's glue).  Every
output must be ``torch.equal`` to the parent's.

The train step (``--only step``) runs ``chip_smoke.run_train`` as
``chip_smoke.py``'s phase 18 runs it: ``TRAIN_STEPS`` steps of the
distillation step (B=16, 450 x 450, the seeded W48 stem) with the fused
CAMs, a ``torch.profiler`` view of one more (the CAM kernels by name,
each tree's: phase 0, dx, the forwards, the weight gradients), then the
same steps on cuDNN CAMs from the fused run's parameters, at
``--inplanes`` 80 and 128; its line gives each turn's step times (host
clock after a synchronise), peak GB, the losses' worst difference and
the profile, nothing held.

An output counts as bad where it differs from the parent's, except a
pixel sum (``SUMS``, and the weight gradients ``WGRADS``, whose order a
redesign may change) within ``SUM_TOL`` of max |parent|, or a chain
output within ``CHAIN_TOL`` of max |parent| (a redesign may reorder its
sums), on a case that is not an exact-sum one; the six CAM ops' outputs
on every random case (``REDESIGNED`` = ``F64_HELD``: a redesign of
``csrc/cam_wg.cuh`` may reorder their products' sums) not against the
parent but against float64: each tree's outputs through its own
``tools/cam_check.py`` (the CAM check's rule, its caps at the timed
shapes, the train step's two CAMs and ``step128``, and the card tests'
small caps elsewhere), the change showing no fault the parent does not;
their exact-sum cases stay bitwise.  For the CAM ops the first line also
says whether every per-pixel output and statistic on the exact-sum
cases is ``torch.equal`` to the parent's
(``cam_per_pixel_and_stats_equal``; every case's difference of max
|parent| is reported as ``redesigned_vs_parent``),
the largest weight-gradient difference of max |parent|, and each tree's
F1b dkh (per dilation) and dkr against a float64 product of x and the
cotangents phase 0 makes (``WGRAD_CASES``: exact-sum x and weights, so
those cotangents are the same in every tree), as the worst |kernel -
f64| / sum_p |u v|.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

OPS = {"cam_f1_fwd": ("x", "kr", "kh"),
       "cam_f3_fwd": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate"),
       "cam_f2_fwd": ("x", "kh", "kt", "bnh"),
       "cam_f1_bwd": ("x", "kr", "kh", "dsr", "dsh", "dgap"),
       "cam_f2_bwd": ("x", "kh", "kt", "bnh", "dst"),
       "cam_f3_bwd": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate",
                      "g")}
OUT_NAMES = {"cam_f1_fwd": ("s_r", "s_h", "gap"),
             "cam_f3_fwd": ("out",), "cam_f2_fwd": ("s_t",),
             "cam_f1_bwd": ("dx", "dkr", "dkh"),
             "cam_f2_bwd": ("dx", "dkh", "dkt", "dS"),
             "cam_f3_bwd": ("dx", "dkr", "dkh", "dkt", "dSr", "dSh", "dSt",
                            "dgate"),
             "basicblock_chain": ("out",),
             "group_lockstep": ("people", "n_people"),
             "group_mega_greedy": ("people", "n_people"),
             "group_mega_lap": ("people", "n_people"),
             "nms_topk": ("val", "x", "y"),
             "lap_rect": ("cols",),
             "qconv": ("out",),
             "forward_bf16": ("coarse", "refined"),
             "forward_int8": ("coarse", "refined"),
             "forward_int8_act": ("coarse", "refined")}
# pixel sums whose order a redesign may change: held to 2^-8 of max |parent|
SUMS = {"s_r", "s_h", "gap", "s_t", "dS", "dSr", "dSh", "dSt", "dgate"}
# the weight gradients, pixel sums of another kernel; held the same way,
# and reported apart from the per-pixel outputs and statistics
WGRADS = {"dkr", "dkh", "dkt"}
SUM_TOL = 2.0 ** -8
CHAIN_TOL = 2.0 ** -5
TIMED = ("steps", "pyramid_hi", "step128")
# ops whose kernels may add their products in another order than the
# parent's (every case but the exact-sum ones): a per-pixel bf16 output
# may round the other way (F3's out: one bf16 step of an element near max
# |parent| is 2^-8), a backward's ReLU mask may flip where its recomputed
# conv rounds the other way (a flip moves an output element by its whole
# size), and F2's bf16(t) the same, moving its sums of t and t^2: their
# random cases are held to the float64 check, each tree with its own
# masks, and their difference of max |parent| is reported, not held
REDESIGNED = {"cam_f1_fwd", "cam_f2_fwd", "cam_f3_fwd", "cam_f1_bwd",
              "cam_f2_bwd", "cam_f3_bwd"}
F64_HELD = REDESIGNED
# Exact-sum x and weights with random F1b cotangents dsr / dsh: the conv
# outputs are exact, so dc = bf16(dsh[0] + 2 c dsh[1]) and dr are the
# same in every tree and in a float64 reference; each tree's dkh and dkr
# are then held to the float64 product of x and dc / dr, as the worst
# |kernel - f64| / sum_p |u v| (chip_smoke.WGRAD_TOL is the new kernel's
# limit).
WGRAD_CASES = {"wgrad_steps": (16, 113, 113, 163, (1, 2, 3), 40),
               "wgrad_pyramid_hi": (16, 113, 113, 83, (1, 2, 3, 4), 20)}
CHAIN_N = 4


def kernel_part(name: str) -> str:
    """The part of an op a kernel belongs to, by its name."""
    # the weight gradients: the first design's wgrad_kernel<5> / <7> and
    # their redesign, wgrad_taps_kernel / wgrad_plain_kernel (dkh; dkr /
    # dkt)
    if "wgrad_kernel<5>" in name or "wgrad_taps_kernel" in name:
        return "dkh_wgrad"
    if "wgrad_kernel<7>" in name or "wgrad_plain_kernel" in name:
        return "wgrad_plain"
    if "dx_kernel" in name or "dx_wg_kernel" in name:
        return "dx"
    if any(k in name for k in ("f1b_wg_kernel", "f2b_wg_kernel",
                               "f3b_wg_kernel")):
        return "phase0"
    if "_wg_kernel" in name:
        return "forward"
    if "reduce_rows" in name:
        return "reductions"
    if "conv3x3_kernel" in name:
        return "chain_conv"
    if "split_epilogue" in name:
        return "chain_split_epilogue"
    if "nms_tile_kernel" in name:
        return "nms_tile"
    if "nms_merge_kernel" in name:
        return "nms_merge"
    if "lap_rect_kernel" in name:
        return "lap"
    if "qconv_kernel" in name:
        return "qconv"
    if "qfuse_kernel" in name:
        return "qfuse"
    if any(k in name for k in ("f1b_", "f2b_", "f3b_")):
        return "phase0"
    if any(k in name for k in ("f1_tile", "f2_tile", "f3_tile", "f1_kernel",
                               "f2_kernel", "f3_kernel")):
        return "forward"
    return "wrapper"


def chain_cases() -> list:
    """(name, shape, n, exact, timed) of the chain's cases."""
    import chip_smoke as cs
    out = [(f"chain_b{b}_{h}x{w}x{c}", (b, h, w, c), CHAIN_N, False, True)
           for h, w, c in cs.BRANCHES for b in (8, 1)]
    out += [(f"chain_exact{k}", shape, n, True, False) for k, (shape, n) in
            enumerate([((2, 12, 20, 96), 4), ((1, 20, 20, 384), 2),
                       ((1, 40, 40, 192), 2), ((8, 80, 80, 96), 1)])]
    return out


def make_chain_inputs(path: str) -> list:
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    saved = []
    for name, shape, n, exact, timed in chain_cases():
        x, w, b = cs.chain_inputs(shape, n, cs.SEED + 11 if timed
                                  else cs.SEED + n, dev, exact=exact)
        saved.append({"name": name, "timed": timed,
                      "t": {"x": x.cpu(), "w": w.cpu(), "b": b.cpu()}})
    torch.save(saved, path)
    return [c["name"] for c in saved]


def main_path_heatmaps(dev) -> tuple:
    """(heatmaps, tags, predictor) of eight 640 x 640 images through the
    bf16 serving predictor with the seeded W48 weights: the decode's
    inputs on the main path."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch.eval import PosePredictor
    from rtpe_tpu_torch.models import hrnet
    model = hrnet.init_random_(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                               seed=cs.SEED)
    pred = PosePredictor(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                         model.state_dict(), device=dev)
    rng = np.random.default_rng(cs.SEED + 4)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    with torch.inference_mode():
        x = torch.stack([pred._preprocess(im)[0] for im in square])
        hms, tags = pred._decode_outputs(*pred._forward(x))
    return hms, tags, pred


def main_path_topk(dev) -> tuple:
    """(val_k, loc_k, tag_k) of :func:`main_path_heatmaps`, as float32:
    the grouping kernels' inputs on the main path."""
    import torch
    from rtpe_tpu_torch.decode.nms import top_k
    hms, tags, _ = main_path_heatmaps(dev)
    with torch.inference_mode():
        return tuple(t.float().contiguous() for t in top_k(hms, tags))


def main_path_lap_costs(hms, tags, pred) -> list:
    """The (8, n, m) cost matrices ``decode_full_batch(lap="pallas")``
    gives the LAP kernel on the main path's heatmaps, one a joint."""
    import torch
    from rtpe_tpu_torch.decode import fused, group_jit
    costs = []
    lap_rect = group_jit.lap_rect

    def capture(cost):
        costs.append(cost.clone())
        return lap_rect(cost)

    group_jit.lap_rect = capture
    try:
        with torch.inference_mode():
            fused.decode_full_batch(hms, tags, lap="pallas",
                                    **pred.parser._fused_kwargs())
    finally:
        group_jit.lap_rect = lap_rect
    return costs


def make_decode_inputs(path: str, only=None) -> list:
    """The NMS and LAP cases (see the module's docstring), or only those
    of ``only`` ("nms" or "lap"), saved."""
    import numpy as np
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    hms, tags, pred = main_path_heatmaps(dev)
    saved = []
    for b in (8, 1):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
        saved.append({"op": "nms_topk", "name": f"synthetic_b{b}",
                      "timed": True, "k": 30, "ksize": 5,
                      "t": cs.nms_input(b, gen, dev).cpu()})
        saved.append({"op": "nms_topk", "name": f"main_b{b}", "timed": True,
                      "k": 30, "ksize": 5, "t": hms[:b].float().cpu()})
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    for name, det in cs.nms_extra_inputs(gen, dev):
        saved.append({"op": "nms_topk", "name": name, "timed": False,
                      "k": 30, "ksize": 5, "t": det.cpu()})
    for ksize in (3, 9):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + ksize)
        saved.append({"op": "nms_topk", "name": f"k{ksize}", "timed": False,
                      "k": 20, "ksize": ksize,
                      "t": cs.nms_input(2, gen, dev).cpu()})
    costs = main_path_lap_costs(hms, tags, pred)
    for b in (8, 1):
        saved.append({"op": "lap_rect", "name": f"decode_b{b}",
                      "timed": True, "t": [c[:b].cpu() for c in costs]})
    rng = np.random.default_rng(cs.SEED + 9)
    for m in (30, 60, 63, 64, 127):
        c = torch.from_numpy(cs.decode_costs(8, 30, m, rng))
        saved.append({"op": "lap_rect", "name": f"costs_m{m}",
                      "timed": False, "t": [c]})
        zero = torch.where(c == 0, torch.where(
            torch.from_numpy(rng.random(c.shape)) < 0.5, -0.0, 0.0),
            c.round()).float()
        saved.append({"op": "lap_rect", "name": f"zeros_m{m}",
                      "timed": False, "t": [zero]})
    if only:
        op = {"nms": "nms_topk", "lap": "lap_rect"}[only]
        saved = [c for c in saved if c["op"] == op]
    torch.save(saved, path)
    return [c["name"] for c in saved]


def group_scene(b, j, k, d, seed, spread=2.0, zeros=False):
    """Tags with key ties (setdefault merges) and sorted detection values.
    A large ``spread`` clamps most costs at 1000, where the tie bias is
    below half an ulp: exact cost ties.  ``zeros``: half the tags -0.0
    or +0.0, so that many distances are 0 and, without the detection
    value in the cost, a row's cost at slot 0 is 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * spread
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    if zeros:
        sign = np.where(rng.random(tags.shape) < 0.5, np.float32(-0.0),
                        np.float32(0.0))
        tags = np.where(rng.random(tags.shape) < 0.5, sign, tags)
    locs = rng.integers(0, 320, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    return tags, locs, vals


def group_cases(dev) -> list:
    """(name, (tag, loc, val), keyword arguments, timed) of the grouping
    cases."""
    import numpy as np
    import torch
    import chip_smoke as cs
    out = []
    main = dict(max_num_people=30, p_max=90)
    for b in (8, 1):
        arrs = cs.lockstep_input(b, np.random.default_rng(cs.SEED + 1), dev)
        out.append((f"lockstep_input_b{b}", arrs, main, True))
    val, loc, tag = main_path_topk(dev)
    for b in (8, 1):
        out.append((f"topk_b{b}", (tag[:b], loc[:b], val[:b]), main, True))
    nan = cs.nan_scene(np.random.default_rng(cs.SEED + 6))
    for b in (8, 1):
        out.append((f"nan_b{b}", tuple(torch.from_numpy(a[:b]).to(dev)
                                       for a in nan), main, True))
    small = [("d2", (3, 6, 12, 2), 20, 24, {}, {}),
             ("d3", (3, 17, 30, 3), 30, 90, {}, {}),
             ("d8", (2, 5, 8, 8), 8, 16, {}, {}),
             ("m63", (3, 9, 32, 1), 63, 96, {"spread": 20.0}, {}),
             ("saturate", (4, 9, 12, 1), 20, 6, {}, {}),
             ("ties", (4, 17, 30, 1), 30, 90, {"spread": 300.0}, {}),
             ("zeros", (4, 9, 16, 1), 16, 40, {"zeros": True},
              {"use_detection_val": False}),
             ("skip", (3, 17, 30, 1), 30, 90, {},
              {"ignore_too_much": True})]
    for name, shape, m, p_max, scene_kw, kw in small:
        arrs = group_scene(*shape, seed=sum(shape) + m, **scene_kw)
        out.append((name, tuple(torch.from_numpy(a).to(dev) for a in arrs),
                    dict(max_num_people=m, p_max=p_max, **kw), False))
    return out


def make_group_inputs(path: str) -> list:
    import torch
    dev = torch.device("cuda", 0)
    saved = [{"name": name, "kw": kw, "timed": timed,
              "t": dict(zip(("tag", "loc", "val"),
                            (a.cpu() for a in arrs)))}
             for name, arrs, kw, timed in group_cases(dev)]
    torch.save(saved, path)
    return [c["name"] for c in saved]


def make_qconv_inputs(path: str) -> list:
    """The int8 forward's call geometries (from a tapped B = 1 forward of
    the seeded W48, scales calibrated on two random 640 x 640 images),
    one random case of each at B = 8 and 1, the scales, and the forwards'
    inputs."""
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch.models import hrnet, hrnet_packed as packed
    from rtpe_tpu_torch.ops import qfuse, quant
    dev = torch.device("cuda", 0)
    w48 = hrnet.w48_config()
    state = hrnet.init_random_(hrnet.PoseHigherHRNet(w48),
                               seed=cs.SEED).state_dict()
    pk = packed.pack_w48_params(state, w48, torch.bfloat16, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 14)
    calib = [torch.randn((1, 3, 640, 640), generator=gen).to(dev)
             for _ in range(2)]
    scales = packed.calibrate_act_scales(pk, calib, w48)
    qp = packed.quantize_packed(pk, scales)
    qc, _, _ = cs.graph_taps(packed, quant, qfuse, lambda: (
        packed.packed_forward(qp, calib[0], w48)), compare=False)
    geos = sorted({k[0] for k in qc})
    dgen = torch.Generator(device=dev).manual_seed(cs.SEED + 15)
    cases = []
    for b in (8, 1):
        for geo in geos:
            x, q, _ = cs.qconv_case(quant, geo, b, dgen, dev)
            cout, cin, kh, kw, tr, h, w, st = geo
            cases.append({"name": f"{list(geo)} b{b}", "cin": q.cin,
                          "tr": tr, "stride": 2 if tr else st,
                          "pad": 1 if tr else (kh - 1) // 2,
                          "t": {"x": x.cpu(), "kernel": q.kernel.cpu(),
                                "bias": q.bias.cpu(), "alpha": q.alpha.cpu(),
                                "inv_sx": q.inv_sx.cpu()}})
    xs = {b: torch.randn((b, 3, 640, 640), generator=gen) for b in (8, 1)}
    torch.save({"cases": cases, "scales": scales, "x": xs}, path)
    return [c["name"] for c in cases]


def make_inputs(path: str) -> list:
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch.ops import cam
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [("steps", cs.STEPS_CAM, False, False),
             ("pyramid_hi", cs.PYRAMID_CAM, False, False),
             ("ragged_signed", (3, 29, 21, 83, (1, 2, 3, 4), 20), False,
              True)]
    card = [(2, 21, 21, 12, (1, 2, 3), 3), (2, 17, 23, 163, (1, 2, 3), 40),
            (2, 9, 13, 83, (1, 2, 3, 4), 20), (1, 5, 30, 163, (1, 2, 3), 40),
            (1, 30, 5, 83, (1, 2, 3, 4), 20), (1, 11, 19, 12, (1, 9), 3),
            (1, 9, 10, 170, (1, 2), 8)]
    cases += [(f"card{k}", s, False, True) for k, s in enumerate(card)]
    cases += [("exact163", (2, 12, 20, 163, (1, 2, 3), 40), True, True),
              ("exact83", (3, 9, 14, 83, (1, 2, 3, 4), 20), True, True)]
    # the wider geometries: the step CAM of --inplanes 128 at B=16, timed,
    # the width grid, and two of it on exact sums
    cases += [("step128", cs.STEP128_CAM, False, False)]
    cases += [(f"wide{k}", s, False, False)
              for k, s in enumerate(cs.WIDE_CAMS)]
    cases += [("exact_wide259", cs.WIDE_CAMS[1], True, True),
              ("exact_wide515", cs.WIDE_CAMS[2], True, True)]
    # F1b's weight gradients against float64 (WGRAD_CASES)
    cases += [(name, shape, "mixed", False)
              for name, shape in WGRAD_CASES.items()]
    saved = []
    for name, shape, exact, signed in cases:
        k = cs.cam_case(cam, shape, cs.SEED + sum(shape[:4]), dev,
                        exact=bool(exact), signed_gates=signed)
        if exact == "mixed":
            gen = torch.Generator().manual_seed(cs.SEED + 30)
            for n in ("dsr", "dsh"):
                k[n] = (torch.randn(k[n].shape, generator=gen)
                        * 1e-3).to(dev)
        saved.append({"name": name, "shape": [*shape[:4], list(shape[4]),
                                              shape[5]],
                      "dils": list(k.pop("dils")),
                      "t": {n: v.cpu() for n, v in k.items()}})
    torch.save(saved, path)
    return [c["name"] for c in saved]


def device_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 20) -> float:
    """Host ms of one call while the card is busy behind a sleep (the
    host never waits for it): the wrapper's Python, its plan and weight
    preparation and the launches."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def forward_ms(fn, windows: int = 3) -> dict:
    """Device ms of one forward: the median of ``windows`` windows of
    one call each behind a sleep of ~0.2 s, and whether the host had
    queued every window whole before its sleep ended (where it had not,
    the host blocked on a full launch queue and may have paced the rest
    of the window: five int8 forwards a window overfill it)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ms, queued = [], True
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4 * 10 ** 8)
        start.record()
        fn()
        queued = queued and not start.query()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return {"ms": statistics.median(ms), "queued": queued}


def breakdown(fn) -> dict:
    """ms of one call by part, and the kernels' names, under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    # a profile can miss the kernels of its first moments: fn runs once
    # in a warm-up cycle and is read in the active cycle after it
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    parts, names = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("ProfilerStep"):
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        part = kernel_part(e.name)
        parts[part] = parts.get(part, 0.0) + ms
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + ms
    parts["all_kernels"] = sum(parts.values())
    return {"parts": parts, "kernels": names}


def chain_worker(chain_inputs: str, outs: dict, times: dict) -> None:
    import torch
    from rtpe_tpu_torch.ops import blocks
    dev = torch.device("cuda", 0)
    for case in torch.load(chain_inputs):
        x, w, b = (case["t"][k].to(dev) for k in ("x", "w", "b"))
        got = blocks.basicblock_chain(x, w, b)
        torch.cuda.synchronize()
        outs["basicblock_chain", case["name"]] = [got.cpu()]
        if case["timed"]:
            fn = lambda: blocks.basicblock_chain(x, w, b)    # noqa: E731
            times["basicblock_chain", case["name"]] = {
                "ms": device_ms(fn, reps=20), **breakdown(fn)}
        del x, w, b, got
    torch.cuda.empty_cache()


def group_worker(group_inputs: str, outs: dict, times: dict) -> None:
    import torch
    from rtpe_tpu_torch.ops import group, group_lockstep
    dev = torch.device("cuda", 0)
    kernels = {
        "group_lockstep": group_lockstep.match_by_tag_lockstep,
        "group_mega_greedy": lambda *a, **kw: group.match_by_tag_kernel(
            *a, solver="greedy", **kw),
        "group_mega_lap": lambda *a, **kw: group.match_by_tag_kernel(
            *a, solver="lap", **kw)}
    for case in torch.load(group_inputs):
        args = [case["t"][k].to(dev) for k in ("tag", "loc", "val")]
        kw = case["kw"]
        for op, fn in kernels.items():
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            outs[op, case["name"]] = [v.cpu() for v in got]
            if case["timed"]:
                times[op, case["name"]] = {
                    "ms": device_ms(lambda: fn(*args, **kw), reps=20),
                    "parts": {}, "kernels": {}}


def decode_worker(decode_inputs: str, outs: dict, times: dict) -> None:
    """The NMS and LAP cases: each kernel, and its plain version on the
    card (``<op>_plain``)."""
    import torch
    from rtpe_tpu_torch.ops import lap, nms_topk
    dev = torch.device("cuda", 0)
    for case in torch.load(decode_inputs):
        if case["op"] == "nms_topk":
            det = case["t"].to(dev)
            k, ksize = case["k"], case["ksize"]
            fn = lambda: nms_topk.nms_topk(det, k, ksize)     # noqa: E731
            plain = lambda: nms_topk.nms_topk_plain(det, k, ksize)  # noqa
            per = 1
        else:
            costs = [c.to(dev) for c in case["t"]]
            fn = lambda: (torch.cat([lap.lap_rect(c)          # noqa: E731
                                     for c in costs]),)
            plain = lambda: (torch.cat([lap.lap_rect_plain(c)  # noqa: E731
                                        for c in costs]),)
            per = len(costs)
        got, want = fn(), plain()
        torch.cuda.synchronize()
        outs[case["op"], case["name"]] = [v.cpu() for v in got]
        outs[case["op"] + "_plain", case["name"]] = [v.cpu() for v in want]
        if case["timed"]:
            times[case["op"], case["name"]] = {
                "ms": device_ms(fn, reps=20) / per, **breakdown(fn)}


def qconv_worker(qconv_inputs: str, outs: dict, times: dict) -> None:
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch.models import hrnet, hrnet_packed as packed
    from rtpe_tpu_torch.ops import quant
    dev = torch.device("cuda", 0)
    d = torch.load(qconv_inputs)
    with torch.inference_mode():
        for case in d["cases"]:
            t = {k: v.to(dev) for k, v in case["t"].items()}
            q = quant.QConv(t["kernel"], t["bias"], t["alpha"], t["inv_sx"],
                            case["cin"], case["tr"])
            x, st, pad = t["x"], case["stride"], case["pad"]
            fn = lambda: quant.qconv(x, q, st, pad)    # noqa: E731
            outs["qconv", case["name"]] = [fn().cpu()]
            times["qconv", case["name"]] = {
                "ms": device_ms(fn, reps=20), "parts": {}, "kernels": {}}
            del t, x, q
        w48 = hrnet.w48_config()
        state = hrnet.init_random_(hrnet.PoseHigherHRNet(w48),
                                   seed=cs.SEED).state_dict()
        pk = packed.pack_w48_params(state, w48, torch.bfloat16, dev)
        qp = packed.quantize_packed(pk, d["scales"])
        for b, xc in d["x"].items():
            x = xc.to(dev)
            runs = {"forward_bf16": lambda: packed.packed_forward(pk, x, w48),
                    "forward_int8": lambda: packed.packed_forward(qp, x, w48),
                    "forward_int8_act": lambda: packed.packed_forward(
                        qp, x, w48, int8_act=True)}
            for name, fn in runs.items():
                outs[name, f"b{b}"] = [v.cpu() for v in fn()]
                times[name, f"b{b}"] = {**forward_ms(fn), **breakdown(fn)}
    torch.cuda.empty_cache()


# the train step's profile: the CAM kernels together, then each by name
# (the first design's tile kernels and the wgmma kernels), the weight
# gradients, the reductions and the wrapper's gather
STEP_PARTS = ("cam::", "f1_tile", "f2_tile", "f3_tile", "f1b_tile",
              "f2b_tile", "f3b_tile", "::dx_kernel", "::f1_wg_kernel",
              "::f2_wg_kernel", "::f3_wg_kernel", "::f1b_wg_kernel",
              "::f2b_wg_kernel", "::f3b_wg_kernel", "::dx_wg_kernel",
              "wgrad_taps_kernel", "wgrad_plain_kernel", "reduce_rows",
              "index_select")


def step_worker(save: str) -> None:
    """The train step in this tree (``--only step``), fused CAMs and
    cuDNN's, at ``--inplanes`` 80 and 128; saved as JSON."""
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch import train as train_mod
    from rtpe_tpu_torch.models import factory, hrnet, students
    from rtpe_tpu_torch.ops import cam
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = hrnet.init_random_(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                               seed=cs.SEED).state_dict()
    batch = cs.train_batch(dev)
    # the profile of each tree's run_train, read by STEP_PARTS
    profile = cs.device_profile
    cs.device_profile = lambda fn, ours=(): profile(fn, STEP_PARTS)
    res = {"file": cam.__file__}
    for inplanes in (80, 128):
        run = {}
        for fused in (True, False):
            r = cs.run_train((factory, students), train_mod, cam, fused,
                             state, run.get("params"), batch, dev,
                             profile=fused, inplanes=inplanes)
            run["params"] = r.pop("params")
            r.pop("model")
            run["fused" if fused else "cudnn"] = r
        f, u = run["fused"], run["cudnn"]
        prof = f["profile"]
        res[str(inplanes)] = {
            "fused": cs.train_summary(f), "cudnn": cs.train_summary(u),
            "loss_worst_rel": max(
                max(abs(a1 - a2) / abs(a2), abs(d1 - d2) / abs(d2))
                for (a1, d1), (a2, d2) in zip(f["losses"], u["losses"])),
            "profile": {k: prof.get(k) for k in ("wall_ms", "kernel_ms",
                                                 "device_busy", "top")},
            "profile_ms": {k: v for k, v in
                           (prof.get("ours_ms") or {}).items() if v}}
        del run, f, u
        torch.cuda.empty_cache()
    with open(save, "w") as fh:
        json.dump(res, fh)


def f64_faults(name: str, fn, args, case: str) -> list:
    """The float64 check's faults (``tools/cam_check.py`` of the tree
    that runs this) of op ``name`` on ``args``, by output: the CAM check's
    caps at the timed shapes (the train step's CAMs, ``step128``), the
    card tests' small caps (one mask flip covers more than 1e-4 of a
    small output) elsewhere."""
    from rtpe_tpu_torch.tools import cam_check
    caps = cam_check.CAPS if case in TIMED \
        else dict(cam_check.CAPS, share=1.0)
    got = cam_check.run_kernel(name, fn, args)
    ctl, ev64 = cam_check.evaluations(name, args)
    _, faults = cam_check.random_check(name, args, got, ctl, ev64, caps)
    return sorted({f.split(":")[0] for f in faults})


def worker(root: str, inputs, chain_inputs, group_inputs, decode_inputs,
           qconv_inputs, save: str, check: bool = False) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from rtpe_tpu_torch.ops import cam
    assert os.path.abspath(cam.__file__).startswith(os.path.abspath(root)), \
        cam.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cases = torch.load(inputs) if inputs else []
    outs, times, checks = {}, {}, {}
    if chain_inputs:
        chain_worker(chain_inputs, outs, times)
    if group_inputs:
        group_worker(group_inputs, outs, times)
    if decode_inputs:
        decode_worker(decode_inputs, outs, times)
    if qconv_inputs:
        qconv_worker(qconv_inputs, outs, times)
    for case in cases:
        t = {n: v.to(dev) for n, v in case["t"].items()}
        dils = tuple(case["dils"])
        if case["name"] in WGRAD_CASES:
            outs["f64", case["name"]] = wgrad_vs_f64(cam, t, dils)
            del t
            torch.cuda.empty_cache()
            continue
        for op, keys in OPS.items():
            fn = getattr(cam, op)
            args = [t[k] for k in keys] + [dils]
            got = fn(*args)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            outs[op, case["name"]] = [v.cpu() for v in got]
            if check and op in F64_HELD and "exact" not in case["name"]:
                checks[op, case["name"]] = f64_faults(op, fn, args,
                                                      case["name"])
            if case["name"] in TIMED:
                times[op, case["name"]] = {
                    "ms": device_ms(lambda: fn(*args)),
                    "host_ms": host_ms(lambda: fn(*args)),
                    **breakdown(lambda: fn(*args))}
        del t
        torch.cuda.empty_cache()
    torch.save({"outs": outs, "times": times, "checks": checks,
                "file": cam.__file__}, save)


def wgrad_vs_f64(cam, t, dils) -> dict:
    """F1b's dkh and dkr on a WGRAD_CASES case against the float64
    products of x and the cotangents phase 0 makes (recomputed: exact
    convs, the same float32 expression, bf16): the worst |kernel - f64|
    / sum_p |u v| of each."""
    import torch
    x, kr, kh, dsr, dsh = t["x"], t["kr"], t["kh"], t["dsr"], t["dsh"]
    _, dkr, dkh = cam.cam_f1_bwd(x, kr, kh, dsr, dsh, t["dgap"], dils)
    x32, x64 = x.float(), x.double()

    def ratio(got, u64, v64, d):
        def prod(a, b):
            return cam._wgrad(a, b, d) if d else torch.einsum(
                "bhwk,bhwn->kn", a, b)
        ref, den = prod(u64, v64), prod(u64.abs(), v64.abs())
        return float(((got.double() - ref).abs()
                      / den.clamp(min=1e-300)).max())

    res = {}
    with torch.backends.cudnn.flags(enabled=False):
        for i, d in enumerate(dils):
            c = cam._bf(cam._conv(x32, kh[i], d))
            dc = cam._bf(dsh[2 * i] + 2.0 * c * dsh[2 * i + 1])
            res[f"dkh_d{d}"] = ratio(dkh[i], x64, dc.double(), d)
    rc = cam._bf(x32 @ kr.float())
    dr = cam._bf(dsr[0] + 2.0 * rc * dsr[1])
    res["dkr"] = ratio(dkr, x64, dr.double(), 0)
    return res


def same(x, y) -> bool:
    """``torch.equal``, with a NaN equal to a NaN at the same place."""
    import torch
    if x.is_floating_point() and x.shape == y.shape:
        nan = torch.isnan(x)
        if bool(nan.any()):
            return torch.equal(nan, torch.isnan(y)) and torch.equal(
                x[~nan], y[~nan])
    return torch.equal(x, y)


def compare(a, b, names) -> dict:
    res = {}
    for n, x, y in zip(names, a, b):
        if same(x, y):
            res[n] = "equal"
            continue
        scale = max(float(y.float().abs().max()), 1e-30)
        res[n] = float((x.float() - y.float()).abs().max()) / scale
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="_tree/cam_ab")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root")
    ap.add_argument("--inputs")
    ap.add_argument("--save")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--chain-inputs")
    ap.add_argument("--group-inputs")
    ap.add_argument("--decode-inputs")
    ap.add_argument("--qconv-inputs")
    ap.add_argument("--only", choices=("cam", "chain", "group", "nms",
                                       "lap", "qconv", "step"))
    a = ap.parse_args()
    if a.only == "step":
        if a.worker:
            sys.path.insert(0, os.path.abspath(a.root))
            step_worker(a.save)
        else:
            step_main(a)
        return
    if a.worker:
        worker(a.root, a.inputs, a.chain_inputs, a.group_inputs,
               a.decode_inputs, a.qconv_inputs, a.save, a.check)
        return
    import torch
    os.makedirs(a.out, exist_ok=True)
    inputs = os.path.join(a.out, "inputs.pt")
    chain_inputs = os.path.join(a.out, "chain_inputs.pt")
    group_inputs = os.path.join(a.out, "group_inputs.pt")
    decode_inputs = os.path.join(a.out, "decode_inputs.pt")
    qconv_inputs = os.path.join(a.out, "qconv_inputs.pt")
    args = []
    if a.only in (None, "cam"):
        make_inputs(inputs)
        args += ["--inputs", inputs]
    if a.only in (None, "chain"):
        make_chain_inputs(chain_inputs)
        args += ["--chain-inputs", chain_inputs]
    if a.only in (None, "group"):
        make_group_inputs(group_inputs)
        args += ["--group-inputs", group_inputs]
    if a.only in (None, "nms", "lap"):
        make_decode_inputs(decode_inputs, a.only)
        args += ["--decode-inputs", decode_inputs]
    if a.only == "qconv":
        make_qconv_inputs(qconv_inputs)
        args += ["--qconv-inputs", qconv_inputs]
    turns = [("parent", a.parent), ("new", "."), ("new", "."),
             ("parent", a.parent)]
    runs = []
    for k, (label, root) in enumerate(turns):
        save = os.path.join(a.out, f"{k}_{label}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--parent", a.parent, "--worker", "--root", root,
                        *args, "--save", save]
                       + (["--check"] if k < 2 else []), check=True)
        runs.append(torch.load(save))
    par, new = runs[0], runs[1]
    report = {"files": [r["file"] for r in runs], "ops": {}}
    bad = []
    for (op, case), got in new["outs"].items():
        if op.endswith("_plain"):   # the change against its plain version
            if not all(same(x, y) for x, y in
                       zip(new["outs"][op[:-6], case], got)):
                bad.append(f"{op[:-6]} {case}: differs from its plain "
                           "version")
            continue
    per_pixel_equal = True
    for (op, case), want in par["outs"].items():
        if op.endswith("_plain"):
            continue
        if op == "f64":
            report.setdefault("wgrad_vs_f64", {})[case] = {
                lab: runs[i]["outs"][op, case]
                for i, lab in ((0, "parent"), (1, "new"))}
            continue
        got = new["outs"][op, case]
        cmp = compare(got, want, OUT_NAMES[op])
        rep_new = all(same(x, y) for x, y in
                      zip(got, runs[2]["outs"][op, case]))
        rep_par = all(same(x, y) for x, y in
                      zip(want, runs[3]["outs"][op, case]))
        exact = "exact" in case
        redesigned = op in REDESIGNED and "exact" not in case
        held = redesigned and op in F64_HELD
        for n, v in cmp.items():
            if op in OPS and n not in WGRADS and v != "equal" \
                    and not redesigned:
                per_pixel_equal = False
            if held:
                continue
            tol = CHAIN_TOL if op == "basicblock_chain" else (
                SUM_TOL if n in SUMS | WGRADS else None)
            if op == "nms_topk" and case.startswith("nan"):
                continue            # the parent's pool dropped the NaN
            if v != "equal" and (tol is None or v > tol or exact):
                bad.append(f"{op} {case} {n}: {v}")
        if not (rep_new and rep_par):
            bad.append(f"{op} {case}: a tree does not repeat itself")
        report["ops"].setdefault(op, {})[case] = {
            "vs_parent": cmp, "new_repeats": rep_new,
            "parent_repeats": rep_par}
        if held:
            f_new = runs[1]["checks"][op, case]
            f_par = par.get("checks", {}).get((op, case), [])
            report["ops"][op][case]["f64_faults"] = {"new": f_new,
                                                     "parent": f_par}
            extra = sorted(set(f_new) - set(f_par))
            if extra:
                bad.append(f"{op} {case}: float64 faults the parent does "
                           f"not show: {extra}")
    report["times"] = {
        f"{op} {case}": {
            "ms": [r["times"][op, case]["ms"] for r in runs],
            "ms_by_part": [r["times"][op, case]["parts"] for r in runs],
            "host_ms": [r["times"][op, case].get("host_ms") for r in runs],
            "queued": [r["times"][op, case].get("queued") for r in runs],
            "kernels": {lab: runs[i]["times"][op, case]["kernels"]
                        for i, lab in ((0, "parent"), (1, "new"))}}
        for (op, case) in par["times"]}
    if any(op in OPS for op, _ in par["outs"]):
        # the per-pixel outputs and statistics against the parent's, and
        # the largest weight-gradient difference of max |parent|
        report["cam_per_pixel_and_stats_equal"] = per_pixel_equal
        report["cam_wgrad_worst_vs_parent"] = max(
            [v for o in report["ops"].values() for c in o.values()
             for n, v in c["vs_parent"].items()
             if n in WGRADS and v != "equal"] or [0.0])
        report["redesigned_vs_parent"] = {
            f"{op} {case}": r["vs_parent"]
            for op, by in report["ops"].items() if op in REDESIGNED
            for case, r in by.items()}
    report["bad"] = bad
    with open(os.path.join(a.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    short = {k: {"ms": [round(x, 3) for x in v["ms"]],
                 "median_new": statistics.median(v["ms"][1:3]),
                 **({"not_queued_whole": True} if False in v["queued"]
                    else {})}
             for k, v in report["times"].items()}
    print(json.dumps({"bad": bad, "times": short, **{
        k: report[k] for k in ("cam_per_pixel_and_stats_equal",
                               "cam_wgrad_worst_vs_parent", "wgrad_vs_f64",
                               "redesigned_vs_parent")
        if k in report}}))
    print(json.dumps(report))
    sys.exit(1 if bad else 0)


def step_main(a) -> None:
    """``--only step``: the train step in each tree, parent, new, new,
    parent, one process each; one JSON line of every turn."""
    os.makedirs(a.out, exist_ok=True)
    runs = []
    for k, (label, root) in enumerate((("parent", a.parent), ("new", "."),
                                       ("new", "."), ("parent", a.parent))):
        save = os.path.join(a.out, f"step_{k}_{label}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--parent", a.parent, "--worker", "--only", "step",
                        "--root", root, "--save", save], check=True)
        with open(save) as fh:
            runs.append({"turn": label, **json.load(fh)})
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
