"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``rtpe_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build seconds and the ``ptxas``
   report, one line per kernel (its name, registers, spills, shared
   memory); then time one warp's chain of 1,024 dependent
   (``__reduce_min_sync``, ballot) steps (``csrc/warp_step_probe.cu``),
   the step that prices the grouping kernels' latency bound;
3. the NMS + top-k kernel against its plain PyTorch version on the card,
   B in {1, 8} x 17 x 320 x 320 with planted ties and sparse planes, and
   planes with NaNs (a peak beside a NaN, a NaN on a tile border), a
   ragged 333 x 250 plane and a wider 320 x 480 one: exactly equal;
4. the lockstep grouping kernel against its plain version, B in
   {1, 8, 32}, J=17, K=30, D=1, p_max=90, ``ignore_too_much`` both ways:
   exactly equal;
5. the per-joint LAP kernel against its plain version: batches of
   cost matrices, n in {1, 8, 30, 32} x m in {30, 60, 63, 64, 127} (63
   and 64 straddle the solver's two column layouts), with the decode's
   sentinel costs and planted ties, and costs of -0.0 and +0.0: exactly
   equal;
6. the grouping mega-kernel against its plain version, both solvers,
   B in {1, 8}, J=17, K=30, D=1, p_max=90, ``ignore_too_much`` both
   ways: exactly equal; its greedy solver equal to the lockstep kernel
   row for row;
7. ``kernel_selfcheck`` on the card for the greedy, exact and lockstep
   grouping kernels: each must pass (a demotion of ``lap="auto"`` fails
   the run);
8. the full-width HigherHRNet-W48 (seeded random weights) as a float32
   forward on the card, TF32 off, against the same weights on the CPU at
   one 256 x 256 image: within 1e-3;
9. the main path: ``PosePredictor`` at full W48 width in bf16 through
   ``predict_batch`` (8 images of mixed shapes), ``predict`` and a
   4-frame ``stream``, with every kernel's launch counter set to 0 just
   before and read just after; then the card's decode of the main path's
   own heatmaps against the plain decode on the CPU;
10. the other decode paths on the bf16 predictor's heatmaps of eight
    640 x 640 images, each with the launch counters set to 0 just before
    and read just after: ``HeatmapParser.parse_fused`` per image (the
    greedy mega-kernel), ``decode_full_batch(lap="kernel")`` (the exact
    mega-kernel), ``decode_full_batch(lap="pallas")`` (the LAP kernel)
    and ``PosePredictor(fused_decode=False).predict_batch`` (NMS + top-k
    kernel, host grouping); each against the plain decode on the CPU
    for one image;
11. timings (CUDA events after a warm-up): each kernel, its plain version
    and its library yardstick at the main path's batch-8 shape and at
    batch 1 (the grouping and LAP kernels also with a latency bound: the
    longest image's chain of dependent steps, each at the probe's time), each decode path's host-clock time on the heatmaps of
    phase 10, the forward, decode and end-to-end rates at batch 1 and 8,
    and a ``torch.profiler`` view of one batch-8 ``predict_batch``;
12. the grouping kernels (lockstep, and the mega-kernel with both
    solvers) against their plain versions on tags with planted NaNs:
    equal, NaN for NaN (a NaN cost matches no one);
13. the BasicBlock-chain kernel against its plain version (float32
    convolutions, TF32 off): B in {1, 8} x the three branch shapes of the
    640 x 640 forward (80 x 80 x 96, 40 x 40 x 192, 20 x 20 x 384) x
    n in {1, 4}, and a ragged (2, 12, 20, 96): the worst element within
    2^-5 of the output's largest magnitude (sum-order flips of bf16
    roundings compound along the chain; the worst relative error and
    the share of elements that differ are printed); bitwise equal on
    inputs whose every conv sum is exact in float32 (with and without
    K splits) and from one run to the next; the kernel's plan
    (``basicblock_chain_plan``) equal to ``ops/blocks.py:chain_plan`` at
    the six B x shape cases;
14. the full-width W48 packed (BN-folded) forward on the card: float32
    with the chains on cuDNN against the canonical float32 forward
    (TF32 off) within 1e-3, as phase 8; bf16 with ``pallas_chains=True``
    against bf16 with the chains on cuDNN within 2^-4 of the largest
    output (cuDNN rounds each conv to bf16 before its float32 bias, a
    second rounding the kernel does not make); 18 chain launches per
    640 x 640 forward;
15. the packed serving path: 8 images at 640 -> preprocess ->
    ``packed_forward(pallas_chains=True)`` -> ``_decode_outputs`` ->
    ``parse_fused_batch`` -> people, with the counters set to 0 just
    before and read just after; then ``PosePredictor(packed=True)``
    through ``predict_batch`` (mixed shapes), ``predict`` and a 4-frame
    ``stream``, the same way;
16. timings: the chain kernel, its plain version and one cuDNN bf16
    conv (the library yardstick, x 2n per chain) at B = 8 and 1 for each
    branch shape, each with its TFLOP/s, and the chain kernels' ``ptxas``
    lines; the forward at batch 1 and 8 for the canonical, the
    packed and the packed + chains forwards; the packed predictor's
    end-to-end rates and its ``torch.profiler`` view;
17. the six fused-CAM kernels against their plain versions (float32
    convs, TF32 off) at the train step's two CAM shapes, B=16, 113 x 113
    x 163 (dilations 1-3) and x 83 (1-4), and a ragged (3, 29, 21, 83)
    case with per-image gates of both signs (all six on the 8 x 8 tiles
    of ``csrc/cam_tile.cuh``): forward statistics within 2^-8 of their largest
    magnitude, every other output within the ``CAM_*`` limits (worst
    element, mean, share off); bitwise equal on exact-sum inputs;
18. the slice's main path: 5 train steps of
    ``make_distill_train_step`` at the reference configuration
    (``AttentionStudentSteps(inplanes=80, fused_cam=True)``, bf16, B=16,
    450 x 450, the stem of the seeded W48 through
    ``load_pretrained_stem``), with the CAM counters set to 0 just before
    and read just after: 30 launches of each kernel and no plain call,
    finite losses, frozen parameters unchanged, every other group and
    running statistic moved; then 5 steps with the CAMs on cuDNN, each
    from the fused run's parameters of that step: each step's losses
    within 1e-3 of each other; step times, peak memory and a
    ``torch.profiler`` view of one fused step;
19. each CAM kernel's time, its plain version's, its bound and the cuDNN
    CAM's train-mode forward (or forward + backward) at both shapes, and
    the per-launch breakdown under ``torch.profiler`` of F1, F2 and F3
    (the tile kernel, F1's and F2's reductions, the wrapper's padding and
    weight re-layout) and of F1b, F2b and F3b (phase 0, dx, the ``dkh`` and
    ``dkr``/``dkt`` weight gradients, the reductions, the wrapper).

20. flip and multi-scale (0.5, 1, 2) TTA at full W48 width on 640 x 640
    images: the grouping self-checks at D=2 (the solver ``lap="auto"``
    then serves is printed); float32 ``tta_forward`` (TF32 off) against
    the same aggregate from separate forwards of B, within 1e-4 of the
    largest magnitude; four bf16 predictors (canonical and packed, flip
    and flip at three scales), each ``predict_batch`` of 8 with the
    counters set to 0 just before and read just after, equal to 8
    ``predict`` calls; the D=2 decode on the card against the plain
    decode on the CPU (n_people exact, 1e-5); the lockstep kernel at D=2
    on the TTA top-k of 8 images, equal to its plain version and timed;
21. ``validate_hhrnet``'s core on an in-memory COCO fixture (six 480 x
    640 and two 640 x 427 images, two or three people each, RLE
    segmentations, served by a dataset subclass): packed, flip, twice,
    the ten stats printed and finite, the NMS + top-k kernel launched
    once a chunk, the forward's img/s beside the card; the evaluator on
    the fixture's ground truth: AP = AR = 1.0 exactly;
22. ``teacher_inference``'s core on 4 of those images through the
    packed forward: each ``.npz`` read back through the port's loader
    bitwise equal to the forward's outputs pulled to the host, with the
    four keys in order and the joint names;
23. ``realtime_demo``'s core: 16 frames through the packed predictor's
    ``stream`` with and without flip, the counters set to 0 just before
    and read just after, every frame's people equal to ``predict``'s,
    and the frames per second;
24. int8 serving at full W48 width on 640 x 640 inputs: the scales
    calibrated on the 8 synthetic images of phase 9; ``qconv``
    (``csrc/qconv.cu``: s8 ``wgmma``, split K, the transposed conv as
    four sub-pixel phases, the graph's epilogue) and ``qfuse``
    (``csrc/qfuse.cu``: the fuse sums and the one-pass quantize) held
    ``torch.equal`` to their plain versions at every call of the int8
    and int8-act forwards at B = 1 and 8, on the forwards' own inputs,
    in the epilogue mode the graph uses at each call (26 weight shapes,
    the transposed conv's included); ``qconv`` also at each (call
    geometry, mode) on random int8 inputs with +-127 in every row and
    random residuals, in its float32 contract at each geometry, and on
    values placed on bf16 ties and at +-126.5 / +-127.5 before the
    clamp; its C plan equal to ``ops/quant.py:qconv_plan`` at every
    geometry at B = 1 and 8; the int8 and int8-act forwards at B = 1 and
    8 bitwise equal to the same forwards on the plain composition (the
    graph's ``qconv`` and ``fuse_sum`` patched to their plain versions),
    finite, correlated > 0.99 with the bf16 packed forward (the worst
    relative error printed); ``PosePredictor(packed=True, int8=True)``
    and ``int8_act=True``, the counters set to 0 just before each call
    and read just after: ``predict_batch`` of 8 launches ``qconv`` once
    a quantized conv (303), ``fuse_sum`` as often as one forward does
    and the decode kernels once, ``predict`` of one image is routed to
    bf16 (neither int8 kernel), and with ``int8_min_batch=0`` quantized
    again; ``export_serving_artifact`` and ``from_artifact`` forwards
    bitwise equal; ``validate_hhrnet``'s core with ``--int8`` and
    ``--int8_act`` (ten finite stats; run inside phase 21's fixture);
    ``realtime_demo``'s core with ``--int8`` (16 frames equal to
    ``predict``, ``routed_bf16``); then times: the bf16, int8 and
    int8-act forwards at B = 1 and 8, the kernels ``torch.profiler``
    sees in one int8 and one int8-act forward that are not the port's,
    ``qconv`` per (call geometry, mode) at B = 8 and 1 on the forwards'
    own inputs beside its bound, its plain version, cuDNN's bf16 conv
    and ``torch._int_mm`` over an im2col (yardsticks the port never
    calls), ``fuse_sum`` per call beside its bytes bound, and
    ``predict_batch`` img/s for each.

Phases 12-19 run among the others: 12 after 6, 13 and 14 after 8, 15
after 10, 16 with 11, and 17-19 after 15; 20-24 run last (24's
validation inside 21's fixture).

Output: the ``nvidia-smi`` line, the CLIs' stats lines, then one JSON
line ``{"kernels": ...}``, one JSON line of end-to-end, train-step, TTA,
CLI and int8 numbers, and last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
``rtpe_tpu_torch`` package beside it, the script exits non-zero and
prints no result.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
CHAIN_TOL = 2.0 ** -5         # chain kernel vs plain, of max |plain|
PACKED_BF16_TOL = 2.0 ** -4   # chains on vs off, of max |off|
BRANCHES = [(80, 80, 96), (40, 40, 192), (20, 20, 384)]   # at 640 x 640
SEED = 0
CAM_STAT_TOL = 2.0 ** -8      # CAM kernels vs plain: forward statistics
# CAM kernels vs plain, activations and gradients (the backward sums over
# pixels included): a conv output whose
# bf16 rounding lands on the other side of a tie can move a ReLU mask
# (z within a rounding of 0), and the one cotangent behind it moves by
# its own size; at B=16 a few such flips happen per call.  So: the worst
# element within CAM_WORST of max |plain|, the mean within CAM_MEAN, and
# at most CAM_SHARE of the elements off by more than CAM_TOL of it.
CAM_TOL = 2.0 ** -5
CAM_WORST = 2.0 ** -2
CAM_MEAN = 2.0 ** -8
CAM_SHARE = 1e-4
# fused vs cuDNN CAMs, each step's losses from the same parameters
# (measured worst 3.4e-5 on the H100; 30x that)
TRAIN_LOSS_TOL = 1e-3
# (B, H, W, C, dilations, hc) of the train step's CAMs at B=16, 450 x 450
STEPS_CAM = (16, 113, 113, 163, (1, 2, 3), 40)
PYRAMID_CAM = (16, 113, 113, 83, (1, 2, 3, 4), 20)
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS = 16, 450, 5
# the kernels of the tiled ops (the forwards: the tile kernel and F1's and
# F2's reductions; the backwards: phase 0, dx, the dkh and dkr / dkt
# weight gradients, the reductions), for their per-launch breakdown under
# torch.profiler; "other" is the wrapper's padded x and re-laid weights
TILE_PARTS = {name: (phase0, dx, "wgrad_kernel<5>", "wgrad_kernel<7>",
                     "reduce_rows_kernel")
              for name, phase0, dx in (
                  ("cam_f1_bwd", "f1b_tile_kernel", "dx_kernel<true, true>"),
                  ("cam_f2_bwd", "f2b_tile_kernel",
                   "dx_kernel<false, false>"),
                  ("cam_f3_bwd", "f3b_tile_kernel", "dx_kernel<true, false>"))}
TILE_PARTS["cam_f1_fwd"] = ("f1_tile_kernel", "reduce_rows_kernel")
TILE_PARTS["cam_f2_fwd"] = ("f2_tile_kernel", "reduce_rows_kernel")
TILE_PARTS["cam_f3_fwd"] = ("f3_tile_kernel",)
CAM_REPLACES = {"cam_f1_fwd": 558, "cam_f1_bwd": 580, "cam_f2_fwd": 609,
                "cam_f2_bwd": 627, "cam_f3_fwd": 655, "cam_f3_bwd": 675}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _window(fn, reps: int, sleep_cycles: int) -> tuple:
    """Device ms per call of ``fn`` over ``reps`` calls queued behind a
    sleep kernel of ``sleep_cycles``, and whether the host had queued
    them all before the sleep ended (else the host's launches paced a
    part of the window)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    queued = not start.query()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, queued


def device_ms(fn, reps: int, warmup: int = 2,
              sleep_cycles: int = 50_000_000) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around
    ``reps`` calls queued behind a sleep kernel of ``sleep_cycles``, so
    that the host's launch overhead is hidden where the device is the
    slower side (as long as the host queues the calls within the
    sleep).  Fails without ``torch.cuda._sleep``: the times would then
    include the host's launches."""
    check(getattr(torch.cuda, "_sleep", None) is not None,
          "torch.cuda._sleep is missing: device times would include host "
          "launch overhead")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _window(fn, reps, sleep_cycles)[0]


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Host milliseconds per call of ``fn`` ending in a synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# ---------------------------------------------------------------- inputs

def nms_input(b: int, gen: torch.Generator, dev) -> torch.Tensor:
    """(B, 320, 320, 17) heatmaps, seen NHWC over NCHW storage as the
    model's output is: smooth random planes, sparse planes with fewer
    than K positive peaks (zero-valued pixels fill the rest), planes
    with equal peaks planted across tile borders, negative planes."""
    h = w = 320
    j = 17
    x = torch.randn((b, j, h // 8, w // 8), generator=gen, device=dev)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    x = torch.round(x * 64) / 64                    # many exact ties
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    for i in range(b):
        sparse = torch.zeros((h, w), device=dev)
        for _ in range(5):
            cy, cx = torch.randint(0, h, (2,), generator=gen, device=dev)
            sparse = torch.maximum(sparse, 0.8 * torch.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0))
        sparse = torch.where(sparse < 1e-3, torch.zeros_like(sparse),
                             sparse)
        x[i, 3] = sparse
        ties = torch.zeros((h, w), device=dev)
        for py, px in [(31, 63), (32, 64), (0, 0), (319, 319), (160, 127),
                       (96, 192), (200, 5), (64, 256)]:
            ties[py, px] = 0.5
        x[i, 5] = ties
        x[i, 9] = -x[i, 9].abs() - 0.01
    return x.permute(0, 2, 3, 1)


def nms_extra_inputs(gen: torch.Generator, dev) -> list:
    """(name, det) beyond the main path's shape: NaNs (a peak beside a
    NaN, NaNs on tile borders beside peaks, scattered NaNs),
    a ragged plane and a wider one (a non-square image), each NHWC over
    NCHW storage."""
    nan = nms_input(2, gen, dev).permute(0, 3, 1, 2).contiguous()
    nan[0, 0] = 0.0
    nan[0, 0, 10, 11] = 1.0
    nan[0, 0, 10, 10] = float("nan")
    nan[0, 0, 30, 40] = 0.5
    nan[0, 1, 31, 63] = float("nan")
    nan[0, 1, 32, 64] = 9.0
    nan[0, 2, 63, 63] = float("nan")                  # a tile corner
    nan[0, 2, 64, 64] = 9.0
    nan[1][torch.rand(nan[1].shape, generator=gen, device=dev) < 0.01] = \
        float("nan")
    out = [("nan", nan.permute(0, 2, 3, 1))]
    for name, (h, w) in (("ragged", (333, 250)), ("wide", (320, 480))):
        x = torch.randn((2, 17, h // 8, w // 8), generator=gen, device=dev)
        x = F.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False)
        out.append((name, (torch.round(x * 64) / 64).permute(0, 2, 3, 1)))
    return out


def lockstep_input(b: int, rng: np.random.Generator, dev):
    j, k, d = 17, 30, 1
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * 2
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2   # key ties: merges
    locs = rng.integers(0, 320, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    return tuple(torch.from_numpy(a).to(dev) for a in (tags, locs, vals))


def decode_costs(b: int, n: int, m: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """(B, n, m) cost matrices shaped like the grouping's: quantised tag
    distances x 100 minus the row's detection value (plus the tie bias
    on odd matrices, exact ties on even ones) on the first p_cur
    columns, BIG on the dummy columns, HUGE / 0 for a row at or below
    the detection threshold; every fourth matrix plain small integers
    (ties everywhere)."""
    f32 = np.float32
    rows = np.arange(n)[:, None]
    cols = np.arange(m)[None, :]
    out = np.empty((b, n, m), f32)
    for i in range(b):
        if i % 4 == 3:
            out[i] = rng.integers(0, 3, (n, m))
            continue
        cost = (rng.integers(0, 4, (n, m)) * 100.0
                - rng.uniform(0.1, 1.0, (n, 1))).astype(f32)
        if i % 2:
            cost = cost + ((m - rows) * cols).astype(f32) * f32(1e-8)
        real = cols < rng.integers(1, max(1, m // 2) + 1)
        valid = rng.random((n, 1)) > 0.2
        cost = np.where(real, cost, f32(2048.0))
        out[i] = np.where(valid, cost, np.where(real, f32(4096.0), f32(0)))
    return out


# ---------------------------------------------------------------- phases

def phase_card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(),
          f"nvidia-smi: {res.stderr.strip()}")
    line = res.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def entry_name(mangled: str) -> str:
    """A kernel's name from its Itanium-mangled symbol: the nested names
    joined by ``::`` (``cam::tile::f3_tile_kernel``) and its bool or int
    template arguments (``dx_kernel<true, false>``); the symbol as it is
    where it does not parse."""
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    parts = []
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group(0))
        pos += len(m.group(0))
        part = mangled[pos:pos + n]
        parts.append("(anonymous)" if part.startswith("_GLOBAL__N_")
                     else part)
        pos += n
    if not parts:
        return mangled
    name = "::".join(parts)
    if mangled[pos:pos + 1] == "I":
        args = re.match(r"I((?:L[bi]n?\d+E)+)E", mangled[pos:])
        if not args:
            return mangled
        vals = [{"b1": "true", "b0": "false"}.get(t + v, v.replace("n", "-"))
                for t, v in re.findall(r"L([bi])(n?\d+)E", args.group(1))]
        name += f"<{', '.join(vals)}>"
    return name


def ptxas_report(log: str) -> dict:
    """Per kernel of one ``nvcc -Xptxas=-v`` log: registers, spill stores
    and loads (bytes), stack frame and static shared memory (bytes)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = entry_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                out[cur][key] = int(m.group(1))
    return out


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True, force=True)
    secs = time.perf_counter() - t0
    check(sorted(logs) == build.sources(), f"built {sorted(logs)}")
    print(f"build: {len(logs)} kernels in {secs:.2f} s", flush=True)
    report = {}
    for name, log in sorted(logs.items()):
        for kern, r in ptxas_report(log).items():
            report[f"{name}: {kern}"] = r
            print(f"  {name}: {kern}: {r.get('registers')} registers, "
                  f"spills {r.get('spill_stores')} / {r.get('spill_loads')} "
                  f"bytes, stack {r.get('stack')}, smem {r.get('smem', 0)}")
    return {"seconds": secs, "ptxas": report}


def phase_nms(nms_mod, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = 0.0
    for b in (1, 8):
        det = nms_input(b, gen, dev)
        for view in (det, det.contiguous()):
            got = nms_mod.nms_topk(view, 30, 5)
            want = nms_mod.nms_topk_plain(view, 30, 5)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(g.is_cuda and g.dtype == w.dtype
                      and g.shape == w.shape, "nms_topk output layout")
                err = max(err, (g.double() - w.double()).abs().max().item())
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"nms_topk differs from its plain version at B={b}")
        # the sparse plane's zero fill, in flat-index order
        v, x, y = got
        check(bool((v[:, 3, -1] == 0).all()), "sparse plane fill")
    for name, det in nms_extra_inputs(gen, dev):
        got = nms_mod.nms_topk(det, 30, 5)
        want = nms_mod.nms_topk_plain(det, 30, 5)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"nms_topk differs from its plain version on the {name} "
              "planes")
        if name == "nan":   # (10, 11) has a NaN in its window: no peak
            check(got[0][0, 0, :2].tolist() == [0.5, 0.0]
                  and got[1][0, 0, 0].item() == 40,
                  "nms_topk: a peak beside a NaN was kept")
    print(f"nms_topk: equal to plain at B in (1, 8), on NaN planes, a "
          f"ragged and a wide plane, max_abs_err {err}", flush=True)
    return {"max_abs_err": err}


def phase_lockstep(grp_mod, dev) -> dict:
    rng = np.random.default_rng(SEED)
    err = 0.0
    for b in (1, 8, 32):
        inputs = lockstep_input(b, rng, dev)
        for itm in (False, True):
            kw = dict(max_num_people=30, ignore_too_much=itm, p_max=90)
            got = grp_mod.match_by_tag_lockstep(*inputs, **kw)
            want = grp_mod.match_by_tag_lockstep_plain(*inputs, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check(g.is_cuda and g.dtype == w.dtype
                      and g.shape == w.shape, "lockstep output layout")
                err = max(err, (g.double() - w.double()).abs().max().item())
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f"group_lockstep differs from plain at B={b}, "
                  f"ignore_too_much={itm}")
            check(int(got[1].min()) > 0, "no people grouped")
    print(f"group_lockstep: equal to plain at B in (1, 8, 32), "
          f"max_abs_err {err}", flush=True)
    return {"max_abs_err": err}


def phase_lap(lap_mod, dev) -> dict:
    rng = np.random.default_rng(SEED)
    shapes = [(n, m) for n in (1, 8, 30, 32) for m in (30, 60, 63, 64, 127)
              if n <= m]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n, m in shapes + [(30, m) for m in (60, 63, 64)]:
        cost = torch.from_numpy(decode_costs(8, n, m, rng)).to(dev)
        if (n, m) not in shapes:    # signed zeros: -0 and +0 tie
            cost = torch.where(cost == 0, torch.where(torch.rand(
                cost.shape, generator=gen, device=dev) < 0.5, -0.0, 0.0),
                cost.round())
        got = lap_mod.lap_rect(cost)
        want = lap_mod.lap_rect_plain(cost)
        torch.cuda.synchronize()
        check(got.is_cuda and got.dtype == want.dtype
              and got.shape == want.shape, "lap_rect output layout")
        check(torch.equal(got, want),
              f"lap_rect differs from its plain version at n={n}, m={m}")
        check(all(len(set(r)) == n for r in got.tolist()),
              "lap_rect: a column assigned twice")
    print(f"lap_rect: equal to plain at (n, m) in {shapes}, B=8, and on "
          "signed zero costs", flush=True)
    return {"max_abs_err": 0.0}


def phase_mega(mega_mod, grp_mod, dev) -> dict:
    """Both solvers of the grouping mega-kernel against its plain version;
    the greedy solver against the lockstep kernel."""
    rng = np.random.default_rng(SEED + 5)
    err = 0.0
    for b in (1, 8):
        inputs = lockstep_input(b, rng, dev)
        for itm in (False, True):
            kw = dict(max_num_people=30, ignore_too_much=itm, p_max=90)
            for solver in ("lap", "greedy"):
                got = mega_mod.match_by_tag_kernel(*inputs, solver=solver,
                                                   **kw)
                want = mega_mod.match_by_tag_kernel_plain(
                    *inputs, solver=solver, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    check(g.is_cuda and g.dtype == w.dtype
                          and g.shape == w.shape, "group_mega output layout")
                    err = max(err, (g.double() - w.double()).abs().max()
                              .item())
                check(torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1]),
                      f"group_mega ({solver}) differs from plain at B={b}, "
                      f"ignore_too_much={itm}")
                check(int(got[1].min()) > 0, "no people grouped")
            lock = grp_mod.match_by_tag_lockstep(*inputs, **kw)
            check(torch.equal(got[0], lock[0])
                  and torch.equal(got[1], lock[1]),
                  f"greedy group_mega differs from group_lockstep at B={b}, "
                  f"ignore_too_much={itm}")
    print(f"group_mega: lap and greedy equal to plain at B in (1, 8), "
          f"greedy equal to lockstep, max_abs_err {err}", flush=True)
    return {"max_abs_err": err}


def phase_selfcheck(fused, dev) -> None:
    """The decode's one-time self-check of each grouping kernel on the
    card, at the main path's shapes (so that ``auto`` finds the verdicts
    cached and the main path's launch counts hold no check)."""
    verdicts = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for solver in ("greedy", "lap", "lockstep"):
            verdicts[solver] = fused.kernel_selfcheck(
                30, 90, 17, 1, solver=solver, device=dev)
    check(all(v is True for v in verdicts.values()) and not caught,
          f"kernel_selfcheck {verdicts}: "
          f"{[str(w.message) for w in caught]}")
    print(f"kernel_selfcheck: {verdicts}", flush=True)


def phase_forward(hrnet, set_tf32, dev):
    set_tf32(False)
    cpu_model = hrnet.init_random_(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                                   seed=SEED).eval()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    check(n_params == 63_827_139, f"W48 has {n_params} parameters")
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    x = torch.randn((1, 3, 256, 256),
                    generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        want = cpu_model(x)
        gpu_model = hrnet.PoseHigherHRNet(hrnet.w48_config())
        gpu_model.load_state_dict(state)
        got = gpu_model.to(dev).eval()(x.to(dev))
    err = 0.0
    for g, w in zip(got, want):
        g = g.float().cpu()
        check(bool(torch.isfinite(g).all()), "non-finite forward")
        check(torch.allclose(g, w, rtol=1e-3, atol=1e-3),
              f"fp32 forward differs from the CPU by "
              f"{(g - w).abs().max().item()}")
        err = max(err, (g - w).abs().max().item())
    print(f"w48 fp32 forward: {n_params} params, card vs CPU max_abs_err "
          f"{err:.3g} (allclose rtol=atol=1e-3)", flush=True)
    del gpu_model
    torch.cuda.empty_cache()
    return state


def synthetic_images(rng: np.random.Generator):
    shapes = [(640, 640), (600, 600), (480, 640), (512, 512),
              (640, 480), (700, 700), (480, 640), (448, 448)]
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8)
            for h, w in shapes]


def check_people(res, num_joints: int, what: str, d: int = 1) -> int:
    """Finite people of (J, 3 + D) (D tag dimensions) and scores."""
    people, scores = res
    check(len(people) == len(scores), f"{what}: people/scores")
    for p in people:
        check(p.shape == (num_joints, 3 + d),
              f"{what}: person shape {p.shape}")
        check(bool(np.isfinite(p).all()), f"{what}: non-finite person")
    check(bool(np.isfinite(np.asarray(scores)).all()),
          f"{what}: non-finite score")
    return len(people)


def phase_main_path(PosePredictor, PoseHigherHRNet, w48_config, state,
                    counters, dev):
    pred = PosePredictor(PoseHigherHRNet(w48_config()), state, device=dev)
    check(pred.dtype == torch.bfloat16 and pred.fused_decode,
          "serving path is bf16 + fused decode")
    images = synthetic_images(np.random.default_rng(SEED))
    reset(counters)
    out = pred.predict_batch(images)
    single = pred.predict(images[0])
    streamed = list(pred.stream(images[:4]))
    launches = read(counters)
    check(len(out) == len(images) and len(streamed) == 4,
          "one result per image")
    n = [check_people(r, 17, f"predict_batch[{i}]")
         for i, r in enumerate(out)]
    n1 = check_people(single, 17, "predict")
    ns = [check_people(r, 17, "stream") for r in streamed]
    check(sum(n) > 0, "no people found on the main path")
    for name in ("nms_topk", "match_by_tag_lockstep"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    print(f"main path: predict_batch people {n}, predict {n1}, stream "
          f"{ns}; launches {launches}", flush=True)
    return pred, images, launches


def phase_decode_vs_cpu(pred, images, decode_full_batch) -> None:
    """The card's decode of the main path's own heatmaps against the
    plain decode on the CPU: n_people exact, people and scores 1e-5."""
    with torch.inference_mode():
        x = torch.stack([pred._preprocess(im)[0] for im in images[:2]])
        hms, tags = pred._decode_outputs(*pred._forward(x))
        check(hms.is_cuda and tags.is_cuda, "heatmaps on the card")
        got = decode_full_batch(hms, tags)
        want = decode_full_batch(hms.cpu(), tags.cpu())
    check(all(g.is_cuda for g in got), "decode output on the card")
    check(torch.equal(got[1].cpu(), want[1]),
          f"n_people card {got[1].tolist()} vs CPU {want[1].tolist()}")
    for g, w in zip((got[0], got[2]), (want[0], want[2])):
        check(torch.allclose(g.cpu(), w, rtol=1e-5, atol=1e-5),
              "card decode differs from the CPU decode")
    print(f"decode: card == CPU plain on main-path heatmaps, n_people "
          f"{got[1].tolist()}", flush=True)


def reset(counters) -> None:
    for c in counters:
        c.launches = 0


def read(counters) -> dict:
    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in counters}


def check_same_decode(got, want, what: str) -> None:
    """One image's (people list, scores) from the card and the CPU:
    n_people exact, people and scores within 1e-5."""
    (p_g, s_g), (p_w, s_w) = got, want
    check(len(p_g) == len(p_w) == len(s_g) == len(s_w),
          f"{what}: {len(p_g)} people on the card, {len(p_w)} on the CPU")
    for a, b in zip(p_g, p_w):
        check(np.allclose(a, b, rtol=1e-5, atol=1e-5),
              f"{what}: card people differ from the CPU's")
    check(np.allclose(s_g, s_w, rtol=1e-5, atol=1e-5),
          f"{what}: card scores differ from the CPU's")


def phase_other_paths(pred, PosePredictor, decode_mods, counters, dev):
    """The decode paths beside the main path, on the bf16 predictor's
    heatmaps of eight 640 x 640 images; each path with the launch
    counters set to 0 just before it and read just after, and held
    against the plain decode on the CPU for image 0.  Returns the
    launches by path, the heatmaps and the cost matrices the LAP kernel
    was given."""
    fused, group_jit, unpack = decode_mods
    rng = np.random.default_rng(SEED + 4)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    with torch.inference_mode():
        x = torch.stack([pred._preprocess(im)[0] for im in square])
        hms, tags = pred._decode_outputs(*pred._forward(x))
    parser = pred.parser
    cpu = (hms[:1].cpu(), tags[:1].cpu())
    launches = {}

    def drive(path: str, kernel: str, fn):
        reset(counters)
        out = fn()
        launches[path] = read(counters)
        check(launches[path][kernel] > 0,
              f"{path}: {kernel} was not launched")
        return out

    fused_one = drive("parse_fused", "match_by_tag_kernel", lambda: [
        parser.parse_fused(hms[i:i + 1], tags[i:i + 1]) for i in range(8)])
    want = parser.parse_fused(*cpu)
    check_same_decode((fused_one[0][0][0], fused_one[0][1]),
                      (want[0][0], want[1]), "parse_fused")

    kw = parser._fused_kwargs()
    for lap, kernel in (("kernel", "match_by_tag_kernel"),
                        ("pallas", "lap_rect")):
        costs = []
        if lap == "pallas":
            lap_rect = group_jit.lap_rect

            def capture(cost):
                costs.append(cost.clone())
                return lap_rect(cost)

            group_jit.lap_rect = capture
        try:
            out = drive(f"decode_full_batch_{lap}", kernel,
                        lambda: fused.decode_full_batch(hms, tags, lap=lap,
                                                        **kw))
        finally:
            if lap == "pallas":
                group_jit.lap_rect = lap_rect
        check(int(out[1].min()) > 0, f"lap={lap}: no people")
        got = unpack(*(t[:1] for t in out))
        want = unpack(*fused.decode_full_batch(*cpu, lap=lap, **kw))
        check_same_decode((got[0][0], got[1][0]), (want[0][0], want[1][0]),
                          f"decode_full_batch(lap={lap!r})")

    host = PosePredictor(pred.model, device=dev, fused_decode=False)
    out_h = drive("predict_batch_host_grouping", "nms_topk",
                  lambda: host.predict_batch(square))
    n_h = [check_people(r, 17, "host grouping") for r in out_h]
    got = parser.parse_batch(hms[:1], tags[:1])
    want = parser.parse_batch(*cpu)
    check_same_decode((got[0][0], got[1][0]), (want[0][0], want[1][0]),
                      "parse_batch")
    print(f"other paths: parse_fused people "
          f"{[len(p[0][0]) for p in fused_one]}"
          f", host grouping people {n_h}; launches {launches}", flush=True)
    return launches, (hms, tags), costs


def decode_path_times(parser, fused, heatmaps) -> dict:
    """Host-clock milliseconds of one call of each decode path on the
    bf16 predictor's heatmaps of eight 640 x 640 images (ending in the
    host pull of the people), and of ``parse_fused`` on one of them."""
    hms, tags = heatmaps
    kw = parser._fused_kwargs()
    out = {"parse_fused_b1": host_ms(
        lambda: parser.parse_fused(hms[:1], tags[:1]), 5)}
    for lap in ("auto", "greedy", "kernel", "pallas"):
        out[f"decode_full_batch_{lap}_b8"] = host_ms(
            lambda: [t.cpu() for t in fused.decode_full_batch(
                hms, tags, lap=lap, **kw)], 3)
    out["parse_batch_host_grouping_b8"] = host_ms(
        lambda: parser.parse_batch(hms, tags), 1)
    print(f"decode paths (ms per call): {out}", flush=True)
    return out


def nms_times(nms_mod, b: int, dev) -> dict:
    """Kernel, plain and library times and the bound of NMS + top-k at
    (B, 320, 320, 17), K=30."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    h, w, j, k = 320, 320, 17, 30
    det = nms_input(b, gen, dev)

    def library():
        planes = det.permute(0, 3, 1, 2)
        pooled = F.max_pool2d(planes, 5, 1, 2)
        peaks = torch.where(pooled == planes, planes, 0.0)
        return torch.topk(peaks.reshape(b, j, h * w), k, dim=-1)

    n_bytes = b * h * w * j * 4 + 3 * b * j * k * 4
    n_ops = b * j * h * w * (4 * 2 + 1)   # separable 5x5 max + compare
    return {"ms": device_ms(lambda: nms_mod.nms_topk(det, k, 5), 20),
            "plain_ms": device_ms(lambda: nms_mod.nms_topk_plain(det, k, 5),
                                  5),
            "library_ms": device_ms(library, 20),
            **bound(n_bytes, n_ops), "shape": [b, h, w, j, k]}


def phase_step_probe(build, dev) -> float:
    """Nanoseconds of one dependent (``__reduce_min_sync``, ballot) step
    of one warp: ``csrc/warp_step_probe.cu`` runs a chain of 1,024 such
    steps, timed with ``clock64`` and the global timer; the fastest of
    five runs."""
    import ctypes
    lib = build.load("warp_step_probe", {"warp_step_probe_launch": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]})
    steps = 1024
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    runs = []
    for _ in range(6):
        err = lib.warp_step_probe_launch(
            steps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"warp_step_probe launch failed with {err}")
        torch.cuda.synchronize()
        runs.append(out[:2].tolist())
    cycles, ns = min(runs[1:], key=lambda r: r[1])
    check(cycles > 0 and ns > 0, f"warp_step_probe read {cycles}, {ns}")
    print(f"warp step probe: {cycles / steps:.2f} cycles, "
          f"{ns / steps:.2f} ns per dependent (min, ballot) step", flush=True)
    return {"ns_per_step": ns / steps, "cycles_per_step": cycles / steps}


def greedy_steps(val_k, det_thr: float = 0.1) -> int:
    """The greedy grouping's dependent steps on the longest image: one
    argmin per active row of every joint after the first (the first has
    no one to match), and one update step per active row."""
    active = (val_k > det_thr).sum(dim=2)                       # (B, J)
    return int((active[:, 1:].sum(dim=1) + active.sum(dim=1)).max())


def latency_bound(steps: int, step_ns: float) -> dict:
    """The least time of a chain of ``steps`` dependent warp steps, each
    at the probe's (min, ballot) time: the kernel cannot be faster than
    its longest image's chain.  The bytes bound stays beside it."""
    return {"latency_bound_ms": steps * step_ns * 1e-6,
            "latency_steps": steps}


def lockstep_times(grp_mod, b: int, dev, step_ns: float) -> dict:
    """Kernel and plain times, the bound and the latency bound of
    lockstep grouping at (B, J=17, K=30, D=1), p_max=90."""
    j, k, d, p_max = 17, 30, 1, 90
    inputs = lockstep_input(b, np.random.default_rng(SEED + 1), dev)
    kw = dict(max_num_people=30, p_max=p_max)
    n_bytes = b * j * k * (d + 2 + 1) * 4 + b * p_max * j * (3 + d) * 4 \
        + b * 4
    # per image, joint and row, the grouping's own work: loop 1 builds
    # the cost of at most min(npv, m) = m = 30 candidate columns, ~12
    # float ops each (diff, round, scale, clamp, tie bias, mask, argmin);
    # loop 2 compares the row's key with at most p_max people keys and
    # updates one slot, ~12 ops.  The most this shape can need; the
    # data's own count is smaller, and already this is under the bytes.
    m = kw["max_num_people"]
    n_ops = b * j * k * (m * 12 + p_max + 12)
    return {"ms": device_ms(
                lambda: grp_mod.match_by_tag_lockstep(*inputs, **kw), 50),
            "plain_ms": host_ms(
                lambda: grp_mod.match_by_tag_lockstep_plain(*inputs, **kw),
                2),
            "library_ms": None,
            **bound(n_bytes, n_ops),
            **latency_bound(greedy_steps(inputs[2]), step_ns),
            "shape": [b, j, k, d, p_max]}


def lap_steps(lap_mod, cost) -> int:
    """Dijkstra steps of the plain LAP on the image of ``cost`` (B, n, m)
    that needs the most."""
    most = 0
    for i in range(cost.shape[0]):
        lap_mod.lap_columns.passes = 0
        lap_mod.lap_rect_plain(cost[i:i + 1])
        most = max(most, lap_mod.lap_columns.passes)
    return most


def lap_times(lap_mod, costs, b: int, step_ns: float) -> dict:
    """Kernel and plain times, the bound and the latency bound of one LAP
    launch, averaged over the per-joint cost matrices the decode gave the
    kernel (``decode_full_batch(lap="pallas")``), first ``b`` images."""
    costs = [c[:b].contiguous() for c in costs]
    _, n, m = costs[0].shape
    per = len(costs)
    lap_mod.lap_columns.passes = 0
    for c in costs:
        lap_mod.lap_rect_plain(c)
    passes = lap_mod.lap_columns.passes
    steps = sum(lap_steps(lap_mod, c) for c in costs)
    # each Dijkstra step touches the m + 1 columns: ~10 float ops each
    # (two subtractions, compare, two selects, masked min, three
    # potential updates); the bytes are the matrices in, columns out
    n_bytes = sum(c.numel() for c in costs) * 4 + per * b * n * 4
    return {"ms": device_ms(lambda: [lap_mod.lap_rect(c) for c in costs],
                            20) / per,
            "plain_ms": host_ms(lambda: [lap_mod.lap_rect_plain(c)
                                         for c in costs], 1) / per,
            "library_ms": None,
            **bound(n_bytes // per, passes * (m + 1) * 10 // per),
            **latency_bound(round(steps / per), step_ns),
            "dijkstra_steps": passes / per, "shape": [b, n, m]}


def mega_times(mega_mod, lap_mod, topk, solver: str, b: int,
               step_ns: float) -> dict:
    """Kernel and plain times, the bound and the latency bound of the
    grouping mega-kernel on the main path's own top-k (B=8 or 1, J=17,
    K=30, D=1), p_max=90.  The exact solver's chain is its longest
    image's Dijkstra steps (from the plain version, image by image) and
    one update step per active row."""
    val_k, loc_k, tag_k = (t[:b].float().contiguous() for t in topk)
    _, j, k, d = tag_k.shape
    m, p_max = 30, 90
    kw = dict(max_num_people=m, p_max=p_max, solver=solver)
    lap_mod.lap_columns.passes = 0
    plain_ms = host_ms(lambda: mega_mod.match_by_tag_kernel_plain(
        tag_k, loc_k, val_k, **kw), 1, warmup=0)
    # per image and joint: the cost build over K x 2m cells (~12 ops:
    # difference, square, root, round, scale, clamp, tie bias, selects),
    # the assignment (greedy: K rows x m candidates, ~3 ops; exact: the
    # Dijkstra steps these inputs took, 2m + 1 columns x ~10 ops), the
    # update (K rows x p_max key compares + ~12 ops)
    n_ops = b * j * k * (2 * m * 12 + p_max + 12)
    if solver == "greedy":
        n_ops += b * j * k * m * 3
    else:
        n_ops += lap_mod.lap_columns.passes * (2 * m + 1) * 10
    n_bytes = b * j * k * (d + 2 + 1) * 4 + b * p_max * j * (3 + d) * 4 \
        + b * 4
    if solver == "greedy":
        steps = greedy_steps(val_k)
    else:
        steps = 0
        for i in range(b):
            lap_mod.lap_columns.passes = 0
            mega_mod.match_by_tag_kernel_plain(
                tag_k[i:i + 1], loc_k[i:i + 1], val_k[i:i + 1], **kw)
            steps = max(steps, lap_mod.lap_columns.passes
                        + int((val_k[i] > 0.1).sum()))
    return {"ms": device_ms(lambda: mega_mod.match_by_tag_kernel(
                tag_k, loc_k, val_k, **kw), 20),
            "plain_ms": plain_ms, "library_ms": None,
            **bound(n_bytes, n_ops), **latency_bound(steps, step_ns),
            "shape": [b, j, k, d, p_max]}


def bound(n_bytes: int, n_ops: int, ops_per_s: float = F32_OPS_PER_S
          ) -> dict:
    """The least time for the work: bytes over the memory rate or the
    operations over the peak rate for their type (float32 unless
    given), whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def new_kernel_rows(mega_mod, lap_mod, path_launches, heatmaps, costs,
                    errs, top_k, step_ns: float) -> list:
    """Rows of the grouping mega-kernel (each solver) and the LAP kernel,
    at batch 8 and batch 1, with the launches of the path that runs
    them."""
    topk = top_k(*heatmaps)
    rows = []
    for name, path, solver in (
            ("group_mega_greedy", "parse_fused", "greedy"),
            ("group_mega_lap", "decode_full_batch_kernel", "lap")):
        rows.append({"name": name, "route": "cuda",
                     "source": "rtpe_tpu_torch/csrc/group_mega.cu",
                     "replaces": "rtpe_tpu/ops/pallas_group.py:348",
                     "launches": path_launches[path]["match_by_tag_kernel"],
                     "path": path, "max_abs_err": errs["group_mega"],
                     **mega_times(mega_mod, lap_mod, topk, solver, 8,
                                  step_ns),
                     "at_b1": mega_times(mega_mod, lap_mod, topk, solver, 1,
                                         step_ns)})
    path = "decode_full_batch_pallas"
    rows.append({"name": "lap_rect", "route": "cuda",
                 "source": "rtpe_tpu_torch/csrc/lap_rect.cu",
                 "replaces": "rtpe_tpu/ops/pallas_lap.py:125",
                 "launches": path_launches[path]["lap_rect"], "path": path,
                 "max_abs_err": errs["lap_rect"],
                 **lap_times(lap_mod, costs, 8, step_ns),
                 "at_b1": lap_times(lap_mod, costs, 1, step_ns)})
    return rows


def phase_kernel_times(nms_mod, grp_mod, launches, errs, dev,
                       step_ns: float) -> list:
    """Times at the main path's batch-8 shape, and at batch 1."""
    rows = []
    for name, times, counter, source, replaces in (
            ("nms_topk", nms_times, "nms_topk", "nms_topk.cu",
             "rtpe_tpu/ops/pallas_decode.py:89"),
            ("group_lockstep",
             lambda mod, b, dev: lockstep_times(mod, b, dev, step_ns),
             "match_by_tag_lockstep",
             "group_lockstep.cu",
             "rtpe_tpu/ops/pallas_group_lockstep.py:161")):
        mod = nms_mod if name == "nms_topk" else grp_mod
        at8, at1 = times(mod, 8, dev), times(mod, 1, dev)
        rows.append({"name": name, "route": "cuda",
                     "source": f"rtpe_tpu_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": launches[counter],
                     "max_abs_err": errs[name], **at8, "at_b1": at1})
    return rows


def phase_profile(pred) -> dict:
    """Where the time of one ``predict_batch`` of 8 square images goes
    (:func:`device_profile`), with the decode kernels' share."""
    rng = np.random.default_rng(SEED + 3)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    pred.predict_batch(square)
    torch.cuda.synchronize()
    return device_profile(lambda: pred.predict_batch(square),
                          ("nms_tile_kernel", "nms_merge_kernel",
                           "lockstep_kernel"))


def phase_end_to_end(pred) -> dict:
    rng = np.random.default_rng(SEED + 2)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    out = {}
    for bs in (1, 8):
        with torch.inference_mode():
            x = torch.stack([pred._preprocess(im)[0] for im in square[:bs]])
            fwd_ms = device_ms(lambda: pred._forward(x), 5)
            heads = pred._forward(x)

            def decode():
                hms, tags = pred._decode_outputs(*heads)
                return pred.parser.parse_fused_batch(hms, tags)

            dec_ms = host_ms(decode, 5)
        if bs == 1:
            e2e_ms = host_ms(lambda: pred.predict(square[0]), 5)
        else:
            e2e_ms = host_ms(lambda: pred.predict_batch(square), 3)
        out[f"bs{bs}"] = {"forward_ms": fwd_ms, "decode_ms": dec_ms,
                          "e2e_ms": e2e_ms, "img_per_s": bs * 1e3 / e2e_ms}
    return out


# ------------------------------------------- the packed serving path

def nan_scene(rng: np.random.Generator):
    """(tags, locs, vals) with planted NaN tags: a whole tag at the first
    joint (a person whose mean stays NaN), one dimension of a later row;
    B=8, J=17, K=30, D=2."""
    b, j, k, d = 8, 17, 30, 2
    tags = rng.normal(size=(b, j, k, d)).astype(np.float32) * 2
    tags[..., 0] = np.round(tags[..., 0] * 2) / 2
    locs = rng.integers(0, 320, size=(b, j, k, 2)).astype(np.float32)
    vals = np.sort(rng.uniform(-0.3, 1.0, size=(b, j, k)).astype(
        np.float32), axis=-1)[..., ::-1].copy()
    vals[:4, :, :3] = np.maximum(vals[:4, :, :3], 0.5)
    tags[0, 0, 1] = np.nan
    tags[1, 2, 0, 1] = np.nan
    tags[2, 5, 2] = np.nan
    tags[3, 16, 0] = np.nan
    return tags, locs, vals


def phase_nan_tags(grp_mod, mega_mod, dev) -> None:
    """The grouping kernels against their plain versions on tags with
    planted NaNs (:func:`nan_scene`)."""
    args = [torch.from_numpy(a).to(dev)
            for a in nan_scene(np.random.default_rng(SEED + 6))]
    kw = dict(max_num_people=30, p_max=90)
    runs = {"lockstep": (grp_mod.match_by_tag_lockstep,
                         grp_mod.match_by_tag_lockstep_plain, {})}
    for solver in ("greedy", "lap"):
        runs[f"mega_{solver}"] = (mega_mod.match_by_tag_kernel,
                                  mega_mod.match_by_tag_kernel_plain,
                                  {"solver": solver})
    for name, (kernel, plain, extra) in runs.items():
        got = kernel(*args, **kw, **extra)
        want = plain(*args, **kw, **extra)
        torch.cuda.synchronize()
        check(bool(torch.isnan(want[0][:4]).any()), f"{name}: no NaN kept")
        check(torch.equal(got[1], want[1]),
              f"{name} n_people on NaN tags differ from plain")
        same = (got[0] == want[0]) | (torch.isnan(got[0])
                                      & torch.isnan(want[0]))
        check(bool(same.all()), f"{name} differs from plain on NaN tags")
    print(f"NaN tags: {sorted(runs)} equal to plain, NaN for NaN",
          flush=True)


def chain_inputs(shape, n: int, seed: int, dev, exact: bool = False):
    """Chain inputs on the card: normal activations and weights scaled to
    keep the chain's activations of order 1, or with ``exact`` small
    integers times powers of two (every conv sum exact in float32)."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    if exact:
        x = torch.randint(-4, 5, shape, generator=g).float()
        w = torch.randint(-1, 2, (n, 2, 3, 3, c, c), generator=g) / 64.0
        b = torch.randint(-8, 9, (n, 2, c), generator=g) / 64.0
    else:
        x = torch.randn(shape, generator=g)
        w = torch.randn((n, 2, 3, 3, c, c), generator=g) / (3 * c) ** 0.5
        b = torch.randn((n, 2, c), generator=g) * 0.1
    return (x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16),
            b.to(dev))


def phase_chain(blk_mod, set_tf32, dev) -> dict:
    """The chain kernel against its plain version; returns the worst
    relative error (of max |plain|) by branch shape at B=8, n=4."""
    set_tf32(False)
    cases = [((bb, *hwc), n) for hwc in BRANCHES for bb in (1, 8)
             for n in (1, 4)] + [((2, 12, 20, 96), 4)]
    worst, share, errs = 0.0, 0.0, {}
    for shape, n in cases:
        x, w, b = chain_inputs(shape, n, SEED + sum(shape) + n, dev)
        got = blk_mod.basicblock_chain(x, w, b)
        want = blk_mod.basicblock_chain_plain(x, w, b)
        torch.cuda.synchronize()
        check(got.is_cuda and got.dtype == torch.bfloat16
              and got.shape == x.shape, "chain output layout")
        diff = (got.float() - want.float()).abs()
        rel = float(diff.max()) / float(want.float().abs().max())
        check(bool(torch.isfinite(got.float()).all()), "non-finite chain")
        check(rel <= CHAIN_TOL, f"chain {shape} n={n}: worst error {rel:.4g} "
              f"of max |plain| > {CHAIN_TOL}")
        worst = max(worst, rel)
        share = max(share, float((diff > 0).float().mean()))
        if shape[0] == 8 and n == 4:
            errs[shape[3]] = float(diff.max())
    for shape, n in (((2, 12, 20, 96), 4), ((1, 20, 20, 384), 2),
                     ((1, 40, 40, 192), 2), ((8, 80, 80, 96), 1)):
        x, w, b = chain_inputs(shape, n, SEED + n, dev, exact=True)
        got = blk_mod.basicblock_chain(x, w, b)
        again = blk_mod.basicblock_chain(x, w, b)
        with torch.backends.cudnn.flags(enabled=False):
            want = blk_mod.basicblock_chain_plain(x, w, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"chain {shape} n={n} differs from "
              "plain on exact sums")
        check(torch.equal(got, again), f"chain {shape} n={n}: two runs "
              "differ")
    plans = {}
    for shape in [(b_, *hwc) for hwc in BRANCHES for b_ in (1, 8)]:
        want = blk_mod.chain_plan(*shape)
        got = blk_mod.chain_plan_c(*shape)
        check(got == {k: want[k] for k in got}, f"chain plan at {shape}: C "
              f"{got}, Python {want}")
        plans["x".join(map(str, shape))] = {
            k: want[k] for k in ("bn", "tiles_m", "tiles_n", "splits",
                                 "blocks", "smem")}
    print(f"basicblock_chain: {len(cases)} cases within {CHAIN_TOL} of max "
          f"|plain|, worst {worst:.4g}, at most {share:.3f} of elements "
          f"differ; bitwise equal on exact sums and run to run; C and "
          f"Python plans agree: {plans}", flush=True)
    return {"worst_rel": worst, "max_share_differing": share,
            "max_abs_err_b8_n4": errs, "plans": plans}


def phase_packed_forward(hrnet, packed, blk_mod, state, dev):
    """The full-width W48 packed forward on the card (TF32 is off).
    Returns what it measured and the bf16 folded weights."""
    cfg = hrnet.w48_config()
    x = torch.randn((1, 3, 256, 256),
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    with torch.inference_mode():
        model = hrnet.PoseHigherHRNet(cfg)
        model.load_state_dict(state)
        want = model.to(dev).eval()(x)
        del model
        pk32 = packed.pack_w48_params(state, cfg, torch.float32, dev)
        got = packed.packed_forward(pk32, x, cfg, torch.float32)
        del pk32
    err32 = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              "packed fp32 forward output")
        check(torch.allclose(g, w, rtol=1e-3, atol=1e-3),
              f"fp32 packed forward differs from the canonical by "
              f"{(g - w).abs().max().item()}")
        err32 = max(err32, (g - w).abs().max().item())
    torch.cuda.empty_cache()
    pk = packed.pack_w48_params(state, cfg, torch.bfloat16, dev)
    xb = torch.randn((8, 3, 640, 640),
                     generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    with torch.inference_mode():
        off = packed.packed_forward(pk, xb, cfg)
        blk_mod.basicblock_chain.launches = 0
        on = packed.packed_forward(pk, xb, cfg, pallas_chains=True)
        torch.cuda.synchronize()
        launches = blk_mod.basicblock_chain.launches
    check(launches == 18, f"{launches} chain launches per 640 x 640 forward")
    rel, mean_rel = 0.0, 0.0
    for a, b in zip(on, off):
        a, b = a.float(), b.float()
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              "packed bf16 forward output")
        rel = max(rel, float((a - b).abs().max() / b.abs().max()))
        mean_rel = max(mean_rel, float((a - b).abs().mean() / b.abs().mean()))
    check(rel <= PACKED_BF16_TOL, f"bf16 chains on vs off: {rel:.4g} of max "
          f"|off| > {PACKED_BF16_TOL}")
    print(f"w48 packed: fp32 vs canonical max_abs_err {err32:.3g} "
          f"(allclose 1e-3); bf16 chains on vs off worst {rel:.4g} of max, "
          f"mean {mean_rel:.4g}; {launches} chain launches per 640 x 640 "
          "forward", flush=True)
    return {"fp32_vs_canonical_max_abs_err": err32,
            "bf16_chains_vs_cudnn_worst_rel": rel,
            "bf16_chains_vs_cudnn_mean_rel": mean_rel,
            "chain_launches_per_forward": launches}, pk


def phase_packed_path(PosePredictor, hrnet, packed, state, counters,
                      dev):
    """The packed serving path through the chain kernel, then the packed
    predictor's entry points; each with the counters set to 0 just
    before and read just after."""
    cfg = hrnet.w48_config()
    pred = PosePredictor(hrnet.PoseHigherHRNet(cfg), state, device=dev,
                         packed=True)
    check(pred.packed and pred.dtype == torch.bfloat16, "packed bf16")
    rng = np.random.default_rng(SEED + 7)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    shapes = []
    chain = packed.basicblock_chain

    def tap(x, w, b):
        shapes.append(tuple(x.shape[1:]))
        return chain(x, w, b)

    packed.basicblock_chain = tap
    try:
        reset(counters)
        with torch.inference_mode():
            pre = [pred._preprocess(im) for im in square]
            x = torch.stack([p[0] for p in pre])
            heads = packed.packed_forward(pred.packed_params,
                                          x.permute(0, 3, 1, 2), cfg,
                                          pred.dtype, pallas_chains=True)
            hms, tags = pred._decode_outputs(*heads)
            grouped, scores = pred.parser.parse_fused_batch(hms, tags)
            hm_hw = (int(hms.shape[1]), int(hms.shape[2]))
            out = [pred._finalize(grouped[k], scores[k], p[1], p[2], hm_hw)
                   for k, p in enumerate(pre)]
        path = read(counters)
    finally:
        packed.basicblock_chain = chain
    n = [check_people(r, 17, f"packed path[{i}]") for i, r in enumerate(out)]
    check(sum(n) > 0, "no people on the packed path")
    for name in ("basicblock_chain", "nms_topk", "match_by_tag_lockstep"):
        check(path[name] > 0, f"{name} was not launched on the packed path")
    check(path["basicblock_chain"] == 18, f"{path['basicblock_chain']} "
          "chain launches for one 640 x 640 forward")
    by_shape = {f"{h}x{w}x{c}": shapes.count((h, w, c))
                for h, w, c in BRANCHES}
    check(sum(by_shape.values()) == 18, f"chain shapes {by_shape}")

    images = synthetic_images(np.random.default_rng(SEED))
    reset(counters)
    res = pred.predict_batch(images)
    single = pred.predict(images[0])
    streamed = list(pred.stream(images[:4]))
    served = read(counters)
    check(len(res) == len(images) and len(streamed) == 4,
          "one result per image")
    nb = [check_people(r, 17, f"packed predict_batch[{i}]")
          for i, r in enumerate(res)]
    check_people(single, 17, "packed predict")
    for r in streamed:
        check_people(r, 17, "packed stream")
    for name in ("nms_topk", "match_by_tag_lockstep"):
        check(served[name] > 0, f"{name} was not launched by the packed "
              "predictor")
    print(f"packed path: people {n}, launches {path}, chains by shape "
          f"{by_shape}; packed predictor people {nb}, launches {served}",
          flush=True)
    return pred, path, by_shape, served


def chain_times(blk_mod, hwc, b: int, dev) -> dict:
    """Kernel, plain and cuDNN times and the bound of one 4-block chain
    at (B, H, W, C)."""
    n = 4
    h, w, c = hwc
    x, wt, bs = chain_inputs((b, h, w, c), n, SEED + 11, dev)
    xc = x.permute(0, 3, 1, 2)                       # channels_last NCHW
    w1 = wt[0, 0].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b1 = bs[0, 0].to(torch.bfloat16)
    conv_ms = device_ms(lambda: F.conv2d(xc, w1, b1, padding=1), 50)
    n_ops = 2 * b * h * w * 9 * c * c * 2 * n
    n_bytes = 2 * b * h * w * c * 2 + wt.numel() * 2 + bs.numel() * 4
    ms = device_ms(lambda: blk_mod.basicblock_chain(x, wt, bs), 20)
    plain_ms = device_ms(lambda: blk_mod.basicblock_chain_plain(x, wt, bs),
                         5)
    times = {"ms": ms, "plain_ms": plain_ms, "library_ms": conv_ms * 2 * n}
    return {**times, "library": "cuDNN F.conv2d bf16 channels_last with "
            "bias, one conv x 2n", "library_conv_ms": conv_ms,
            "tflops": {k: n_ops / (v * 1e9) for k, v in times.items()},
            **bound(n_bytes, n_ops, BF16_OPS_PER_S),
            "plan": blk_mod.chain_plan(b, h, w, c), "shape": [b, h, w, c, n]}


def chain_rows(blk_mod, by_shape, chain_errs, ptxas, dev) -> list:
    """One row per branch shape: times at B=8 (and B=1 under ``at_b1``)
    with TFLOP/s beside each, and the ``ptxas`` report of the chain's
    kernels."""
    kern = {k.split(": ", 1)[1]: v for k, v in ptxas.items()
            if k.startswith("basicblock_chain: ")}
    rows = []
    for hwc in BRANCHES:
        key = "x".join(map(str, hwc))
        rows.append({"name": f"basicblock_chain_{key}", "route": "cuda",
                     "source": "rtpe_tpu_torch/csrc/basicblock_chain.cu",
                     "replaces": "rtpe_tpu/ops/pallas_blocks.py:58",
                     "launches": by_shape[key],
                     "path": "packed_forward(pallas_chains=True)",
                     "max_abs_err": chain_errs["max_abs_err_b8_n4"][hwc[2]],
                     **chain_times(blk_mod, hwc, 8, dev),
                     "at_b1": chain_times(blk_mod, hwc, 1, dev),
                     "ptxas": kern})
    print("chain ms / TFLOP/s (B=8; B=1): " + "; ".join(
        f"{r['name']}: {r['ms']:.4f} / {r['tflops']['ms']:.1f} "
        f"(cuDNN {r['library_ms']:.4f}); {r['at_b1']['ms']:.4f} / "
        f"{r['at_b1']['tflops']['ms']:.1f} (cuDNN "
        f"{r['at_b1']['library_ms']:.4f})" for r in rows), flush=True)
    return rows


def forward_times(packed, canonical, pk, dev) -> dict:
    """Device and host milliseconds of one forward at batch 1 and 8 on
    640 x 640 inputs: canonical, packed, packed + chains (bf16)."""
    cfg = canonical.cfg
    out = {}
    for bs in (1, 8):
        x = torch.randn((bs, 3, 640, 640),
                        generator=torch.Generator().manual_seed(bs)).to(dev)
        x = x.contiguous(memory_format=torch.channels_last)
        runs = {"canonical": lambda: canonical(x),
                "packed": lambda: packed.packed_forward(pk, x, cfg),
                "packed_chains": lambda: packed.packed_forward(
                    pk, x, cfg, pallas_chains=True)}
        with torch.inference_mode():
            for name, fn in runs.items():
                out[f"{name}_bs{bs}"] = {"device_ms": device_ms(fn, 5),
                                         "host_ms": host_ms(fn, 5)}
    print(f"forward ms: {out}", flush=True)
    return out


# ------------------------------------------- the distillation train step

def cam_rows_bn(s, n, gen, exact):
    """BN rows [mean, inv, scale, bias] per branch from sums ``s`` (2k, w)
    over n pixels: the batch statistics, or dyadic rows near them."""
    mean = s[0::2] / n
    var = (s[1::2] / n - mean * mean).clamp(min=0)
    if exact:
        mean = torch.round(mean)
        inv = torch.full_like(mean, 0.25)
        scale = 0.5 * torch.randint(1, 3, mean.shape, generator=gen)
        bias = torch.randint(-4, 5, mean.shape, generator=gen) / 8.0
    else:
        inv = torch.rsqrt(var + 1e-5)
        scale = 1.0 + 0.1 * torch.randn(mean.shape, generator=gen)
        bias = 0.1 * torch.randn(mean.shape, generator=gen)
    return torch.stack([mean, inv, scale.float(), bias.float()],
                       1).reshape(-1, mean.shape[1]).contiguous()


def cam_case(cam_mod, shape, seed, dev, exact=False, signed_gates=False):
    """Every input of the six CAM kernels at shape (B, H, W, C, dils, hc):
    x in [0, 1), weights N(0, 1/fan_in), BN rows from the batch
    statistics, random cotangents; or with ``exact`` small integers,
    weights in {-1, 0, 1} and dyadic rows, gates and cotangents (every
    sum exact in float32)."""
    b, h, w, c, dils, hc = shape
    gen = torch.Generator().manual_seed(seed)
    nb = len(dils)

    def weight(shp, fan_in):
        if exact:
            keep = torch.rand(shp, generator=gen) < 0.15
            return (torch.randint(-1, 2, shp, generator=gen) * keep).float()
        return torch.randn(shp, generator=gen) / fan_in ** 0.5

    x = (torch.randint(-1, 2, (b, h, w, c), generator=gen).float() if exact
         else torch.rand((b, h, w, c), generator=gen))
    bf = dict(dtype=torch.bfloat16, device=dev)
    k = {"x": x.to(**bf), "kr": weight((c, c), c).to(**bf),
         "kh": weight((nb, 3, 3, c, hc), 9 * c).to(**bf),
         "kt": weight((nb, hc, c), nb * hc).to(**bf), "dils": tuple(dils)}
    n = b * h * w
    with torch.backends.cudnn.flags(enabled=False):
        s_r, s_h, _ = cam_mod.cam_f1_fwd_plain(k["x"], k["kr"], k["kh"], dils)
        k["bnh"] = cam_rows_bn(s_h.cpu(), n, gen, exact).to(dev)
        k["bnr"] = cam_rows_bn(s_r.cpu(), n, gen, exact).to(dev)
        s_t = cam_mod.cam_f2_fwd_plain(k["x"], k["kh"], k["kt"], k["bnh"],
                                       dils)
    k["bnt"] = cam_rows_bn(s_t.cpu(), n, gen, exact).to(dev)
    if exact:
        def cot(shp):
            return torch.randint(-4, 5, shp, generator=gen) / 8.0
        gate = torch.randint(-8, 9, (b, c), generator=gen) / 8.0
        g = torch.randint(-2, 3, (b, h, w, c), generator=gen).float()
    else:
        def cot(shp):
            return torch.randn(shp, generator=gen) * 1e-3
        gate = (torch.randn((b, c), generator=gen) if signed_gates
                else torch.rand((b, c), generator=gen))
        g = torch.randn((b, h, w, c), generator=gen)
    for name, shp in (("dsr", (2, c)), ("dsh", (2 * nb, hc)),
                      ("dgap", (b, c)), ("dst", (2, c))):
        k[name] = cot(shp).float().to(dev)
    k["gate"] = gate.float().to(dev)
    k["g"] = g.to(**bf)
    return k


def cam_calls(cam_mod, k):
    """(name, kernel, plain, args) of the six CAM kernels on case ``k``."""
    d = k["dils"]
    m = cam_mod
    return [
        ("cam_f1_fwd", m.cam_f1_fwd, m.cam_f1_fwd_plain,
         (k["x"], k["kr"], k["kh"], d)),
        ("cam_f1_bwd", m.cam_f1_bwd, m.cam_f1_bwd_plain,
         (k["x"], k["kr"], k["kh"], k["dsr"], k["dsh"], k["dgap"], d)),
        ("cam_f2_fwd", m.cam_f2_fwd, m.cam_f2_fwd_plain,
         (k["x"], k["kh"], k["kt"], k["bnh"], d)),
        ("cam_f2_bwd", m.cam_f2_bwd, m.cam_f2_bwd_plain,
         (k["x"], k["kh"], k["kt"], k["bnh"], k["dst"], d)),
        ("cam_f3_fwd", m.cam_f3_fwd, m.cam_f3_fwd_plain,
         (k["x"], k["kr"], k["kh"], k["kt"], k["bnr"], k["bnh"], k["bnt"],
          k["gate"], d)),
        ("cam_f3_bwd", m.cam_f3_bwd, m.cam_f3_bwd_plain,
         (k["x"], k["kr"], k["kh"], k["kt"], k["bnr"], k["bnh"], k["bnt"],
          k["gate"], k["g"], d)),
    ]


# the outputs of each CAM kernel that are forward batch statistics (held
# to CAM_STAT_TOL); the rest are activations and gradients
CAM_STATS = {"cam_f1_fwd": (0, 1, 2), "cam_f2_fwd": (0,)}


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def phase_cam(cam_mod, set_tf32, dev) -> dict:
    """The six CAM kernels against their plain versions (float32 convs,
    TF32 off): both CAM shapes of the train step at B=16, and a ragged
    (3, 29, 21, 83) case with per-image gates of both signs; bitwise on
    exact-sum inputs.  Returns the max abs error of each kernel's outputs
    at the steps' shape, and the worst and mean error (of max |plain|)
    and the share of elements off by more than CAM_TOL of each."""
    set_tf32(False)
    cases = [(STEPS_CAM, False), (PYRAMID_CAM, False),
             ((3, 29, 21, 83, (1, 2, 3, 4), 20), True)]
    errs, worst, mean, share, bad = {}, {}, {}, {}, []
    for shape, signed in cases:
        k = cam_case(cam_mod, shape, SEED + sum(shape[:4]), dev,
                     signed_gates=signed)
        for name, kernel, plain, args in cam_calls(cam_mod, k):
            got, want = as_tuple(kernel(*args)), as_tuple(plain(*args))
            torch.cuda.synchronize()
            check(len(got) == len(want), f"{name} output count")
            for i, (a, b) in enumerate(zip(got, want)):
                check(a.is_cuda and a.dtype == b.dtype
                      and a.shape == b.shape, f"{name}[{i}] output layout")
                check(bool(torch.isfinite(a.float()).all()),
                      f"{name}[{i}] not finite at {shape}")
                d = (a.float() - b.float()).abs()
                scale = max(float(b.float().abs().max()), 1e-30)
                rel, avg = float(d.max()) / scale, float(d.mean()) / scale
                off = float((d > CAM_TOL * scale).float().mean())
                what = f"{name}[{i}] at {shape}"
                if i in CAM_STATS.get(name, ()):
                    ok = rel <= CAM_STAT_TOL
                else:
                    ok = (rel <= CAM_WORST and avg <= CAM_MEAN
                          and off <= CAM_SHARE)
                if not ok:
                    bad.append(f"{what}: worst {rel:.4g}, mean {avg:.4g} of "
                               f"max |plain|, {off:.3g} of the elements off "
                               f"by > {CAM_TOL}")
                worst[name] = max(worst.get(name, 0.0), rel)
                mean[name] = max(mean.get(name, 0.0), avg)
                share[name] = max(share.get(name, 0.0), off)
                if shape == STEPS_CAM:
                    errs[name] = max(errs.get(name, 0.0), float(d.max()))
        del k, got, want
        torch.cuda.empty_cache()
    check(not bad, "CAM kernels differ from plain beyond the limits "
          f"(statistics {CAM_STAT_TOL}; else worst {CAM_WORST}, mean "
          f"{CAM_MEAN}, share {CAM_SHARE}): {bad}")
    for shape in ((2, 12, 20, 163, (1, 2, 3), 40),
                  (3, 9, 14, 83, (1, 2, 3, 4), 20)):
        k = cam_case(cam_mod, shape, SEED + 7, dev, exact=True)
        for name, kernel, plain, args in cam_calls(cam_mod, k):
            got = as_tuple(kernel(*args))
            with torch.backends.cudnn.flags(enabled=False):
                want = as_tuple(plain(*args))
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, want)):
                check(torch.equal(a, b), f"{name}[{i}] at {shape} differs "
                      "from plain on exact sums")
    print(f"cam kernels vs plain at {[c[0][:4] for c in cases]}: worst "
          f"(of max |plain|) {worst}, mean {mean}, share off by > {CAM_TOL} "
          f"{share}; bitwise equal on exact sums", flush=True)
    return {"max_abs_err": errs, "worst_rel": worst, "mean_rel": mean,
            "share_off": share}


def train_batch(dev) -> dict:
    """A seeded batch of the step's contract (``rtpe_tpu/train/step.py:
    121-125``), made on the card: normalised images, LAB-like alt images
    in [0, 1), segmentation masks, sparse gt heatmaps, teacher heatmaps a
    little outside [0, 1], loss masks."""
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, s = TRAIN_BATCH, TRAIN_SIZE

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    gt = rand(b, s, s, 17) ** 8
    return {"img": torch.randn((b, s, s, 3), generator=g, device=dev),
            "img_alt": rand(b, s, s, 3),
            "segm_mask": (rand(b, s, s, 1) > 0.7).float(),
            "gt_hms": torch.where(gt < 0.01, torch.zeros_like(gt), gt),
            "teacher_hms": rand(b, s, s, 17) * 1.2 - 0.1,
            "mask": (rand(b, s, s, 1) > 0.1).float()}


def device_profile(fn, ours=()) -> dict:
    """Wall time, device busy share (the union of kernel intervals), the
    largest kernels and the time of the kernels whose names contain each
    of ``ours``, for one call of ``fn`` under ``torch.profiler``; nulls
    where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a profile can miss the kernels of its first moments (seen on
        # the H100: a backward's first two kernels): let those be a spin
        # kernel, finished before fn starts and left out of every figure
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.name]
    if not kernels:
        return {"wall_ms": wall_ms, "device_busy": None, "top": None}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "kernel_ms": busy / 1e3,
            "device_busy": busy / 1e3 / wall_ms, "n_kernels": len(kernels),
            "ours_ms": {n: sum(v for k, v in by_name.items() if n in k) / 1e3
                        for n in ours},
            "top": [[n[:80], v / 1e3] for n, v in top]}


def run_train(students, train_mod, cam_mod, fused, w48_state, params,
              batch, dev, profile=False) -> dict:
    """TRAIN_STEPS steps of ``make_distill_train_step`` at the reference
    configuration (``AttentionStudentSteps(inplanes=80)``, bf16,
    ``detach_att_for_det``, BN output bf16) from the seeded student with
    the W48 stem, each step's parameters kept in ``params``; or, given
    ``params``, each step from those parameters (loaded outside the timed
    step).  The CAM kernels' counters are set to 0 just before the steps
    and read just after."""
    factory, _ = students
    model = factory.get_attention_student(fused_cam=fused, device=dev,
                                          seed=SEED)
    factory.load_pretrained_stem(model, w48_state)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    record = params is None
    params = [] if record else params
    cfg = train_mod.DistillConfig()
    state = train_mod.DistillTrainState.create(model, cfg)
    step = train_mod.make_distill_train_step(model, cfg,
                                             bn_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(cam_mod.KERNELS)
    for f in cam_mod.PLAIN:
        f.calls = 0
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        if record:
            params.append({k: p.detach().clone()
                           for k, p in model.named_parameters()})
        else:
            model.load_state_dict(params[i], strict=False)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append([float(m["attention_loss"]),
                       float(m["keypoints_loss"])])
    launches = read(cam_mod.KERNELS)
    plain_calls = sum(f.calls for f in cam_mod.PLAIN)
    peak = torch.cuda.max_memory_allocated()
    out = {"model": model, "init": init, "params": params, "losses": losses,
           "step_ms": step_ms, "launches": launches,
           "plain_calls": plain_calls, "peak_bytes": peak,
           "labels": train_mod.label_params(model.named_parameters())}
    if profile:
        # the CAM kernels together, then each tile kernel and the weight
        # gradients by name
        out["profile"] = device_profile(
            lambda: step(state, batch),
            ("cam::", "f1_tile", "f2_tile", "f3_tile", "f1b_tile",
             "f2b_tile", "f3b_tile", "dx_kernel", "wgrad_kernel<5>",
             "wgrad_kernel<7>", "reduce_rows"))
    return out


def phase_train(students, train_mod, cam_mod, w48_state, dev) -> dict:
    """The slice's main path: TRAIN_STEPS fused train steps at full width
    (B=16, 450 x 450, inplanes=80), then the same steps with the CAMs on
    cuDNN on the same batch, each from the fused run's parameters of that
    step (so each step's losses differ by the CAM implementation alone)."""
    batch = train_batch(dev)
    fused = run_train(students, train_mod, cam_mod, True, w48_state, None,
                      batch, dev, profile=True)
    n = 6 * TRAIN_STEPS
    for name, count in fused["launches"].items():
        check(count == n, f"{name}: {count} launches in {TRAIN_STEPS} steps, "
              f"not {n}")
    check(fused["plain_calls"] == 0, "a plain CAM version ran on the card")
    check(all(np.isfinite(v) for row in fused["losses"] for v in row),
          f"non-finite losses {fused['losses']}")
    model, init, labels = fused.pop("model"), fused["init"], fused["labels"]
    moved = {"att": False, "det": False}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            check(torch.equal(p.detach(), init[name]),
                  f"frozen {name} moved")
        elif not torch.equal(p.detach(), init[name]):
            moved[labels[name]] = True
    check(all(moved.values()), f"parameters moved: {moved}")
    sd = model.state_dict()
    stats = [k for k in sd if k.endswith("running_mean")
             or k.endswith("running_var")]
    still = [k for k in stats if torch.equal(sd[k], init[k])]
    check(not still, f"running statistics that did not move: {still[:5]}")
    del model
    torch.cuda.empty_cache()
    unfused = run_train(students, train_mod, cam_mod, False, w48_state,
                        fused.pop("params"), batch, dev)
    unfused.pop("model")
    unfused.pop("params")
    check(sum(unfused["launches"].values()) == 0,
          "the cuDNN path launched a CAM kernel")
    rel = 0.0
    for (a1, d1), (a2, d2) in zip(fused["losses"], unfused["losses"]):
        rel = max(rel, abs(a1 - a2) / abs(a2), abs(d1 - d2) / abs(d2))
    check(rel <= TRAIN_LOSS_TOL, f"fused vs cuDNN losses differ by {rel:.4g} "
          f"> {TRAIN_LOSS_TOL}: {fused['losses']} vs {unfused['losses']}")
    out = {}
    for name, run in (("fused", fused), ("unfused", unfused)):
        ms = sum(run["step_ms"][1:]) / (TRAIN_STEPS - 1)
        out[name] = {"losses": run["losses"], "step_ms": run["step_ms"],
                     "mean_step_ms_after_first": ms,
                     "img_per_s": TRAIN_BATCH * 1e3 / ms,
                     "peak_gb": run["peak_bytes"] / 1e9,
                     "launches": run["launches"]}
    out["fused"]["profile"] = fused["profile"]
    out["loss_worst_rel_fused_vs_unfused"] = rel
    print(f"train step: {TRAIN_STEPS} fused steps, B={TRAIN_BATCH} "
          f"{TRAIN_SIZE}^2, launches {fused['launches']}, frozen unchanged, "
          f"att/det/running stats moved; losses fused {fused['losses']} vs "
          f"cuDNN {unfused['losses']} (worst {rel:.4g}); ms/step fused "
          f"{out['fused']['mean_step_ms_after_first']:.1f}, cuDNN "
          f"{out['unfused']['mean_step_ms_after_first']:.1f}; peak GB "
          f"{out['fused']['peak_gb']:.2f} / {out['unfused']['peak_gb']:.2f}",
          flush=True)
    return out


def cam_bound(name: str, shape) -> dict:
    """Each CAM kernel's least time at ``shape``: its multiply-adds at the
    bf16 tensor-core rate against its inputs read once and its outputs
    written once."""
    b, h, w, c, dils, hc = shape
    nb, m = len(dils), b * h * w
    nh = nb * hc
    conv, res, top = 9 * nb * c * hc, c * c, nh * c
    macs = {"cam_f1_fwd": res + conv, "cam_f1_bwd": 3 * (res + conv),
            "cam_f2_fwd": conv + top, "cam_f2_bwd": 3 * (conv + top),
            "cam_f3_fwd": res + conv + top,
            "cam_f3_bwd": 3 * (res + conv + top)}[name]
    act = m * c * 2                                   # one bf16 (M, C)
    wts = {"cam_f1": (res + conv) * 2, "cam_f2": (conv + top) * 2,
           "cam_f3": (res + conv + top) * 2}[name[:6]]
    small = {"cam_f1_fwd": (2 * c + 2 * nh + b * c) * 4,
             "cam_f1_bwd": (2 * c + 2 * nh + b * c + res + conv) * 4,
             "cam_f2_fwd": (4 * nh + 2 * c) * 4,
             "cam_f2_bwd": (4 * nh + 2 * c + conv + top + 2 * nh) * 4,
             "cam_f3_fwd": (8 * c + 4 * nh + b * c) * 4,
             "cam_f3_bwd": (8 * c + 4 * nh + b * c + res + conv + top
                            + 4 * c + 2 * nh + b * c) * 4}[name]
    n_act = {"cam_f1_fwd": 1, "cam_f1_bwd": 2, "cam_f2_fwd": 1,
             "cam_f2_bwd": 2, "cam_f3_fwd": 2, "cam_f3_bwd": 3}[name]
    return bound(n_act * act + wts + small, 2 * macs * m, BF16_OPS_PER_S)


def cam_yardstick(students_mod, shape, dev) -> dict:
    """The unfused cuDNN ContextAwareModule at ``shape`` in train mode
    (bf16, channels_last): forward, and forward plus backward."""
    b, h, w, c, dils, _ = shape
    mod = students_mod.ContextAwareModule(c, dils, dtype=torch.bfloat16)
    mod = mod.to(dev, memory_format=torch.channels_last).train()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.rand((b, c, h, w), generator=gen, device=dev,
                   dtype=torch.bfloat16).contiguous(
                       memory_format=torch.channels_last).requires_grad_(True)
    g = torch.randn((b, c, h, w), generator=gen, device=dev,
                    dtype=torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    fwd = device_ms(lambda: mod(x), 5)
    fwd_bwd = device_ms(lambda: mod(x).backward(g), 5)
    return {"fwd_ms": fwd, "fwd_bwd_ms": fwd_bwd}


def cam_kernel_rows(cam_mod, students_mod, errs, launches, dev) -> list:
    """One row per CAM kernel: at the steps' shape, and at the pyramid's
    full-resolution shape under ``at_pyramid_hi``; each row also carries
    its per-launch breakdown at both shapes (ms by kernel)."""
    per_shape, breakdown = {}, {}
    for key, shape in (("steps", STEPS_CAM), ("pyramid_hi", PYRAMID_CAM)):
        yard = cam_yardstick(students_mod, shape, dev)
        k = cam_case(cam_mod, shape, SEED + 10, dev)
        for name, kernel, plain, args in cam_calls(cam_mod, k):
            fwd = name.endswith("fwd")
            if name in TILE_PARTS:
                # the profiler can drop a kernel's events (seen on the
                # H100: a backward's phase-0 and wgrad kernels in one of
                # six profiles): profile again until each part shows
                for _ in range(3):
                    prof = device_profile(lambda: kernel(*args),
                                          TILE_PARTS[name])
                    part = dict(prof.get("ours_ms") or {})
                    if all(part.get(p_, 0.0) > 0
                           for p_ in TILE_PARTS[name]):
                        break
                if prof["device_busy"] is not None:
                    part["other"] = prof["kernel_ms"] - sum(part.values())
                    part["all_kernels"] = prof["kernel_ms"]
                breakdown.setdefault(name, {})[key] = part
            per_shape.setdefault(name, {})[key] = {
                "ms": device_ms(lambda: kernel(*args), 5),
                "plain_ms": device_ms(lambda: plain(*args), 2, warmup=1),
                "library_ms": yard["fwd_ms" if fwd else "fwd_bwd_ms"],
                "library": ("unfused cuDNN ContextAwareModule, train-mode "
                            + ("forward" if fwd else "forward + backward")
                            + ", same shape (no one PyTorch call computes "
                              "the op)"),
                **cam_bound(name, shape), "shape": list(shape[:4])
                + [list(shape[4]), shape[5]]}
        del k
        torch.cuda.empty_cache()
    rows = []
    for name, by in per_shape.items():
        rows.append({"name": name, "route": "cuda",
                     "source": f"rtpe_tpu_torch/csrc/{name[:6]}.cu",
                     "replaces": "rtpe_tpu/ops/pallas_cam.py:"
                                 f"{CAM_REPLACES[name]}",
                     "launches": launches[name],
                     "launches_per_step": 6, "path": "train step "
                     "(AttentionStudentSteps(fused_cam=True)): 3 at the "
                     "steps' shape, 3 in the pyramid (113, 57, 29)",
                     "max_abs_err": errs[name], **by["steps"],
                     "at_pyramid_hi": by["pyramid_hi"]})
        if name in breakdown:
            rows[-1]["breakdown_ms"] = breakdown[name]
    ms = {r["name"]: [r["ms"], r["at_pyramid_hi"]["ms"]] for r in rows}
    print(f"cam kernel ms (steps / pyramid hi): {ms}; the tiled ops by "
          f"kernel: {breakdown}", flush=True)
    return rows


# ------------------- test-time augmentation, COCO evaluation, the CLIs

TTA_TOL = 1e-4                # tta_forward vs by hand, float32 (TF32 off),
                              # of the largest magnitude: cuDNN sums a
                              # batch of 2B in another order than one of B
TTA_SCALES = (0.5, 1.0, 2.0)  # HigherHRNet's multi-scale test set
DECODE_TOL = 1e-5             # card decode vs the plain decode on the CPU


def tta_by_hand(fwd, x, scales, flip_back, resize):
    """:func:`tta_forward`'s aggregate with one forward of B per view
    (the original and its mirror) instead of one of 2B per scale."""
    b, h, w = x.shape[:3]
    j = 17
    base, acc, tags = None, None, None
    for s in scales:
        xs = x if s == 1.0 else resize(
            x, (int(round(h * s / 64)) * 64, int(round(w * s / 64)) * 64),
            align_corners=False)
        views = []
        for v in (xs, xs.flip(2)):
            coarse, refined = fwd(v)
            views.append((refined[..., :j].float(), coarse[..., j:].float()))
        if base is None:
            base = tuple(views[0][0].shape[1:3])

        def to_base(t):
            return t if tuple(t.shape[1:3]) == base else resize(
                t, base, align_corners=True)

        hm = to_base(views[0][0]) + flip_back(to_base(views[1][0]))
        acc = hm if acc is None else acc + hm
        if s == 1.0:
            tags = [to_base(views[0][1]), flip_back(to_base(views[1][1]))]
    return acc / float(2 * len(scales)), torch.stack(tags, dim=-1).reshape(
        b, *base, 2 * j)


def same_people(got, want, what: str) -> None:
    """Two lists of one image's (people, scores): n_people exact, people
    and scores within DECODE_TOL."""
    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check_same_decode(g, w, f"{what}[{i}]")


def phase_tta(mods, state, counters, dev, step_ns: float) -> dict:
    """Flip and multi-scale TTA at full W48 width on 640 x 640 images:
    the self-checks at D=2 and the solver they leave ``auto``; float32
    ``tta_forward`` against :func:`tta_by_hand`; the bf16 predictors,
    canonical and packed, with each path's counters set to 0 just before
    and read just after (``predict_batch`` of 8 against 8 ``predict``);
    the D=2 decode on the card against the plain decode on the CPU; the
    lockstep kernel at D=2 on the TTA top-k of 8 images, timed."""
    (PosePredictor, hrnet, tta_mod, fused, decode_full_batch, top_k,
     grp_mod, nms_mod, resize_bilinear, set_tf32) = mods
    cfg = hrnet.w48_config()
    verdicts = {s: fused.kernel_selfcheck(30, 90, 17, 2, solver=s,
                                          device=dev)
                for s in ("greedy", "lap", "lockstep")}
    served = fused._resolve_auto_lap(30, 90, 17, 2, device=dev)
    print(f"tta: kernel_selfcheck at D=2 {verdicts}; lap='auto' serves "
          f"{served!r} on a batch", flush=True)
    rng = np.random.default_rng(SEED + 9)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]

    set_tf32(False)
    pred32 = PosePredictor(hrnet.PoseHigherHRNet(cfg), state, device=dev,
                           dtype=torch.float32, with_flip=True,
                           scales=TTA_SCALES)
    hand = {}
    with torch.inference_mode():
        x = torch.stack([pred32._preprocess(im)[0] for im in square[:2]])
        for scales in ((1.0,), TTA_SCALES):
            got = tta_mod.tta_forward(pred32._forward_nhwc, x, 17, True,
                                      scales)
            want = tta_by_hand(pred32._forward_nhwc, x, scales,
                               tta_mod.flip_back, resize_bilinear)
            errs = []
            for g, w in zip(got, want):
                check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                      f"tta_forward {scales}: shape or non-finite")
                err = (g - w).abs().max().item()
                rel = err / w.abs().max().item()
                check(rel <= TTA_TOL, f"tta_forward {scales} differs from "
                      f"the separate forwards by {err} ({rel:.3g} of the "
                      f"largest magnitude)")
                errs.append((err, rel))
            hand[",".join(map(str, scales))] = {
                "max_abs_err_hms": errs[0][0], "rel_err_hms": errs[0][1],
                "max_abs_err_tags": errs[1][0], "rel_err_tags": errs[1][1],
                "hms_shape": list(got[0].shape),
                "tags_shape": list(got[1].shape)}
    del pred32
    torch.cuda.empty_cache()

    paths, times = {}, {}
    for packed in (False, True):
        for scales in ((1.0,), TTA_SCALES):
            name = (f"{'packed' if packed else 'canonical'}_flip"
                    + ("_multiscale" if len(scales) > 1 else ""))
            pred = PosePredictor(hrnet.PoseHigherHRNet(cfg), state,
                                 device=dev, packed=packed, with_flip=True,
                                 scales=scales)
            check(pred.tta and pred.dtype == torch.bfloat16, name)
            reset(counters)
            batch = pred.predict_batch(square)
            launches = read(counters)
            singles = [pred.predict(im) for im in square]
            same_people(batch, singles, f"{name} predict_batch vs predict")
            n = [check_people(r, 17, name, d=2) for r in batch]
            check(sum(n) > 0, f"{name}: no people")
            check(launches["nms_topk"] == 8,
                  f"{name}: {launches['nms_topk']} nms_topk launches")
            kernel = ("match_by_tag_lockstep" if served == "lockstep"
                      else "lap_rect")
            check(launches[kernel] > 0, f"{name}: {kernel} not launched")
            times[name] = {"predict_ms": host_ms(
                lambda: pred.predict(square[0]), 3)}
            if packed and len(scales) == 1:
                times[name]["profile"] = device_profile(
                    lambda: pred.predict(square[0]),
                    ("nms_tile_kernel", "nms_merge_kernel",
                     "lockstep_kernel"))
            paths[name] = {"people": n, "launches": launches}
            if packed or len(scales) > 1:
                del pred
                torch.cuda.empty_cache()
            else:
                flip_pred = pred

    with torch.inference_mode():
        x = torch.stack([flip_pred._preprocess(im)[0] for im in square])
        hms, tags = flip_pred._maps(x)
        check(tags.shape[-1] == 34, f"tags {tuple(tags.shape)}: D != 2")
        reset(counters)
        got = decode_full_batch(hms[:2], tags[:2])
        decode_launches = read(counters)
        want = decode_full_batch(hms[:2].cpu(), tags[:2].cpu())
        check(torch.equal(got[1].cpu(), want[1]),
              f"D=2 n_people card {got[1].tolist()} vs CPU "
              f"{want[1].tolist()}")
        for g, w in zip((got[0], got[2]), (want[0], want[2])):
            check(torch.allclose(g.cpu(), w, rtol=DECODE_TOL,
                                 atol=DECODE_TOL),
                  "D=2 card decode differs from the CPU decode")
        val_k, loc_k, tag_k = top_k(hms, tags, 30, 5, 2, True)
        kw = dict(max_num_people=30, p_max=90)
        d2 = {"ms": device_ms(lambda: grp_mod.match_by_tag_lockstep(
                  tag_k, loc_k, val_k, **kw), 50),
              "plain_ms": host_ms(lambda: grp_mod.match_by_tag_lockstep_plain(
                  tag_k, loc_k, val_k, **kw), 2),
              **latency_bound(greedy_steps(val_k), step_ns),
              "shape": list(tag_k.shape),
              "nms_topk_ms": device_ms(lambda: nms_mod.nms_topk(hms), 50)}
        lock = grp_mod.match_by_tag_lockstep(tag_k, loc_k, val_k, **kw)
        plain = grp_mod.match_by_tag_lockstep_plain(tag_k, loc_k, val_k,
                                                    **kw)
        check(torch.equal(lock[0], plain[0]) and torch.equal(lock[1],
                                                              plain[1]),
              "group_lockstep at D=2 differs from its plain version")
    del flip_pred
    torch.cuda.empty_cache()
    print(f"tta: by hand {hand}; paths {paths}; D=2 decode of 2 images "
          f"== CPU plain, n_people {got[1].tolist()}, launches "
          f"{decode_launches}; lockstep D=2 B=8 {d2['ms']:.4f} ms; "
          f"predict ms {({k: v['predict_ms'] for k, v in times.items()})}",
          flush=True)
    return {"selfcheck_d2": verdicts, "auto_serves": served,
            "by_hand": hand, "paths": paths,
            "decode_d2_launches": decode_launches,
            "lockstep_d2_b8": d2, "times": times}


def coco_fixture(rle_encode, rng):
    """An in-memory COCO split: six 480 x 640 and two 640 x 427 RGB
    images in [0, 1], two or three people each, 17 labelled keypoints in
    a grid inside each person's box, uncompressed-RLE segmentations."""
    shapes = [(480, 640)] * 6 + [(640, 427)] * 2
    images, anns, pics = [], [], {}
    aid = 1
    for i, (h, w) in enumerate(shapes):
        img_id = 2000 + i
        pics[img_id] = rng.random((h, w, 3)).astype(np.float32)
        images.append({"id": img_id, "file_name": f"{img_id:012d}.jpg",
                       "height": h, "width": w})
        for p in range(2 + i % 2):
            x0, y0, bw, bh = 0.04 * w + p * 0.31 * w, 0.2 * h, 0.25 * w, \
                0.5 * h
            kps = []
            for j in range(17):
                kps += [x0 + (j % 4 + 0.5) * bw / 4,
                        y0 + (j // 4 + 0.5) * bh / 5, 2]
            mask = np.zeros((h, w), np.uint8)
            mask[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
            anns.append({"id": aid, "image_id": img_id, "category_id": 1,
                         "keypoints": kps, "num_keypoints": 17,
                         "iscrowd": 0, "area": float(mask.sum()),
                         "bbox": [x0, y0, bw, bh],
                         "segmentation": rle_encode(mask, compress=False)})
            aid += 1
    data = {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person",
                            "keypoints": ["k"] * 17}]}
    return data, pics


def memory_dataset(base, pics):
    """``base`` (the port's ``CocoDistillationDataset``) serving the
    fixture's images from memory instead of reading files."""
    class MemoryCoco(base):
        def load_image(self, img_id):
            return pics[img_id]
    return MemoryCoco


def phase_validate(mods, model, root, pics, counters, card, dev) -> dict:
    """``validate_hhrnet``'s core on the fixture, packed, with flip, on
    the card: twice (the second timed), the ten stats finite and equal
    run to run; the NMS + top-k kernel launched; the evaluator on the
    fixture's own ground truth gives AP = AR = 1 exactly."""
    validate_mod, dataset_cls, stats_names = mods
    ds = memory_dataset(dataset_cls, pics)(root, "val2017",
                                           host_gt_heatmaps=False)
    check(len(ds) == 8, f"fixture has {len(ds)} images")
    args = validate_mod.build_parser().parse_args(
        ["--coco_dir", root, "--flip", "--save_every", "0",
         "--device", str(dev)])
    validate_mod.validate(model, ds, args)
    reset(counters)
    res = validate_mod.validate(model, ds, args)
    launches = read(counters)
    check(list(res.stats) == stats_names, f"stats {list(res.stats)}")
    check(all(np.isfinite(v) for v in res.stats.values()),
          f"non-finite stats {res.stats}")
    # one decode a chunk: the six 480 x 640 images in chunks of 4 and 2,
    # the two 640 x 427 in one
    check(launches["nms_topk"] == 3,
          f"{launches['nms_topk']} nms_topk launches for three chunks")
    n = [len(p) for p in res.preds]
    for people in res.preds:
        for p in people:
            check(p.shape[0] == 17 and bool(np.isfinite(p).all()),
                  "validate: bad person")
    gt, scores = [], []
    for img_id in ds.ids:
        people = [np.asarray(a["keypoints"], np.float64).reshape(17, 3)
                  for a in ds.coco.load_anns(ds.coco.get_ann_ids(img_id))]
        gt.append(people)
        scores.append([1.0] * len(people))
    perfect = ds.evaluate(gt, scores)
    check(perfect["AP"] == 1.0 and perfect["AR"] == 1.0,
          f"ground truth scores {perfect}")
    img_per_s = len(ds) / res.forward_s
    print(json.dumps(res.stats))
    print(f"validate: 8 images (flip, packed), people {n}, launches "
          f"{launches}; forward {img_per_s:.2f} img/s ({card}); ground "
          f"truth AP {perfect['AP']} AR {perfect['AR']}", flush=True)
    return {"stats": res.stats, "people": n, "launches": launches,
            "forward_img_per_s": img_per_s, "forward_s": res.forward_s,
            "ground_truth_stats": perfect}


def phase_corpus(mods, model, pics, card, dev) -> dict:
    """``teacher_inference``'s core: 4 images through the packed forward
    (once to warm up, once timed);
    each ``.npz`` read back through the port's loader bitwise equal to
    the forward's outputs pulled to the host (taken where the CLI hands
    them to ``save_teacher_prediction``), with the four keys in order
    and the joint names."""
    ti_mod, cache_mod = mods
    ids = sorted(pics)[:4]
    names = [f"{i:012d}.jpg" for i in ids]
    by_name = {n: pics[i] * 255.0 for n, i in zip(names, ids)}
    captured = {}
    save = ti_mod.save_teacher_prediction

    def tap(out_dir, name, coarse, refined):
        captured[name] = (coarse.copy(), refined.copy())
        return save(out_dir, name, coarse, refined)

    with tempfile.TemporaryDirectory() as out:
        args = ti_mod.build_parser().parse_args(
            ["-I", *names, "-o", out, "-m", "-", "--device", str(dev)])
        ti_mod.save_teacher_prediction = tap
        try:
            sources = [(n, by_name[n].shape[:2]) for n in names]
            ti_mod.write_corpus(model, sources, by_name.__getitem__, out,
                                args)                        # warm-up
            info = ti_mod.write_corpus(model, sources, by_name.__getitem__,
                                       out, args)
        finally:
            ti_mod.save_teacher_prediction = save
        check(sorted(captured) == names, f"npz written for {captured}")
        for name in names:
            coarse, refined = captured[name]
            check(bool(np.isfinite(coarse).all()
                       and np.isfinite(refined).all()), "non-finite maps")
            npz = np.load(cache_mod.prediction_path(out, name))
            check(list(npz.keys()) == ["pred_heatmaps", "embeddings",
                                       "heatmaps_refined", "heatmaps_order"],
                  f"npz keys {list(npz.keys())}")
            check(list(npz["heatmaps_order"]) == cache_mod.HEATMAPS_ORDER,
                  "joint names")
            check(np.array_equal(npz["pred_heatmaps"], coarse[:17]),
                  "pred_heatmaps")
            t_hms, t_ae = cache_mod.load_teacher_prediction(out, name[:-4])
            check(np.array_equal(t_hms, refined.transpose(1, 2, 0))
                  and np.array_equal(t_ae, coarse[17:].transpose(1, 2, 0)),
                  f"{name}: the loader's maps differ from the forward's")
        shapes = {"coarse": list(coarse.shape), "refined": list(refined.shape)}
    img_per_s = info["images"] / info["forward_s"]
    print(f"corpus: 4 npz bitwise equal to the forward's outputs, "
          f"{shapes}; forward + pull {img_per_s:.2f} img/s ({card})",
          flush=True)
    return {"images": info["images"], "shapes": shapes,
            "forward_img_per_s": img_per_s}


def phase_stream(mods, state, frames, counters, card, dev) -> dict:
    """``realtime_demo``'s core: 8 frames x 2 loops through the packed
    predictor's ``stream``, without and with flip, the counters set to 0
    just before and read just after; every streamed frame's people equal
    to ``predict`` of that frame."""
    rt_mod, PosePredictor, hrnet = mods
    args = rt_mod.build_parser().parse_args(["-I", "-", "-m", "-",
                                             "--loops", "2"])
    out = {}
    for flip in (False, True):
        pred = PosePredictor(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                             state, device=dev, packed=True, with_flip=flip)
        pred.predict(frames[0])
        reset(counters)
        stats, results = rt_mod.run_stream(pred, frames, args)
        launches = read(counters)
        check(stats["frames"] == len(results) == 16, "16 streamed frames")
        check(launches["nms_topk"] == 16
              and launches["match_by_tag_lockstep"] == 16,
              f"stream launches {launches}")
        same_people(results, [pred.predict(frames[i % len(frames)])
                              for i in range(16)], f"stream flip={flip}")
        out["flip" if flip else "plain"] = {**stats, "launches": launches}
        print(json.dumps(stats))
        del pred
        torch.cuda.empty_cache()
    print(f"stream: 16 frames == predict, fps plain "
          f"{out['plain']['fps_sustained']} flip "
          f"{out['flip']['fps_sustained']} ({card})", flush=True)
    return out


# ----------------------------------------------- phase 24: int8 serving

INT8_OPS_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
INT8_CORR = 0.99              # int8 forward vs bf16: correlation, as
#                               tests/test_rowpack.py holds JAX's
PORT_KERNELS = ("qconv_kernel", "qfuse_kernel")


def mode_name(e) -> str:
    """An epilogue's mode: dtype, ReLU, residual kind, ReLU, stores."""
    if e is None:
        return "f32-contract"
    parts = ["bf16" if e.dtype == torch.bfloat16 else "f32"]
    if e.relu:
        parts.append("relu")
    if e.res is not None:
        parts.append("res-" + ("int8" if e.res.dtype == torch.int8
                               else "dtype"))
    if e.relu_after:
        parts.append("relu")
    stores = (["store"] if e.store else []) + (
        [("q" if e.q_rounded else "q-of-f32")] if e.q_inv is not None
        else [])
    return "+".join(parts) + ":" + ",".join(stores)


def geometry_key(q, xshape, stride) -> tuple:
    """(cout, cin, kh, kw, transposed, H, W, stride): one distinct call."""
    cout, kh, kw, _ = q.kernel.shape
    return (cout, q.cin, kh, kw, q.transposed, xshape[2], xshape[3], stride)


def fuse_key(ops, dtype, kw) -> tuple:
    """One fuse_sum call: shape, dtype, (operand dtype, factor)s, ReLU,
    stores, and the padded buffer's channels."""
    t0 = ops[0]
    b, c = t0.t.shape[:2]
    h, w = t0.t.shape[2] * t0.factor, t0.t.shape[3] * t0.factor
    out_q = kw.get("out_q")
    return ((c, h, w), str(dtype).replace("torch.", ""),
            tuple((str(o.t.dtype).replace("torch.", ""), o.factor)
                  for o in ops), bool(kw.get("relu")),
            bool(kw.get("store", True)), kw.get("q_inv") is not None,
            None if out_q is None else (out_q.shape[1], kw.get("q_off", 0),
                                        kw.get("q_zero", 0)))


def same_outputs(got, want, what: str) -> None:
    for g, w in zip(got, want):
        check((g is None) == (w is None), f"{what}: outputs differ")
        if g is not None:
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"{what}: differs from plain by "
                  f"{(g.float() - w.float()).abs().max().item()}")


def graph_taps(packed, quant_mod, qfuse_mod, fn, compare: bool,
               keep: bool = False):
    """``fn()`` with taps on the graph's ``qconv`` and ``fuse_sum`` that
    call the kernels and record each call: ``{(geometry, mode): [count,
    args]}``, ``{fuse key: [count, args]}`` (args of the first call with
    ``keep``) and the kernels' launches (``fuse_sum``'s include the
    quantize passes inside ``qconv``).  With ``compare`` every call is
    also held ``torch.equal`` to its plain version on the same
    inputs."""
    qcalls, fcalls = {}, {}
    real_q, real_f = packed.qconv, packed.fuse_sum

    def tap_q(xin, q, stride=1, padding=None, epilogue=None):
        got = real_q(xin, q, stride, padding, epilogue=epilogue)
        key = (geometry_key(q, xin.shape, stride), mode_name(epilogue))
        ent = qcalls.setdefault(key, [0, None])
        ent[0] += 1
        if keep and ent[1] is None:
            ent[1] = (xin, q, stride, padding, epilogue)
        if compare:
            want = quant_mod.qconv_plain(xin, q, stride, padding,
                                         epilogue=epilogue)
            same_outputs(got if epilogue else (got,),
                         want if epilogue else (want,), f"qconv {key}")
        return got

    def tap_f(ops, dtype, **kw):
        before = kw["out_q"].clone() if kw.get("out_q") is not None else None
        got = real_f(ops, dtype, **kw)
        key = fuse_key(ops, dtype, kw)
        ent = fcalls.setdefault(key, [0, None])
        ent[0] += 1
        if keep and ent[1] is None:
            ent[1] = (ops, dtype, kw)
        if compare:
            want = qfuse_mod.fuse_sum_plain(
                ops, dtype, **(kw if before is None else
                               {**kw, "out_q": before}))
            same_outputs(got, want, f"fuse_sum {key}")
            if before is not None:
                check(torch.equal(kw["out_q"], before),
                      f"fuse_sum {key}: the padded buffer differs")
        return got

    packed.qconv, packed.fuse_sum = tap_q, tap_f
    before = quant_mod.qconv.launches, qfuse_mod.fuse_sum.launches
    try:
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
    finally:
        packed.qconv, packed.fuse_sum = real_q, real_f
    launches = {"qconv": quant_mod.qconv.launches - before[0],
                "fuse_sum": qfuse_mod.fuse_sum.launches - before[1]}
    return qcalls, fcalls, launches


def qconv_case(quant_mod, key, b: int, gen, dev):
    """Random int8 x (B, Cin, H, W) channels_last and a random QConv at
    ``key``, +-127 planted in every row of both."""
    cout, cin, kh, kw, tr, h, w, _ = key

    def int8(shape):
        t = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        flat = t.view(-1, shape[-1])
        flat[::2, 0] = 127
        flat[1::2, -1] = -127
        return t

    x = int8((b, h, w, cin)).permute(0, 3, 1, 2)
    wq = int8((cin, cout, kh, kw) if tr else (cout, cin, kh, kw))
    kernel, c = quant_mod.kernel_layout(wq, tr)
    alpha = (torch.rand((2, cout) if tr else (cout,), generator=gen,
                        device=dev) * 1e-3)
    bias = torch.randn((cout,), generator=gen, device=dev)
    q = quant_mod.QConv(kernel, bias, alpha,
                        torch.tensor(1.0, device=dev), c, tr)
    return x, q, wq


def random_epilogue(quant_mod, e, y, gen, dev):
    """An epilogue of ``e``'s mode for a conv whose float32 output is
    ``y``: random residual (+-127 planted in an int8 one) and scales at
    which a part of the values clamp."""
    if e is None:
        return None
    cl = torch.channels_last
    amax = y.abs().amax().clamp_min(1e-3)
    q_inv = (254.0 / amax).reshape(()) if e.q_inv is not None else None
    res = res_inv = None
    if e.res is not None:
        if e.res.dtype == torch.int8:
            res = torch.randint(-127, 128, y.shape, generator=gen,
                                device=dev, dtype=torch.int32).to(torch.int8)
            res.view(-1)[::7] = 127
            res.view(-1)[3::7] = -127
            res_inv = torch.rand((), generator=gen, device=dev) + 0.1
        else:
            res = (torch.randn(y.shape, generator=gen, device=dev) * amax
                   / 2).to(e.dtype)
        res = res.contiguous(memory_format=cl)
    return e._replace(res=res, res_inv=res_inv, q_inv=q_inv)


def tie_case(quant_mod, dev):
    """A 1 x 1 conv whose outputs are the input's channel 0 exactly, or
    channel 1 minus channel 0 (alpha 1, bias 0, weights +-1), over every
    int8 value, with an int8
    residual at res_inv 0.5 (sums on bf16 ties: odd integers past 256)
    and int8 stores at q_inv 0.5 (on +-126.5, +-127.5 and every other
    half-integer before the clamp)."""
    v = torch.arange(-128, 128, device=dev).clamp_min(-127).to(torch.int8)
    x = torch.zeros((1, 16, 16, 16), dtype=torch.int8, device=dev)
    x[..., 0] = v.view(16, 16)
    x[..., 1] = v.flip(0).view(16, 16)
    w = torch.zeros((48, 16, 1, 1), dtype=torch.int8, device=dev)
    w[0::2, 0] = 1
    w[1::2, 0] = -1
    w[5, 1] = 1
    kernel, c = quant_mod.kernel_layout(w)
    q = quant_mod.QConv(kernel, torch.zeros(48, device=dev),
                        torch.ones(48, device=dev),
                        torch.tensor(1.0, device=dev), c, False)
    res = x.permute(0, 3, 1, 2)[:, :1].repeat(1, 48, 1, 1).flip(2) \
        .contiguous(memory_format=torch.channels_last)
    half = torch.tensor(0.5, device=dev)
    E = quant_mod.Epilogue
    modes = [E(res=res, res_inv=half, q_inv=half),
             E(res=res, res_inv=half, relu_after=True, q_inv=half),
             E(res=res.to(torch.bfloat16).mul(2).add(1).contiguous(
                 memory_format=torch.channels_last), q_inv=half),
             E(q_inv=half, q_rounded=False), E(relu=True, q_inv=half),
             E(torch.float32, res=res, res_inv=half, q_inv=half)]
    return x.permute(0, 3, 1, 2), q, modes


def phase_qconv(quant_mod, qfuse_mod, packed, pk_q, cfg, dtype, dev) -> dict:
    """Both kernels against their plain versions: every ``qconv`` and
    ``fuse_sum`` call of the 640 x 640 int8 and int8-act forwards at B = 1
    and 8, in the mode the graph uses there, on the forward's own inputs;
    each (geometry, mode) on random int8 inputs with +-127 in every row
    and random residuals, and the f32 contract at each geometry at B = 1
    and 8; values
    on bf16 ties and the clamp's edges; the C plan of every geometry
    equal to ``qconv_plan``.  All ``torch.equal``."""
    keys, fkeys, per_forward = {}, {}, {}
    for b in (1, 8):
        x = torch.randn((b, 3, 640, 640), generator=torch.Generator()
                        .manual_seed(SEED + b)).to(dev)
        for ia in (False, True):
            name = "int8_act" if ia else "int8"
            qc, fc, launches = graph_taps(
                packed, quant_mod, qfuse_mod, lambda: packed.packed_forward(
                    pk_q, x, cfg, dtype, int8_act=ia), compare=True)
            nq = sum(v[0] for v in qc.values())
            check(nq == len(pk_q) == launches["qconv"],
                  f"{name}: {nq} qconv calls, {launches} launches for "
                  f"{len(pk_q)} quantized convs")
            per_forward[f"{name}_b{b}"] = {
                **launches, "fuse_sum_calls": sum(v[0] for v in fc.values())}
            if b == 1:
                for k, v in qc.items():
                    keys.setdefault(k, {})[name] = v[0]
                for k, v in fc.items():
                    fkeys.setdefault(k, {})[name] = v[0]
    geos = sorted({k[0] for k in keys})
    shapes = {g[:5] for g in geos}
    # 25 conv weight shapes and the transposed conv's
    check(len(shapes) == 26, f"{len(shapes)} distinct weight shapes")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    n_random = 0
    with torch.inference_mode():
        for geo in geos:
            cout, cin, kh, kw, tr, h, w, s = geo
            stride, pad = (2, 1) if tr else (s, (kh - 1) // 2)
            for b in (1, 8):
                x, q, _ = qconv_case(quant_mod, geo, b, gen, dev)
                same_outputs((quant_mod.qconv(x, q, stride, pad),),
                             (quant_mod.qconv_plain(x, q, stride, pad),),
                             f"qconv {geo} B={b} f32 contract")
                del x
                plan = quant_mod.qconv_plan(b, h, w, cin, cout, kh, kw,
                                            stride, pad, tr)
                check(plan is not None and quant_mod.qconv_plan_c(
                    b, h, w, cin, cout, kh, kw, stride, pad, tr) == plan,
                    f"qconv plan at {geo} B={b}")
        modes = {}
        for (geo, mode), _ in sorted(keys.items()):
            modes.setdefault(mode, []).append(geo)
        # each mode at every geometry the graph runs it at, random inputs
        eps = {}
        qc, _, _ = graph_taps(packed, quant_mod, qfuse_mod, lambda: [
            packed.packed_forward(pk_q, torch.zeros(
                (1, 3, 64, 64), device=dev), cfg, dtype, int8_act=ia)
            for ia in (False, True)], compare=False, keep=True)
        for (_, mode), (_, args) in qc.items():
            eps.setdefault(mode, args[4])
        for mode, geo_list in sorted(modes.items()):
            for geo in geo_list:
                cout, cin, kh, kw, tr, h, w, s = geo
                x, q, _ = qconv_case(quant_mod, geo, 1, gen, dev)
                stride, pad = (2, 1) if tr else (s, (kh - 1) // 2)
                y = quant_mod.qconv_plain(x, q, stride, pad)
                e = random_epilogue(quant_mod, eps[mode], y, gen, dev)
                same_outputs(quant_mod.qconv(x, q, stride, pad, epilogue=e),
                             quant_mod.qconv_plain(x, q, stride, pad,
                                                   epilogue=e),
                             f"qconv {geo} {mode} on random inputs")
                n_random += 1
        x, q, tie_modes = tie_case(quant_mod, dev)
        seen = set()
        for e in tie_modes:
            want = quant_mod.qconv_plain(x, q, 1, 0, epilogue=e)
            same_outputs(quant_mod.qconv(x, q, 1, 0, epilogue=e), want,
                         f"qconv ties {mode_name(e)}")
            seen |= set(want[1].unique().tolist())
        check({-127, -126, 126, 127} <= seen, f"tie case int8 {seen}")
    print(f"qconv: torch.equal to plain at every call of both forwards at "
          f"B=1 and 8 ({per_forward}), {len(geos)} call geometries "
          f"({len(shapes)} weight shapes) x {len(modes)} modes, {n_random} "
          f"random-input cases, the f32 contract at each geometry at B=1 "
          f"and 8, ties; "
          f"C plans equal; fuse_sum: every call of both forwards "
          f"({len(fkeys)} distinct) equal to plain", flush=True)
    return {"geometries": len(geos), "shapes": len(shapes),
            "modes": sorted(modes), "random_cases": n_random,
            "per_forward": per_forward, "by_key": keys, "fuse_keys": fkeys,
            "max_abs_err": 0.0}


def patched_plain(packed, quant_mod, qfuse_mod, fn):
    """``fn()`` with the graph's kernels replaced by their plain
    versions: the composition of PyTorch ops the CPU runs (float64
    cuDNN convs of the int8 values, then the epilogues' and fuse sums'
    ops)."""
    real = packed.qconv, packed.fuse_sum
    packed.qconv, packed.fuse_sum = (quant_mod.qconv_plain,
                                     qfuse_mod.fuse_sum_plain)
    try:
        return fn()
    finally:
        packed.qconv, packed.fuse_sum = real


def phase_int8_forwards(packed, quant_mod, qfuse_mod, pred8, pk_bf16, cfg,
                        dev) -> dict:
    """The int8 and int8-act forwards at B = 1 and 8 on 640 x 640 inputs:
    bitwise equal to the same forwards on the plain composition; finite
    and correlated > 0.99 with the bf16 packed forward (the worst
    relative error printed, as JAX's test does)."""
    out = {}
    dtype = pred8.dtype
    for bs in (1, 8):
        x = torch.randn((bs, 3, 640, 640), generator=torch.Generator()
                        .manual_seed(SEED + 1)).to(dev)
        with torch.inference_mode():
            ref = packed.packed_forward(pk_bf16, x, cfg, dtype)
            for ia in (False, True):
                name = f"{'int8_act' if ia else 'int8'}_b{bs}"

                def fwd():
                    return packed.packed_forward(pred8.int8_params, x, cfg,
                                                 dtype, int8_act=ia)

                got = fwd()
                want = patched_plain(packed, quant_mod, qfuse_mod, fwd)
                worst, corr = 0.0, 1.0
                for g, w, r in zip(got, want, ref):
                    check(torch.equal(g, w), f"{name} forward differs from "
                          f"the plain composition by "
                          f"{(g.float() - w.float()).abs().max().item()}")
                    g, r = g.float(), r.float()
                    check(bool(torch.isfinite(g).all()),
                          f"{name}: non-finite")
                    worst = max(worst, ((g - r).abs().max()
                                        / r.abs().max().clamp_min(1e-6))
                                .item())
                    c = torch.corrcoef(torch.stack([g.flatten(),
                                                    r.flatten()]))[0, 1]
                    corr = min(corr, c.item())
                check(corr > INT8_CORR,
                      f"{name}: correlation {corr} with bf16")
                out[name] = {"worst_rel_err": worst, "min_corr": corr}
    print(f"int8 forwards B=1 and 8: == the plain compositions bitwise; vs "
          f"bf16 {out}", flush=True)
    return out


def phase_int8_predictors(PosePredictor, hrnet, quant_mod, state, scales,
                          counters, n_q: int, n_f: dict, dev) -> dict:
    """``PosePredictor(packed=True, int8=True)`` and ``int8_act=True``
    from the calibrated scales, the counters set to 0 just before each
    call and read just after: ``predict_batch`` of 8 launches ``qconv``
    once a quantized conv, ``fuse_sum`` as often as in one forward of the
    mode (``n_f``), ``nms_topk`` and ``group_lockstep`` once; ``predict`` of
    one image is routed to bf16 (neither int8 kernel); with
    ``int8_min_batch=0`` it is quantized again."""
    rng = np.random.default_rng(SEED + 24)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    out = {}
    for ia in (False, True):
        name = "int8_act" if ia else "int8"
        pred = PosePredictor(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                             state, device=dev, packed=True, int8=True,
                             int8_act=ia, act_scales=scales)
        pred.predict_batch(square)
        calls = {}
        for what, fn in (("predict_batch_8", lambda: pred.predict_batch(
                square)), ("predict_1", lambda: pred.predict(square[0]))):
            reset(counters)
            res = fn()
            calls[what] = read(counters)
            for r in (res if what.startswith("predict_batch") else [res]):
                check_people(r, 17, f"{name} {what}")
        pred.int8_min_batch = 0
        reset(counters)
        check_people(pred.predict(square[0]), 17, f"{name} unrouted")
        calls["predict_1_min_batch_0"] = read(counters)
        b8, p1, p0 = (calls["predict_batch_8"], calls["predict_1"],
                      calls["predict_1_min_batch_0"])
        check(b8["qconv"] == n_q and b8["fuse_sum"] == n_f[name]
              and b8["nms_topk"] == 1 and b8["match_by_tag_lockstep"] == 1,
              f"{name} predict_batch launches {b8}")
        check(p1["qconv"] == 0 and p1["fuse_sum"] == 0
              and p1["nms_topk"] == 1,
              f"{name} predict routed to bf16: launches {p1}")
        check(p0["qconv"] == n_q and p0["fuse_sum"] == n_f[name],
              f"{name} min_batch 0: launches {p0}")
        out[name] = calls
        del pred
        torch.cuda.empty_cache()
    print(f"int8 predictors: launches {out}", flush=True)
    return out


def phase_int8_export(PosePredictor, hrnet, io_mods, state, scales,
                      dev) -> dict:
    """``export_serving_artifact`` of the int8 predictor's weights and
    scales, then ``from_artifact``: its int8-act forward bitwise equal to
    the exporting predictor's."""
    jax_variables_from_state_dict, export, load = io_mods
    model = hrnet.PoseHigherHRNet(hrnet.w48_config())
    model.load_state_dict(state)
    kw = dict(device=dev, int8_min_batch=0)
    ref = PosePredictor(model, packed=True, int8=True, int8_act=True,
                        act_scales=scales, **kw)
    x = torch.randn((1, 640, 640, 3), generator=torch.Generator()
                    .manual_seed(SEED + 5)).to(dev)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        export(d, jax_variables_from_state_dict(state, model.cfg), model.cfg,
               packed=True, int8=True, int8_act=True, act_scales=scales)
        export_s = time.perf_counter() - t0
        got = PosePredictor.from_artifact(d, **kw)
        meta = load(d).meta
        with torch.inference_mode():
            for a, b in zip(ref._forward(x), got._forward(x)):
                check(torch.equal(a, b), "the reloaded artifact's forward "
                      "differs from the exporting predictor's")
    check(got.int8_act and got.act_scales == scales, "artifact int8 mode")
    mb = meta["weights"]["total_bytes"] / 1e6
    print(f"export: {meta['weights']['num_arrays']} arrays, {mb:.1f} MB, "
          f"{export_s:.2f} s; from_artifact forward bitwise equal", flush=True)
    return {"export_s": export_s, "weights_mb": mb}


def phase_int8_validate(mods, model, root, pics, counters, card,
                        dev) -> dict:
    """``validate_hhrnet``'s core on the in-memory fixture with ``--int8``
    and with ``--int8_act``: scales calibrated on its first 4 images,
    ten finite stats, ``qconv`` launched."""
    validate_mod, dataset_cls = mods
    ds = memory_dataset(dataset_cls, pics)(root, "val2017",
                                           host_gt_heatmaps=False)
    out = {}
    for flags in (["--int8"], ["--int8", "--int8_act"]):
        args = validate_mod.build_parser().parse_args(
            ["--coco_dir", root, "--save_every", "0", "--device", str(dev),
             *flags])
        reset(counters)
        res = validate_mod.validate(model, ds, args)
        launches = read(counters)
        check(len(res.stats) == 10 and all(np.isfinite(v) for v in
                                           res.stats.values()),
              f"validate {flags}: stats {res.stats}")
        check(launches["qconv"] > 0, f"validate {flags}: no qconv launch")
        print(json.dumps(res.stats))
        out[" ".join(flags)] = {"stats": res.stats, "launches": launches,
                                "forward_img_per_s": len(ds) / res.forward_s}
    print(f"validate int8: ten finite stats each, forwards "
          f"{[round(v['forward_img_per_s'], 2) for v in out.values()]} "
          f"img/s ({card})", flush=True)
    return out


def phase_int8_stream(rt_mod, model, frames, counters, card, dev) -> dict:
    """``realtime_demo``'s core with ``--int8``: scales calibrated on the
    first 8 frames, 16 streamed frames equal to ``predict``'s, every one
    routed to bf16 (``routed_bf16``, no ``qconv`` launch)."""
    args = rt_mod.build_parser().parse_args(
        ["-I", "-", "-m", "-", "--loops", "2", "--int8", "--device",
         str(dev)])
    pred = rt_mod.make_predictor(model, frames, args)
    pred.predict(frames[0])
    reset(counters)
    stats, results = rt_mod.run_stream(pred, frames, args)
    launches = read(counters)
    check(stats["routed_bf16"] is True and stats["path"] == "int8",
          f"stream stats {stats}")
    check(launches["qconv"] == 0 and launches["fuse_sum"] == 0
          and launches["nms_topk"] == 16, f"int8 stream launches {launches}")
    same_people(results, [pred.predict(frames[i % len(frames)])
                          for i in range(16)], "int8 stream")
    print(json.dumps(stats))
    print(f"stream int8: 16 frames == predict, routed to bf16, "
          f"{stats['fps_sustained']} fps ({card})", flush=True)
    return {**stats, "launches": launches}


def im2col_int8(x, kh: int, kw: int, stride: int, pad: int):
    """(B*Ho*Wo, kh*kw*Cin) int8 column matrix of an NCHW int8 x (the
    ``torch._int_mm`` yardstick's input; not the port's path)."""
    xp = F.pad(x, (pad, pad, pad, pad))
    b, c, h, w = xp.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    cols = [xp[:, :, i:i + stride * ho:stride, j:j + stride * wo:stride]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, 1).permute(0, 2, 3, 1).reshape(b * ho * wo, -1) \
        .contiguous()


def qconv_work(geo, b: int, ho: int, wo: int, e) -> tuple:
    """Bytes (x and w read once, alpha and bias, the residual read once,
    each output written once in its type) and operations (2 per
    multiply-add this input needs: the transposed conv's output reads
    2 x 2 of its 4 x 4 taps)."""
    cout, cin, kh, kw, tr, h, w, _ = geo
    taps = (kh // 2) * (kw // 2) if tr else kh * kw
    n_out = b * ho * wo * cout
    n_ops = 2 * n_out * taps * cin
    n_bytes = (b * h * w * cin + cout * kh * kw * cin
               + 4 * (2 if tr else 1) * cout + 4 * cout)
    if e is None:
        n_bytes += 4 * n_out
    else:
        dsz = 2 if e.dtype == torch.bfloat16 else 4
        if e.res is not None:
            n_bytes += n_out * (1 if e.res.dtype == torch.int8 else dsz)
        n_bytes += n_out * ((dsz if e.store else 0)
                            + (1 if e.q_inv is not None else 0))
    return n_bytes, n_ops


def qconv_times(quant_mod, geo, args, b: int, yardsticks: bool) -> dict:
    """The kernel on a forward's own inputs in the graph's mode, its
    plain version, and (``yardsticks``) the calls the port never makes:
    cuDNN's bf16 conv of the same shape on the int8 values and
    ``torch._int_mm`` over an im2col where it runs; device ms."""
    xin, q, stride, pad, e = args
    cout, cin, kh, kw, tr, h, w, s = geo
    pad = (kh - 1) // 2 if pad is None else pad
    out = {}
    with torch.inference_mode():
        y = quant_mod.qconv(xin, q, stride, pad, epilogue=e)
        if e is not None:
            y = y[0] if y[0] is not None else y[1]
        ho, wo = y.shape[2], y.shape[3]
        out["ms"] = device_ms(lambda: quant_mod.qconv(
            xin, q, stride, pad, epilogue=e), 20)
        out["plain_ms"] = device_ms(lambda: quant_mod.qconv_plain(
            xin, q, stride, pad, epilogue=e), 3, 1)
        if yardsticks:
            x8 = xin if xin.dtype == torch.int8 else \
                quant_mod.quantize_act(xin, q.inv_sx)
            wq = q.kernel[..., :q.cin].permute(0, 3, 1, 2)
            xb = x8.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            bb = q.bias.to(torch.bfloat16)
            if tr:
                wb = wq.flip(2, 3).permute(1, 0, 2, 3).to(
                    torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
                conv = lambda: F.conv_transpose2d(  # noqa: E731
                    xb, wb, bb, 2, 1)
            else:
                wb = wq.to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
                conv = lambda: F.conv2d(xb, wb, bb, s, pad)  # noqa: E731
            out["library_ms"] = device_ms(conv, 20)
            out["int_mm_im2col_ms"] = None
            if not tr:
                try:
                    cols = im2col_int8(x8, kh, kw, s, pad)
                    wm = wq.permute(0, 2, 3, 1).reshape(cout, -1).T
                    out["int_mm_im2col_ms"] = device_ms(
                        lambda: torch._int_mm(cols, wm), 20)
                except RuntimeError as exc:     # shapes _int_mm refuses
                    out["int_mm_im2col_ms"] = \
                        f"refused: {str(exc).splitlines()[0][:80]}"
    n_bytes, n_ops = qconv_work(geo, b, ho, wo, e)
    plan = quant_mod.qconv_plan(b, h, w, cin, cout, kh, kw, stride, pad, tr)
    return {**out, **bound(n_bytes, n_ops, INT8_OPS_PER_S),
            "tops": n_ops / (out["ms"] * 1e9),
            "gb_per_s": n_bytes / (out["ms"] * 1e6),
            "shape": list(geo[:5]) + [b, h, w, s],
            "plan": {k: plan[k] for k in ("bn", "tiles_m", "tiles_n",
                                          "phases", "nsteps", "splits")}}


def fuse_times(qfuse_mod, args) -> dict:
    """One fuse_sum call on a forward's own inputs: device ms against
    its bytes bound (each operand read once at its own size, the outputs
    written once)."""
    ops, dtype, kw = args
    b, c = ops[0].t.shape[:2]
    h, w = ops[0].t.shape[2] * ops[0].factor, \
        ops[0].t.shape[3] * ops[0].factor
    n = b * c * h * w
    n_bytes = sum(o.t.numel() * o.t.element_size() for o in ops)
    n_bytes += n * (dtype.itemsize if kw.get("store", True) else 0)
    if kw.get("q_inv") is not None:
        n_bytes += b * h * w * (c + kw.get("q_zero", 0))
    with torch.inference_mode():
        ms = device_ms(lambda: qfuse_mod.fuse_sum(ops, dtype, **kw), 20)
        plain_ms = device_ms(lambda: qfuse_mod.fuse_sum_plain(
            ops, dtype, **kw), 3, 1)
    return {"ms": ms, "plain_ms": plain_ms, **bound(n_bytes, 0),
            "gb_per_s": n_bytes / (ms * 1e6)}


def nonport_kernels(fn, quant_mod, qfuse_mod) -> dict:
    """The CUDA kernels of one ``fn()`` under ``torch.profiler`` that are
    not the port's two int8 kernels, by name.  A profile can miss the
    kernels of its first moments (seen on the H100: the input's cast
    and six port kernels), so ``fn`` runs once in a warm-up cycle
    and is read in the one active cycle after it.  Fails unless the
    profile holds exactly the port kernels that the launch counters
    count in that cycle and, beside them, only ``fn``'s input cast."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            before = quant_mod.qconv.launches + qfuse_mod.fuse_sum.launches
            fn()
            torch.cuda.synchronize()
            counted = (quant_mod.qconv.launches
                       + qfuse_mod.fuse_sum.launches - before)
            prof.step()
    names = {}
    n_port = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("ProfilerStep"):
            continue
        if any(k in e.name for k in PORT_KERNELS):
            n_port += 1
        else:
            names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    check(n_port == counted, f"the profile holds {n_port} port kernels, "
          f"the counters {counted}: an incomplete profile")
    check(sum(names.values()) == 1 and all("copy" in k for k in names),
          f"non-port kernels besides the input's cast: {names}")
    return {"port_kernels": n_port, "counted": counted,
            "other_kernels": sum(names.values()), "other": names}


def forward_ms(fn, windows: int = 3) -> dict:
    """A forward's device ms, the median of ``windows`` windows of one
    call behind a sleep of ~0.2 s (``window_ms``).  A window is the
    device's own time where the host had queued it whole before the
    sleep ended (``queued``); where it had not, the host blocked on a
    full launch queue (the bf16 forwards: cuDNN's and PyTorch's
    launches) and may have paced the rest, so ``device_ms`` is then the
    median replay of the forward captured in a CUDA graph (``graph_ms``,
    one launch: the same kernels with shorter gaps between them)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    runs = [_window(fn, 1, 4 * 10 ** 8) for _ in range(windows)]
    out = {"window_ms": sorted(r[0] for r in runs)[windows // 2],
           "queued": all(r[1] for r in runs)}
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm the side stream
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    reps = [_window(graph.replay, 1, 4 * 10 ** 8)[0]
            for _ in range(windows)]
    out["graph_ms"] = sorted(reps)[windows // 2]
    del graph
    out["device_ms"] = out["window_ms"] if out["queued"] \
        else out["graph_ms"]
    return out


def int8_times(packed, quant_mod, qfuse_mod, pred8, pk_bf16, cfg,
               dev) -> dict:
    """Device ms of the int8, int8-act and bf16 packed forwards at B = 1
    and 8; the non-port kernels in one int8 and int8-act forward; then
    ``qconv`` per (call geometry, mode) and ``fuse_sum`` per distinct
    call at B = 8 and 1 on the forwards' own inputs (each summed over a
    forward's calls in the rows)."""
    out, prof, per, fper = {}, {}, {}, {}
    dt = pred8.dtype
    for bs in (1, 8):
        x = torch.randn((bs, 3, 640, 640), generator=torch.Generator()
                        .manual_seed(bs)).to(dev).contiguous(
            memory_format=torch.channels_last)
        runs = {"bf16": lambda: packed.packed_forward(pk_bf16, x, cfg, dt),
                "int8": lambda: packed.packed_forward(pred8.int8_params, x,
                                                      cfg, dt),
                "int8_act": lambda: packed.packed_forward(
                    pred8.int8_params, x, cfg, dt, int8_act=True)}
        with torch.inference_mode():
            for name, fn in runs.items():
                out[f"{name}_bs{bs}"] = {**forward_ms(fn),
                                         "host_ms": host_ms(fn, 3)}
            if bs == 8:
                for name in ("int8", "int8_act"):
                    prof[name] = nonport_kernels(runs[name], quant_mod,
                                                 qfuse_mod)
        rows, frows = [], []
        for ia in (False, True):
            qc, fc, _ = graph_taps(packed, quant_mod, qfuse_mod, lambda: (
                packed.packed_forward(pred8.int8_params, x, cfg, dt,
                                      int8_act=ia)), compare=False,
                keep=True)
            for (geo, mode), (n, args) in sorted(qc.items()):
                rows.append({**qconv_times(quant_mod, geo, args, bs,
                                           yardsticks=not ia),
                             "mode": mode, "forward": "int8_act" if ia
                             else "int8", "calls": n})
            for key, (n, args) in sorted(fc.items(), key=str):
                frows.append({**fuse_times(qfuse_mod, args),
                              "key": str(key), "forward": "int8_act" if ia
                              else "int8", "calls": n})
            del qc, fc
            torch.cuda.empty_cache()
        per[bs], fper[bs] = rows, frows
    print(f"int8 forward ms: {out}; non-port kernels a forward: "
          f"{ {k: v['other_kernels'] for k, v in prof.items()} }",
          flush=True)
    return {"forward": out, "nonport": prof, "per_shape": per,
            "per_fuse": fper}


def _total(rows, forward: str, keys=("ms", "plain_ms", "bound_ms")) -> dict:
    """A forward's sum of (time x calls) over its rows, and what bounds
    most of its calls."""
    rows = [r for r in rows if r["forward"] == forward]
    agg = {k: sum(r[k] * r["calls"] for r in rows) for k in keys}
    by_ops = sum(r["calls"] for r in rows if r["bound_by"] == "operations")
    return {**agg, "bound_by": "operations" if by_ops * 2 > sum(
        r["calls"] for r in rows) else "bytes"}


def qconv_row(times, n_launches: int, err: float, ptxas) -> dict:
    """The ``kernels`` row of ``qconv``: each time summed over one 640 x
    640 int8 forward's calls (a (geometry, mode)'s time x its calls) at
    B = 8, at B = 1 under ``at_b1`` and int8-act's under ``int8_act``;
    the rows per (geometry, mode) under ``per_shape``.  ``library_ms``:
    one cuDNN bf16 conv of each call's shape, summed the same way."""
    b8, b1 = times["per_shape"][8], times["per_shape"][1]
    lib = {b: sum(r["library_ms"] * r["calls"] for r in rows
                  if r["forward"] == "int8")
           for b, rows in ((8, b8), (1, b1))}
    kern = {k.split(": ", 1)[1]: v for k, v in ptxas.items()
            if k.startswith("qconv: ")}
    return {"name": "qconv", "route": "cuda",
            "source": "rtpe_tpu_torch/csrc/qconv.cu",
            "replaces": "rtpe_tpu/ops/quant.py:68 (qconv: XLA's s8 "
                        "conv_general_dilated and the fused epilogue of "
                        "rtpe_tpu/models/hrnet_packed.py; not a Pallas "
                        "kernel)",
            "launches": n_launches, "path": "PosePredictor(int8=True)"
            ".predict_batch(8 images)", "max_abs_err": err,
            **_total(b8, "int8"), "library_ms": lib[8],
            "library": "cuDNN bf16 conv of the same shape, one a call",
            "at_b1": {**_total(b1, "int8"), "library_ms": lib[1]},
            "int8_act": {"b8": _total(b8, "int8_act"),
                         "b1": _total(b1, "int8_act")},
            "per_shape": times["per_shape"], "ptxas": kern}


def qfuse_row(times, n_launches: int, ptxas) -> dict:
    """The ``kernels`` row of ``qfuse``: each time summed over one int8
    forward's calls at B = 8 (B = 1 under ``at_b1``, int8-act's under
    ``int8_act``); no one PyTorch call computes it."""
    b8, b1 = times["per_fuse"][8], times["per_fuse"][1]
    kern = {k.split(": ", 1)[1]: v for k, v in ptxas.items()
            if k.startswith("qfuse: ")}
    return {"name": "qfuse", "route": "cuda",
            "source": "rtpe_tpu_torch/csrc/qfuse.cu",
            "replaces": "rtpe_tpu/models/hrnet_packed.py:525 (_module's "
                        "fuse sum, an XLA fusion) and "
                        "rtpe_tpu/ops/quant.py:61 (quantize_act); not "
                        "Pallas kernels",
            "launches": n_launches, "path": "PosePredictor(int8=True)"
            ".predict_batch(8 images)", "max_abs_err": 0.0,
            **_total(b8, "int8"), "library_ms": None,
            "at_b1": _total(b1, "int8"),
            "int8_act": {"b8": _total(b8, "int8_act"),
                         "b1": _total(b1, "int8_act")},
            "per_call": times["per_fuse"], "ptxas": kern}


def int8_end_to_end(PosePredictor, hrnet, state, scales, dev) -> dict:
    """``predict_batch`` of 8 square 640 x 640 images, host clock, img/s:
    bf16 packed, int8 and int8-act."""
    rng = np.random.default_rng(SEED + 2)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    out = {}
    for name, kw in (("bf16", {}), ("int8", dict(int8=True)),
                     ("int8_act", dict(int8=True, int8_act=True))):
        if kw:
            kw["act_scales"] = scales
        pred = PosePredictor(hrnet.PoseHigherHRNet(hrnet.w48_config()),
                             state, device=dev, packed=True, **kw)
        ms = host_ms(lambda: pred.predict_batch(square), 3)
        out[name] = {"e2e_ms": ms, "img_per_s": 8e3 / ms}
        del pred
        torch.cuda.empty_cache()
    print(f"int8 predict_batch of 8: {out}", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from rtpe_tpu_torch.decode import decode_full_batch
        from rtpe_tpu_torch.decode import fused, group_jit, parser
        from rtpe_tpu_torch.decode.nms import top_k
        from rtpe_tpu_torch.device import set_tf32
        from rtpe_tpu_torch.eval import PosePredictor
        from rtpe_tpu_torch import train as train_mod
        from rtpe_tpu_torch.models import factory as factory_mod
        from rtpe_tpu_torch.models import hrnet
        from rtpe_tpu_torch.models import hrnet_packed as packed_mod
        from rtpe_tpu_torch.models import students as students_mod
        from rtpe_tpu_torch.ops import _build
        from rtpe_tpu_torch.ops import blocks as blk_mod
        from rtpe_tpu_torch.ops import cam as cam_mod
        from rtpe_tpu_torch.ops import group as mega_mod
        from rtpe_tpu_torch.ops import group_lockstep as grp_mod
        from rtpe_tpu_torch.ops import lap as lap_mod
        from rtpe_tpu_torch.ops import nms_topk as nms_mod
        from rtpe_tpu_torch.ops import resize as resize_mod
        from rtpe_tpu_torch.cli import realtime_demo as rt_mod
        from rtpe_tpu_torch.cli import teacher_inference as ti_mod
        from rtpe_tpu_torch.cli import validate_hhrnet as validate_mod
        from rtpe_tpu_torch.data import dataset as dataset_mod
        from rtpe_tpu_torch.data import rle as rle_mod
        from rtpe_tpu_torch.data import teacher_cache as cache_mod
        from rtpe_tpu_torch.eval import cocoeval as cocoeval_mod
        from rtpe_tpu_torch.eval import tta as tta_mod
        from rtpe_tpu_torch.io import (export_serving_artifact,
                                       jax_variables_from_state_dict,
                                       load_serving_artifact)
        from rtpe_tpu_torch.ops import qfuse as qfuse_mod
        from rtpe_tpu_torch.ops import quant as quant_mod
    except ImportError as exc:
        fail(f"the rtpe_tpu_torch package is missing: {exc}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    build = phase_build(_build)
    probe = phase_step_probe(_build, dev)
    errs = {"nms_topk": phase_nms(nms_mod, dev)["max_abs_err"],
            "group_lockstep": phase_lockstep(grp_mod, dev)["max_abs_err"],
            "lap_rect": phase_lap(lap_mod, dev)["max_abs_err"],
            "group_mega": phase_mega(mega_mod, grp_mod, dev)["max_abs_err"]}
    phase_nan_tags(grp_mod, mega_mod, dev)
    phase_selfcheck(fused, dev)
    state = phase_forward(hrnet, set_tf32, dev)
    chain_errs = phase_chain(blk_mod, set_tf32, dev)
    packed_info, pk = phase_packed_forward(hrnet, packed_mod, blk_mod, state,
                                           dev)
    counters = (nms_mod.nms_topk, grp_mod.match_by_tag_lockstep,
                mega_mod.match_by_tag_kernel, lap_mod.lap_rect,
                blk_mod.basicblock_chain, quant_mod.qconv,
                qfuse_mod.fuse_sum)
    pred, images, launches = phase_main_path(
        PosePredictor, hrnet.PoseHigherHRNet, hrnet.w48_config, state,
        counters, dev)
    phase_decode_vs_cpu(pred, images, decode_full_batch)
    path_launches, heatmaps, costs = phase_other_paths(
        pred, PosePredictor, (fused, group_jit, parser._unpack), counters,
        dev)
    kernels = phase_kernel_times(nms_mod, grp_mod, launches, errs, dev,
                                 probe["ns_per_step"])
    kernels += new_kernel_rows(mega_mod, lap_mod, path_launches, heatmaps,
                               costs, errs, top_k, probe["ns_per_step"])
    pred_p, packed_launches, by_shape, served = phase_packed_path(
        PosePredictor, hrnet, packed_mod, state, counters, dev)
    kernels += chain_rows(blk_mod, by_shape, chain_errs, build["ptxas"], dev)
    cam_errs = phase_cam(cam_mod, set_tf32, dev)
    train = phase_train((factory_mod, students_mod), train_mod, cam_mod,
                        state, dev)
    kernels += cam_kernel_rows(cam_mod, students_mod, cam_errs["max_abs_err"],
                               train["fused"]["launches"], dev)
    paths_ms = decode_path_times(pred.parser, fused, heatmaps)
    fwd_ms = forward_times(packed_mod, pred.model, pk, dev)
    e2e = phase_end_to_end(pred)
    prof = phase_profile(pred)
    e2e_packed = phase_end_to_end(pred_p)
    prof_packed = phase_profile(pred_p)
    del pred, pred_p
    torch.cuda.empty_cache()
    tta = phase_tta((PosePredictor, hrnet, tta_mod, fused, decode_full_batch,
                     top_k, grp_mod, nms_mod, resize_mod.resize_bilinear,
                     set_tf32), state, counters, dev, probe["ns_per_step"])
    data, pics = coco_fixture(rle_mod.rle_encode,
                              np.random.default_rng(SEED + 10))
    model = hrnet.PoseHigherHRNet(hrnet.w48_config())
    model.load_state_dict(state)
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "annotations"))
        with open(os.path.join(root, "annotations",
                               "person_keypoints_val2017.json"), "w") as f:
            json.dump(data, f)
        validate = phase_validate(
            (validate_mod, dataset_mod.CocoDistillationDataset,
             cocoeval_mod.STATS_NAMES), model, root, pics, counters, card,
            dev)
        validate_int8 = phase_int8_validate(
            (validate_mod, dataset_mod.CocoDistillationDataset), model,
            root, pics, counters, card, dev)
    corpus = phase_corpus((ti_mod, cache_mod), model, pics, card, dev)
    frames = [(pics[i] * 255.0).astype(np.uint8) for i in sorted(pics)]
    stream = phase_stream((rt_mod, PosePredictor, hrnet), state, frames,
                          counters, card, dev)
    # phase 24: int8 serving
    w48 = hrnet.w48_config()
    t0 = time.perf_counter()
    pred8 = PosePredictor(hrnet.PoseHigherHRNet(w48), state, device=dev,
                          packed=True, int8=True, calibration_images=(
                              synthetic_images(np.random.default_rng(SEED))))
    calib_s = time.perf_counter() - t0
    scales = pred8.act_scales
    n_q = len(pred8.int8_params)
    qinfo = phase_qconv(quant_mod, qfuse_mod, packed_mod, pred8.int8_params,
                        w48, pred8.dtype, dev)
    n_f = {m: qinfo["per_forward"][f"{m}_b8"]["fuse_sum"]
           for m in ("int8", "int8_act")}
    int8_fwd = phase_int8_forwards(packed_mod, quant_mod, qfuse_mod, pred8,
                                   pred8.packed_params, w48, dev)
    int8_served = phase_int8_predictors(PosePredictor, hrnet, quant_mod,
                                        state, scales, counters, n_q, n_f,
                                        dev)
    exported = phase_int8_export(
        PosePredictor, hrnet, (jax_variables_from_state_dict,
                               export_serving_artifact,
                               load_serving_artifact), state, scales, dev)
    stream_int8 = phase_int8_stream(rt_mod, model, frames, counters, card,
                                    dev)
    times8 = int8_times(packed_mod, quant_mod, qfuse_mod, pred8,
                        pred8.packed_params, w48, dev)
    del pred8
    torch.cuda.empty_cache()
    served8 = int8_served["int8"]["predict_batch_8"]
    kernels.append(qconv_row(times8, served8["qconv"], qinfo["max_abs_err"],
                             build["ptxas"]))
    kernels.append(qfuse_row(times8, served8["fuse_sum"], build["ptxas"]))
    e2e_int8 = int8_end_to_end(PosePredictor, hrnet, state, scales, dev)
    int8 = {"calibration_s": calib_s, "n_scales": len(scales),
            "quantized_convs": n_q, "fuse_sum_launches_a_forward": n_f,
            "qconv_check": {**qinfo, "by_key": [
                [*k[0], k[1], n] for k, n in sorted(qinfo["by_key"].items())],
                "fuse_keys": [[str(k), n] for k, n in
                              qinfo["fuse_keys"].items()]},
            "forwards": int8_fwd, "predictor_launches": int8_served,
            "export": exported, "validate": validate_int8,
            "stream": stream_int8, "forward_ms": times8["forward"],
            "nonport_kernels": times8["nonport"],
            "predict_batch_8": e2e_int8}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"card": card, "build_s": build["seconds"],
                      "ptxas": build["ptxas"], "warp_step_probe": probe,
                      "main_path_launches": launches,
                      "other_path_launches": path_launches,
                      "decode_paths_ms": paths_ms,
                      "end_to_end": e2e, "profile_bs8": prof,
                      "chain_check": chain_errs, "packed_forward": packed_info,
                      "packed_path_launches": packed_launches,
                      "packed_predictor_launches": served,
                      "forward_ms": fwd_ms, "end_to_end_packed": e2e_packed,
                      "profile_bs8_packed": prof_packed,
                      "cam_check": cam_errs, "train": train, "tta": tta,
                      "validate": validate, "corpus": corpus,
                      "stream": stream, "int8": int8}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
