"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of ``rtpe_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build seconds and ``ptxas`` report;
3. the NMS + top-k kernel against its plain PyTorch version on the card,
   B in {1, 8} x 17 x 320 x 320 with planted ties and sparse planes:
   exactly equal;
4. the lockstep grouping kernel against its plain version, B in
   {1, 8, 32}, J=17, K=30, D=1, p_max=90, ``ignore_too_much`` both ways:
   exactly equal;
5. the per-joint LAP kernel against its plain version: batches of
   cost matrices, n in {1, 8, 30, 32} x m in {30, 60, 127}, with the
   decode's sentinel costs and planted ties: exactly equal;
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
    batch 1, each decode path's host-clock time on the heatmaps of
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
    inputs whose every conv sum is exact in float32;
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
    branch shape; the forward at batch 1 and 8 for the canonical, the
    packed and the packed + chains forwards; the packed predictor's
    end-to-end rates and its ``torch.profiler`` view.

Phases 12-16 run among the others: 12 after 6, 13 and 14 after 8, 15
after 10, and 16 with 11.

Output: the ``nvidia-smi`` line, then one JSON line ``{"kernels": ...}``,
one JSON line of end-to-end numbers, and last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
``rtpe_tpu_torch`` package beside it, the script exits non-zero and
prints no result.
"""

import json
import subprocess
import sys
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around
    ``reps`` calls queued behind a sleep kernel, so that the host's
    launch overhead is hidden where the device is the slower side.
    Fails without ``torch.cuda._sleep``: the times would then include
    the host's launches."""
    sleep = getattr(torch.cuda, "_sleep", None)
    check(sleep is not None, "torch.cuda._sleep is missing: device times "
          "would include host launch overhead")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_build(build) -> float:
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True, force=True)
    secs = time.perf_counter() - t0
    check(sorted(logs) == build.sources(), f"built {sorted(logs)}")
    print(f"build: {len(logs)} kernels in {secs:.2f} s", flush=True)
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"  {name}: {ln.strip()}")
    return secs


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
    print(f"nms_topk: equal to plain at B in (1, 8), max_abs_err {err}",
          flush=True)
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
    shapes = [(n, m) for n in (1, 8, 30, 32) for m in (30, 60, 127)
              if n <= m]
    for n, m in shapes:
        cost = torch.from_numpy(decode_costs(8, n, m, rng)).to(dev)
        got = lap_mod.lap_rect(cost)
        want = lap_mod.lap_rect_plain(cost)
        torch.cuda.synchronize()
        check(got.is_cuda and got.dtype == want.dtype
              and got.shape == want.shape, "lap_rect output layout")
        check(torch.equal(got, want),
              f"lap_rect differs from its plain version at n={n}, m={m}")
        check(all(len(set(r)) == n for r in got.tolist()),
              "lap_rect: a column assigned twice")
    print(f"lap_rect: equal to plain at (n, m) in {shapes}, B=8",
          flush=True)
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


def check_people(res, num_joints: int, what: str) -> int:
    people, scores = res
    check(len(people) == len(scores), f"{what}: people/scores")
    for p in people:
        check(p.shape == (num_joints, 4), f"{what}: person shape {p.shape}")
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


def lockstep_times(grp_mod, b: int, dev) -> dict:
    """Kernel and plain times and the bound of lockstep grouping at
    (B, J=17, K=30, D=1), p_max=90."""
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
            **bound(n_bytes, n_ops), "shape": [b, j, k, d, p_max]}


def lap_times(lap_mod, costs, b: int) -> dict:
    """Kernel and plain times and the bound of one LAP launch, averaged
    over the per-joint cost matrices the decode gave the kernel
    (``decode_full_batch(lap="pallas")``), first ``b`` images."""
    costs = [c[:b].contiguous() for c in costs]
    _, n, m = costs[0].shape
    per = len(costs)
    lap_mod.lap_columns.passes = 0
    for c in costs:
        lap_mod.lap_rect_plain(c)
    passes = lap_mod.lap_columns.passes
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
            "dijkstra_steps": passes / per, "shape": [b, n, m]}


def mega_times(mega_mod, lap_mod, topk, solver: str, b: int) -> dict:
    """Kernel and plain times and the bound of the grouping mega-kernel
    on the main path's own top-k (B=8 or 1, J=17, K=30, D=1), p_max=90."""
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
    return {"ms": device_ms(lambda: mega_mod.match_by_tag_kernel(
                tag_k, loc_k, val_k, **kw), 20),
            "plain_ms": plain_ms, "library_ms": None,
            **bound(n_bytes, n_ops), "shape": [b, j, k, d, p_max]}


def bound(n_bytes: int, n_ops: int, ops_per_s: float = F32_OPS_PER_S
          ) -> dict:
    """The least time for the work: bytes over the memory rate or the
    operations over the peak rate for their type (float32 unless
    given), whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def new_kernel_rows(mega_mod, lap_mod, path_launches, heatmaps, costs,
                    errs, top_k) -> list:
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
                     **mega_times(mega_mod, lap_mod, topk, solver, 8),
                     "at_b1": mega_times(mega_mod, lap_mod, topk, solver, 1)})
    path = "decode_full_batch_pallas"
    rows.append({"name": "lap_rect", "route": "cuda",
                 "source": "rtpe_tpu_torch/csrc/lap_rect.cu",
                 "replaces": "rtpe_tpu/ops/pallas_lap.py:125",
                 "launches": path_launches[path]["lap_rect"], "path": path,
                 "max_abs_err": errs["lap_rect"],
                 **lap_times(lap_mod, costs, 8),
                 "at_b1": lap_times(lap_mod, costs, 1)})
    return rows


def phase_kernel_times(nms_mod, grp_mod, launches, errs, dev) -> list:
    """Times at the main path's batch-8 shape, and at batch 1."""
    rows = []
    for name, times, counter, source, replaces in (
            ("nms_topk", nms_times, "nms_topk", "nms_topk.cu",
             "rtpe_tpu/ops/pallas_decode.py:89"),
            ("group_lockstep", lockstep_times, "match_by_tag_lockstep",
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
    """Where the time of one ``predict_batch`` of 8 square images goes:
    the wall time, the device's busy share (the union of kernel
    intervals) and the largest kernels, from ``torch.profiler``.
    Returns nulls where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 3)
    square = [(rng.random((640, 640, 3)) * 255).astype(np.uint8)
              for _ in range(8)]
    pred.predict_batch(square)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_batch(square)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
    ours = {n: sum(v for k, v in by_name.items() if n in k) / 1e3
            for n in ("nms_tile_kernel", "nms_merge_kernel",
                      "lockstep_kernel")}
    return {"wall_ms": wall_ms, "kernel_ms": busy / 1e3,
            "device_busy": busy / 1e3 / wall_ms,
            "n_kernels": len(kernels), "ours_ms": ours,
            "top": [[n[:80], v / 1e3] for n, v in top]}


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

def phase_nan_tags(grp_mod, mega_mod, dev) -> None:
    """The grouping kernels against their plain versions on tags with
    planted NaNs: a whole tag at the first joint (a person whose mean
    stays NaN), one dimension of a later row; B=8, J=17, K=30, D=2."""
    rng = np.random.default_rng(SEED + 6)
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
    args = [torch.from_numpy(a).to(dev) for a in (tags, locs, vals)]
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
    for shape, n in (((2, 12, 20, 96), 4), ((1, 20, 20, 384), 2)):
        x, w, b = chain_inputs(shape, n, SEED + n, dev, exact=True)
        got = blk_mod.basicblock_chain(x, w, b)
        with torch.backends.cudnn.flags(enabled=False):
            want = blk_mod.basicblock_chain_plain(x, w, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"chain {shape} n={n} differs from "
              "plain on exact sums")
    print(f"basicblock_chain: {len(cases)} cases within {CHAIN_TOL} of max "
          f"|plain|, worst {worst:.4g}, at most {share:.3f} of elements "
          f"differ; bitwise equal on exact sums", flush=True)
    return {"worst_rel": worst, "max_share_differing": share,
            "max_abs_err_b8_n4": errs}


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
    return {"ms": device_ms(lambda: blk_mod.basicblock_chain(x, wt, bs), 20),
            "plain_ms": device_ms(
                lambda: blk_mod.basicblock_chain_plain(x, wt, bs), 5),
            "library_ms": conv_ms * 2 * n, "library": "cuDNN F.conv2d bf16 "
            "channels_last with bias, one conv x 2n", "library_conv_ms":
            conv_ms, **bound(n_bytes, n_ops, BF16_OPS_PER_S),
            "shape": [b, h, w, c, n]}


def chain_rows(blk_mod, by_shape, chain_errs, dev) -> list:
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
                     "at_b1": chain_times(blk_mod, hwc, 1, dev)})
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from rtpe_tpu_torch.decode import decode_full_batch
        from rtpe_tpu_torch.decode import fused, group_jit, parser
        from rtpe_tpu_torch.decode.nms import top_k
        from rtpe_tpu_torch.device import set_tf32
        from rtpe_tpu_torch.eval import PosePredictor
        from rtpe_tpu_torch.models import hrnet
        from rtpe_tpu_torch.models import hrnet_packed as packed_mod
        from rtpe_tpu_torch.ops import _build
        from rtpe_tpu_torch.ops import blocks as blk_mod
        from rtpe_tpu_torch.ops import group as mega_mod
        from rtpe_tpu_torch.ops import group_lockstep as grp_mod
        from rtpe_tpu_torch.ops import lap as lap_mod
        from rtpe_tpu_torch.ops import nms_topk as nms_mod
    except ImportError as exc:
        fail(f"the rtpe_tpu_torch package is missing: {exc}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    build_s = phase_build(_build)
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
                blk_mod.basicblock_chain)
    pred, images, launches = phase_main_path(
        PosePredictor, hrnet.PoseHigherHRNet, hrnet.w48_config, state,
        counters, dev)
    phase_decode_vs_cpu(pred, images, decode_full_batch)
    path_launches, heatmaps, costs = phase_other_paths(
        pred, PosePredictor, (fused, group_jit, parser._unpack), counters,
        dev)
    kernels = phase_kernel_times(nms_mod, grp_mod, launches, errs, dev)
    kernels += new_kernel_rows(mega_mod, lap_mod, path_launches, heatmaps,
                               costs, errs, top_k)
    pred_p, packed_launches, by_shape, served = phase_packed_path(
        PosePredictor, hrnet, packed_mod, state, counters, dev)
    kernels += chain_rows(blk_mod, by_shape, chain_errs, dev)
    paths_ms = decode_path_times(pred.parser, fused, heatmaps)
    fwd_ms = forward_times(packed_mod, pred.model, pk, dev)
    e2e = phase_end_to_end(pred)
    prof = phase_profile(pred)
    e2e_packed = phase_end_to_end(pred_p)
    prof_packed = phase_profile(pred_p)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"card": card, "build_s": build_s,
                      "main_path_launches": launches,
                      "other_path_launches": path_launches,
                      "decode_paths_ms": paths_ms,
                      "end_to_end": e2e, "profile_bs8": prof,
                      "chain_check": chain_errs, "packed_forward": packed_info,
                      "packed_path_launches": packed_launches,
                      "packed_predictor_launches": served,
                      "forward_ms": fwd_ms, "end_to_end_packed": e2e_packed,
                      "profile_bs8_packed": prof_packed}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
