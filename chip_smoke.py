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
5. the full-width HigherHRNet-W48 (seeded random weights) as a float32
   forward on the card, TF32 off, against the same weights on the CPU at
   one 256 x 256 image: within 1e-3;
6. the main path: ``PosePredictor`` at full W48 width in bf16 through
   ``predict_batch`` (8 images of mixed shapes), ``predict`` and a
   4-frame ``stream``, with both kernels' launch counters set to 0 just
   before and read just after; then the card's decode of the main path's
   own heatmaps against the plain decode on the CPU;
7. timings (CUDA events after a warm-up): each kernel, its plain version
   and its library yardstick at the main path's batch-8 shape and at
   batch 1, the forward, decode and end-to-end rates at batch 1 and 8,
   and a ``torch.profiler`` view of one batch-8 ``predict_batch``.

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

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
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
    for c in counters:
        c.launches = 0
    out = pred.predict_batch(images)
    single = pred.predict(images[0])
    streamed = list(pred.stream(images[:4]))
    launches = {c.__name__: c.launches for c in counters}
    torch.cuda.synchronize()
    check(len(out) == len(images) and len(streamed) == 4,
          "one result per image")
    n = [check_people(r, 17, f"predict_batch[{i}]")
         for i, r in enumerate(out)]
    n1 = check_people(single, 17, "predict")
    ns = [check_people(r, 17, "stream") for r in streamed]
    check(sum(n) > 0, "no people found on the main path")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
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


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time for the work: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from rtpe_tpu_torch.decode import decode_full_batch
        from rtpe_tpu_torch.device import set_tf32
        from rtpe_tpu_torch.eval import PosePredictor
        from rtpe_tpu_torch.models import hrnet
        from rtpe_tpu_torch.ops import _build
        from rtpe_tpu_torch.ops import group_lockstep as grp_mod
        from rtpe_tpu_torch.ops import nms_topk as nms_mod
    except ImportError as exc:
        fail(f"the rtpe_tpu_torch package is missing: {exc}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_card()
    build_s = phase_build(_build)
    errs = {"nms_topk": phase_nms(nms_mod, dev)["max_abs_err"],
            "group_lockstep": phase_lockstep(grp_mod, dev)["max_abs_err"]}
    state = phase_forward(hrnet, set_tf32, dev)
    counters = (nms_mod.nms_topk, grp_mod.match_by_tag_lockstep)
    pred, images, launches = phase_main_path(
        PosePredictor, hrnet.PoseHigherHRNet, hrnet.w48_config, state,
        counters, dev)
    phase_decode_vs_cpu(pred, images, decode_full_batch)
    kernels = phase_kernel_times(nms_mod, grp_mod, launches, errs, dev)
    e2e = phase_end_to_end(pred)
    prof = phase_profile(pred)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"card": card, "build_s": build_s,
                      "end_to_end": e2e, "profile_bs8": prof}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
