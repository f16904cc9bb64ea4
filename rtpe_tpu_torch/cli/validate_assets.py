"""Real-asset validation runbook: one command the day assets mount.

    python -m rtpe_tpu_torch.cli.validate_assets \\
        -m models/pose_higher_hrnet_w48_640.pth.tar \\
        [--coco_dir <root>] [--teacher_dir <npz corpus>] [--device cpu]

Port of ``scripts/validate_assets.py`` with the same flags, plus
``--device`` (default ``cuda``; raises without CUDA unless ``--device
cpu``, and is passed to each child process).  The claims left open
until real assets mount need the pretrained
``pose_higher_hrnet_w48_640.pth.tar``, real COCO and a real teacher
``.npz`` corpus; this runs every gated check in JAX's order, skipping
(loudly) whatever asset is absent:

1. **Teacher import**: the state dict loads (63,827,139 parameters) and
   a float32 forward of the first sample image at 320 is finite.
2. **Packed / int8 forward parity**: the packed forwards in float32,
   bf16, int8 and int8-act (``csrc/qconv.cu``, ``csrc/qfuse.cu``)
   against the canonical float32 forward, and the scale file's round
   trip.
3. **Greedy decode parity**: the greedy grouping (``csrc/group_mega.cu``
   on the card, its plain version on the CPU) against the exact
   Hungarian, one image and the batch.
4. **Stream consistency**: ``PosePredictor.stream`` against ``predict``,
   packed and packed + flip.
5. **Artifact round trip**: an int8 serving artifact reloaded, its
   forward bitwise the exporting predictor's.
6. **Decode-stack AP** (COCO + teacher corpus): ``cli.dataloader_demo``
   in a child process.
7. **Teacher COCO AP** (COCO): ``cli.validate_hhrnet`` in child
   processes against the reference's recorded numbers, 0.418
   (simplified pipeline) and 0.698 (flip TTA), and the int8 deltas.

The sample images (the first two ``*.jpg`` of ``--data_dir``) are read
once, with PIL, imported only then; each step takes the arrays.  On the
card the float32 forwards run with TF32 off.  ``--data_dir`` and the
whitelist default to the reference repository's ``data/`` and
``assets/coco_minival2017_100.txt``, under ``reference/`` here.

Exit code 0: everything that could run passed; 1: a check failed.  The
last line of standard output is a JSON object of the passed, failed and
skipped names.
"""

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the reference's golden numbers (assets/explorations.md:156-247)
GOLDEN_SIMPLIFIED_AP = 0.418
GOLDEN_FLIP_TTA_AP = 0.698
AP_TOLERANCE = 0.1  # BASELINE.json: "COCO minival AP within 0.1"
INPUT_SIZE = 320


def log(msg):
    print(f"[validate_assets] {msg}", flush=True)


class Results:
    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def record(self, name, ok, detail=""):
        (self.passed if ok else self.failed).append((name, detail))
        log(f"{'PASS' if ok else 'FAIL'}: {name} {detail}")

    def skip(self, name, why):
        self.skipped.append((name, why))
        log(f"SKIP: {name} ({why})")


def read_images(data_dir: str, n: int = 2) -> List[np.ndarray]:
    """The first ``n`` ``*.jpg`` of ``data_dir`` (sorted) as (H, W, 3)
    uint8 RGB arrays; PIL is imported only when there is one."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.jpg")))[:n]
    if not paths:
        return []
    from PIL import Image
    return [np.asarray(Image.open(p).convert("RGB")) for p in paths]


@contextlib.contextmanager
def _float32_convs():
    """TF32 off for the block (cuDNN's default is on), then restored."""
    from ..device import set_tf32
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    set_tf32(False)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


def _input(img, input_size, dev) -> torch.Tensor:
    """A 0-255 RGB image -> the NCHW float32 model input of one image."""
    from .common import model_input
    return model_input(np.asarray(img, np.float32), input_size,
                       dev)[None].permute(0, 3, 1, 2)


def step_teacher_import(res, args, images, input_size=INPUT_SIZE):
    if not os.path.exists(args.model_path):
        res.skip("teacher_import", f"no statedict at {args.model_path}")
        return None
    from ..models.factory import get_hrnet_w48_teacher
    from ..utils.summary import param_count

    dev = torch.device(args.device)
    model, _ = get_hrnet_w48_teacher(args.model_path)
    n = param_count(model)
    res.record("teacher_param_count", n == 63_827_139, f"({n})")
    model = model.to(dev)
    if images:
        with torch.inference_mode(), _float32_convs():
            coarse, refined = model(_input(images[0], input_size, dev))
        finite = bool(torch.isfinite(coarse).all()
                      and torch.isfinite(refined).all())
        res.record("teacher_forward_finite", finite,
                   f"image 0 coarse[max]={float(coarse.max()):.3f}")
    return model, model.state_dict()


def _rel(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.double(), got.double()
    return float(torch.linalg.vector_norm(want - got)
                 / (torch.linalg.vector_norm(want) + 1e-12))


def step_packed_parity(res, args, teacher, images, input_size=INPUT_SIZE):
    if teacher is None:
        res.skip("packed_parity_real_weights", "needs the statedict")
        return
    from ..models.hrnet_packed import (calibrate_act_scales, load_act_scales,
                                       pack_w48_params, packed_forward,
                                       quantize_packed, save_act_scales)

    model, sd = teacher
    cfg = model.cfg
    if not images:
        res.skip("packed_parity_real_weights", "no data/*.jpg")
        return
    dev = torch.device(args.device)
    f32 = torch.float32
    xs = [_input(img, input_size, dev) for img in images]
    worst = {"packed_fp32": 0.0, "packed_bf16": 0.0, "int8": 0.0,
             "int8_act": 0.0}
    with torch.inference_mode(), _float32_convs():
        pk32 = pack_w48_params(sd, cfg, dtype=f32, device=dev)
        pkbf = pack_w48_params(sd, cfg, dtype=torch.bfloat16, device=dev)
        scales = calibrate_act_scales(pk32, xs, cfg, dtype=f32,
                                      percentile=99.9)
        pkq = quantize_packed(pk32, scales)
        # distinct shapes: evaluate per image
        for x in xs:
            want = model(x)[1]
            for key, pk, kw in (
                    ("packed_fp32", pk32, dict(dtype=f32)),
                    ("packed_bf16", pkbf, dict(dtype=torch.bfloat16)),
                    ("int8", pkq, dict(dtype=f32)),
                    ("int8_act", pkq, dict(dtype=f32, int8_act=True))):
                got = packed_forward(pk, x, cfg, **kw)[1]
                worst[key] = max(worst[key], _rel(want, got))
    res.record("packed_fp32_parity", worst["packed_fp32"] < 1e-4,
               f"rel={worst['packed_fp32']:.2e}")
    res.record("packed_bf16_parity", worst["packed_bf16"] < 0.02,
               f"rel={worst['packed_bf16']:.2e}")
    # real-weight int8 accuracy: the numbers to quote instead of the
    # random-weight bounds
    res.record("int8_forward_drift", worst["int8"] < 0.05,
               f"rel={worst['int8']:.3f}")
    res.record("int8_act_forward_drift", worst["int8_act"] < 0.08,
               f"rel={worst['int8_act']:.3f}")
    # scale-file round trip on the real calibration: the persisted
    # scales must reproduce the quantized params bit-exactly
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "act_scales.json")
        save_act_scales(path, scales)
        pkq2 = quantize_packed(pk32, load_act_scales(path))
    same = all(
        torch.equal(getattr(pkq[k], f2), getattr(pkq2[k], f2))
        for k in pkq for f2 in ("kernel", "alpha", "inv_sx")
        if getattr(pkq[k], f2) is not None)
    res.record("act_scales_file_roundtrip", same,
               f"{len(scales)} entries")


def _have_coco(args):
    return os.path.exists(os.path.join(
        args.coco_dir, "annotations", "person_keypoints_val2017.json"))


def _child(module: str, flags: List[str], args, timeout: int):
    """``python -m rtpe_tpu_torch.cli.<module> <flags> --device <dev>``
    with the repository root first on the child's ``PYTHONPATH``."""
    cmd = [sys.executable, "-m", f"rtpe_tpu_torch.cli.{module}", *flags,
           "--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def step_decode_stack_ap(res, args):
    if not (_have_coco(args) and args.teacher_dir
            and os.path.isdir(args.teacher_dir)):
        res.skip("decode_stack_minival_ap",
                 "needs COCO val2017 + teacher npz corpus")
        return
    r = _child("dataloader_demo",
               ["--coco_dir", args.coco_dir,
                "--teacher_dir", args.teacher_dir,
                "--num_demo_batches", "0",
                "--max_eval_images", str(args.minival_images)],
               args, timeout=3600)
    ok = r.returncode == 0 and "AP" in (r.stdout + r.stderr)
    res.record("decode_stack_minival_ap", ok,
               (r.stdout + r.stderr).strip().splitlines()[-1][:200]
               if ok else f"rc={r.returncode}")


def step_teacher_coco_ap(res, args):
    if not (_have_coco(args) and os.path.exists(args.model_path)):
        res.skip("teacher_coco_ap", "needs COCO val2017 + statedict")
        return
    wl = args.whitelist or os.path.join(
        "reference", "assets", "coco_minival2017_100.txt")
    variants = [
        ("simplified", [], GOLDEN_SIMPLIFIED_AP),
        ("flip_tta", ["--flip", "--batch_size", "1"],
         GOLDEN_FLIP_TTA_AP),
        # batched TTA (flip as a doubled leading axis) must reproduce
        # the bs=1 flip AP exactly: cross-checked below
        ("flip_tta_batched", ["--flip", "--batch_size", "8"],
         GOLDEN_FLIP_TTA_AP),
        ("int8", ["--int8"], GOLDEN_SIMPLIFIED_AP),
        ("int8_act", ["--int8", "--int8_act"], GOLDEN_SIMPLIFIED_AP),
        # multi-scale + flip, the full legacy TTA shape
        # (legacy/valid_ae1dim.py:166-191); no golden of its own, so it
        # is held to the flip golden and cross-checked against the flip
        # AP below
        ("flip_ms_tta", ["--flip", "--scales", "1.0,0.5",
                         "--batch_size", "8"], GOLDEN_FLIP_TTA_AP),
    ]
    baseline_ap = {}
    for name, extra, golden in variants:
        flags = ["--coco_dir", args.coco_dir, "-m", args.model_path,
                 "--save_every", "0"]
        if os.path.exists(wl):
            flags += ["--whitelist", wl]
        if not args.full:               # else the whole of val2017
            flags += ["--max_images", str(args.minival_images)]
        flags += extra
        r = _child("validate_hhrnet", flags, args, timeout=4 * 3600)
        if r.returncode != 0:
            res.record(f"teacher_coco_ap_{name}", False,
                       f"rc={r.returncode}: {r.stderr[-200:]}")
            continue
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        ap = stats.get("AP", float("nan"))
        baseline_ap[name] = ap
        ok = abs(ap - golden) <= AP_TOLERANCE
        res.record(f"teacher_coco_ap_{name}", ok,
                   f"AP={ap:.3f} vs golden {golden} "
                   f"(±{AP_TOLERANCE})")
    if "simplified" in baseline_ap and "int8" in baseline_ap:
        delta = baseline_ap["simplified"] - baseline_ap["int8"]
        res.record("int8_ap_delta", abs(delta) <= 0.02,
                   f"bf16->int8 AP delta {delta:+.3f}")
    if "simplified" in baseline_ap and "int8_act" in baseline_ap:
        delta = baseline_ap["simplified"] - baseline_ap["int8_act"]
        res.record("int8_act_ap_delta", abs(delta) <= 0.03,
                   f"bf16->int8_act AP delta {delta:+.3f}")
    if "flip_tta" in baseline_ap and "flip_tta_batched" in baseline_ap:
        delta = baseline_ap["flip_tta"] - baseline_ap["flip_tta_batched"]
        res.record("tta_batched_equals_bs1", abs(delta) <= 0.005,
                   f"bs1 vs batched flip-TTA AP delta {delta:+.3f}")
    if "flip_tta" in baseline_ap and "flip_ms_tta" in baseline_ap:
        # adding the 0.5x scale may move AP either way on a minival
        # slice; a collapse means the multi-scale aggregation is broken
        delta = baseline_ap["flip_ms_tta"] - baseline_ap["flip_tta"]
        res.record("tta_multiscale_sane", delta >= -0.05,
                   f"flip+2-scale vs flip AP delta {delta:+.3f}")


def _grouped_mass(people: torch.Tensor, n: int) -> float:
    return float(people[:n, :, 2].clamp(min=0).sum())


def step_greedy_decode_parity(res, args, teacher, images,
                              input_size=INPUT_SIZE):
    """Greedy against exact grouping on the teacher's outputs: the
    sample images through ``decode_full`` with ``lap="greedy"`` (the
    mega-kernel on the card, its plain version on the CPU) and
    ``lap="xla"`` (the plain Hungarian), and the stacked batch through
    ``decode_full_batch``.  The gate is bounded suboptimality, not
    membership: on tie-heavy tag fields (and any random-init teacher)
    greedy and optimal assignments group different, equally plausible,
    people; on any weights greedy must capture nearly the detection
    mass the exact solve does and find as many people."""
    if teacher is None:
        res.skip("greedy_decode_parity", "needs the statedict")
        return
    if not images:
        res.skip("greedy_decode_parity", "no data/*.jpg")
        return
    from ..decode.fused import decode_full, decode_full_batch
    from ..ops.resize import resize_bilinear

    model, _ = teacher
    nj = model.cfg.num_joints
    dev = torch.device(args.device)
    worst_people = 0
    worst_ratio = 1.0
    hms_all, tags_all = [], []
    with torch.inference_mode(), _float32_convs():
        for img in images:
            coarse, refined = model(_input(img, input_size, dev))
            hms = refined[:, :nj].float().permute(0, 2, 3, 1)
            tags = resize_bilinear(
                coarse[:, nj:].float().permute(0, 2, 3, 1),
                tuple(hms.shape[1:3]), align_corners=True)
            hms_all.append(hms)
            tags_all.append(tags)
            p_g, n_g, _ = decode_full(hms, tags, lap="greedy")
            p_x, n_x, _ = decode_full(hms, tags, lap="xla")
            n_g, n_x = int(n_g), int(n_x)
            worst_people = max(worst_people, abs(n_g - n_x))
            worst_ratio = min(worst_ratio, _grouped_mass(p_g, n_g)
                              / max(_grouped_mass(p_x, n_x), 1e-6))
        # the batch entry (PosePredictor's serving default): the same
        # gate over the stacked sample batch
        if len({h.shape for h in hms_all}) == 1 and len(hms_all) > 1:
            hb, tb = torch.cat(hms_all), torch.cat(tags_all)
            pb_g, nb_g, _ = decode_full_batch(hb, tb, lap="greedy")
            pb_x, nb_x, _ = decode_full_batch(hb, tb, lap="xla")
            for i in range(hb.shape[0]):
                ng, nx = int(nb_g[i]), int(nb_x[i])
                worst_people = max(worst_people, abs(ng - nx))
                worst_ratio = min(worst_ratio, _grouped_mass(pb_g[i], ng)
                                  / max(_grouped_mass(pb_x[i], nx), 1e-6))
    res.record("greedy_decode_parity",
               worst_people <= 1 and worst_ratio >= 0.95,
               f"max people delta {worst_people}, grouped-mass ratio "
               f"greedy/exact {worst_ratio:.3f} (single + batch)")


def step_stream_consistency(res, args, teacher, images,
                            input_size=INPUT_SIZE):
    """The realtime surface: ``PosePredictor.stream`` (behind
    ``cli/realtime_demo.py``) must yield exactly the per-frame results
    of ``predict``: pipelining may only overlap, never change, them."""
    if teacher is None:
        res.skip("stream_matches_predict", "needs the statedict")
        return
    if not images:
        res.skip("stream_matches_predict", "no data/*.jpg")
        return
    from ..eval.predictor import PosePredictor

    model, sd = teacher
    frames = list(images)
    ok, detail = True, ""
    for label, kw in (("packed", {}),
                      ("packed+flip", {"with_flip": True})):
        pred = PosePredictor(model, sd, device=args.device,
                             num_joints=model.cfg.num_joints,
                             input_size=input_size, packed=True, **kw)
        streamed = list(pred.stream(iter(frames)))
        if len(streamed) != len(frames):
            ok, detail = False, f"{label}: frame count mismatch"
            break
        for frame, (people, _) in zip(frames, streamed):
            p1, _ = pred.predict(frame)
            if len(people) != len(p1) or not all(
                    np.allclose(np.asarray(a), np.asarray(b),
                                rtol=1e-4, atol=1e-4)
                    for a, b in zip(people, p1)):
                ok, detail = False, f"{label}: per-frame people mismatch"
                break
        if not ok:
            break
    res.record("stream_matches_predict", ok,
               detail or f"({len(frames)} frames, packed + flip)")


def step_artifact_roundtrip(res, args, teacher, images,
                            input_size=INPUT_SIZE):
    """The deployable artifact: export (int8 scales calibrated on the
    sample images) -> ``from_artifact`` -> the loaded predictor's int8
    forward must be bit-identical to the exporting one's."""
    if teacher is None:
        res.skip("artifact_roundtrip_real_weights", "needs the statedict")
        return
    if not images:
        res.skip("artifact_roundtrip_real_weights", "no data/*.jpg")
        return
    from ..eval.predictor import PosePredictor
    from ..io import export_serving_artifact, jax_variables_from_state_dict

    model, sd = teacher
    cfg = model.cfg
    ref = PosePredictor(model, sd, device=args.device,
                        num_joints=cfg.num_joints, input_size=input_size,
                        packed=True, int8=True,
                        calibration_images=list(images),
                        fused_decode=False)
    with tempfile.TemporaryDirectory() as td:
        d = export_serving_artifact(
            td, jax_variables_from_state_dict(
                {k: v.cpu() for k, v in sd.items()}, cfg), cfg,
            num_joints=cfg.num_joints, input_size=input_size, packed=True,
            int8=True, act_scales=ref.act_scales)
        got = PosePredictor.from_artifact(d, fused_decode=False,
                                          device=args.device)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 256, 256, 3).astype(np.float32)).to(ref.device)
    with torch.inference_mode():
        # n = int8_min_batch: the int8 program, as JAX's _fwd
        (ca, ra), (cb, rb) = (p._forward(x, n=p.int8_min_batch)
                              for p in (ref, got))
        ok = torch.equal(ca.float(), cb.float()) \
            and torch.equal(ra.float(), rb.float())
    res.record("artifact_roundtrip_real_weights", ok,
               "(int8, scales shipped in-artifact)")


def run(args: argparse.Namespace, images: Sequence[np.ndarray],
        input_size: int = INPUT_SIZE) -> Results:
    """The seven steps in order on ``images`` (0-255 RGB arrays)."""
    res = Results()
    teacher = step_teacher_import(res, args, images, input_size)
    step_packed_parity(res, args, teacher, images, input_size)
    step_greedy_decode_parity(res, args, teacher, images, input_size)
    step_stream_consistency(res, args, teacher, images, input_size)
    step_artifact_roundtrip(res, args, teacher, images, input_size)
    step_decode_stack_ap(res, args)
    step_teacher_coco_ap(res, args)
    return res


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("validate_assets")
    p.add_argument("-m", "--model_path",
                   default="models/pose_higher_hrnet_w48_640.pth.tar")
    p.add_argument("--coco_dir",
                   default=os.path.join(os.path.expanduser("~"),
                                        "datasets", "coco"))
    p.add_argument("--teacher_dir", default=None,
                   help="precomputed teacher npz corpus dir")
    p.add_argument("--data_dir", default=os.path.join("reference", "data"),
                   help="bundled sample jpgs (the reference repository's "
                        "data/)")
    p.add_argument("--whitelist", default=None,
                   help="minival id list (default: the reference's "
                        "coco_minival2017_100.txt)")
    p.add_argument("--minival_images", type=int, default=100)
    p.add_argument("--full", action="store_true",
                   help="run the AP comparison on ALL of val2017 "
                        "(hours), not just minival")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; passed to each child")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..device import resolve_device

    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    res = run(args, read_images(args.data_dir))
    log(f"summary: {len(res.passed)} passed, {len(res.failed)} failed, "
        f"{len(res.skipped)} skipped")
    for name, why in res.skipped:
        log(f"  skipped: {name} — {why}")
    print(json.dumps({
        "passed": [n for n, _ in res.passed],
        "failed": [n for n, _ in res.failed],
        "skipped": [n for n, _ in res.skipped],
    }))
    sys.exit(1 if res.failed else 0)


if __name__ == "__main__":
    main()
