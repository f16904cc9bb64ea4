"""Distillation training of the students.

    python -m rtpe_tpu_torch.cli.distillation --coco_dir <root> \\
        --teacher_dir <npz corpus> --model_path <w48.pth.tar> [--device cpu]

Port of ``scripts/distillation.py`` with the same flags and defaults,
plus ``--device`` (``cuda`` by default; raises without CUDA): the same
model (``AttentionStudentSteps``, inplanes 80, 17 heatmaps, 0 AE dims,
bf16 on CUDA), the same dual attention/detection objective and SGDR
hyperparameters, with

* the data path of :class:`~rtpe_tpu_torch.data.pipeline.TrainPipeline`
  (a thread pool builds host canvases, one upload, then colorspace,
  targets and one affine warp of every plane on the device),
* the train step of :func:`~rtpe_tpu_torch.train.make_distill_train_step`
  (with ``--fused_cam``, the six hand-written CAM kernels),
* per-epoch train-state checkpoints with automatic latest-step resume
  and a SIGTERM save (:class:`~rtpe_tpu_torch.io.checkpoint.
  TrainCheckpointer`), plus the reference's seven part snapshots per
  epoch, ``{timestamp}_epoch{E}_step{S}{part}.statedict.npz``,
* the in-training attention minival (and the detection minival for a
  student with AE channels) over ``--minival_file``'s ids,
* metrics to ``metrics.jsonl`` (and TensorBoard where tensorboardX is
  installed).

``--student cam|refiner|multistage`` trains a legacy student as the JAX
script does (``scripts/distillation.py:158-245``): built in bf16 on
CUDA (``inplanes=48`` for ``cam``), the keypoint-mining MSE step of
:func:`~rtpe_tpu_torch.train.legacy_steps.make_student_train_step` at
``background_factor`` 0.01 for ``cam`` and 0 otherwise, on the batch's
``img``, ``gt_hms``, ``teacher_hms`` and ``mask``, the same checkpoints,
one part file per top-level module, and no minival.

:func:`train` is the core on datasets the caller builds; :func:`main`
builds them from ``--coco_dir``.  The JAX script's ``CompileWatchdog``
guards the TPU's remote compile service and is not carried over.

Data parallelism runs one process per device, as torchrun starts them::

    torchrun --nproc_per_node N -m rtpe_tpu_torch.cli.distillation \
        ... [--mesh_data N] [--zero1]

:func:`main` starts the process group from the environment
(:func:`rtpe_tpu_torch.parallel.dist.initialize`: torchrun's variables or
JAX's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``; NCCL
on cards, gloo with ``--device cpu``), and each process trains on
``cuda:{LOCAL_RANK}``.  ``--mesh_data`` (default: every process) is the
data-parallel size; above the number of processes it exits with status
2, below it the other processes warn and stay idle, as JAX's
``make_mesh`` leaves devices.  Each process feeds its
``batch_size / mesh_data`` rows of every global batch (the rows one
process would build: ``TrainPipeline(shard=...)``), the step reduces its
batch statistics over the group and averages the gradients
(``train/step.py``), and ``--zero1`` shards the momentum
(:class:`~rtpe_tpu_torch.parallel.zero.Zero1SGD`).  The log, metrics,
TensorBoard, checkpoints, part files and minival are rank 0's; a
checkpoint holds the whole momentum, gathered from every process.
"""

import argparse
import dataclasses
import os
import signal
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.coco import read_whitelist
from ..data.dataset import CocoDistillationDataset
from ..data.pipeline import TrainPipeline
from ..device import resolve_device
from ..eval.minival import attention_minival, detection_minival
from ..io.checkpoint import (TrainCheckpointer, save_parts_by_toplevel,
                             save_student_parts)
from ..models.factory import (get_attention_student, get_legacy_student,
                              load_pretrained_stem)
from ..obs.tb import MetricWriter
from ..parallel import dist as pdist
from ..parallel.zero import Zero1SGD
from ..train import (DistillConfig, DistillTrainState, StudentDistillConfig,
                     StudentTrainState, make_distill_train_step,
                     make_student_train_step)
from ..utils import ColorLogger, make_timestamp, model_summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("distillation")
    home = os.path.expanduser("~")
    p.add_argument("--coco_dir", default=os.path.join(home, "datasets",
                                                      "coco"))
    p.add_argument("--train_dataset", default="val2017",
                   help="the reference trains on val2017-sized sets")
    p.add_argument("--teacher_dir", default=None,
                   help="precomputed teacher .npz dir (HRNET_VAL_DIR)")
    p.add_argument("--model_path",
                   default="models/pose_higher_hrnet_w48_640.pth.tar",
                   help="teacher statedict for the frozen stem")
    p.add_argument("--student", default="attention_steps",
                   choices=["attention_steps", "cam", "refiner",
                            "multistage"],
                   help="attention_steps = the live reference config")
    p.add_argument("--num_heatmaps", type=int, default=17)
    p.add_argument("--ae_dims", type=int, default=0)
    p.add_argument("--inplanes", type=int, default=80)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatch count: gradients of batch_size/N "
                        "slices are averaged into one optimizer update")
    p.add_argument("--bn_f32", action="store_true",
                   help="BatchNorm output in fp32 (the default computes "
                        "it in bf16; the statistics stay fp32)")
    p.add_argument("--remat", dest="remat", action="store_true",
                   default=False,
                   help="recompute CAM-block internals in the backward "
                        "pass instead of keeping them (less memory, "
                        "more compute); turns --fused_cam off")
    p.add_argument("--fused_cam", dest="fused_cam", action="store_true",
                   default=False,
                   help="train-mode CAM blocks on the fused hand-written "
                        "kernels (ops/cam.py, csrc/cam_f*.cu)")
    p.add_argument("--no_fused_cam", dest="fused_cam",
                   action="store_false")
    p.add_argument("--num_epochs", type=int, default=20000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--train_hw", type=int, nargs=2, default=[450, 450])
    p.add_argument("--canvas_hw", type=int, nargs=2, default=[640, 640],
                   help="host canvas; must cover the dataset's images")
    p.add_argument("--train_gt_stddev", type=float, default=7.0)
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--snapshot_dir", default=os.path.join("models",
                                                          "snapshots"))
    p.add_argument("--log_dir", default="log")
    p.add_argument("--tb_dir", default=os.path.join("tb_log", "train"))
    p.add_argument("--minival_file", default=None,
                   help="e.g. assets/coco_minival2017_100.txt")
    p.add_argument("--minival_every", type=int, default=150000)
    p.add_argument("--diagnose_every", type=int, default=500)
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--no_resume", dest="resume", action="store_false")
    p.add_argument("--num_workers", type=int,
                   default=max(1, min(8, os.cpu_count() or 1)),
                   help="host loader threads (JPEG/RLE/npz all release "
                        "the GIL)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the optimizer's momentum over the "
                        "data-parallel processes")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel size (default: every process)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def check_flags(parser: argparse.ArgumentParser,
                args: argparse.Namespace) -> None:
    """Parser errors (status 2): a ``--mesh_data`` the processes cannot
    hold, a batch that does not split over it."""
    world = pdist.world_size()
    n = world if args.mesh_data is None else args.mesh_data
    if not 1 <= n <= world:
        parser.error(f"--mesh_data {args.mesh_data} needs as many "
                     f"processes; {world} running")
    if args.batch_size % n:
        parser.error(f"--batch_size {args.batch_size} does not split over "
                     f"--mesh_data {n}")


class _Silent:
    """The log and metric writer of a rank other than 0: every call a
    no-op."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def data_parallel_group(args: argparse.Namespace):
    """``(group, active)``: the data-parallel group of ``--mesh_data``
    processes (None without a process group), and whether this process
    is one of them.  Every process must call it."""
    if not pdist.dist.is_initialized():
        return None, True
    world = pdist.world_size()
    n = world if args.mesh_data is None else args.mesh_data
    if n == world:
        return pdist.dist.group.WORLD, True
    group = pdist.dist.new_group(list(range(n)))
    return group, pdist.rank() < n


@dataclasses.dataclass
class Training:
    """What :func:`train` did: the final state, the step it started
    from (after any resume) and ended at, the last step's metrics, the
    minival results ``(step, att_loss, det_stats or None)``, the part
    files written and the timestamp that names them."""
    state: Union[DistillTrainState, StudentTrainState]
    start_step: int
    step: int
    metrics: dict
    minival: List[tuple]
    parts: List[str]
    timestamp: str


def load_stem(model, model_path: Optional[str], log) -> None:
    """The teacher's stem from a reference-format ``.pth.tar`` into
    ``model``; a missing file warns and keeps the stem random, as the
    JAX script does (``scripts/distillation.py:172-177``)."""
    if model_path and os.path.exists(model_path):
        sd = torch.load(model_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        load_pretrained_stem(model, sd)
        log.info(f"loaded pretrained stem from {model_path}")
    else:
        log.warning("no teacher statedict found — stem stays random "
                    f"({model_path})")


def _diagnose(tb: MetricWriter, batch: dict, model, step: int) -> None:
    """Images and parameter histograms, like the reference's TensorBoard
    diagnostics (distillation.py:346-389)."""
    img0 = batch["img"][0].float().cpu().numpy()
    img0 = (img0 - img0.min()) / (np.ptp(img0) + 1e-9)
    tb.image("batch imgs", img0, step)
    tb.image("gradient masks", batch["mask"][0].amax(-1).cpu().numpy(), step)
    tb.image("attention masks", batch["segm_mask"][0, :, :, 0].cpu().numpy(),
             step)
    tb.image("GT heatmaps_1", batch["gt_hms"][0].amax(-1).cpu().numpy(),
             step)
    for name, p in model.named_parameters():
        tb.histogram(name.replace(".", "/") + "_PARAMETERS",
                     p.detach().float().cpu().numpy(), step)
    tb.flush()


def train(args: argparse.Namespace, train_ds, minival_ds=None,
          device=None,
          on_step: Optional[Callable[[int, DistillTrainState, dict],
                                     None]] = None) -> Optional[Training]:
    """Train on ``train_ds`` (a ``CocoDistillationDataset`` with teacher
    maps) with the options of :func:`build_parser`; ``minival_ds`` (with
    ``alt_colorspace="LAB"``) is evaluated every ``--minival_every``
    steps.  ``device`` overrides ``--device``; ``on_step(step, state,
    metrics)`` is called after each step is queued.

    Under a process group every process calls it: the data-parallel ones
    train (module docstring), the idle ones return None."""
    group, active = data_parallel_group(args)
    rank = pdist.rank()
    if not active:
        ColorLogger("distillation").warning(
            f"rank {rank} idle: --mesh_data {args.mesh_data} of "
            f"{pdist.world_size()} processes")
        return None
    if group is not None:
        dev = pdist.rank_device(device if device is not None
                                else args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device if device is not None else args.device)
    world = pdist.world_size(group)
    lead = rank == 0
    timestamp = make_timestamp(with_tz_output=False)
    if lead:
        os.makedirs(args.log_dir, exist_ok=True)
        os.makedirs(args.snapshot_dir, exist_ok=True)
        log = ColorLogger("distillation", os.path.join(
            args.log_dir, f"[distillation.py]_{timestamp}.log"),
            filemode="w")
        tb = MetricWriter(os.path.join(args.tb_dir,
                                       f"[distillation.py]_{timestamp}"))
    else:
        log = tb = _Silent()

    attention = args.student == "attention_steps"
    if attention:
        model = get_attention_student(
            inplanes=args.inplanes, num_heatmaps=args.num_heatmaps,
            ae_dims=args.ae_dims, detach_att_for_det=True,
            fused_cam=args.fused_cam and not args.remat, remat=args.remat,
            device=dev, seed=0)
        cfg = DistillConfig(distillation_alpha=args.alpha)
        state = DistillTrainState.create(model, cfg)
        step_fn = make_distill_train_step(
            model, cfg, grad_accum=args.grad_accum,
            bn_dtype=None if args.bn_f32 else torch.bfloat16, group=group)
    else:
        model = get_legacy_student(args.student,
                                   num_heatmaps=args.num_heatmaps,
                                   ae_dims=args.ae_dims, device=dev, seed=0)
        # legacy/distillation_pcr.py:278 uses background_factor 0.01
        cfg = StudentDistillConfig(
            distillation_alpha=args.alpha,
            background_factor=0.01 if args.student == "cam" else 0.0)
        state = StudentTrainState.create(model, cfg)
        raw_step = make_student_train_step(model, cfg,
                                           out_hw=tuple(args.train_hw),
                                           group=group)

        def step_fn(state, batch):
            return raw_step(state, {k: batch[k] for k in (
                "img", "gt_hms", "teacher_hms", "mask")})

        minival_ds = None  # no minival for these (distillation.py:203)
    load_stem(model, args.model_path, log)
    log.info(model_summary(model))
    tb.hparams(vars(args))
    if args.zero1 and group is not None:
        state.optimizer = Zero1SGD(state.optimizer, group)

    ckpt = TrainCheckpointer(os.path.join(args.snapshot_dir, "train_state"))
    if args.resume:
        state, step = ckpt.restore(state)
        if step is not None:
            log.info(f"resumed from checkpoint step {step}")
    old_handler = signal.getsignal(signal.SIGTERM)
    sharded = isinstance(state.optimizer, Zero1SGD) and world > 1
    if lead and not sharded:
        # a ZeRO-1 state's momentum lies on every process: no lone save
        ckpt.install_sigterm_save(lambda: state)

    pipeline = TrainPipeline(train_ds, batch_size=args.batch_size,
                             out_hw=tuple(args.train_hw),
                             sigma=args.train_gt_stddev,
                             canvas_hw=tuple(args.canvas_hw),
                             num_workers=args.num_workers, device=dev,
                             shard=None if group is None else
                             pdist.process_local_batch_slice(
                                 args.batch_size, group))
    log.info(f"train dataset: {len(train_ds)} images, "
             f"{len(pipeline)} steps/epoch on {dev}"
             + (f", data-parallel over {world} processes"
                f"{' with ZeRO-1' if args.zero1 else ''}"
                if group is not None else ""))
    global_step = start_step = state.step
    metrics: dict = {}
    minival: List[tuple] = []
    parts: List[str] = []
    t_start = time.time()
    try:
        for epoch in range(args.num_epochs):
            for batch in pipeline:
                batch.pop("img_id")
                state, metrics = step_fn(state, batch)
                global_step += 1
                if on_step is not None:
                    on_step(global_step, state, metrics)
                if global_step % 10 == 0 or global_step < 5:
                    m = {k: float(v) for k, v in metrics.items()}
                    rate = (args.batch_size * (global_step - start_step)
                            / (time.time() - t_start))
                    log.info(f"epoch {epoch} step {global_step}: {m} "
                             f"({rate:.1f} img/s)")
                    tb.scalars(m, global_step)
                if (lead and args.diagnose_every
                        and global_step % args.diagnose_every == 0):
                    _diagnose(tb, batch, model, global_step)
                if (lead and minival_ds is not None and args.minival_every
                        and global_step % args.minival_every == 0):
                    t0 = time.time()
                    mv = attention_minival(model, minival_ds)
                    log.info(f"MINIVAL att loss: {mv:.5f} "
                             f"({time.time() - t0:.1f}s)")
                    tb.scalar("minival att loss", mv, global_step)
                    stats = None
                    if args.ae_dims > 0:
                        stats = detection_minival(
                            model, minival_ds,
                            num_heatmaps=args.num_heatmaps, logger=log)
                        log.info(f"MINIVAL AP: {stats}")
                        for k, v in stats.items():
                            tb.scalar(f"minival {k}", v, global_step)
                    tb.scalar("minival elapsed_seconds",
                              time.time() - t0, global_step)
                    minival.append((global_step, mv, stats))
                if args.max_steps and global_step >= args.max_steps:
                    break
            # per-epoch snapshots (reference distillation.py:422-431)
            if isinstance(state.optimizer, Zero1SGD):
                state.optimizer.gather()   # every process
            if lead:
                ckpt.save(global_step, state)
                prefix = f"{timestamp}_epoch{epoch}_step{global_step}"
                save = save_student_parts if attention else \
                    save_parts_by_toplevel
                written = save(model, args.snapshot_dir, prefix)
                parts += written
                log.info(f"saved snapshot parts to {args.snapshot_dir} "
                         f"({len(written)} files)")
            if args.max_steps and global_step >= args.max_steps:
                break
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        tb.close()
    log.info("PROGRAM FINISHED")
    return Training(state, start_step, global_step, metrics, minival, parts,
                    timestamp)


def main(argv: Optional[Sequence[str]] = None) -> Optional[Training]:
    parser = build_parser()
    args = parser.parse_args(argv)
    pdist.initialize(backend="gloo" if torch.device(args.device).type
                     == "cpu" else None)
    check_flags(parser, args)
    resolve_device(args.device)
    whitelist = (read_whitelist(args.minival_file)
                 if args.minival_file else None)
    minival_ds = None
    if whitelist and args.student == "attention_steps":
        minival_ds = CocoDistillationDataset(
            args.coco_dir, args.train_dataset,
            remove_images_without_annotations=False,
            gt_stddevs_pix=[2.0], whitelist_ids=whitelist,
            alt_colorspace="LAB", host_gt_heatmaps=False)  # never read
    train_ds = CocoDistillationDataset(
        args.coco_dir, args.train_dataset, args.teacher_dir,
        remove_images_without_annotations=True,
        gt_stddevs_pix=[args.train_gt_stddev],
        host_gt_heatmaps=False)  # targets render on the device
    return train(args, train_ds, minival_ds)


if __name__ == "__main__":
    main()
