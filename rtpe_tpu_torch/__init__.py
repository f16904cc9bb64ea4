"""rtpe_tpu_torch — the PyTorch/CUDA port of ``rtpe_tpu``.

A second package beside the JAX reference.  It imports ``torch``, numpy
and scipy only: no JAX, and nothing of ``rtpe_tpu`` (it keeps its own
copies of the numpy helpers it needs).  It covers the teacher's
image -> people serving path, its test-time augmentation, COCO
evaluation and command-line entry points, and the students'
distillation training:

  data/preprocess.py   resize-align (on-device affine warp) + normalize
  data/                COCO annotations and RLE masks, the evaluation /
                       distillation dataset, heatmap targets, the
                       teacher's .npz corpus, minival splits (numpy)
  models/              HigherHRNet-W48 (NCHW nn.Modules, reference keys),
                       the BN-folded serving forward (hrnet_packed.py),
                       the stem, AttentionStudentSteps (fused or cuDNN
                       CAMs) and the legacy students (students.py, rsb.py)
                       and the factories
  decode/              NMS + top-k -> grouping -> adjust/refine, every
                       decode path of the JAX package
  eval/predictor.py    PosePredictor: predict / predict_batch / stream,
                       canonical or packed, flip / multi-scale TTA
                       (eval/tta.py), from_jax / from_artifact
  eval/cocoeval.py     COCO keypoint AP / AR (numpy)
  cli/                 validate_hhrnet, teacher_inference, realtime_demo,
                       export_serving, distillation, eval_attention,
                       dataloader_demo, visualize_stem
                       (python -m rtpe_tpu_torch.cli.<name>)
  obs/vis.py           skeleton and heatmap pictures (cv2 where used)
  train/               losses, SGDR, the dual-optimizer distillation step,
                       the legacy students' step, loss scaling
  io/                  JAX variables (teacher, student), folded weights,
                       serving artifacts and the reference's torch
                       student state dicts -> the port; checkpoints
  native/              the host's C++ helpers (bilinear resize, RLE
                       codec, assignment solver), built with g++ at
                       first use, numpy / scipy without it
  parallel/            serving meshes (data-sharded batches, the
                       H-sharded spatial W48 with halo exchange) and
                       multi-process training over torch.distributed
                       (global batch statistics, ZeRO-1)
  ops/                 resize, pooling, affine, the BN fold and the
                       wrappers of the CUDA kernels in csrc/ (NMS + top-k,
                       two groupings, LAP, BasicBlock chain, the six
                       fused-CAM kernels)

Entry points take an explicit ``device`` that defaults to ``"cuda"``
(:func:`rtpe_tpu_torch.device.resolve_device`); without CUDA they raise
unless the caller asks for ``"cpu"``.  On the CPU each kernel wrapper
runs its plain PyTorch version; on a CUDA tensor it launches the kernel
or raises.
"""

__version__ = "0.1.0"
