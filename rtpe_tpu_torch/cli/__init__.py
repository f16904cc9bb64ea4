"""Command-line entry points of the port, run as modules:

  python -m rtpe_tpu_torch.cli.validate_hhrnet    COCO keypoint AP
  python -m rtpe_tpu_torch.cli.teacher_inference  the teacher's .npz corpus
  python -m rtpe_tpu_torch.cli.realtime_demo      a pipelined frame stream
  python -m rtpe_tpu_torch.cli.export_serving     the serving artifact
  python -m rtpe_tpu_torch.cli.distillation       the student's trainer
  python -m rtpe_tpu_torch.cli.eval_attention     a snapshot's attention loss
  python -m rtpe_tpu_torch.cli.dataloader_demo    the pipeline and decode demo

Each takes the flags of its ``scripts/`` counterpart in the JAX package
plus ``--device`` (default ``cuda``; without CUDA it raises unless given
``--device cpu``).  Each is split into ``main(argv)``, which parses the
flags and reads the files, and a function that takes the model (or,
for the trainer, the datasets) and the data in memory, which tests and
``chip_smoke.py`` drive directly.
"""
