"""rtpe_tpu_torch — the PyTorch/CUDA port of ``rtpe_tpu``.

A second package beside the JAX reference.  It imports ``torch``, numpy
and scipy only: no JAX, and nothing of ``rtpe_tpu`` (it keeps its own
copies of the numpy helpers it needs).  It covers the teacher's
image -> people serving path:

  data/preprocess.py   resize-align (on-device affine warp) + normalize
  models/              HigherHRNet-W48 (NCHW nn.Modules, reference keys),
                       the BN-folded serving forward (hrnet_packed.py)
                       and the factories
  decode/              NMS + top-k -> grouping -> adjust/refine, every
                       decode path of the JAX package
  eval/predictor.py    PosePredictor: predict / predict_batch / stream,
                       canonical or packed, from_jax / from_artifact
  io/                  JAX variables, folded weights and serving
                       artifacts -> the port
  ops/                 resize, pooling, affine, the BN fold and the
                       wrappers of the five CUDA kernels in csrc/

Entry points take an explicit ``device`` that defaults to ``"cuda"``
(:func:`rtpe_tpu_torch.device.resolve_device`); without CUDA they raise
unless the caller asks for ``"cpu"``.  On the CPU each kernel wrapper
runs its plain PyTorch version; on a CUDA tensor it launches the kernel
or raises.
"""

__version__ = "0.1.0"
