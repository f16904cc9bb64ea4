"""Tensor ops (resize, pooling, affine) and the CUDA kernels' wrappers
(``nms_topk``, ``group_lockstep``), each with its plain version."""
