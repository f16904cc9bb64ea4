"""Tensor ops (resize, pooling, affine, the BN fold) and the CUDA
kernels' wrappers (``nms_topk``, ``group_lockstep``, ``group``, ``lap``,
``blocks``), each with its plain version."""
