"""Parallelism (port of ``rtpe_tpu/parallel/``).

* ``mesh.py`` — single-process serving meshes: :func:`make_mesh`,
  :func:`shard_batch`, :func:`replicate`;
* ``spatial.py`` — the W48 forward with every activation H-sharded over
  a mesh axis, halos moved between the shards' devices;
* ``dist.py`` — multi-process training over ``torch.distributed``: the
  process group from the environment, per-process batch slices, and the
  global batch statistics of the data-parallel step;
* ``zero.py`` — ZeRO-1: the SGD momentum sharded over the processes.
"""

from .mesh import Mesh, make_mesh, replicate, shard_batch  # noqa: F401
from .zero import zero1_state_sharding  # noqa: F401
