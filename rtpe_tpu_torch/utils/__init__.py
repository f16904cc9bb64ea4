"""Utilities: logging, timestamps, model summaries, meters, NaN
debugging (:mod:`.debug`).

Not carried over from ``rtpe_tpu/utils/``: ``compile.py`` (XLA:TPU's
scoped-VMEM compiler option for the serving jits) and ``watchdog.py``
(pokes a TPU's remote compile service when a compile stalls).  Both
serve XLA's compiler on the TPU; the port compiles nothing through such
a service: its kernels are built once by ``nvcc`` (``ops/_build.py``).
"""

from .logging import ColorLogger, make_timestamp  # noqa: F401
from .meters import AverageMeter  # noqa: F401
from .summary import compiled_flops, model_summary, param_count  # noqa: F401
