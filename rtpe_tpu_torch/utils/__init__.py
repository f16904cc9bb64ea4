"""Utilities: logging, timestamps, model summaries, meters."""

from .logging import ColorLogger, make_timestamp  # noqa: F401
from .meters import AverageMeter  # noqa: F401
from .summary import model_summary, param_count  # noqa: F401
