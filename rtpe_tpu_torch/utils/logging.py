"""Colored, hostname-aware logging (port of ``rtpe_tpu/utils/logging.py``;
reference ``ColorLogger``, ``rtpe/helpers.py:254-365``) without the
coloredlogs/pytz dependencies: ANSI level colors and stdlib timezone
handling.
"""

import datetime
import logging
import sys
from socket import gethostname

_LEVEL_COLORS = {
    logging.DEBUG: "\033[32m",     # green
    logging.INFO: "\033[0m",       # default
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"


def make_timestamp(timezone: str = "Europe/Berlin",
                   with_tz_output: bool = True) -> str:
    """``10_Feb_2018_20:10:16.151`` style timestamp
    (reference ``helpers.py:254-264``)."""
    try:
        from zoneinfo import ZoneInfo
        now = datetime.datetime.now(tz=ZoneInfo(timezone))
    except Exception:
        now = datetime.datetime.now()
    ts = now.strftime("%d_%b_%Y_%H:%M:%S.%f")[:-3]
    if with_tz_output:
        return "%s(%s)" % (ts, timezone)
    return ts


class _HostnameFilter(logging.Filter):
    def filter(self, record) -> bool:
        record.hostname = gethostname()
        return True


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _LEVEL_COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color else msg


class ColorLogger:
    """Colored stdout + optional append-mode file logging."""

    FORMAT_STR = ("%(asctime)s.%(msecs)03d %(hostname)s: %(name)s"
                  "[%(process)d] %(levelname)s %(message)s")

    def __init__(self, logger_name: str, logfile_path: str = None,
                 filemode: str = "a", logging_level=logging.DEBUG):
        logger = logging.getLogger(logger_name)
        logger.setLevel(logging_level)
        logger.handlers = []
        logger.propagate = False
        hostname_filter = _HostnameFilter()

        stdout_handler = logging.StreamHandler(sys.stdout)
        stdout_handler.addFilter(hostname_filter)
        stdout_handler.setFormatter(_ColorFormatter(
            self.FORMAT_STR, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(stdout_handler)

        if logfile_path is not None:
            file_handler = logging.FileHandler(logfile_path, filemode)
            file_handler.addFilter(hostname_filter)
            file_handler.setFormatter(logging.Formatter(
                self.FORMAT_STR, datefmt="%Y-%m-%d %H:%M:%S"))
            logger.addHandler(file_handler)

        self.logger = logger
        if logfile_path is not None:
            self.info("[{}] Saving log into {}".format(
                self.__class__.__name__, logfile_path))

    def debug(self, *a, **k):
        self.logger.debug(*a, **k)

    def info(self, *a, **k):
        self.logger.info(*a, **k)

    def warning(self, *a, **k):
        self.logger.warning(*a, **k)

    def error(self, *a, **k):
        self.logger.error(*a, **k)

    def critical(self, *a, **k):
        self.logger.critical(*a, **k)
