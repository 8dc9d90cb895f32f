"""The project logger: stderr plus a ``<pid>-<timestamp>.log`` file.

The port's copy of ``autodist_tpu/utils/logging.py``.  The level comes
from ``AUTODIST_TPU_MIN_LOG_LEVEL`` (default ``INFO``); the file goes
under ``$AUTODIST_TPU_WORKING_DIR/logs`` (default: ``autodist_tpu_torch``
in the temporary directory, which honours ``TMPDIR``), one file a
process, so that workers on one host never interleave.  An unwritable
directory leaves the logger on stderr alone.

The project logger ``autodist_tpu_torch`` is the parent of every module
logger of the package (``logging.getLogger(__name__)``), so it keeps
propagating: every record of the package reaches the root logger's
handlers (a user's ``logging.basicConfig``, pytest's ``caplog``)
whatever was called first.  Its stderr handler stays quiet while a root
handler already writes to stderr, so that a record prints there once.
"""
import logging as _logging
import os
import sys
import time

from autodist_tpu_torch import const

_LOGGER_NAME = "autodist_tpu_torch"
_logger = None


class _StderrHandler(_logging.StreamHandler):
    """stderr, unless a root handler already writes there."""

    def emit(self, record):
        for handler in _logging.getLogger().handlers:
            if getattr(handler, "stream", None) in (sys.stderr,
                                                    sys.__stderr__):
                return
        super().emit(record)


def get_logger():
    """The process's framework logger (stderr and file handlers)."""
    global _logger
    if _logger is not None:
        return _logger
    logger = _logging.getLogger(_LOGGER_NAME)
    level = const.ENV.AUTODIST_TPU_MIN_LOG_LEVEL.val.upper()
    logger.setLevel(getattr(_logging, level, _logging.INFO))
    fmt = _logging.Formatter(
        "%(asctime)s %(levelname).1s %(process)d %(filename)s:%(lineno)d] "
        "%(message)s")
    sh = _StderrHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    log_dir = os.path.join(const.ENV.AUTODIST_TPU_WORKING_DIR.val, "logs")
    try:
        os.makedirs(log_dir, exist_ok=True)
        fh = _logging.FileHandler(os.path.join(
            log_dir, f"{os.getpid()}-{int(time.time())}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError:       # a read-only disk: stderr alone
        pass
    _logger = logger
    return logger


def set_verbosity(level):
    """The level on the logger and on its handlers."""
    logger = get_logger()
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.setLevel(level)


def debug(msg, *a):
    get_logger().debug(msg, *a, stacklevel=2)


def info(msg, *a):
    get_logger().info(msg, *a, stacklevel=2)


def warning(msg, *a):
    get_logger().warning(msg, *a, stacklevel=2)


def error(msg, *a):
    get_logger().error(msg, *a, stacklevel=2)
