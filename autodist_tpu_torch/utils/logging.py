"""Logging for the port.

Port of the JAX package's ``utils/logging.py``: a module-level logger
(``autodist_tpu``'s name) writing to stderr and to a timestamped file
under ``DEFAULT_LOG_DIR``, its level set by ``AUTODIST_MIN_LOG_LEVEL``.
"""
from __future__ import annotations

import logging as _logging
import os
import sys
import time

from autodist_tpu_torch.const import DEFAULT_LOG_DIR, ENV

_LOGGER_NAME = "autodist_tpu"
_logger = None


def _get_logger() -> _logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    logger = _logging.getLogger(_LOGGER_NAME)
    logger.propagate = False
    level_name = str(ENV.AUTODIST_MIN_LOG_LEVEL.val).upper()
    logger.setLevel(getattr(_logging, level_name, _logging.INFO))
    fmt = _logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", datefmt="%H:%M:%S")
    sh = _logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    try:
        os.makedirs(DEFAULT_LOG_DIR, exist_ok=True)
        fh = _logging.FileHandler(os.path.join(
            DEFAULT_LOG_DIR, time.strftime("%Y%m%d-%H%M%S") + ".log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError:
        pass
    _logger = logger
    return logger


def set_verbosity(level) -> None:
    _get_logger().setLevel(level)


def debug(msg, *args, **kwargs):
    _get_logger().debug(msg, *args, **kwargs)


def info(msg, *args, **kwargs):
    _get_logger().info(msg, *args, **kwargs)


def warning(msg, *args, **kwargs):
    _get_logger().warning(msg, *args, **kwargs)


def error(msg, *args, **kwargs):
    _get_logger().error(msg, *args, **kwargs)
