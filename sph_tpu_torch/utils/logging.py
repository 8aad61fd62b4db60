"""Logging singleton (reference: sph/utils/Logger.hpp:26-70 — spdlog with
console + optional file sinks and trace..critical levels)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LOGGER_NAME = "sph_tpu_torch"
_FILE_HANDLER: Optional[logging.Handler] = None

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_log_path(path: str) -> None:
    """Attach a file sink (reference: Logger::setLogPath)."""
    global _FILE_HANDLER
    logger = get_logger()
    if _FILE_HANDLER is not None:
        logger.removeHandler(_FILE_HANDLER)
        _FILE_HANDLER.close()
    _FILE_HANDLER = logging.FileHandler(path)
    _FILE_HANDLER.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] %(message)s"))
    logger.addHandler(_FILE_HANDLER)


def set_level(level: int | str) -> None:
    get_logger().setLevel(level)


def flush() -> None:
    for h in get_logger().handlers:
        h.flush()


class Log:
    """`Log::trace/debug/info/warn/error/critical` facade."""

    _once_seen: set = set()

    @staticmethod
    def warn_once(msg, *args):
        """Warn the first time a given message is seen in this process
        (setting-conflict notices would otherwise repeat per level/run)."""
        key = msg % args if args else msg
        if key not in Log._once_seen:
            Log._once_seen.add(key)
            get_logger().warning(msg, *args)

    @staticmethod
    def trace(msg, *args):
        get_logger().log(TRACE, msg, *args)

    @staticmethod
    def debug(msg, *args):
        get_logger().debug(msg, *args)

    @staticmethod
    def info(msg, *args):
        get_logger().info(msg, *args)

    @staticmethod
    def warn(msg, *args):
        get_logger().warning(msg, *args)

    @staticmethod
    def error(msg, *args):
        get_logger().error(msg, *args)

    @staticmethod
    def critical(msg, *args):
        get_logger().critical(msg, *args)
