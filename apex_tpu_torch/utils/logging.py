"""Rank-annotated logging (``apex_tpu/utils/logging.py``).

One process is rank 0 of 1 until the distributed-training slice: the
formatter prints ``[host 0/1]`` and ``print_rank_0`` prints."""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "print_rank_0", "set_logging_level",
           "RankInfoFormatter"]

_LOGGER_NAME = "apex_tpu_torch"


def _rank() -> int:
    return 0


class RankInfoFormatter(logging.Formatter):
    """Prepends the host rank to every record."""

    def format(self, record):
        record.rank_info = f"[host {_rank()}/1]"
        return super().format(record)


def _build_root_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(RankInfoFormatter(
            "%(asctime)s %(levelname)s %(rank_info)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.WARNING)
        logger.propagate = False
    return logger


_ROOT = _build_root_logger()


def get_logger(name: str | None = None) -> logging.Logger:
    return _ROOT if name is None else _ROOT.getChild(name)


def set_logging_level(level) -> None:
    _ROOT.setLevel(level)


def print_rank_0(message: str) -> None:
    """Print on process 0 only (every process, until the distributed
    slice: there is one)."""
    if _rank() == 0:
        print(message, flush=True)
