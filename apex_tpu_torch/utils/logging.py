"""Rank-annotated logging (``apex_tpu/utils/logging.py``).

The formatter prints ``[host r/N]`` from the world of ``torch.
distributed`` (0 of 1 without a process group), plus the installed
mesh's shape (``parallel_state.get_rank_info``); ``print_rank_0`` prints
on rank 0 only."""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "print_rank_0", "set_logging_level",
           "RankInfoFormatter"]

_LOGGER_NAME = "apex_tpu_torch"


def _rank() -> int:
    from apex_tpu_torch.transformer.parallel_state import world_rank

    return world_rank()


class RankInfoFormatter(logging.Formatter):
    """Prepends the host rank (and the mesh, when one is installed) to
    every record."""

    def format(self, record):
        from apex_tpu_torch.transformer import parallel_state

        record.rank_info = (f"[host {_rank()}/{parallel_state.world_size()}]"
                            + parallel_state.get_rank_info())
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
    """Print on process 0 only."""
    if _rank() == 0:
        print(message, flush=True)
