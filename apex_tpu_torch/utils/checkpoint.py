"""Checkpoint and resume of train states (``apex_tpu/utils/checkpoint.py``):
``save_checkpoint``, ``restore_checkpoint``, ``latest_step``,
``AsyncSaver`` / ``async_saver`` and ``AutoResume``.

The JAX package writes these through orbax.  The machine with the card
has no orbax, so the port writes the sharded format of
:mod:`apex_tpu_torch.checkpoint.sharded` instead (``step_%08d/`` with one
shard file and a committed ``MANIFEST.json``): these files are not
orbax's, and neither package's orbax-free reader takes an orbax
directory.  ``AutoResume`` is the ADLR-shaped polling hook: a scheduler
writes ``termination_file`` (or ``APEX_TPU_TERMINATION_FILE``) to ask
for checkpoint-and-requeue.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from apex_tpu_torch.checkpoint import sharded as _sharded
from apex_tpu_torch.checkpoint.async_saver import AsyncCheckpointer

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "async_saver", "AsyncSaver", "AutoResume"]


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` (a tree of tensors) as ``directory/step_N`` and
    return its path once committed."""
    return _sharded.save_sharded(directory, step, state)


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step under ``directory``, or None."""
    return _sharded.latest_step(directory)


def restore_checkpoint(directory: str, state_like: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into the structure, dtypes and devices of ``state_like``
    (the freshly initialised state); the newest step by default."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return _sharded.restore_sharded(directory, state_like, step=step)


class AsyncSaver:
    """Non-blocking writes: ``save`` snapshots and returns, the write runs
    on a background thread; at most one save in flight; ``wait`` and the
    context manager's exit block until everything is durable."""

    def __init__(self):
        self._saver: Optional[AsyncCheckpointer] = None

    def save(self, directory: str, step: int, state: Any) -> str:
        self.wait()          # one save in flight
        self._saver = AsyncCheckpointer(directory, keep=None)
        self._saver.save(step, state)
        return os.path.join(os.path.abspath(directory), f"step_{step:08d}")

    def wait(self):
        if self._saver is not None:
            self._saver.wait()

    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def async_saver() -> AsyncSaver:
    """A reusable non-blocking saver for a training loop::

        with async_saver() as saver:
            for step in range(n):
                state, metrics = train_step(state, batch)
                if step % ckpt_every == 0:
                    saver.save(ckpt_dir, step, state)
    """
    return AsyncSaver()


class AutoResume:
    """ADLR AutoResume-shaped hook: the loop polls
    ``termination_requested`` and calls ``request_resume`` after saving."""

    def __init__(self, termination_file: Optional[str] = None):
        self.termination_file = termination_file or os.environ.get(
            "APEX_TPU_TERMINATION_FILE", "")

    def init(self):
        return self

    def termination_requested(self) -> bool:
        return bool(self.termination_file) and os.path.exists(
            self.termination_file)

    def request_resume(self):
        if self.termination_file and os.path.exists(self.termination_file):
            os.unlink(self.termination_file)
