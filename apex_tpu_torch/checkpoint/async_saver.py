"""Overlapped checkpointing (``apex_tpu/checkpoint/async_saver.py``):
``AsyncCheckpointer``.

``save(step, state)`` takes a snapshot and returns; a background thread
digests the bytes, writes the shard file and commits the manifest
(``checkpoint/sharded.py``) while the loop runs its next steps.  The
snapshot: every device tensor is cloned on the current stream (ordered
before whatever the next step does to it, the counterpart of JAX's
donation-safe jitted copy), then one copy stream, which waits for the
clones, moves them to pinned host memory (allocated at the first save
and reused) without blocking the loop; the writer waits for that
stream's event.  The clones are marked as used by
the copy stream, so the caching allocator does not hand their memory to
the next step before the copies end.  Host tensors are cloned at once.
At most one save is in flight: a new ``save`` first waits out the
previous write, so host memory stays bounded at one state.  A background
failure re-raises from the next ``save`` or ``wait``.

Telemetry (``observability/metrics``; nothing when unconfigured):
histograms ``checkpoint.save`` (the writer's seconds) and
``checkpoint.blocking`` (the seconds ``save`` held the loop), gauge
``checkpoint.overlap_ratio`` (``1 − blocking / total``), counters
``checkpoint.bytes`` and ``checkpoint.saves``, event
``checkpoint.committed``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.checkpoint import sharded as _sharded
from apex_tpu_torch.observability import metrics as _telemetry

__all__ = ["AsyncCheckpointer", "CheckpointWriteError", "SaveResult"]


class SaveResult(NamedTuple):
    """What one completed save measured."""

    step: int
    path: str
    bytes: int
    save_ms: float        # the writer's wall (copy wait, digest, write)
    blocking_ms: float    # the time save() held the loop's thread
    overlap_ratio: float  # 1 - blocking / (blocking + writer)


class CheckpointWriteError(_sharded.CheckpointError):
    """A background write failed (re-raised on the next ``save``/``wait``)."""


class _Snapshot(NamedTuple):
    state: Any            # the tree with host tensors
    event: Any            # the copy stream's event, or None
    keep: list            # device clones, alive until the copies end


def _snapshot(state: Any, pinned: dict) -> _Snapshot:
    """``pinned``: host buffers of an earlier save by (shape, dtype),
    reused (the earlier write has ended) and refilled."""
    keyed, rebuild = _sharded.flatten_with_keys(state)
    leaves = [leaf for _, leaf in keyed]
    dev = [i for i, leaf in enumerate(leaves)
           if torch.is_tensor(leaf) and leaf.is_cuda]
    host = [i for i, leaf in enumerate(leaves)
            if torch.is_tensor(leaf) and not leaf.is_cuda]
    out = list(leaves)
    for i in host:
        out[i] = leaves[i].detach().clone()
    event, clones = None, []
    if dev:
        clones = [leaves[i].detach().clone() for i in dev]
        ready = torch.cuda.Event()
        ready.record()
        copy_stream = torch.cuda.Stream(device=clones[0].device)
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(ready)
            for n, (i, c) in enumerate(zip(dev, clones)):
                c.record_stream(copy_stream)
                key = (n, tuple(c.shape), c.dtype)
                buf = pinned.get(key)
                if buf is None:
                    buf = pinned[key] = torch.empty(c.shape, dtype=c.dtype,
                                                    pin_memory=True)
                buf.copy_(c, non_blocking=True)
                out[i] = buf
            event = torch.cuda.Event()
            event.record(copy_stream)
    return _Snapshot(rebuild(out), event, clones)


class AsyncCheckpointer:
    """Overlapped checkpointing for a training loop::

        with AsyncCheckpointer(ckpt_dir, keep=3) as ckpt:
            for step in loop:
                state, metrics = train_step(state, batch)
                if step % every == 0:
                    ckpt.save(step, state)   # returns at once
        # the exit waits until the last manifest is committed

    ``keep`` is the retention applied after each commit."""

    def __init__(self, directory: str, *, keep: Optional[int] = 3,
                 process_index: Optional[int] = None):
        if process_index not in (None, 0):
            raise NotImplementedError(
                "saving from another process than 0 comes with the "
                "distributed-training slice of the port")
        self.directory = directory
        self.keep = keep
        # the writer publishes its result or error; the loop's thread
        # reads them only after joining it (wait), so the join is the
        # synchronization
        self.last_result: Optional[SaveResult] = None  # guarded-by: join(self._thread)
        self._thread: Optional[threading.Thread] = None  # guarded-by: confined(train-loop)
        self._error: Optional[BaseException] = None    # guarded-by: join(self._thread)
        self._pinned: dict = {}                         # guarded-by: join(self._thread)

    def save(self, step: int, state: Any,
             extra: Optional[dict] = None) -> None:
        """Snapshot ``state`` and write it in the background (module
        docstring)."""
        self.wait()      # bound the saves in flight; surface an error
        t0 = time.perf_counter()
        snap = _snapshot(state, self._pinned)
        blocking_s = time.perf_counter() - t0
        self._thread = threading.Thread(
            target=self._write, args=(int(step), snap, extra, blocking_s),
            name="apex-torch-ckpt-writer", daemon=True)
        self._thread.start()

    def _write(self, step: int, snap: _Snapshot, extra: Optional[dict],
               blocking_s: float) -> None:
        t0 = time.perf_counter()
        try:
            if snap.event is not None:
                snap.event.synchronize()
            snap.keep.clear()
            path, nbytes = _sharded.save_sharded(
                self.directory, step, snap.state, keep=self.keep,
                extra=extra, return_stats=True)
        except BaseException as e:   # re-raised from the next save/wait
            self._error = e
            return
        bg_s = time.perf_counter() - t0
        total = blocking_s + bg_s
        result = SaveResult(
            step=step, path=path, bytes=nbytes, save_ms=bg_s * 1e3,
            blocking_ms=blocking_s * 1e3,
            overlap_ratio=(1.0 - blocking_s / total) if total > 0 else 1.0)
        self.last_result = result
        reg = _telemetry.registry()
        if reg is not None:
            reg.histogram("checkpoint.save").observe(bg_s)
            reg.histogram("checkpoint.blocking").observe(blocking_s)
            _telemetry.gauge("checkpoint.overlap_ratio").set(
                result.overlap_ratio)
            _telemetry.counter("checkpoint.bytes").inc(nbytes)
            _telemetry.counter("checkpoint.saves").inc()
            _telemetry.event("checkpoint.committed", step=step, path=path,
                             bytes=nbytes, save_ms=round(result.save_ms, 3),
                             blocking_ms=round(result.blocking_ms, 3))

    def wait(self) -> Optional[SaveResult]:
        """Block until the save in flight is durable; re-raise a
        background failure; return the last completed result."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                f"background checkpoint write failed: {err}") from err
        return self.last_result

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # an exception already in flight propagates unshadowed
        if exc and exc[0] is not None:
            try:
                self.wait()
            except Exception:
                pass
            return False
        self.close()
        return False
