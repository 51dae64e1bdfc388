"""Spans and StepTimer (``apex_tpu/observability/spans.py``): the shared
timing path for training and benches.

CUDA launches are asynchronous: a host clock read between two calls
measures dispatch, not device work.  Two tools here handle that:

- :func:`fence` — block until the work producing a value has finished:
  synchronise the device of the first tensor in it (the CPU needs
  nothing).
- :class:`StepTimer` — the steady-state step-timing protocol: warmup
  calls each fenced, then ``iters`` back-to-back calls with ONE
  trailing fence.

:func:`span` measures host wall time (enter → exit) and records a
``span`` observation named ``name`` when telemetry is configured (no
timestamp is taken when it is not); pass ``fence_on=`` to fence a device
value at exit when the span closes over asynchronous device work.  With
the registry's ``profiler`` flag a span also opens a
``torch.profiler.record_function`` region under its name.
"""

from __future__ import annotations

import threading
import time
from contextlib import ContextDecorator
from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.observability import metrics as _metrics

__all__ = ["span", "StepTimer", "fence"]


def _first_tensor(x: Any) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for leaf in x:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def fence(x: Any) -> None:
    """Block until the work producing ``x`` (a tensor, or a tuple, list
    or dict holding tensors) has finished: synchronise the device of its
    first tensor.  CPU tensors and values without a tensor need
    nothing."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class span(ContextDecorator):
    """Measure a named region: ``with span("fwd"): ...`` or as a
    decorator ``@span("fwd")``; nested, recursive and per-thread
    entries keep their own start times."""

    def __init__(self, name: str, fence_on: Any = None,
                 tags: Optional[dict] = None):
        self.name = name
        self.tags = tags
        self._fence_on = fence_on
        self._local = threading.local()

    def _thread_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def __enter__(self):
        reg = _metrics.registry()
        if reg is None:
            self._thread_stack().append(None)   # mark: telemetry off
            return self
        ann = None
        if reg.profiler:
            ann = torch.profiler.record_function(self.name)
            ann.__enter__()
        self._thread_stack().append((time.perf_counter(), ann))
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = self._thread_stack()
        entry = stack.pop() if stack else None
        if entry is None:
            return False
        t0, ann = entry
        if self._fence_on is not None:
            fence(self._fence_on)
        dur = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(exc_type, exc, tb)
        reg = _metrics.registry()
        if reg is not None:
            extra = {"tags": self.tags} if self.tags else {}
            reg.observe_span(self.name, dur, **extra)
        return False


class StepTimer:
    """Steady-state step timing with fencing.

    - :meth:`time` — carry protocol: ``fn(carry) -> carry`` where
      ``carry`` is ``None`` on the first call and the returned tuple's
      LAST element is fenced (by convention the loss).
    - :meth:`time_call` — fixed-args protocol: ``fn(*args)`` repeatedly;
      the output is fenced.

    Both return mean seconds per timed iteration, keep the last output
    on ``self.last``, and, when telemetry is on, record a
    ``step.<name>`` span observation (which feeds the
    throughput-regression detector) and sample the device-memory
    gauges."""

    def __init__(self, name: str, warmup: int = 2, iters: int = 10,
                 fence_fn: Callable[[Any], None] = fence):
        self.name = name
        self.warmup = warmup
        self.iters = iters
        self._fence = fence_fn
        self.last: Any = None

    def _record(self, avg_s: float) -> None:
        reg = _metrics.registry()
        if reg is not None:
            reg.observe_span(f"step.{self.name}", avg_s,
                             iters=self.iters, warmup=self.warmup)
            from apex_tpu_torch.observability import device as _device

            _device.sample_device_memory()

    def time(self, fn: Callable[[Any], Any]) -> float:
        out = None
        for _ in range(self.warmup):
            out = fn(out)
            self._fence(out[-1])
        t0 = time.perf_counter()
        for _ in range(self.iters):
            out = fn(out)
        self._fence(out[-1])
        avg = (time.perf_counter() - t0) / self.iters
        self.last = out
        self._record(avg)
        return avg

    def time_call(self, fn: Callable[..., Any], *args) -> float:
        out = None
        for _ in range(self.warmup):
            out = fn(*args)
            self._fence(out)
        t0 = time.perf_counter()
        for _ in range(self.iters):
            out = fn(*args)
        self._fence(out)
        avg = (time.perf_counter() - t0) / self.iters
        self.last = out
        self._record(avg)
        return avg
