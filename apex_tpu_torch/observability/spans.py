"""Named timing regions (``apex_tpu/observability/spans.py``'s
``span``): ``with span("serving.prefill"): ...`` records the region's
host-clock seconds into the histogram ``name`` when telemetry is
configured, and takes no timestamp when it is not."""

from __future__ import annotations

import threading
import time
from contextlib import ContextDecorator
from typing import Optional

from apex_tpu_torch.observability import metrics as _metrics

__all__ = ["span"]


class span(ContextDecorator):
    """Context manager and decorator; nested and per-thread entries keep
    their own start times."""

    def __init__(self, name: str, tags: Optional[dict] = None):
        self.name = name
        self.tags = tags
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def __enter__(self):
        self._stack().append(time.perf_counter() if _metrics.enabled()
                             else None)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = self._stack()
        t0 = stack.pop() if stack else None
        reg = _metrics.registry()
        if t0 is not None and reg is not None:
            reg.histogram(self.name, self.tags).observe(
                time.perf_counter() - t0)
        return False
