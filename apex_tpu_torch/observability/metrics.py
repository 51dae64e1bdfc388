"""Process-local metrics registry (``apex_tpu/observability/metrics.py``),
the part the serving engine reports into.

Counters, gauges, windowed histograms and the mergeable SLO sketches
(:mod:`~apex_tpu_torch.observability.sketches`), tagged like the JAX
package's, plus a bounded ring of structured events.  Nothing is
recorded until :func:`configure` runs: every module-level accessor then
hands back one shared no-op metric, so an instrumented call site costs
one ``is None`` check.  Sinks, the exporter and the anomaly detectors of
the JAX package are not ported yet; :meth:`MetricsRegistry.summary`
reads the state in process.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from apex_tpu_torch.observability.sketches import LogBucketSketch

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Sketch",
           "configure", "counter", "enabled", "event", "gauge",
           "histogram", "registry", "shutdown", "sketch"]


class _NoopMetric:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, value) -> None:
        pass

    def observe(self, value, **extra) -> None:
        pass


NOOP_METRIC = _NoopMetric()


def _tags_key(tags: Optional[dict]) -> tuple:
    return tuple(sorted(tags.items())) if tags else ()


def _summary_key(name: str, tags: Optional[dict]) -> str:
    if not tags:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, lock: threading.Lock,
                 tags: Optional[dict] = None):
        self.name, self.tags, self.value = name, tags, 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-value-wins scalar."""

    def __init__(self, name: str, tags: Optional[dict] = None):
        self.name, self.tags = name, tags
        self.value: Optional[float] = None

    def set(self, value) -> None:
        self.value = float(value)


class Histogram:
    """Running count/total/max plus the last 4096 observations for
    in-process quantiles."""

    WINDOW = 4096

    def __init__(self, name: str, lock: threading.Lock,
                 tags: Optional[dict] = None):
        self.name, self.tags = name, tags
        self.count, self.total, self.max = 0, 0.0, float("-inf")
        self._window = deque(maxlen=self.WINDOW)
        self._lock = lock

    def observe(self, value, **extra) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.max = max(self.max, v)
            self._window.append(v)

    def quantile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))]

    def summary(self) -> dict:
        with self._lock:
            count, total, vmax = self.count, self.total, self.max
            retained = len(self._window)
        return {"count": count, "retained": retained,
                "truncated": count > retained, "total": total,
                "mean": total / count if count else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "max": vmax if count else 0.0}


class Sketch:
    """Mergeable log-bucket sketch: bounded memory, bounded relative
    error, exact merge across streams."""

    def __init__(self, name: str, lock: threading.Lock,
                 tags: Optional[dict] = None):
        self.name, self.tags = name, tags
        self._sketch = LogBucketSketch()
        self._lock = lock

    def observe(self, value, **extra) -> None:
        with self._lock:
            self._sketch.observe(float(value))

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._sketch.quantile(q)

    def summary(self) -> dict:
        with self._lock:
            return self._sketch.summary()

    def state(self) -> dict:
        with self._lock:
            return self._sketch.to_dict()


class MetricsRegistry:
    """Named metrics (get-or-create, keyed by kind, name and tags) and
    the last ``max_events`` events."""

    def __init__(self, tags: Optional[dict] = None, max_events: int = 65536):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, tuple], object] = {}
        self.tags = dict(tags or {})
        self.events: deque = deque(maxlen=max_events)

    def _get(self, kind: str, name: str, factory, tags):
        key = (kind, name, _tags_key(tags))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, factory())
        return m

    def counter(self, name: str, tags: Optional[dict] = None) -> Counter:
        return self._get("counter", name,
                         lambda: Counter(name, self._lock, tags), tags)

    def gauge(self, name: str, tags: Optional[dict] = None) -> Gauge:
        return self._get("gauge", name, lambda: Gauge(name, tags), tags)

    def histogram(self, name: str, tags: Optional[dict] = None) -> Histogram:
        return self._get("histogram", name,
                         lambda: Histogram(name, self._lock, tags), tags)

    def sketch(self, name: str, tags: Optional[dict] = None) -> Sketch:
        return self._get("sketch", name,
                         lambda: Sketch(name, self._lock, tags), tags)

    def event(self, name: str, /, **data) -> None:
        self.events.append({"t": time.time(), "name": name, "data": data})

    def summary(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "sketches": {}}
        for m in metrics:
            key = _summary_key(m.name, m.tags)
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][key] = m.summary()
            else:
                out["sketches"][key] = m.summary()
        return out


_REGISTRY: Optional[MetricsRegistry] = None


def configure(tags: Optional[dict] = None,
              max_events: int = 65536) -> MetricsRegistry:
    """Start recording (replacing any earlier registry)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry(tags, max_events)
    return _REGISTRY


def shutdown() -> None:
    """Stop recording; the accessors go back to the no-op metric."""
    global _REGISTRY
    _REGISTRY = None


def enabled() -> bool:
    return _REGISTRY is not None


def registry() -> Optional[MetricsRegistry]:
    return _REGISTRY


def counter(name: str, tags: Optional[dict] = None):
    reg = _REGISTRY
    return reg.counter(name, tags) if reg is not None else NOOP_METRIC


def gauge(name: str, tags: Optional[dict] = None):
    reg = _REGISTRY
    return reg.gauge(name, tags) if reg is not None else NOOP_METRIC


def histogram(name: str, tags: Optional[dict] = None):
    reg = _REGISTRY
    return reg.histogram(name, tags) if reg is not None else NOOP_METRIC


def sketch(name: str, tags: Optional[dict] = None):
    reg = _REGISTRY
    return reg.sketch(name, tags) if reg is not None else NOOP_METRIC


def event(name: str, /, **data) -> None:
    reg = _REGISTRY
    if reg is not None:
        reg.event(name, **data)
