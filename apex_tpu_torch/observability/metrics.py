"""Process-local metrics registry (``apex_tpu/observability/metrics.py``)
with a zero-overhead disabled path.

- **No-op fast path.** The module-level ``_REGISTRY`` is ``None`` until
  :func:`configure` runs; every helper (:func:`counter`, :func:`gauge`,
  :func:`histogram`, :func:`event`, :func:`record_step_metrics`) checks
  it once and hands back the shared :data:`NOOP_METRIC` singleton or
  returns: an instrumented call site costs one ``is None`` check.
- **Step-boundary values.** Device values enter through the metrics
  dict a train step already returns (:func:`record_step_metrics`,
  ``amp.scaler.record_scaler_step``); reading them syncs, as any
  per-step logging does.
- **Rank-tagged.** ``host`` / ``num_hosts`` come from
  ``torch.distributed`` when a process group is up, else 0 of 1 (the
  JAX package's process index on one process).

Record stream: every record is one JSON object with ``schema_version``
(:data:`SCHEMA_VERSION`), ``t`` (unix seconds), ``type`` (``meta`` |
``counter`` | ``gauge`` | ``observe`` | ``span`` | ``event`` |
``sketch`` | ``summary``) and ``name``; records emitted after
:func:`set_step` also carry ``step``.  Gauges, histogram observations
and spans emit on every update; counters and sketches accumulate in
memory and emit cumulative totals on :meth:`MetricsRegistry.flush` (and
at close).  The JSONL, stderr-summary and Chrome-trace sinks, the flight
recorder, the anomaly detectors and the OpenMetrics exporter hang off
the registry as in the JAX package (:func:`configure`).

Beyond the JAX registry the port's keeps the last ``max_events`` events
in memory (:attr:`MetricsRegistry.events`), which
``checkpoint.RecoveryManager`` watches for ``anomaly.*`` firings.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from apex_tpu_torch.observability.sketches import LogBucketSketch

# v3: records may carry "step" (set_step); flush emits "sketch" and
# "summary" records.  Matches the JAX package's stream.
SCHEMA_VERSION = 3

__all__ = [
    "SCHEMA_VERSION",
    "NOOP_METRIC",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Sketch",
    "configure",
    "configure_from_env",
    "counter",
    "enabled",
    "event",
    "gauge",
    "histogram",
    "record_step_metrics",
    "registry",
    "set_step",
    "shutdown",
    "sketch",
]


class _NoopMetric:
    """Shared do-nothing metric: handed out by the module-level helpers
    whenever telemetry is disabled, so ``counter("x").inc()`` is a
    method call on one long-lived singleton (the no-op fast path the
    overhead tier-1 test asserts on)."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, value) -> None:
        pass

    def observe(self, value, **extra) -> None:
        pass


NOOP_METRIC = _NoopMetric()


def _tags_key(tags: Optional[dict]) -> tuple:
    """Tags are a real metric dimension (per-``slo_class`` sketches and
    goodput counters): two call sites naming the same
    metric with different tags get distinct instances, which the
    OpenMetrics exporter renders as one family with distinct label
    sets.  Untagged call sites keep their original identity."""
    return tuple(sorted(tags.items())) if tags else ()


def _summary_key(name: str, tags: Optional[dict]) -> str:
    """Display key for summaries/dumps: ``name`` or
    ``name{k=v,...}`` when tagged."""
    if not tags:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc`` is in-memory only; cumulative totals
    are emitted as records on registry flush/close."""

    __slots__ = ("name", "tags", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 tags: Optional[dict] = None):
        self.name = name
        self.tags = tags
        self.value = 0                 # guarded-by: self._lock
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:   # += is load/add/store; the GIL doesn't cover it
            self.value += n


class Gauge:
    """Last-value-wins scalar; every ``set`` emits a record (gauges are
    the per-step time series — loss scale, grad norm — the report tool
    plots distributions of)."""

    __slots__ = ("name", "tags", "value", "_reg")

    def __init__(self, name: str, reg: "MetricsRegistry",
                 tags: Optional[dict] = None):
        self.name = name
        self.tags = tags
        self.value: Optional[float] = None   # guarded-by: self._reg._lock
        self._reg = reg

    def set(self, value) -> None:
        v = float(value)
        with self._reg._lock:
            self.value = v
        rec = {"type": "gauge", "name": self.name, "value": v}
        if self.tags:
            rec["tags"] = self.tags
        self._reg._emit(rec)   # re-acquires the lock; not held here


class Histogram:
    """Streaming distribution: running count/total plus a bounded window
    (last 4096 observations) for in-process quantiles.  The JSONL stream
    carries every observation, so offline summaries (the report tool)
    are exact; the in-memory window only bounds the live summary."""

    WINDOW = 4096

    __slots__ = ("name", "tags", "record_type", "count", "total", "max",
                 "_window", "_reg")

    def __init__(self, name: str, reg: "MetricsRegistry",
                 tags: Optional[dict] = None, record_type: str = "observe"):
        self.name = name
        self.tags = tags
        self.record_type = record_type
        self.count = 0                       # guarded-by: self._reg._lock
        self.total = 0.0                     # guarded-by: self._reg._lock
        # -inf, not 0.0: a histogram of all-negative observations must
        # report the max it actually saw (summary() maps "never
        # observed" back to 0.0 for display)
        self.max = float("-inf")             # guarded-by: self._reg._lock
        self._window = deque(maxlen=self.WINDOW)   # guarded-by: self._reg._lock
        self._reg = reg

    def observe(self, value, **extra) -> None:
        v = float(value)
        with self._reg._lock:   # stats first, emit after (lock re-entry)
            self.count += 1
            self.total += v
            self.max = max(self.max, v)
            self._window.append(v)
        rec = {"type": self.record_type, "name": self.name, "value": v}
        if self.tags:
            rec["tags"] = self.tags
        if extra:
            rec.update(extra)
        self._reg._emit(rec)

    def quantile(self, q: float) -> float:
        with self._reg._lock:   # snapshot: deques hate concurrent append
            vals = sorted(self._window)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))
        return vals[idx]

    def summary(self) -> dict:
        # observed vs retained: quantiles below are
        # computed over the bounded window; when observed > retained
        # they are NOT exact and every consumer (stderr summary table,
        # flight dumps, the "summary" flush record, the OpenMetrics
        # summary family) can now say so instead of looking exact.
        # count/total/retained snapshot under ONE lock hold, or a
        # concurrent observe between the reads fakes a truncation.
        with self._reg._lock:
            count, total, vmax = self.count, self.total, self.max
            retained = len(self._window)
        return {
            "count": count,
            "observed": count,
            "retained": retained,
            "truncated": count > retained,
            "total": total,
            "mean": total / count if count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "max": vmax if count else 0.0,
        }


class Sketch:
    """Mergeable log-bucket histogram sketch — the registry metric kind
    for high-volume series (per-request serving latencies): bounded
    memory, bounded-relative-error quantiles, exact cross-stream merge
    (:mod:`~apex_tpu_torch.observability.sketches`).

    Unlike :class:`Histogram`, an observation emits **no record** — a
    soak's million TPOT samples must not become a million JSONL lines.
    The serialized sketch state is emitted as one ``sketch`` record per
    flush (cumulative, like counters), which merges exactly across hosts
    and which the OpenMetrics exporter exposes as native histogram
    buckets.
    """

    __slots__ = ("name", "tags", "_sketch", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 tags: Optional[dict] = None):
        self.name = name
        self.tags = tags
        self._sketch = LogBucketSketch()     # guarded-by: self._lock
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
        """Serialized sketch (the ``sketch`` record value)."""
        with self._lock:
            return self._sketch.to_dict()

    def buckets(self):
        """Cumulative ``(le, count)`` buckets (OpenMetrics form)."""
        with self._lock:
            return self._sketch.cumulative_buckets()

    def export(self):
        """(serialized state, cumulative buckets) under ONE lock hold:
        the exporter needs ``_count``/``_sum`` and the bucket series to
        describe the same instant, or a concurrent observe makes the
        scrape violate the OpenMetrics ``_count == +Inf bucket``
        invariant."""
        with self._lock:
            return (self._sketch.to_dict(),
                    self._sketch.cumulative_buckets())


class MetricsRegistry:
    """Process-local registry of named metrics with pluggable sinks.

    Thread-safe for concurrent updates: one lock serializes metric
    creation, value updates (counter incs, gauge sets, histogram
    stats) and sink emission — contention only exists when telemetry
    is on; the disabled fast path never touches it.
    """

    def __init__(self, sinks=(), tags: Optional[dict] = None,
                 profiler: bool = False, max_events: int = 65536):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str], Any] = {}   # guarded-by: self._lock
        self.sinks = list(sinks)
        self.tags = dict(tags or {})
        # Feature flag for profiler annotations: spans consult it and
        # additionally open a torch.profiler.record_function region.
        self.profiler = bool(profiler)
        self._closed = False
        # diagnostics, attached by configure(): a DetectorBank, a
        # FlightRecorder (when a dump path is set) and the live
        # OpenMetrics exporter (when configure(export_port=...) asked
        # for it).  None means absent: feeding call sites None-check.
        self.detectors: Optional[Any] = None
        self.recorder: Optional[Any] = None
        self.exporter: Optional[Any] = None
        # current train-step index; stamped onto every record once known
        self.step: Optional[int] = None
        self._auto_step = 0
        # True once anyone declared a step explicitly (set_step or a
        # metrics dict carrying "step"): the auto-increment fallback
        # then stays out of the way (a loop resumed at step 50k must
        # not be re-stamped 1, 2, 3...)
        self._external_step = False
        # the last max_events events, in memory
        self.events: deque = deque(maxlen=max_events)
        self._emit({"type": "meta", "tags": self.tags, "pid": os.getpid()})

    # -- emission ----------------------------------------------------------

    def _emit(self, rec: dict) -> None:
        if not self.sinks:
            return
        full = {"schema_version": SCHEMA_VERSION, "t": time.time()}
        if self.step is not None:
            full["step"] = self.step
        full.update(rec)
        with self._lock:
            for sink in self.sinks:
                sink.emit(full)

    def set_step(self, step: int) -> None:
        """Declare the current train-step index; subsequent records
        carry ``step`` until the next call.  ``record_step_metrics``
        calls this from the metrics dict's ``step`` entry; loops whose
        step fn reports no index may call it directly (and doing so
        disables the auto-increment fallback — an externally declared
        step is never clobbered)."""
        self.step = int(step)
        self._external_step = True

    # -- metric accessors (get-or-create) ----------------------------------

    def _get(self, kind: str, name: str, factory,
             tags: Optional[dict] = None):
        key = (kind, name, _tags_key(tags))
        # lock-free first probe is the hot-path contract: dict.get on a
        # never-shrinking dict is safe under the GIL, and the miss path
        # double-checks under the lock before inserting
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = factory()
                    self._metrics[key] = m
        return m

    def counter(self, name: str, tags: Optional[dict] = None) -> Counter:
        return self._get("counter", name,
                         lambda: Counter(name, self._lock, tags),
                         tags=tags)

    def gauge(self, name: str, tags: Optional[dict] = None) -> Gauge:
        return self._get("gauge", name, lambda: Gauge(name, self, tags),
                         tags=tags)

    def histogram(self, name: str, tags: Optional[dict] = None,
                  record_type: str = "observe") -> Histogram:
        return self._get(
            f"histogram:{record_type}", name,
            lambda: Histogram(name, self, tags, record_type=record_type),
            tags=tags)

    def sketch(self, name: str, tags: Optional[dict] = None) -> Sketch:
        return self._get("sketch", name,
                         lambda: Sketch(name, self._lock, tags),
                         tags=tags)

    def observe_span(self, name: str, dur_s: float, **extra) -> None:
        """Record one span duration (seconds) — a ``span``-typed
        histogram observation; the span API and StepTimer both land
        here so every timing shares one schema.  Each observation also
        feeds the throughput-regression detector (per-name baselines),
        so a step that silently got slower fires an anomaly."""
        self.histogram(name, record_type="span").observe(dur_s, **extra)
        bank = self.detectors
        if bank is not None:
            bank.feed_step_time(name, dur_s, self.step)

    def event(self, name: str, /, **data) -> None:
        """One-off structured event (e.g. a loss-scale change).
        ``name`` is positional-only so payloads may carry a ``name``
        key of their own."""
        self.events.append({"t": time.time(), "name": name, "data": data})
        self._emit({"type": "event", "name": name, "data": data})

    # -- lifecycle ---------------------------------------------------------

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
            elif isinstance(m, Sketch):
                out["sketches"][key] = m.summary()
        return out

    def snapshot(self) -> list:
        """The live per-metric state the OpenMetrics exporter renders:
        one dict per metric instance (tags preserved as label
        dimensions) — counters/gauges with their value, sketches with
        cumulative buckets, deque histograms as bounded-window
        summaries carrying their truncation accounting."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: list = []
        for m in metrics:
            if isinstance(m, Counter):
                out.append({"kind": "counter", "name": m.name,
                            "tags": m.tags, "value": m.value})
            elif isinstance(m, Gauge):
                out.append({"kind": "gauge", "name": m.name,
                            "tags": m.tags, "value": m.value})
            elif isinstance(m, Sketch):
                s, buckets = m.export()
                out.append({"kind": "sketch", "name": m.name,
                            "tags": m.tags, "count": s["count"],
                            "sum": s["total"],
                            "buckets": buckets})
            elif isinstance(m, Histogram):
                s = m.summary()
                out.append({"kind": "summary", "name": m.name,
                            "tags": m.tags, "observed": s["observed"],
                            "retained": s["retained"],
                            "truncated": s["truncated"],
                            "sum": s["total"], "p50": s["p50"],
                            "p95": s["p95"], "max": s["max"]})
        return out

    def flush(self) -> None:
        """Emit cumulative counter totals, serialized sketch states,
        and per-histogram truncation summaries, then flush every
        sink."""
        with self._lock:
            metrics = list(self._metrics.values())
        for c in (m for m in metrics if isinstance(m, Counter)):
            rec = {"type": "counter", "name": c.name, "value": c.value}
            if c.tags:
                rec["tags"] = c.tags
            self._emit(rec)
        for s in (m for m in metrics if isinstance(m, Sketch)):
            rec = {"type": "sketch", "name": s.name, "value": s.state()}
            if s.tags:
                rec["tags"] = s.tags
            self._emit(rec)
        for h in (m for m in metrics if isinstance(m, Histogram)):
            summ = h.summary()
            rec = {"type": "summary", "name": h.name,
                   "value": {"observed": summ["observed"],
                             "retained": summ["retained"],
                             "truncated": summ["truncated"],
                             "p50": summ["p50"], "p95": summ["p95"]}}
            if h.tags:
                rec["tags"] = h.tags
            self._emit(rec)
        with self._lock:
            for sink in self.sinks:
                sink.flush()

    def close(self) -> None:
        if self._closed:
            return
        if self.exporter is not None:
            # stop serving scrapes before the state they render starts
            # tearing down
            self.exporter.close()
            self.exporter = None
        self.flush()
        self._closed = True
        if self.recorder is not None:
            # before sinks close: the shutdown dump (fires only when
            # anomalies were recorded) snapshots the live summary
            self.recorder.on_shutdown()
        summ = self.summary()
        with self._lock:
            for sink in self.sinks:
                sink.close(summary=summ)


# -- module-level fast path ------------------------------------------------

_REGISTRY: Optional[MetricsRegistry] = None


def enabled() -> bool:
    """True when telemetry is configured; the one check every
    instrumented call site makes."""
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
    """Mergeable log-bucket histogram sketch (bounded memory, exact
    cross-host merge) — use for high-volume series; no-op singleton on
    the disabled fast path (no sketch allocation when telemetry is
    off)."""
    reg = _REGISTRY
    return reg.sketch(name, tags) if reg is not None else NOOP_METRIC


def event(name: str, /, **data) -> None:
    reg = _REGISTRY
    if reg is not None:
        reg.event(name, **data)


def set_step(step: int) -> None:
    """Stamp subsequent records with this train-step index (no-op on
    the disabled fast path)."""
    reg = _REGISTRY
    if reg is not None:
        reg.set_step(step)


def _rank_tags() -> dict:
    """``host`` / ``num_hosts``: this process's rank and the world's size
    (``parallel_state.world_rank`` / ``world_size``; 0 of 1 without a
    process group, the JAX package's tags on one process)."""
    from apex_tpu_torch.transformer import parallel_state

    return {"host": parallel_state.world_rank(),
            "num_hosts": parallel_state.world_size()}


def configure(
    jsonl_path: Optional[str] = None,
    stderr_summary: bool = False,
    profiler: bool = False,
    tags: Optional[dict] = None,
    sinks=(),
    trace_path: Optional[str] = None,
    flight_recorder: Optional[str] = None,
    flight_steps: int = 256,
    dump_on_anomaly: bool = True,
    detectors: bool = True,
    detector_config: Optional[dict] = None,
    export_port: Optional[int] = None,
    max_events: int = 65536,
) -> MetricsRegistry:
    """Enable telemetry for this process; returns the live registry.

    - ``jsonl_path``: append records to this JSONL file.
    - ``stderr_summary``: print a per-metric summary table to stderr at
      shutdown.
    - ``profiler``: spans additionally open a
      ``torch.profiler.record_function`` region, so they show up in
      profiler traces under the same names.
    - ``sinks``: extra sink objects (``emit``/``flush``/``close``).
    - ``trace_path``: mirror the record stream into a Chrome
      trace_events JSON file (open in Perfetto / chrome://tracing —
      :mod:`~apex_tpu_torch.observability.trace`).
    - ``flight_recorder``: dump path for the crash/anomaly post-mortem
      ring buffer (:mod:`~apex_tpu_torch.observability.recorder`);
      ``flight_steps`` bounds the ring, ``dump_on_anomaly`` dumps on
      the first detector firing.
    - ``detectors``: run the step-boundary anomaly detectors
      (loss-spike / grad-norm / NaN-first-seen / scaler-thrash /
      throughput-regression / serving-queue / SLO-violation —
      :mod:`~apex_tpu_torch.observability.detectors`).  ``detector_config``
      overrides thresholds (see ``DetectorBank``).
    - ``export_port``: serve the live registry over HTTP on this
      localhost port (``0`` = ephemeral; read it back from
      ``registry().exporter.port``): ``/metrics`` (OpenMetrics),
      ``/healthz`` (flips 503 on detector firings), ``/statusz``
      (JSON summary) — :mod:`~apex_tpu_torch.observability.exporter`.  When
      absent (the default) no server thread or socket exists.

    - ``max_events``: how many events the registry keeps in memory.

    A previously configured registry is shut down (flushed/closed)
    first, so re-configuration in tests or notebooks is safe.
    """
    global _REGISTRY
    if _REGISTRY is not None:
        shutdown()
    from apex_tpu_torch.observability import sinks as sinks_mod

    sink_list = list(sinks)
    if jsonl_path:
        sink_list.append(sinks_mod.JsonlSink(jsonl_path))
    if stderr_summary:
        sink_list.append(sinks_mod.StderrSummarySink())
    if trace_path:
        from apex_tpu_torch.observability.trace import TraceSink

        sink_list.append(TraceSink(trace_path))
    all_tags = _rank_tags()
    all_tags.update(tags or {})
    reg = MetricsRegistry(sink_list, tags=all_tags, profiler=profiler,
                          max_events=max_events)
    if detectors:
        from apex_tpu_torch.observability.detectors import DetectorBank

        reg.detectors = DetectorBank(reg, detector_config)
    if flight_recorder:
        from apex_tpu_torch.observability.recorder import FlightRecorder

        rec = FlightRecorder(flight_recorder, max_steps=flight_steps,
                             dump_on_anomaly=dump_on_anomaly)
        rec._registry = reg
        rec.install_excepthook()
        reg.recorder = rec
    if export_port is not None:
        # lazy import: the exporter module (and its HTTP machinery)
        # must never load on the unconfigured path
        from apex_tpu_torch.observability.exporter import TelemetryExporter

        reg.exporter = TelemetryExporter(reg, port=export_port)
    _REGISTRY = reg
    return _REGISTRY


# The one authoritative table of APEX_TPU_TELEMETRY_* variables:
# name (sans prefix) -> (kind, configure kwarg, help).  Document new
# variables HERE — configure_from_env validates against this table and
# warns (with the variable name) on anything unknown or malformed
# instead of silently disabling telemetry.
ENV_PREFIX = "APEX_TPU_TELEMETRY"
ENV_VARS = {
    "": ("path", "jsonl_path", "JSONL record-stream file"),
    "_STDERR": ("bool", "stderr_summary",
                "per-metric summary table at shutdown"),
    "_PROFILER": ("bool", "profiler",
                  "torch.profiler span annotations"),
    "_TRACE": ("path", "trace_path",
               "Chrome trace_events JSON timeline (Perfetto)"),
    "_FLIGHT": ("path", "flight_recorder",
                "flight-recorder post-mortem dump path"),
    "_FLIGHT_STEPS": ("int", "flight_steps",
                      "flight-recorder ring size (steps)"),
    "_DETECTORS": ("bool", "detectors",
                   "step-boundary anomaly detectors (default on)"),
    "_PORT": ("int", "export_port",
              "serve /metrics + /healthz + /statusz on this localhost "
              "port (0 = ephemeral)"),
}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")


def _env_warn(msg: str) -> None:
    from apex_tpu_torch.utils.logging import get_logger

    get_logger("observability").warning(msg)


def configure_from_env(env=None) -> Optional[MetricsRegistry]:
    """Configure from ``APEX_TPU_TELEMETRY*`` variables, or return None
    (leaving the no-op fast path in place) when none is set.

    The full variable table is :data:`ENV_VARS`.  Validation policy: an unknown ``APEX_TPU_TELEMETRY_*``
    variable or a malformed value warns *naming the variable* and falls
    back to that option's default — one typo never silently disables
    the rest of the telemetry config.
    """
    env = os.environ if env is None else env
    kwargs: dict = {}
    for suffix, (kind, kwarg, _help) in ENV_VARS.items():
        name = ENV_PREFIX + suffix
        if name not in env:
            continue
        raw = env[name]
        if kind == "path":
            if raw:
                kwargs[kwarg] = raw
            continue
        if kind == "bool":
            low = raw.strip().lower()
            if low in _TRUE:
                kwargs[kwarg] = True
            elif low in _FALSE:
                kwargs[kwarg] = False
            else:
                _env_warn(f"{name}={raw!r} is not a recognized boolean "
                          f"(use one of {_TRUE + _FALSE[:-1]}); "
                          "ignoring it")
            continue
        if kind == "int":
            try:
                kwargs[kwarg] = int(raw)
            except ValueError:
                _env_warn(f"{name}={raw!r} is not an integer; using "
                          "the default")
            continue
    for name in env:
        if (name.startswith(ENV_PREFIX)
                and name[len(ENV_PREFIX):] not in ENV_VARS):
            known = ", ".join(ENV_PREFIX + s for s in ENV_VARS)
            _env_warn(f"unknown telemetry variable {name} (known: "
                      f"{known}); it has no effect")
    # telemetry turns ON only when an output is requested (a sink
    # path, the stderr summary, or the live export port — port 0 means
    # "ephemeral", so it is an is-not-None check, not truthiness);
    # _PROFILER/_DETECTORS/_FLIGHT_STEPS alone only modify a
    # configuration that something else enabled
    if (not any(kwargs.get(k) for k in ("jsonl_path", "trace_path",
                                        "flight_recorder",
                                        "stderr_summary"))
            and kwargs.get("export_port") is None):
        return None
    return configure(**kwargs)


def shutdown() -> None:
    """Flush + close the registry and restore the no-op fast path."""
    global _REGISTRY
    reg, _REGISTRY = _REGISTRY, None
    if reg is not None:
        reg.close()


atexit.register(shutdown)


def record_step_metrics(metrics: dict, prefix: str = "train") -> None:
    """Record a train step's returned metrics dict at the step boundary.

    The step returns its scalars (loss, loss_scale, grad_norm, ...) as
    tensors and the loop feeds them here.  Scalar floats become gauges
    ``<prefix>.<key>``; the ``overflow`` flag becomes the counter
    ``<prefix>.overflow_count``; non-scalars (``aux`` trees) are
    skipped.  Reading the values forces a device sync — which a loop
    that logs per step does anyway.  No-op when telemetry is disabled.

    The step index (``metrics["step"]`` when the step reports one —
    ``amp.frontend.make_train_step`` does — else an internal counter)
    stamps subsequent records; the scalars feed the flight recorder's
    ring buffer and the anomaly detectors (loss-spike / grad-norm /
    NaN-first-seen), so a diverging run fires ``anomaly.*`` events and
    a post-mortem dump with no extra code in the loop.
    """
    reg = _REGISTRY
    if reg is None:
        return
    import numpy as np
    import torch

    scalars: Dict[str, Any] = {}
    for key, val in metrics.items():
        if key == "aux":
            continue
        if torch.is_tensor(val):
            if val.numel() != 1:
                continue
            scalars[key] = val.reshape(()).item()   # one sync a scalar
            continue
        try:
            arr = np.asarray(val)
        except Exception:
            continue
        if arr.size != 1:
            continue
        scalars[key] = arr.reshape(()).item()
    step = scalars.pop("step", None)
    if step is not None:
        reg.set_step(int(step))
    elif not reg._external_step:
        # fallback for loops that neither return nor declare a step:
        # count record_step_metrics calls (direct write — this is not
        # an external declaration and must stay overridable)
        reg._auto_step += 1
        reg.step = reg._auto_step
    for key, v in scalars.items():
        if key == "overflow" or isinstance(v, bool):
            reg.counter(f"{prefix}.{key}_count").inc(int(bool(v)))
        else:
            reg.gauge(f"{prefix}.{key}").set(float(v))
    # a DDP step pmeans its metrics, so "overflow" may arrive as a
    # float — normalize it out of the detector value set either way
    overflow = bool(scalars.get("overflow", False))
    float_scalars = {k: float(v) for k, v in scalars.items()
                     if not isinstance(v, bool) and k != "overflow"}
    recorder = reg.recorder
    if recorder is not None:
        row = dict(float_scalars)
        if "overflow" in scalars:
            row["overflow"] = overflow
        # cumulative comm wire bytes, when the comm layer is active —
        # cheap in-memory counter reads, no device traffic
        for cname in ("collectives.compressed.bytes",
                      "collectives.compressed.raw_bytes"):
            c = reg._metrics.get(("counter", cname, ()))
            if c is not None:
                row[cname.rsplit(".", 1)[-1] + "_comm"] = c.value
        recorder.record_step(reg.step, row)
    # NOTE: the scaler-thrash detector is fed by
    # amp.scaler.record_scaler_step (the AMP entry point owns the
    # overflow stream) — feeding it here too would double-count loops
    # that call both.
    bank = reg.detectors
    if bank is not None:
        bank.feed_step(reg.step, float_scalars, overflow=overflow)
