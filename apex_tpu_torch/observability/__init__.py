"""apex_tpu_torch.observability (``apex_tpu/observability``): a
process-local registry of counters, gauges, histograms and mergeable SLO
sketches with pluggable sinks (JSONL, stderr summary, Chrome trace), the
flight recorder, the step-boundary anomaly detectors, the live
OpenMetrics exporter (``/metrics``, ``/healthz``, ``/statusz``),
``span`` / ``StepTimer`` / ``fence``, and device-memory gauges.  A no-op
until :func:`configure` (or :func:`configure_from_env`) runs.

The JAX package's recompilation tracker (``install_recompile_tracker``,
``recompile_tracker``, ``runtime_summary``) reads ``jax.monitoring`` and
has no counterpart here; the compiled ladder's hit and miss counters
(``serving/compile_cache``) play its part for the serving engine."""

from apex_tpu_torch.observability.device import (  # noqa: F401
    compile_label, sample_device_memory)
from apex_tpu_torch.observability.metrics import (  # noqa: F401
    SCHEMA_VERSION, MetricsRegistry, configure, configure_from_env, counter,
    enabled, event, gauge, histogram, record_step_metrics, registry,
    set_step, shutdown, sketch)
from apex_tpu_torch.observability.sketches import LogBucketSketch  # noqa: F401
from apex_tpu_torch.observability.recorder import FlightRecorder  # noqa: F401
from apex_tpu_torch.observability.sinks import (  # noqa: F401
    JsonlSink, StderrSummarySink)
from apex_tpu_torch.observability.spans import (  # noqa: F401
    StepTimer, fence, span)
from apex_tpu_torch.observability.trace import (  # noqa: F401
    TraceSink, load_trace)

__all__ = ["SCHEMA_VERSION", "FlightRecorder", "JsonlSink",
           "LogBucketSketch", "MetricsRegistry", "StderrSummarySink",
           "StepTimer", "TraceSink", "compile_label", "configure",
           "configure_from_env", "counter", "enabled", "event", "fence",
           "gauge", "histogram", "load_trace", "record_step_metrics",
           "registry", "sample_device_memory", "set_step", "shutdown",
           "sketch", "span"]
