"""apex_tpu_torch.observability — the metrics the serving engine emits
(``apex_tpu/observability``, the subset the engine reports into): a
process-local registry of counters, gauges, histograms and mergeable
SLO sketches, ``span``, and device-memory gauges.  A no-op until
:func:`configure` runs.  Exporter, sinks, detectors and trace export are
not ported yet."""

from apex_tpu_torch.observability.device import (  # noqa: F401
    compile_label, sample_device_memory)
from apex_tpu_torch.observability.metrics import (  # noqa: F401
    MetricsRegistry, configure, counter, enabled, event, gauge, histogram,
    registry, shutdown, sketch)
from apex_tpu_torch.observability.sketches import LogBucketSketch  # noqa: F401
from apex_tpu_torch.observability.spans import span  # noqa: F401

__all__ = ["LogBucketSketch", "MetricsRegistry", "compile_label",
           "configure", "counter", "enabled", "event", "gauge",
           "histogram", "registry", "sample_device_memory", "shutdown",
           "sketch", "span"]
