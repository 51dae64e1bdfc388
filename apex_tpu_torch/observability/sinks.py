"""Telemetry sinks (``apex_tpu/observability/sinks.py``, stdlib only;
copied, not imported): where the registry's record stream lands.

Sink protocol (duck-typed): ``emit(record: dict)``, ``flush()``,
``close(summary: dict | None)``.  Sinks only run when telemetry is
configured.  The JAX package's third sink, ``jax.profiler`` trace
annotations, is the registry's ``profiler=True`` flag; in the port a
span then opens a ``torch.profiler.record_function`` region instead
(:mod:`~apex_tpu_torch.observability.spans`).
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional

__all__ = ["JsonlSink", "StderrSummarySink", "sanitize_json"]


def _json_default(obj):
    # numpy or torch scalars that slipped into event payloads
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


def sanitize_json(obj):
    """Strict-JSON (RFC 8259) form: Python's json writes bare ``NaN`` /
    ``Infinity`` tokens that Perfetto, jq and ``JSON.parse`` reject, and
    a NaN loss is exactly what the trace and the flight dump must
    survive.  Non-finite floats become their repr strings."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj


class JsonlSink:
    """Append one JSON object per record to a file, flushed on every
    write (a post-mortem reads what a dying run left)."""

    def __init__(self, path: str):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def emit(self, record: dict) -> None:
        self._f.write(
            json.dumps(record, separators=(",", ":"),
                       default=_json_default) + "\n")
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self, summary: Optional[dict] = None) -> None:
        self._f.flush()
        self._f.close()


class StderrSummarySink:
    """Print a per-metric summary table at close (``sys.stderr`` is
    resolved at write time, so capture and late redirection see it)."""

    def emit(self, record: dict) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self, summary: Optional[dict] = None) -> None:
        if not summary:
            return
        out = sys.stderr
        print("== telemetry summary ==", file=out)
        hists = summary.get("histograms", {})
        if hists:
            print(f"{'span/observation':<40} {'count':>7} {'total_s':>10} "
                  f"{'mean':>10} {'p50':>10} {'p95':>10}", file=out)
            truncated = False
            for name in sorted(hists):
                s = hists[name]
                # '*': quantiles over the retained window only
                mark = "*" if s.get("truncated") else " "
                truncated = truncated or s.get("truncated", False)
                print(f"{name:<39}{mark} {s['count']:>7} "
                      f"{s['total']:>10.4g} "
                      f"{s['mean']:>10.4g} {s['p50']:>10.4g} "
                      f"{s['p95']:>10.4g}", file=out)
            if truncated:
                print("(* = p50/p95 over the retained window only — "
                      "the JSONL stream is exact)", file=out)
        sketches = summary.get("sketches", {})
        if sketches:
            print(f"{'sketch':<40} {'count':>7} {'p50':>10} "
                  f"{'p95':>10} {'p99':>10}", file=out)
            for name in sorted(sketches):
                s = sketches[name]
                print(f"{name:<40} {s['count']:>7} {s['p50']:>10.4g} "
                      f"{s['p95']:>10.4g} {s['p99']:>10.4g}", file=out)
        counters = summary.get("counters", {})
        if counters:
            print(f"{'counter':<40} {'total':>12}", file=out)
            for name in sorted(counters):
                print(f"{name:<40} {counters[name]:>12}", file=out)
        gauges = summary.get("gauges", {})
        if gauges:
            print(f"{'gauge':<40} {'last':>12}", file=out)
            for name in sorted(gauges):
                v = gauges[name]
                v = "n/a" if v is None else f"{v:.6g}"
                print(f"{name:<40} {v:>12}", file=out)
