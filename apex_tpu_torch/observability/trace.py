"""Chrome ``trace_events`` / Perfetto export of the telemetry stream
(``apex_tpu/observability/trace.py``, copied, not imported).

:class:`TraceSink` is a registry sink (``emit``/``flush``/``close``)
that mirrors every record into the Chrome trace-event JSON format, so
one training or serving run produces a timeline openable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` — spans and StepTimer
iterations as duration slices, gauges/counter flushes/histogram
observations as counter tracks, events as instants, and paired
``<name>.begin`` / ``<name>.end`` events (with an ``id``) as async
rows — the serving engine emits those per request, so overlapping
in-flight requests render as separate sub-rows instead of a garbled
slice stack.

Enable with ``configure(trace_path="trace.json")`` or
``APEX_TPU_TELEMETRY_TRACE=<path>``.

Layout: one Perfetto *process* per rank (``pid`` = the registry's
``host`` tag), one *thread row* per top-level metric family (the first
dotted component of the name: ``step``, ``serving``, ``train``, ...),
named via metadata events.  Timestamps are wall-clock microseconds
(``record.t``); a span's slice starts at ``t - value`` (records are
emitted at span *exit* carrying the duration).

Crash-robust by format choice: the file is the JSON *array* form of
the spec (events streamed one per line, each write flushed); the
trailing ``]`` is optional in that form, so a run that dies mid-step
still leaves a loadable trace.  :func:`load_trace` reads both the
array and the ``{"traceEvents": [...]}`` object form, tolerating the
truncated tail.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from apex_tpu_torch.observability.sinks import _json_default, sanitize_json

__all__ = ["TraceSink", "load_trace"]

# categories for records that are values-over-time, not slices
_COUNTER_TYPES = ("gauge", "counter", "observe")


def _json(obj) -> str:
    # sanitize_json: Perfetto/chrome://tracing use strict JSON.parse
    return json.dumps(sanitize_json(obj), separators=(",", ":"),
                      default=_json_default)


class TraceSink:
    """Stream telemetry records into a Chrome trace-event JSON file."""

    def __init__(self, path: str):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._f = open(path, "w")
        self._f.write("[\n")
        self._first = True
        self._pid = 0
        self._tids: Dict[str, int] = {}
        self._named_pid = False

    # -- event plumbing ----------------------------------------------------

    def _write(self, ev: dict) -> None:
        prefix = "" if self._first else ",\n"
        self._first = False
        self._f.write(prefix + _json(ev))
        self._f.flush()

    def _tid(self, name: str) -> int:
        """Stable thread row per top-level name family."""
        family = name.split(".", 1)[0]
        tid = self._tids.get(family)
        if tid is None:
            tid = self._tids[family] = len(self._tids) + 1
            self._write({"ph": "M", "name": "thread_name",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": family}})
        return tid

    # -- sink protocol -----------------------------------------------------

    def emit(self, record: dict) -> None:
        rtype = record.get("type")
        t_us = float(record.get("t", 0.0)) * 1e6
        name = record.get("name", "")
        if rtype == "meta":
            tags = record.get("tags") or {}
            try:
                # the registry's rank tag; a user-supplied non-numeric
                # "host" tag must not kill configure()
                self._pid = int(tags.get("host", 0))
            except (TypeError, ValueError):
                self._pid = 0
            label = f"rank{self._pid} apex_tpu"
            if not self._named_pid:
                self._named_pid = True
                self._write({"ph": "M", "name": "process_name",
                             "pid": self._pid, "tid": 0,
                             "args": {"name": label}})
            return
        if rtype == "span":
            dur_us = max(0.0, float(record.get("value", 0.0)) * 1e6)
            args = {k: v for k, v in record.items()
                    if k not in ("schema_version", "t", "type", "name",
                                 "value")}
            args["dur_s"] = record.get("value")
            self._write({"ph": "X", "name": name, "cat": "span",
                         "pid": self._pid, "tid": self._tid(name),
                         "ts": t_us - dur_us, "dur": dur_us,
                         "args": args})
            return
        if rtype in _COUNTER_TYPES:
            try:
                value = float(record.get("value"))
            except (TypeError, ValueError):
                return
            tags = record.get("tags")
            if tags:
                # tags are a metric dimension (per-slo_class goodput
                # counters): without the suffix every class would fold
                # into one counter track.  Same key format as the
                # registry's summaries and dumps.
                from apex_tpu_torch.observability.metrics import _summary_key

                name = _summary_key(name, tags)
            self._write({"ph": "C", "name": name, "cat": rtype,
                         "pid": self._pid, "tid": 0, "ts": t_us,
                         "args": {"value": value}})
            return
        if rtype == "event":
            data = record.get("data") or {}
            for suffix, ph in ((".begin", "b"), (".end", "e")):
                if name.endswith(suffix) and "id" in data:
                    base = name[: -len(suffix)]
                    self._write({
                        "ph": ph, "name": base, "cat": base,
                        "id": data["id"], "pid": self._pid,
                        "tid": self._tid(base), "ts": t_us,
                        "args": dict(data)})
                    return
            self._write({"ph": "i", "name": name, "cat": "event",
                         "s": "p", "pid": self._pid,
                         "tid": self._tid(name), "ts": t_us,
                         "args": dict(data)})

    def flush(self) -> None:
        self._f.flush()

    def close(self, summary: Optional[dict] = None) -> None:
        self._f.write("\n]\n")
        self._f.flush()
        self._f.close()


def load_trace(path: str) -> List[dict]:
    """Read a trace file back into its event list — both the object
    form (``{"traceEvents": [...]}``) and the array form this sink
    writes, including a crash-truncated array (trailing ``]`` missing
    or a final half-written line)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        # truncated array form: parse line-by-line, drop the bad tail
        events = []
        for line in text.splitlines():
            line = line.strip().rstrip(",")
            if line in ("[", "]", ""):
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
        return events
    if isinstance(doc, dict):
        return list(doc.get("traceEvents", []))
    return list(doc)
