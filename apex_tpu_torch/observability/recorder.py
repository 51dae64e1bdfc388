"""Flight recorder (``apex_tpu/observability/recorder.py``, copied, not
imported): a bounded ring of recent steps and a crash post-mortem.

The last ``max_steps`` step boundaries' scalar metrics (loss, loss scale,
grad/update norms, step time, comm bytes: whatever the step returned),
every anomaly the detectors fired and the registry's live summary, all
dumped as ONE JSON file

- on crash (a ``sys.excepthook`` chain installed at configure time; the
  dump happens before the traceback prints),
- at shutdown when anomalies fired during the run (quiet runs leave no
  artifact),
- or on demand (:meth:`FlightRecorder.dump`).

Feeding is automatic: ``metrics.record_step_metrics`` appends each
step's scalars, and the detectors notify on every firing (the first
anomaly dumps at once when ``dump_on_anomaly``).  The JAX dump's
``runtime`` section (compile and HBM accounting from ``jax.monitoring``)
has no torch counterpart and is left out.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "DUMP_SCHEMA_VERSION"]

DUMP_SCHEMA_VERSION = 1


class FlightRecorder:
    """Bounded ring buffer of step records with post-mortem dumping.

    ``path`` is where :meth:`dump` writes by default (parent dirs are
    created).  ``max_steps`` bounds the ring.  ``dump_on_anomaly``
    dumps on the FIRST detector firing (later firings are recorded in
    the anomaly log but do not re-dump — one incident, one artifact;
    the shutdown/crash dump carries the full log)."""

    def __init__(self, path: str, *, max_steps: int = 256,
                 dump_on_anomaly: bool = True):
        self.path = path
        self.max_steps = int(max_steps)
        self.dump_on_anomaly = bool(dump_on_anomaly)
        self.steps: deque = deque(maxlen=self.max_steps)
        self.anomalies: List[dict] = []
        self.first_anomaly: Optional[dict] = None
        self.last_dump_path: Optional[str] = None
        self._dumped_for_anomaly = False
        self._registry = None          # set by metrics.configure
        self._prev_excepthook = None
        self._t0 = time.time()

    # -- feeding -----------------------------------------------------------

    def record_step(self, step: Optional[int],
                    values: Dict[str, Any]) -> None:
        rec = {"t": time.time(), "step": step}
        rec.update(values)
        self.steps.append(rec)

    def note_anomaly(self, anomaly) -> None:
        """Detector callback (``DetectorBank._fire``): log it, dump the
        post-mortem on first blood."""
        d = anomaly.to_dict() if hasattr(anomaly, "to_dict") else dict(
            anomaly)
        d["t"] = time.time()
        if self.first_anomaly is None:
            self.first_anomaly = d
        if len(self.anomalies) < 1024:
            self.anomalies.append(d)
        if self.dump_on_anomaly and not self._dumped_for_anomaly:
            self._dumped_for_anomaly = True
            self.dump(reason=f"anomaly:{d.get('kind', 'unknown')}")

    # -- dumping -----------------------------------------------------------

    def snapshot(self, reason: str = "on_demand",
                 error: Optional[str] = None) -> dict:
        """The post-mortem document (dumped as JSON)."""
        doc: dict = {
            "dump_schema_version": DUMP_SCHEMA_VERSION,
            "reason": reason,
            "t": time.time(),
            "run_started_t": self._t0,
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "first_anomaly": self.first_anomaly,
            "first_anomalous_step": (
                self.first_anomaly.get("step")
                if self.first_anomaly else None),
            "anomalies": list(self.anomalies),
            "steps": list(self.steps),
        }
        if error is not None:
            doc["error"] = error
        reg = self._registry
        if reg is not None:
            try:
                doc["metrics_summary"] = reg.summary()
            except Exception:   # a dying process still gets the ring
                pass
            bank = getattr(reg, "detectors", None)
            if bank is not None:
                doc["detector_summary"] = bank.summary()
            if reg.tags:
                doc["tags"] = dict(reg.tags)
        return doc

    def dump(self, path: Optional[str] = None, reason: str = "on_demand",
             error: Optional[str] = None) -> Optional[str]:
        """Write the post-mortem JSON; returns the path (None if the
        write itself failed — a crash handler must not raise)."""
        from apex_tpu_torch.observability.sinks import sanitize_json

        path = path or self.path
        try:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                # sanitize_json: a NaN loss in the ring must not turn
                # the post-mortem into invalid strict JSON (jq /
                # JSON.parse reject bare NaN tokens)
                json.dump(
                    sanitize_json(self.snapshot(reason=reason,
                                                error=error)),
                    f, indent=1, default=str)
            os.replace(tmp, path)   # atomic: never a half-written dump
        except Exception:
            return None
        self.last_dump_path = path
        from apex_tpu_torch.utils.logging import get_logger

        get_logger("observability").warning(
            "flight recorder dumped post-mortem (%s) to %s", reason, path)
        return path

    # -- lifecycle hooks (installed by metrics.configure) ------------------

    def install_excepthook(self) -> None:
        if self._prev_excepthook is not None:
            return
        self._prev_excepthook = sys.excepthook

        def hook(exc_type, exc, tb):
            # same preservation rule as on_shutdown: never clobber an
            # incident-time dump with its aftermath
            path = (self.final_path() if self._dumped_for_anomaly
                    else self.path)
            self.dump(path=path, reason="crash",
                      error=f"{exc_type.__name__}: {exc}")
            (self._prev_excepthook or sys.__excepthook__)(
                exc_type, exc, tb)

        sys.excepthook = hook

    def uninstall_excepthook(self) -> None:
        if self._prev_excepthook is None:
            return
        # only restore if nobody chained on top of us meanwhile —
        # getattr: a foreign hook may be a partial/callable object
        # with no __qualname__ at all
        if getattr(sys.excepthook, "__qualname__", "").startswith(
                "FlightRecorder.install_excepthook"):
            sys.excepthook = self._prev_excepthook
        self._prev_excepthook = None

    def final_path(self) -> str:
        """Where the shutdown dump lands when an incident dump already
        occupies ``self.path``: overwriting it would destroy the ring
        window that *bracketed* the first anomaly (a run that outlives
        the incident by more than ``max_steps`` only has its aftermath
        left in memory)."""
        root, ext = os.path.splitext(self.path)
        return f"{root}.final{ext or '.json'}"

    def on_shutdown(self) -> None:
        """Registry close: persist the post-mortem iff something fired
        (quiet runs leave no artifact).  The incident-time dump, when
        one was written, is preserved — the shutdown dump goes to
        :meth:`final_path` beside it."""
        self.uninstall_excepthook()
        if self.anomalies:
            path = (self.final_path() if self._dumped_for_anomaly
                    else self.path)
            self.dump(path=path, reason="shutdown_with_anomalies")
