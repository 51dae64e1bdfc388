"""Anomaly detectors fed at step boundaries
(``apex_tpu/observability/detectors.py``, copied, not imported).

A NaN surfaces steps after its cause, a thrashing loss scaler halves
throughput with no signal, and a silent retrace looks like "the step got
slow" — all of them are visible *in the values a step already returns*
if something is watching.  This module is that something: a bank of
host-side detectors fed from the metrics dict at each step boundary
(``metrics.record_step_metrics`` / ``amp.scaler.record_scaler_step`` /
``StepTimer`` feed it automatically; nothing here runs on the device,
and nothing here forces a device sync the feeding call site did not
already pay).

Detectors:

- :class:`ZScoreDetector` — loss-spike and grad-norm-explosion: the
  current value against the mean/std of a trailing window (current value
  excluded), firing when ``|z| > threshold`` once the window is warm.
- :class:`NanInfDetector` — NaN/Inf **first-seen attribution**: watches
  every scalar the step returns (loss, grad/update/param norms, ...) and
  fires ONCE naming the first step and the first key(s) that went
  non-finite — the norm telemetry usually implicates ``grad_norm`` a
  step before the loss shows it.
- :class:`ScalerThrashDetector` — overflow-rate over a sliding window:
  a healthy dynamic scaler overflows rarely; a thrashing one (scale too
  high for the loss landscape, or real divergence) alternates
  overflow/recover and silently skips a large fraction of steps.
- :class:`ThroughputRegressionDetector` — step-time regression against
  the rolling baseline of earlier ``StepTimer`` history (a silent
  retrace or HBM-pressure spill shows up here first).
- :class:`QueueStallDetector` — serving-side: queue depth growing while
  cache slots sit free (an admission stall), or a sustained backlog.
- :class:`SLOViolationDetector` — serving-side: per-class
  missed-deadline rate over a sliding window of completed requests;
  the engine feeds every completion's goodput verdict (met/missed
  against the class's TTFT/TPOT deadlines), and a class missing more
  than the threshold fraction fires once (with hysteresis) instead of
  once per late request.
- :class:`PoolStallDetector` — cluster-side: consecutive
  RPC failures against a named worker pool (a prefill or decode pool
  of the disaggregated serving tier).  The router feeds every
  dispatch/poll outcome; ``threshold`` consecutive failures on one
  pool fire a ``pool_stall`` anomaly — which latches ``/healthz`` to
  503, the signal a load balancer or autoscaler acts on — and the
  pool re-arms only after the same number of consecutive successes.

Every firing becomes an ``anomaly.<kind>`` event in the telemetry
stream, increments ``anomaly.count``, and notifies the flight recorder
(which can dump a post-mortem on first blood —
:mod:`apex_tpu_torch.observability.recorder`).  Detectors only exist when
telemetry is configured; the disabled fast path never constructs them.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "Anomaly",
    "DetectorBank",
    "NanInfDetector",
    "PoolStallDetector",
    "QueueStallDetector",
    "SLOViolationDetector",
    "ScalerThrashDetector",
    "ThroughputRegressionDetector",
    "ZScoreDetector",
]


class Anomaly:
    """One detector firing: what, when, and the evidence."""

    __slots__ = ("kind", "step", "message", "detail")

    def __init__(self, kind: str, step: Optional[int], message: str,
                 detail: Optional[dict] = None):
        self.kind = kind
        self.step = step
        self.message = message
        self.detail = dict(detail or {})

    def to_dict(self) -> dict:
        return {"kind": self.kind, "step": self.step,
                "message": self.message, "detail": self.detail}

    def __repr__(self):   # pragma: no cover - debugging aid
        return f"Anomaly({self.kind!r}, step={self.step}, {self.message!r})"


class _Window:
    """Bounded sample window with O(1) running mean/variance."""

    __slots__ = ("_buf", "_sum", "_sumsq")

    def __init__(self, maxlen: int):
        self._buf = deque(maxlen=maxlen)
        self._sum = 0.0
        self._sumsq = 0.0

    def push(self, v: float) -> None:
        if len(self._buf) == self._buf.maxlen:
            old = self._buf[0]
            self._sum -= old
            self._sumsq -= old * old
        self._buf.append(v)
        self._sum += v
        self._sumsq += v * v

    def __len__(self):
        return len(self._buf)

    def mean(self) -> float:
        return self._sum / len(self._buf) if self._buf else 0.0

    def std(self) -> float:
        n = len(self._buf)
        if n < 2:
            return 0.0
        var = max(0.0, self._sumsq / n - (self._sum / n) ** 2)
        return math.sqrt(var)


class ZScoreDetector:
    """Fire when a value departs the trailing window by > ``threshold``
    standard deviations (the window excludes the current value, so a
    spike cannot hide inside its own statistics).  ``min_points`` warms
    the window before the first verdict; a relative floor
    (``min_relative``, vs the window mean's magnitude) suppresses
    z-score blowups on near-constant series where std ~ 0."""

    def __init__(self, key: str, kind: str, *, window: int = 64,
                 threshold: float = 6.0, min_points: int = 8,
                 min_relative: float = 0.1):
        self.key = key
        self.kind = kind
        self.threshold = float(threshold)
        self.min_points = int(min_points)
        self.min_relative = float(min_relative)
        self._win = _Window(window)

    def feed(self, step: Optional[int],
             values: Dict[str, float]) -> Optional[Anomaly]:
        v = values.get(self.key)
        if v is None or not math.isfinite(v):
            return None   # the NaN detector owns non-finite attribution
        out = None
        if len(self._win) >= self.min_points:
            mean, std = self._win.mean(), self._win.std()
            floor = self.min_relative * max(abs(mean), 1e-12)
            z = (v - mean) / max(std, 1e-12)
            if abs(z) > self.threshold and abs(v - mean) > floor:
                out = Anomaly(
                    self.kind, step,
                    f"{self.key}={v:.6g} is {z:+.1f} sigma from the "
                    f"trailing mean {mean:.6g} (window {len(self._win)})",
                    {"key": self.key, "value": v, "z": round(z, 2),
                     "mean": mean, "std": std})
        self._win.push(v)
        return out


class NanInfDetector:
    """First-seen NaN/Inf attribution across every scalar the step
    returns.  Fires once (further steps are poisoned by definition)
    naming the step and the offending key(s) — with norm telemetry on,
    ``grad_norm`` usually goes non-finite before the loss does.

    Scaler-aware: on a step the dynamic loss scaler SKIPPED
    (``overflow=True``) non-finite grad/update norms are the system
    *working* — bf16 training overflows by design until the scale
    settles — so only the loss (computed before scaling) is checked
    there.  A clean step (``overflow=False``) checks everything."""

    def __init__(self):
        self.fired = False

    def feed(self, step: Optional[int], values: Dict[str, float],
             overflow: bool = False) -> Optional[Anomaly]:
        if self.fired:
            return None
        watched = ("loss",) if overflow else tuple(values)
        bad = sorted(k for k in watched
                     if isinstance(values.get(k), float)
                     and not math.isfinite(values[k]))
        if not bad:
            return None
        self.fired = True
        return Anomaly(
            "nan_inf", step,
            f"first non-finite value at step {step}: "
            f"{', '.join(f'{k}={values[k]}' for k in bad)}",
            {"keys": bad, "overflow_step": bool(overflow),
             "values": {k: repr(values[k]) for k in bad}})


class ScalerThrashDetector:
    """Overflow-rate window over the loss scaler's skip decisions.

    A healthy dynamic scaler overflows on a tiny fraction of steps; a
    rate above ``rate_threshold`` over the last ``window`` steps means
    the scaler is thrashing (halve/skip/double cycling) and silently
    discarding work.  Hysteresis: after firing, the detector re-arms
    only once the rate falls below half the threshold, so a sustained
    thrash is one anomaly, not one per step."""

    def __init__(self, *, window: int = 32, rate_threshold: float = 0.25,
                 min_points: int = 8):
        self.rate_threshold = float(rate_threshold)
        self.min_points = int(min_points)
        self._win: deque = deque(maxlen=window)
        self._armed = True

    def feed(self, step: Optional[int],
             overflow: bool) -> Optional[Anomaly]:
        self._win.append(bool(overflow))
        if len(self._win) < self.min_points:
            return None
        rate = sum(self._win) / len(self._win)
        if not self._armed:
            if rate < self.rate_threshold / 2:
                self._armed = True
            return None
        if rate >= self.rate_threshold:
            self._armed = False
            return Anomaly(
                "scaler_thrash", step,
                f"loss scaler overflowed on {rate:.0%} of the last "
                f"{len(self._win)} steps (threshold "
                f"{self.rate_threshold:.0%}) — scale is cycling instead "
                "of settling",
                {"overflow_rate": round(rate, 4),
                 "window": len(self._win)})
        return None


class ThroughputRegressionDetector:
    """Step-time regression vs the run's own rolling baseline.

    Baseline = median of the first ``baseline_points`` timings per
    series name (``StepTimer`` names); fire when the mean of the last
    ``recent`` timings exceeds ``ratio`` x baseline AND the absolute
    slowdown exceeds ``min_delta_s`` — the ratio alone would flag
    scheduler noise on millisecond-scale series, while the real
    targets (a silent retrace in the timed path, HBM allocator churn /
    spill) cost tens of milliseconds or more.  One firing per series
    until it recovers below the threshold."""

    def __init__(self, *, baseline_points: int = 4, recent: int = 3,
                 ratio: float = 1.5, min_delta_s: float = 0.010):
        self.baseline_points = int(baseline_points)
        self.recent = int(recent)
        self.ratio = float(ratio)
        self.min_delta_s = float(min_delta_s)
        self._series: Dict[str, dict] = {}

    def feed(self, name: str, seconds: float,
             step: Optional[int] = None) -> Optional[Anomaly]:
        s = self._series.setdefault(
            name, {"head": [], "recent": deque(maxlen=self.recent),
                   "baseline": None, "armed": True})
        if s["baseline"] is None:
            s["head"].append(float(seconds))
            if len(s["head"]) >= self.baseline_points:
                s["baseline"] = sorted(s["head"])[len(s["head"]) // 2]
            return None
        s["recent"].append(float(seconds))
        if len(s["recent"]) < self.recent:
            return None
        mean = sum(s["recent"]) / len(s["recent"])
        slow = (mean > self.ratio * s["baseline"]
                and mean - s["baseline"] > self.min_delta_s)
        if not s["armed"]:
            if not slow:
                s["armed"] = True
            return None
        if slow:
            s["armed"] = False
            return Anomaly(
                "throughput_regression", step,
                f"step '{name}' now averages {mean * 1e3:.3g} ms vs a "
                f"{s['baseline'] * 1e3:.3g} ms baseline "
                f"({mean / s['baseline']:.2f}x) — silent retrace or "
                "memory pressure?",
                # "series", not "name": anomaly details are splatted
                # into event(name, **data)
                {"series": name, "recent_mean_s": mean,
                 "baseline_s": s["baseline"],
                 "ratio": round(mean / s["baseline"], 3)})
        return None


class QueueStallDetector:
    """Serving-side anomaly: requests queue while capacity idles.

    Admission normally drains the queue into any free slot within one
    engine step, so ``queue_depth > 0`` while ``occupancy < 1`` for
    ``patience`` consecutive feeds is a stall (an admission bug or a
    wedged prefill).  A full-occupancy backlog deeper than
    ``backlog_threshold`` for the same patience is reported as
    ``serving_backlog`` (capacity, not correctness)."""

    def __init__(self, *, patience: int = 8, backlog_threshold: int = 16):
        self.patience = int(patience)
        self.backlog_threshold = int(backlog_threshold)
        self._stall_streak = 0
        self._backlog_streak = 0
        self._stall_armed = True
        self._backlog_armed = True

    def feed(self, queue_depth: float,
             occupancy: float) -> Optional[Anomaly]:
        stalled = queue_depth > 0 and occupancy < 1.0
        self._stall_streak = self._stall_streak + 1 if stalled else 0
        if not stalled:
            self._stall_armed = True
        if (self._stall_armed
                and self._stall_streak >= self.patience):
            self._stall_armed = False
            return Anomaly(
                "serving_admission_stall", None,
                f"{queue_depth:.0f} request(s) queued while occupancy "
                f"is {occupancy:.0%} for {self._stall_streak} "
                "consecutive steps — admission is not filling free "
                "slots",
                {"queue_depth": queue_depth, "occupancy": occupancy})
        backlog = queue_depth >= self.backlog_threshold
        self._backlog_streak = self._backlog_streak + 1 if backlog else 0
        if not backlog:
            self._backlog_armed = True
        if (self._backlog_armed
                and self._backlog_streak >= self.patience):
            self._backlog_armed = False
            return Anomaly(
                "serving_backlog", None,
                f"queue depth has held >= {self.backlog_threshold} for "
                f"{self._backlog_streak} steps (now "
                f"{queue_depth:.0f}) — sustained overload",
                {"queue_depth": queue_depth, "occupancy": occupancy})
        return None


class SLOViolationDetector:
    """Per-class missed-SLO rate over a sliding window of completions.

    The serving engine judges every completed request against its SLO
    class's TTFT/TPOT deadlines (``serving/slo.py``) and feeds the
    verdict here.  One late request is weather; a class whose missed
    rate over the last ``window`` completions exceeds
    ``rate_threshold`` is an incident (overload, a preemption storm, a
    wedged prefill) — fire once per class, re-arming only when the rate
    recovers below half the threshold (hysteresis, same discipline as
    the scaler-thrash detector)."""

    def __init__(self, *, window: int = 32, rate_threshold: float = 0.25,
                 min_points: int = 8):
        self.rate_threshold = float(rate_threshold)
        self.min_points = int(min_points)
        self.window = int(window)
        self._wins: Dict[str, deque] = {}
        self._armed: Dict[str, bool] = {}

    def feed(self, slo_class: str, met: bool,
             step: Optional[int] = None) -> Optional[Anomaly]:
        win = self._wins.get(slo_class)
        if win is None:
            win = self._wins[slo_class] = deque(maxlen=self.window)
            self._armed[slo_class] = True
        win.append(bool(met))
        if len(win) < self.min_points:
            return None
        rate = 1.0 - sum(win) / len(win)
        if not self._armed[slo_class]:
            if rate < self.rate_threshold / 2:
                self._armed[slo_class] = True
            return None
        if rate >= self.rate_threshold:
            self._armed[slo_class] = False
            return Anomaly(
                "slo_violation", step,
                f"SLO class {slo_class!r} missed its TTFT/TPOT "
                f"deadlines on {rate:.0%} of the last {len(win)} "
                f"completed requests (threshold "
                f"{self.rate_threshold:.0%})",
                {"slo_class": slo_class, "missed_rate": round(rate, 4),
                 "window": len(win)})
        return None


class PoolStallDetector:
    """Consecutive-failure latch per worker pool (cluster tier).

    The router feeds one boolean per RPC against a pool ("prefill",
    "decode", or a finer label).  A single refused connection is
    weather (a worker restarting mid-deploy); ``threshold``
    consecutive failures mean the pool is stalled — fire once, and
    stay latched until ``threshold`` consecutive *successes* prove
    recovery (so a flapping pool cannot fire per flap)."""

    def __init__(self, *, threshold: int = 3):
        if threshold < 1:
            raise ValueError(f"threshold={threshold} must be >= 1")
        self.threshold = int(threshold)
        self._fails: Dict[str, int] = {}
        self._oks: Dict[str, int] = {}
        self._latched: Dict[str, bool] = {}

    def feed(self, pool: str, ok: bool,
             detail: Optional[str] = None) -> Optional[Anomaly]:
        if ok:
            self._fails[pool] = 0
            self._oks[pool] = self._oks.get(pool, 0) + 1
            if (self._latched.get(pool)
                    and self._oks[pool] >= self.threshold):
                self._latched[pool] = False
            return None
        self._oks[pool] = 0
        self._fails[pool] = self._fails.get(pool, 0) + 1
        if self._latched.get(pool) or self._fails[pool] < self.threshold:
            return None
        self._latched[pool] = True
        return Anomaly(
            "pool_stall", None,
            f"worker pool {pool!r} failed {self._fails[pool]} "
            f"consecutive RPCs{': ' + detail if detail else ''} — "
            "routing around it; requests requeue, they are not lost",
            {"pool": pool, "consecutive_failures": self._fails[pool],
             **({"detail": detail} if detail else {})})

    def stalled(self, pool: str) -> bool:
        """Is the pool currently latched stalled?"""
        return bool(self._latched.get(pool))


class DetectorBank:
    """The per-registry detector set + firing pipeline.

    Construction and feeding only happen when telemetry is configured
    (``metrics.configure(detectors=True)``, the default) — the
    module-level feed helpers in :mod:`~apex_tpu_torch.observability.metrics`
    keep the disabled fast path at one ``is None`` check.  Firing an
    anomaly: ``anomaly.<kind>`` event into the record stream,
    ``anomaly.count`` counter, a WARNING log line, and a flight-recorder
    notification (which may trigger a post-mortem dump)."""

    MAX_KEPT = 256   # bound the in-memory anomaly log

    def __init__(self, registry, config: Optional[dict] = None):
        cfg = dict(config or {})
        self._registry = registry
        self.anomalies: List[Anomaly] = []
        # monotonic per-kind firing totals, NOT bounded by MAX_KEPT:
        # consumers that react to firings (checkpoint.RecoveryManager)
        # must keep seeing new incidents after the in-memory log fills
        self.fired_counts: Dict[str, int] = {}
        self._dropped = 0
        self.loss_spike = ZScoreDetector(
            "loss", "loss_spike",
            threshold=cfg.get("loss_z_threshold", 6.0))
        self.grad_norm = ZScoreDetector(
            "grad_norm", "grad_norm_explosion",
            threshold=cfg.get("grad_z_threshold", 6.0))
        self.nan_inf = NanInfDetector()
        self.scaler = ScalerThrashDetector(
            rate_threshold=cfg.get("overflow_rate_threshold", 0.25))
        self.throughput = ThroughputRegressionDetector(
            ratio=cfg.get("throughput_ratio", 1.5))
        self.serving = QueueStallDetector()
        self.slo = SLOViolationDetector(
            rate_threshold=cfg.get("slo_miss_rate_threshold", 0.25))
        self.pool = PoolStallDetector(
            threshold=cfg.get("pool_stall_threshold", 3))

    # -- feeds (called by metrics.record_step_metrics & friends) -----------

    def feed_step(self, step: Optional[int], values: Dict[str, float],
                  overflow: bool = False) -> List[Anomaly]:
        fired = []
        a = self.nan_inf.feed(step, values, overflow=overflow)
        if a is not None:
            fired.append(a)
        for det in (self.loss_spike, self.grad_norm):
            a = det.feed(step, values)
            if a is not None:
                fired.append(a)
        for a in fired:
            self._fire(a)
        return fired

    def feed_scaler(self, step: Optional[int],
                    overflow: bool) -> Optional[Anomaly]:
        a = self.scaler.feed(step, overflow)
        if a is not None:
            self._fire(a)
        return a

    def feed_step_time(self, name: str, seconds: float,
                       step: Optional[int] = None) -> Optional[Anomaly]:
        a = self.throughput.feed(name, seconds, step)
        if a is not None:
            self._fire(a)
        return a

    def feed_serving(self, queue_depth: float,
                     occupancy: float) -> Optional[Anomaly]:
        a = self.serving.feed(queue_depth, occupancy)
        if a is not None:
            self._fire(a)
        return a

    def feed_slo(self, slo_class: str, met: bool,
                 step: Optional[int] = None) -> Optional[Anomaly]:
        a = self.slo.feed(slo_class, met, step)
        if a is not None:
            self._fire(a)
        return a

    def feed_pool(self, pool: str, ok: bool,
                  detail: Optional[str] = None) -> Optional[Anomaly]:
        a = self.pool.feed(pool, ok, detail)
        if a is not None:
            self._fire(a)
        return a

    def record_rollback(self, from_step: Optional[int],
                        to_step: Optional[int],
                        detail: Optional[dict] = None) -> Anomaly:
        """Document a checkpoint rollback: the recovery
        manager restored the last good snapshot instead of letting the
        job die.  Fires through the standard pipeline — an
        ``anomaly.rollback`` event, the anomaly counter, a WARNING
        line, and the flight-recorder notification (post-mortem dump
        on first blood), so the post-mortem carries the
        incident with its rollback-to-step and re-warm schedule.

        Also re-arms the NaN first-seen latch: ``NanInfDetector``
        fires once per run by design, but a rollback starts a fresh
        incident window — a *second* divergence after recovery must be
        detected (and trigger the next rollback), not ignored."""
        d = dict(detail or {})
        d.setdefault("from_step", from_step)
        d.setdefault("to_step", to_step)
        a = Anomaly(
            "rollback", from_step,
            f"anomaly at step {from_step} -> rolled back to the last "
            f"good checkpoint (step {to_step}); LR re-warm over "
            f"{d.get('rewarm_steps', '?')} steps from "
            f"{d.get('lr_scale_floor', '?')}x",
            d)
        self._fire(a)
        self.nan_inf.fired = False
        return a

    # -- firing ------------------------------------------------------------

    def _fire(self, anomaly: Anomaly) -> None:
        self.fired_counts[anomaly.kind] = (
            self.fired_counts.get(anomaly.kind, 0) + 1)
        if len(self.anomalies) < self.MAX_KEPT:
            self.anomalies.append(anomaly)
        else:
            self._dropped += 1
        reg = self._registry
        if reg is not None:
            reg.counter("anomaly.count").inc()
            reg.event(f"anomaly.{anomaly.kind}", step=anomaly.step,
                      message=anomaly.message, **anomaly.detail)
            recorder = getattr(reg, "recorder", None)
            if recorder is not None:
                recorder.note_anomaly(anomaly)
        from apex_tpu_torch.utils.logging import get_logger

        get_logger("observability").warning(
            "ANOMALY [%s] %s", anomaly.kind, anomaly.message)

    def summary(self) -> dict:
        return {
            "count": len(self.anomalies) + self._dropped,
            "dropped": self._dropped,
            "anomalies": [a.to_dict() for a in self.anomalies],
        }
