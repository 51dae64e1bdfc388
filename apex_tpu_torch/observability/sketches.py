"""Mergeable fixed-boundary log-bucket histogram sketch
(``apex_tpu/observability/sketches.py``, stdlib only; copied, not
imported).

The deque histograms in :mod:`~apex_tpu_torch.observability.metrics`
keep the last 4096 raw observations — exact for short series, silently truncated
for the per-token serving series a soak produces (millions of
observations), and fundamentally un-mergeable across hosts (averaging
two hosts' p95s is not the fleet p95).  This module is the metric kind
built for those series:

- **Bounded memory.** Bucket boundaries are *fixed at construction*
  (log-spaced: bucket ``i`` covers ``(min_value·g^(i-1),
  min_value·g^i]`` for growth factor ``g``), so the sketch is one flat
  integer array (~650 buckets at the defaults) regardless of how many
  observations land in it.
- **Bounded relative error.** A quantile query returns the upper
  boundary of the bucket holding that rank, so the reported value
  overestimates the exact nearest-rank quantile by at most a factor of
  ``growth`` (4% at the default 1.04) for values inside
  ``[min_value, max_value]``.
- **Exact merge.** Because every sketch built from the same parameters
  shares the same boundaries, merging is element-wise count addition —
  associative, commutative, and *exactly* equal to having observed the
  union stream in one sketch.  Fleet percentiles from N hosts'
  serialized sketches are therefore real percentiles, not
  averaged-percentile lies (``tools/aggregate_telemetry.py``).

The JSONL record form (:meth:`LogBucketSketch.to_dict` /
:meth:`LogBucketSketch.from_dict`) is sparse (only non-empty buckets)
and carries its own parameters, so a reader never guesses boundaries
and a parameter mismatch is a detectable error instead of a silent
wrong merge.

Deliberately stdlib-only and self-contained (no package-relative
imports), so a sketch serialized by either package merges with the
other's.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["LogBucketSketch", "DEFAULT_MIN_VALUE", "DEFAULT_GROWTH",
           "DEFAULT_MAX_VALUE"]

# Defaults sized for millisecond-denominated latency series: 1e-3 ms
# (1 µs) .. 1e8 ms (~28 h) at 4% relative error = 648 buckets (~5 KiB).
DEFAULT_MIN_VALUE = 1e-3
DEFAULT_GROWTH = 1.04
DEFAULT_MAX_VALUE = 1e8

_SERIAL_VERSION = 1


class LogBucketSketch:
    """Fixed-boundary log-bucket histogram with exact cross-stream merge.

    Layout: bucket 0 is the underflow bucket ``(-inf, min_value]``
    (durations are non-negative; zeros and sub-resolution values land
    here and quantize to ``min_value``), buckets ``1..n_log`` are
    log-spaced with upper bound ``min_value·growth^i``, and the last
    bucket is the overflow ``(max_value-ish, +inf)`` whose quantile
    reports the exact tracked ``max``.  ``count``/``total``/``min``/
    ``max`` are tracked exactly alongside the bucket counts.
    """

    __slots__ = ("min_value", "growth", "max_value", "n_log", "_log_g",
                 "counts", "count", "total", "min", "max")

    def __init__(self, min_value: float = DEFAULT_MIN_VALUE,
                 growth: float = DEFAULT_GROWTH,
                 max_value: float = DEFAULT_MAX_VALUE):
        if not (min_value > 0 and max_value > min_value):
            raise ValueError(
                f"need 0 < min_value < max_value, got [{min_value}, "
                f"{max_value}]")
        if not growth > 1.0:
            raise ValueError(f"growth={growth} must be > 1")
        self.min_value = float(min_value)
        self.growth = float(growth)
        self.max_value = float(max_value)
        self._log_g = math.log(self.growth)
        self.n_log = int(math.ceil(
            math.log(self.max_value / self.min_value) / self._log_g))
        # [underflow] + n_log log buckets + [overflow]
        self.counts: List[int] = [0] * (self.n_log + 2)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- observing ---------------------------------------------------------

    def _index(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        if v >= self.max_value:
            return self.n_log + 1
        # bucket i covers (min·g^(i-1), min·g^i]; float boundary wobble
        # only shifts a boundary-exact value by one bucket, which stays
        # inside the documented relative-error bound
        i = 1 + int(math.log(v / self.min_value) / self._log_g)
        return min(max(i, 1), self.n_log)

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return                     # a NaN duration is a caller bug;
        self.counts[self._index(v)] += 1   # never poison the sketch
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # -- querying ----------------------------------------------------------

    def upper_bound(self, index: int) -> float:
        """The inclusive upper boundary of bucket ``index`` (``+inf``
        for the overflow bucket)."""
        if index <= 0:
            return self.min_value
        if index > self.n_log:
            return math.inf
        return self.min_value * self.growth ** index

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile with relative error bounded by
        ``growth - 1``: the upper boundary of the bucket holding rank
        ``ceil(q·count)``.  The overflow bucket reports the exact
        tracked max; an empty sketch reports 0.0.

        ``tools``-side consumers (``openmetrics.histogram_quantile``)
        mirror this algorithm over the exported cumulative buckets, so
        a /metrics scrape and the JSONL sketch record answer quantile
        queries identically.
        """
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i > self.n_log:
                    return self.max
                return self.upper_bound(i)
        return self.max                # unreachable (cum == count)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "relative_error": self.growth - 1.0,
        }

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` over non-empty buckets plus
        the terminal ``(+inf, count)`` — the OpenMetrics histogram
        exposition form (sparse ``le`` series are valid; cumulative
        counts are preserved exactly)."""
        out: List[Tuple[float, int]] = []
        cum = 0
        for i, c in enumerate(self.counts):
            if c and i <= self.n_log:
                cum += c
                out.append((self.upper_bound(i), cum))
            elif c:
                cum += c
        out.append((math.inf, cum))
        return out

    # -- merging -----------------------------------------------------------

    def _check_mergeable(self, other: "LogBucketSketch") -> None:
        if (self.min_value != other.min_value
                or self.growth != other.growth
                or self.max_value != other.max_value):
            raise ValueError(
                "sketch parameter mismatch: "
                f"[{self.min_value}, {self.max_value}] x{self.growth} vs "
                f"[{other.min_value}, {other.max_value}] x{other.growth} "
                "— differently-bucketed sketches cannot merge exactly")

    def merge(self, other: "LogBucketSketch") -> "LogBucketSketch":
        """In-place exact merge: afterwards this sketch is
        indistinguishable from one that observed both streams."""
        self._check_mergeable(other)
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    @classmethod
    def merged(cls, sketches: Iterable["LogBucketSketch"]
               ) -> Optional["LogBucketSketch"]:
        """Merge an iterable of sketches into a fresh one (None when
        empty) — order-independent by construction."""
        out: Optional[LogBucketSketch] = None
        for s in sketches:
            if out is None:
                out = cls(s.min_value, s.growth, s.max_value)
            out.merge(s)
        return out

    # -- serialization (the JSONL `sketch` record value) -------------------

    def to_dict(self) -> dict:
        return {
            "v": _SERIAL_VERSION,
            "min_value": self.min_value,
            "growth": self.growth,
            "max_value": self.max_value,
            "count": self.count,
            "total": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            # sparse: JSON keys are strings
            "buckets": {str(i): c for i, c in enumerate(self.counts)
                        if c},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LogBucketSketch":
        s = cls(d["min_value"], d["growth"], d["max_value"])
        for k, c in d.get("buckets", {}).items():
            i = int(k)
            if not 0 <= i < len(s.counts):
                raise ValueError(f"bucket index {i} out of range for "
                                 f"{len(s.counts)}-bucket sketch")
            s.counts[i] = int(c)
        s.count = int(d.get("count", sum(s.counts)))
        s.total = float(d.get("total", 0.0))
        n = s.count
        s.min = float(d.get("min", 0.0)) if n else math.inf
        s.max = float(d.get("max", 0.0)) if n else -math.inf
        return s
