"""SLO classes and deadlines for the serving engine
(``apex_tpu/serving/slo.py``, which imports no JAX; copied, not
imported).

A serving fleet is not run on throughput alone: every request belongs
to an **SLO class** (interactive chat, standard API, offline batch)
with per-class latency deadlines, and the fleet-level objective is
**goodput** — the fraction of requests that met their class's
deadlines — not raw tokens/sec.  The two deadline dimensions that
matter for LLM serving:

- **TTFT** (time to first token): submit → first sampled token,
  queue wait included.  The interactivity number.
- **TPOT** (time per output token): the mean inter-token interval
  after the first token (``(finish − first_token) / (tokens − 1)``),
  preemption stalls included — what streaming feels like.

:class:`SLOTarget` holds one class's deadlines (``None`` = that
dimension carries no deadline — a batch class meets its SLO by
completing at all); :data:`DEFAULT_SLO_TARGETS` is the built-in class
table and :func:`resolve_slo_targets` normalizes the
``ServingEngine(slo_targets=...)`` override (accepting
``SLOTarget`` / ``(ttft_ms, tpot_ms)`` tuples / dicts).  The engine
stamps every completed request's measurements into per-class
``serving.{queue_wait_ms,ttft_ms,tpot_ms,e2e_ms,preempt_overhead_ms}``
sketches and judges it here (:func:`judge`) into the
``serving.goodput.{met,missed}`` counters and the SLO-violation
detector.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

__all__ = ["SLOTarget", "DEFAULT_SLO_TARGETS", "resolve_slo_targets",
           "judge", "tpot_ms"]


def tpot_ms(first_token_t: float, finish_t: float,
            tokens: int) -> Optional[float]:
    """Mean inter-token interval in milliseconds after the first
    token: ``(finish − first_token) / (tokens − 1)``.

    The denominator is **tokens delivered**, never engine polls: under
    multi-token emission (speculative decoding) one poll can
    deliver several tokens, and a 3-tokens-per-poll stream must report
    one third of the per-poll interval (tests/test_serving_slo.py pins
    it).  ``None`` for a one-token response — no interval exists, so
    there is no TPOT verdict to take."""
    intervals = int(tokens) - 1
    if intervals <= 0:
        return None
    return (finish_t - first_token_t) / intervals * 1e3


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Per-class deadlines, in milliseconds; ``None`` = no deadline on
    that dimension."""

    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None

    def __post_init__(self):
        for field in ("ttft_ms", "tpot_ms"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{field}={v}: a deadline must be positive "
                    "(use None for no deadline)")


# The built-in class table.  "default" (what ``submit`` stamps when the
# caller names no class) is deadline-free on purpose: goodput deadlines
# are an explicit operator decision, not something a library guesses —
# an unconfigured engine reports 100% goodput and exact latency
# sketches, and the operator tightens from evidence.
DEFAULT_SLO_TARGETS: Dict[str, SLOTarget] = {
    "interactive": SLOTarget(ttft_ms=500.0, tpot_ms=50.0),
    "standard": SLOTarget(ttft_ms=2000.0, tpot_ms=200.0),
    "batch": SLOTarget(),
    "default": SLOTarget(),
}

_TargetLike = Union[SLOTarget, tuple, list, Mapping, None]


def _coerce(cls: str, t: _TargetLike) -> SLOTarget:
    if t is None:
        return SLOTarget()
    if isinstance(t, SLOTarget):
        return t
    if isinstance(t, Mapping):
        unknown = set(t) - {"ttft_ms", "tpot_ms"}
        if unknown:
            raise ValueError(
                f"slo_targets[{cls!r}]: unknown keys {sorted(unknown)} "
                "(expected ttft_ms / tpot_ms)")
        return SLOTarget(**t)
    if isinstance(t, (tuple, list)) and len(t) == 2:
        return SLOTarget(ttft_ms=t[0], tpot_ms=t[1])
    raise ValueError(
        f"slo_targets[{cls!r}]={t!r}: expected SLOTarget, "
        "(ttft_ms, tpot_ms), or a dict")


def resolve_slo_targets(
        targets: Optional[Mapping[str, _TargetLike]] = None
) -> Dict[str, SLOTarget]:
    """The engine's class table: the defaults overlaid with the
    caller's per-class overrides (an override replaces that class's
    whole target; classes the caller invents are added)."""
    out = dict(DEFAULT_SLO_TARGETS)
    for cls, t in (targets or {}).items():
        out[str(cls)] = _coerce(str(cls), t)
    return out


def judge(target: Optional[SLOTarget], ttft_ms: float,
          tpot_ms: Optional[float]) -> bool:
    """Did a request meet its class's deadlines?  ``tpot_ms=None``
    (a one-token response has no inter-token interval) passes any TPOT
    deadline; a class with no target (or no deadlines) is met by
    completing."""
    if target is None:
        return True
    if target.ttft_ms is not None and ttft_ms > target.ttft_ms:
        return False
    if (target.tpot_ms is not None and tpot_ms is not None
            and tpot_ms > target.tpot_ms):
        return False
    return True
