"""OpenMetrics / Prometheus text exposition of a registry snapshot
(``apex_tpu/observability/openmetrics.py``, stdlib only; copied, not
imported).

:func:`render` turns :meth:`MetricsRegistry.snapshot` (a list of
per-metric dicts) into the OpenMetrics text format a Prometheus scraper
ingests; :func:`parse` is the inverse (strict enough to validate a
live ``/metrics`` endpoint).  Mapping:

- registry **tags** → Prometheus **labels** (``serving.ttft_ms`` tagged
  ``slo_class=interactive`` becomes
  ``serving_ttft_ms_bucket{slo_class="interactive",le="..."}``);
- **counters** → ``counter`` families (``_total`` sample suffix, per
  the spec);
- **gauges** → ``gauge`` families;
- **sketches** (:mod:`~apex_tpu_torch.observability.sketches`) → native
  ``histogram`` families: each non-empty bucket is one ``_bucket``
  sample with its ``le`` upper boundary and *cumulative* count, plus
  ``_count``/``_sum`` — so PromQL ``histogram_quantile`` and this
  module's :func:`histogram_quantile` both work on the scrape, and the
  scrape answers quantile queries identically to the JSONL sketch
  record (same boundaries, same counts);
- **deque histograms** → ``summary`` families (they have quantiles but
  no mergeable buckets): ``{quantile="0.5"}``/``{quantile="0.95"}``
  samples over the bounded window plus exact ``_count``/``_sum``.

Metric names are sanitized (``[^a-zA-Z0-9_:]`` → ``_``); the exposition
ends with the mandatory ``# EOF``.

Deliberately stdlib-only and self-contained (no package-relative
imports), so the text either package renders parses with the other's
:func:`parse`.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["CONTENT_TYPE", "render", "parse", "sanitize_name",
           "histogram_quantile", "bucket_series", "sample_value"]

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # sample name
    # optional {labels} — quote-aware, since a '}' inside a quoted
    # label value (any string is a valid slo_class) must not end the
    # block early
    r'(?:\{((?:[^{}"]|"(?:[^"\\]|\\.)*")*)\})?'
    r" ([^ ]+)"                             # value
    r"(?: (.+))?$")                         # optional timestamp
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def sanitize_name(name: str) -> str:
    """Dotted registry names → Prometheus metric names."""
    out = _NAME_OK.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(tags: Optional[dict], extra: Optional[dict] = None) -> str:
    items: List[Tuple[str, object]] = []
    if tags:
        items.extend(sorted(tags.items()))
    if extra:
        items.extend(extra.items())
    if not items:
        return ""
    return ("{" + ",".join(
        f'{sanitize_name(str(k))}="{_escape_label(v)}"'
        for k, v in items) + "}")


def _num(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(snapshot: Sequence[dict]) -> str:
    """OpenMetrics text for a registry snapshot (see module docstring
    for the kind mapping).  Entries sharing a (sanitized) family name
    are grouped under one ``# TYPE`` line; the first entry's kind wins
    if kinds disagree (a naming bug worth seeing in the output, not
    crashing an exporter over)."""
    families: Dict[str, List[dict]] = {}
    for entry in snapshot:
        families.setdefault(sanitize_name(entry["name"]),
                            []).append(entry)
    lines: List[str] = []
    for fam in sorted(families):
        entries = families[fam]
        kind = entries[0]["kind"]
        if kind == "counter":
            lines.append(f"# TYPE {fam} counter")
            for e in entries:
                lines.append(
                    f"{fam}_total{_labels(e.get('tags'))} "
                    f"{_num(e['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {fam} gauge")
            for e in entries:
                if e.get("value") is None:
                    continue
                lines.append(
                    f"{fam}{_labels(e.get('tags'))} {_num(e['value'])}")
        elif kind == "sketch":
            lines.append(f"# TYPE {fam} histogram")
            for e in entries:
                tags = e.get("tags")
                for le, cum in e["buckets"]:
                    lines.append(
                        f"{fam}_bucket{_labels(tags, {'le': _num(le)})} "
                        f"{cum}")
                lines.append(f"{fam}_count{_labels(tags)} {e['count']}")
                lines.append(
                    f"{fam}_sum{_labels(tags)} {_num(e['sum'])}")
        elif kind == "summary":
            lines.append(f"# TYPE {fam} summary")
            for e in entries:
                tags = e.get("tags")
                for q in ("0.5", "0.95"):
                    key = "p" + str(int(float(q) * 100))
                    if key in e:
                        lines.append(
                            f"{fam}{_labels(tags, {'quantile': q})} "
                            f"{_num(e[key])}")
                lines.append(
                    f"{fam}_count{_labels(tags)} {e['observed']}")
                lines.append(f"{fam}_sum{_labels(tags)} {_num(e['sum'])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# parsing (the dashboard / validator side)
# ---------------------------------------------------------------------------


def _unescape_label(v: str) -> str:
    # single left-to-right scan: sequential .replace passes corrupt a
    # literal backslash followed by 'n' ('win\\network' -> newline)
    out = []
    i, n = 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n and v[i + 1] in ('n', '"', "\\"):
            out.append("\n" if v[i + 1] == "n" else v[i + 1])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(text: str) -> dict:
    out = {}
    for m in _LABEL_RE.finditer(text or ""):
        out[m.group(1)] = _unescape_label(m.group(2))
    return out


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)


def parse(text: str) -> dict:
    """Parse an OpenMetrics exposition into ``{"types": {family:
    kind}, "samples": [(name, labels, value)], "eof": bool}``.  Raises
    ``ValueError`` on a malformed sample or TYPE line — strict enough
    to serve as the exporter smoke validator."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, dict, float]] = []
    eof = False
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if eof:
            raise ValueError(f"line {lineno}: content after # EOF")
        if line.startswith("#"):
            parts = line.split()
            if parts[:2] == ["#", "EOF"]:
                eof = True
                continue
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                continue
            if len(parts) >= 3 and parts[1] in ("HELP", "UNIT"):
                continue
            raise ValueError(f"line {lineno}: unrecognized comment "
                             f"{line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample "
                             f"{line!r}")
        name, labels, value, _ts = m.groups()
        samples.append((name, _parse_labels(labels),
                        _parse_value(value)))
    return {"types": types, "samples": samples, "eof": eof}


def sample_value(parsed: dict, name: str,
                 labels: Optional[dict] = None) -> Optional[float]:
    """The first sample matching ``name`` whose labels include
    ``labels`` (subset match), or None."""
    want = labels or {}
    for n, ls, v in parsed["samples"]:
        if n == name and all(ls.get(k) == v2 for k, v2 in want.items()):
            return v
    return None


def bucket_series(parsed: dict, family: str,
                  labels: Optional[dict] = None
                  ) -> List[Tuple[float, float]]:
    """``[(le, cumulative_count)]`` for one histogram family/labelset,
    sorted by ``le`` (``le`` itself excluded from the match)."""
    want = labels or {}
    out = []
    for n, ls, v in parsed["samples"]:
        if n != family + "_bucket" or "le" not in ls:
            continue
        if all(ls.get(k) == v2 for k, v2 in want.items()):
            out.append((_parse_value(ls["le"]), v))
    return sorted(out)


def histogram_quantile(buckets: Sequence[Tuple[float, float]],
                       q: float) -> float:
    """Nearest-rank quantile over cumulative ``(le, count)`` buckets —
    the same algorithm as ``LogBucketSketch.quantile``, so a scraped
    histogram answers exactly what the sketch it came from would
    (except in the ``+Inf`` overflow bucket, where the sketch knows its
    exact max and this side reports the highest finite boundary)."""
    if not buckets:
        return 0.0
    total = buckets[-1][1]
    if total <= 0:
        return 0.0
    rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * total))
    prev_finite = 0.0
    for le, cum in buckets:
        if cum >= rank:
            return prev_finite if math.isinf(le) else le
        if not math.isinf(le):
            prev_finite = le
    return prev_finite
