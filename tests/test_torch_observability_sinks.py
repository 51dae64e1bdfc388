"""The port's observability record path against the JAX package's, on the
CPU: one scripted record stream (counters, tagged gauges, histograms,
sketches, spans, paired request events, step metrics with a NaN) goes
through both registries with the clock pinned, and

- the JSONL records are equal, record for record (the JAX package's
  ``compile`` records come from its ``jax.monitoring`` recompile
  tracker, which the port does not have, and are left out);
- the Chrome trace events are equal;
- the flight-recorder dumps are equal (the JAX dump's ``runtime``
  section, ``jax.monitoring`` accounting, has no port counterpart);
- ``openmetrics.render`` gives byte-identical text for the two
  snapshots, and ``parse`` / ``bucket_series`` / ``histogram_quantile``
  agree on it;
- the stderr summary table, ``sanitize_json``, ``load_trace`` on a
  truncated file and ``configure_from_env`` behave as JAX's.
"""

import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import observability as jobs
from apex_tpu.observability import metrics as jmetrics
from apex_tpu.observability import openmetrics as jom
from apex_tpu.observability import sinks as jsinks
from apex_tpu.observability import trace as jtrace
from apex_tpu_torch import observability as tobs
from apex_tpu_torch.observability import metrics as tmetrics
from apex_tpu_torch.observability import openmetrics as tom
from apex_tpu_torch.observability import sinks as tsinks
from apex_tpu_torch.observability import trace as ttrace

PKGS = {"jax": (jobs, jnp.asarray), "torch": (tobs, torch.tensor)}
T0 = 1_700_000_000.0

LOSSES = np.asarray([2.5, 2.25, 2.0, 1.875, 1.75, 1.625, 1.5, 1.4375,
                     1.375, 1.3125, 1.25, np.nan, 1.2], np.float32)


def _script(pkg, tmp_path, detectors=True):
    """Drive one package's registry through the scripted stream → (paths,
    snapshot, summary, anomaly kinds)."""
    obs, arr = PKGS[pkg]
    d = tmp_path / pkg
    paths = {"jsonl": d / "t.jsonl", "trace": d / "t.trace.json",
             "flight": d / "flight.json"}
    reg = obs.configure(jsonl_path=str(paths["jsonl"]),
                        trace_path=str(paths["trace"]),
                        flight_recorder=str(paths["flight"]),
                        detectors=detectors, tags={"run": "script"})
    try:
        reg.counter("collectives.calls").inc(3)
        reg.counter("serving.goodput.met", {"slo_class": "interactive"}) \
            .inc(2)
        reg.gauge("hbm.bytes_in_use").set(1 << 20)
        reg.gauge("serving.cache_bytes", {"dtype": "bfloat16"}).set(4096)
        for i, v in enumerate((0.25, 0.5, 0.125, 4.0)):
            reg.histogram("serving.prefill_ms").observe(v, rid=i)
        for v in (1.0, 2.0, 3.0, 50.0, 0.001, 1e4, 7.5):
            reg.sketch("serving.ttft_ms", {"slo_class": "interactive"}) \
                .observe(v)
            reg.sketch("serving.ttft_ms", {"slo_class": "batch"}) \
                .observe(v * 3)
        reg.observe_span("serving.prefill", 0.0625, bucket=32)
        reg.observe_span("serving.kv_inject", 0.03125,
                         tags={"pool": "decode"})
        obs.event("serving.request.begin", id=1, prompt_tokens=9)
        obs.event("serving.request.end", id=1, finish_reason="length")
        obs.event("amp.loss_scale_change", old=65536.0, new=32768.0,
                  overflow=True, name="payload-name")
        for step, loss in enumerate(LOSSES, 1):
            obs.record_step_metrics({
                "loss": arr(loss), "grad_norm": arr(np.float32(0.5)),
                "loss_scale": arr(np.float32(65536.0)),
                "overflow": arr(False), "step": arr(step),
                "aux": {"ignored": arr([1.0, 2.0])},
                "vector": arr(np.ones(3, np.float32))})
        obs.set_step(99)
        reg.gauge("after.step").set(float("inf"))
        reg.flush()
        snap = [e for e in reg.snapshot() if not _jax_only(e["name"])]
        summ = {kind: {k: v for k, v in d.items() if not _jax_only(k)}
                for kind, d in reg.summary().items()}
        kinds = ([a.kind for a in reg.detectors.anomalies]
                 if reg.detectors is not None else [])
    finally:
        obs.shutdown()
    return paths, snap, summ, kinds


def _jax_only(name):
    """Records of the JAX package's recompile tracker."""
    return name == "compile" or name.startswith("compile.")


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)


@pytest.fixture
def both(tmp_path, pinned):
    return {pkg: _script(pkg, tmp_path) for pkg in PKGS}


def _jsonl(path):
    return [r for r in map(json.loads, open(path))
            if not _jax_only(r.get("name", ""))]


def test_jsonl_records_equal(both):
    got, want = (_jsonl(both[p][0]["jsonl"]) for p in ("torch", "jax"))
    assert len(got) == len(want) > 40
    for g, w in zip(got, want):
        assert g == w
    types = {r["type"] for r in got}
    assert types == {"meta", "counter", "gauge", "observe", "span",
                     "event", "sketch", "summary"}
    assert got[0]["tags"] == {"host": 0, "num_hosts": 1, "run": "script"}


def test_trace_events_equal(both):
    got = ttrace.load_trace(str(both["torch"][0]["trace"]))
    want = [e for e in jtrace.load_trace(str(both["jax"][0]["trace"]))
            if not _jax_only(e["name"])]
    assert got == want
    phases = {e["ph"] for e in got}
    assert {"M", "X", "C", "b", "e", "i"} <= phases


def _dump(path):
    doc = json.load(open(path))
    doc.pop("runtime", None)
    doc["metrics_summary"] = {
        kind: {k: v for k, v in d.items() if not _jax_only(k)}
        for kind, d in doc["metrics_summary"].items()}
    return doc


@pytest.mark.parametrize("which", ["incident", "final"])
def test_flight_dumps_equal(both, which):
    name = "flight.json" if which == "incident" else "flight.final.json"
    got = _dump(both["torch"][0]["flight"].parent / name)
    want = _dump(both["jax"][0]["flight"].parent / name)
    assert got == want
    assert got["first_anomaly"]["kind"] == "nan_inf"
    assert got["first_anomalous_step"] == 12
    assert got["reason"] == ("anomaly:nan_inf" if which == "incident"
                             else "shutdown_with_anomalies")


def test_anomalies_and_summaries_equal(both):
    assert both["torch"][3] == both["jax"][3]
    assert "nan_inf" in both["torch"][3]
    assert both["torch"][2] == both["jax"][2]


def test_openmetrics_render_byte_identical(both):
    tsnap, jsnap = both["torch"][1], both["jax"][1]
    text = tom.render(tsnap)
    assert text == jom.render(jsnap)
    assert tom.render(jsnap) == text
    assert text.endswith("# EOF\n")


def test_openmetrics_parse_and_quantiles_agree(both):
    text = tom.render(both["torch"][1])
    tp, jp = tom.parse(text), jom.parse(text)
    assert tp == jp and tp["eof"]
    for cls in ("interactive", "batch"):
        lab = {"slo_class": cls}
        tb = tom.bucket_series(tp, "serving_ttft_ms", lab)
        assert tb == jom.bucket_series(jp, "serving_ttft_ms", lab)
        assert tb and tb[-1][1] == 7
        for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert tom.histogram_quantile(tb, q) == \
                jom.histogram_quantile(tb, q)
        assert tom.sample_value(tp, "serving_ttft_ms_count", lab) == 7
    assert tom.sample_value(tp, "collectives_calls_total") == 3


@pytest.mark.parametrize("bad", ["foo bar baz", "# TYPE", "x 1\n# EOF\ny 2",
                                 'x{a="1"} notanumber'])
def test_openmetrics_parse_rejects_like_jax(bad):
    for om in (tom, jom):
        with pytest.raises(ValueError):
            om.parse(bad)


def test_stderr_summary_equal(both, capsys):
    summ = both["jax"][2]
    jsinks.StderrSummarySink().close(summary=summ)
    want = capsys.readouterr().err
    tsinks.StderrSummarySink().close(summary=summ)
    assert capsys.readouterr().err == want and "telemetry summary" in want


@pytest.mark.parametrize("value", [
    1.5, float("nan"), float("inf"), -float("inf"),
    {"a": [1, float("nan"), {"b": (2.0, float("inf"))}], "c": "s"}])
def test_sanitize_json_equal(value):
    assert tsinks.sanitize_json(value) == jsinks.sanitize_json(value)


def test_load_trace_truncated(tmp_path, pinned):
    path = tmp_path / "cut.json"
    sink = ttrace.TraceSink(str(path))
    sink.emit({"type": "meta", "tags": {"host": 0}, "t": T0})
    sink.emit({"type": "span", "name": "step.x", "value": 0.5, "t": T0})
    sink.flush()
    text = path.read_text() + ',\n{"ph": "X", "na'
    path.write_text(text)
    assert ttrace.load_trace(str(path)) == jtrace.load_trace(str(path))
    assert len(ttrace.load_trace(str(path))) == 3


def test_env_table_matches_jax():
    tvars, jvars = tmetrics.ENV_VARS, jmetrics.ENV_VARS
    assert set(tvars) == set(jvars)
    for k in tvars:
        assert tvars[k][:2] == jvars[k][:2]


@pytest.mark.parametrize("env,expect", [
    ({}, None),
    ({"APEX_TPU_TELEMETRY_PROFILER": "1"}, None),
    ({"APEX_TPU_TELEMETRY_STDERR": "yes"}, "StderrSummarySink"),
    ({"APEX_TPU_TELEMETRY_STDERR": "maybe",
      "APEX_TPU_TELEMETRY_PORTT": "1"}, None),
])
def test_configure_from_env_like_jax(env, expect, caplog):
    regs = []
    for m in (jmetrics, tmetrics):
        reg = m.configure_from_env(dict(env))
        try:
            regs.append(None if reg is None
                        else [type(s).__name__ for s in reg.sinks])
        finally:
            m.shutdown()
    assert regs[0] == regs[1]
    assert regs[1] == (None if expect is None else [expect])


def test_configure_from_env_paths(tmp_path):
    env = {"APEX_TPU_TELEMETRY": str(tmp_path / "a.jsonl"),
           "APEX_TPU_TELEMETRY_TRACE": str(tmp_path / "a.trace"),
           "APEX_TPU_TELEMETRY_FLIGHT": str(tmp_path / "f.json"),
           "APEX_TPU_TELEMETRY_FLIGHT_STEPS": "8",
           "APEX_TPU_TELEMETRY_DETECTORS": "off",
           "APEX_TPU_TELEMETRY_PORT": "0"}
    reg = tmetrics.configure_from_env(env)
    try:
        assert [type(s).__name__ for s in reg.sinks] == ["JsonlSink",
                                                         "TraceSink"]
        assert reg.detectors is None
        assert reg.recorder.max_steps == 8
        assert reg.exporter.port > 0
    finally:
        tmetrics.shutdown()
    assert tmetrics.registry() is None


def test_unconfigured_path_is_noop():
    assert tobs.registry() is None
    c = tobs.counter("x")
    assert c is tmetrics.NOOP_METRIC
    tobs.record_step_metrics({"loss": torch.tensor(1.0)})
    tobs.set_step(3)
    with tobs.span("never.recorded"):
        pass
    assert tobs.registry() is None


def test_span_step_timer_and_fence():
    reg = tobs.configure(detectors=False)
    try:
        with tobs.span("outer"):
            with tobs.span("inner", fence_on=torch.ones(2)):
                pass
        timer = tobs.StepTimer("mm", warmup=1, iters=3)
        x = torch.randn(16, 16)
        avg = timer.time_call(torch.matmul, x, x)
        assert avg > 0 and timer.last.shape == (16, 16)
        avg = timer.time(lambda c: (x @ x, (x @ x).sum()))
        assert avg > 0
        tobs.fence({"a": [torch.zeros(1)]})
        tobs.fence(None)
        hists = reg.summary()["histograms"]
        assert hists["outer"]["count"] == hists["inner"]["count"] == 1
        assert hists["step.mm"]["count"] == 2
    finally:
        tobs.shutdown()


def test_profiler_flag_opens_record_function():
    reg = tobs.configure(profiler=True, detectors=False)
    try:
        with torch.profiler.profile() as prof:
            with tobs.span("named.region"):
                torch.ones(4).sum()
        names = {e.name for e in prof.events()}
        assert "named.region" in names
        assert reg.summary()["histograms"]["named.region"]["count"] == 1
    finally:
        tobs.shutdown()


def test_registry_keeps_events_in_memory():
    reg = tobs.configure(max_events=3, detectors=False)
    try:
        for i in range(5):
            tobs.event("e", i=i)
        assert [e["data"]["i"] for e in reg.events] == [2, 3, 4]
        assert math.isfinite(reg.events[-1]["t"])
    finally:
        tobs.shutdown()
