"""The port's anomaly detectors against the JAX package's, on the CPU.

- each detector class fed one series in both packages fires the same
  anomalies (kind, step, message, detail) at the same points;
- one scripted run — loss / grad-norm step metrics with a spike and a
  NaN through ``record_step_metrics``, overflowing scaler steps through
  ``record_scaler_step``, a throughput series through spans, and queue,
  SLO and pool series through the bank's feeds, the engine's and the
  router's call sites — fires the same anomalies at the same steps in
  both, and ``/healthz`` flips from 200 to 503 on both exporters,
  scraped over HTTP on ephemeral ports;
- the gap this closes: the port's ``RecoveryManager``, fed a NaN loss
  through ``record_step_metrics``, rolls back to the last committed
  checkpoint on the detector's ``anomaly.nan_inf`` alone.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import observability as jobs
from apex_tpu.amp.scaler import record_scaler_step as j_scaler_step
from apex_tpu.observability import detectors as jdet
from apex_tpu_torch import observability as tobs
from apex_tpu_torch.amp.scaler import record_scaler_step as t_scaler_step
from apex_tpu_torch.observability import detectors as tdet

DET = {"jax": jdet, "torch": tdet}


def _series_losses():
    v = [2.0 + 0.01 * np.sin(i) for i in range(30)]
    v[20] = 40.0                                  # a spike
    return np.asarray(v, np.float32)


def _feed_unit(pkg, name):
    d = DET[pkg]
    out = []
    if name == "zscore":
        det = d.ZScoreDetector("loss", "loss_spike")
        for i, v in enumerate(_series_losses()):
            out.append(det.feed(i, {"loss": float(v)}))
    elif name == "nan_inf":
        det = d.NanInfDetector()
        for i, v in enumerate([1.0, 2.0, float("inf"), float("nan")]):
            out.append(det.feed(i, {"loss": 1.0, "grad_norm": v},
                                overflow=(i == 2)))
        out.append(det.feed(9, {"loss": float("nan")}))
        out.append(det.feed(10, {"loss": float("nan")}))
    elif name == "scaler":
        det = d.ScalerThrashDetector()
        flips = [False] * 8 + [True, False] * 8 + [False] * 40 + [True] * 8
        out = [det.feed(i, f) for i, f in enumerate(flips)]
    elif name == "throughput":
        det = d.ThroughputRegressionDetector()
        ts = [0.05] * 6 + [0.2] * 4 + [0.05] * 4 + [0.3] * 3
        out = [det.feed("step.train", t, i) for i, t in enumerate(ts)]
    elif name == "queue":
        det = d.QueueStallDetector()
        ser = [(3, 0.5)] * 9 + [(0, 1.0)] * 2 + [(20, 1.0)] * 9
        out = [det.feed(q, o) for q, o in ser]
    elif name == "slo":
        det = d.SLOViolationDetector()
        for i in range(40):
            out.append(det.feed("interactive", met=(i % 3 != 0), step=i))
            out.append(det.feed("batch", met=True, step=i))
    elif name == "pool":
        det = d.PoolStallDetector(threshold=2)
        for ok in (False, False, False, True, True, False, False):
            out.append(det.feed("decode", ok, "refused"))
    return [None if a is None else a.to_dict() for a in out]


@pytest.mark.parametrize("name", ["zscore", "nan_inf", "scaler",
                                  "throughput", "queue", "slo", "pool"])
def test_detector_fires_like_jax(name):
    got, want = _feed_unit("torch", name), _feed_unit("jax", name)
    assert got == want
    assert any(a is not None for a in got)


def test_pool_stall_threshold_validated():
    for d in DET.values():
        with pytest.raises(ValueError):
            d.PoolStallDetector(threshold=0)


PKGS = {"jax": (jobs, j_scaler_step, jnp.asarray),
        "torch": (tobs, t_scaler_step, torch.tensor)}


def _scripted(pkg):
    """The whole scripted run in one package → (anomalies as (kind,
    step), anomaly.count, healthz codes before and after, the 503
    document's kinds)."""
    obs, scaler_step, arr = PKGS[pkg]
    reg = obs.configure(export_port=0)
    codes = []

    def healthz():
        try:
            r = urllib.request.urlopen(reg.exporter.url + "/healthz",
                                       timeout=5)
            return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        codes.append(healthz()[0])
        losses = _series_losses()
        scale = 65536.0
        for step in range(1, 31):
            overflow = 12 <= step <= 22 and step % 2 == 0
            if overflow:
                scale /= 2
            scaler_step({"loss_scale": arr(np.float32(scale)),
                         "overflow": arr(overflow), "step": arr(step)})
            loss = losses[step - 1] if step != 27 else np.float32(np.nan)
            obs.record_step_metrics({
                "loss": arr(np.float32(loss)),
                "grad_norm": arr(np.float32(1.0 + 0.01 * step)),
                "overflow": arr(overflow), "step": arr(step)})
            reg.observe_span("step.train", 0.3 if step > 24 else 0.05)
            reg.detectors.feed_serving(4 if 5 <= step <= 14 else 0, 0.5)
            reg.detectors.feed_slo("interactive", met=step % 2 == 0,
                                   step=step)
            reg.detectors.feed_pool("decode", step < 26, "refused")
        status, doc = healthz()
        codes.append(status)
        fired = [(a.kind, a.step) for a in reg.detectors.anomalies]
        count = reg.counter("anomaly.count").value
    finally:
        obs.shutdown()
    return fired, count, codes, doc["kinds"]


def test_scripted_run_fires_like_jax_and_flips_healthz():
    got, want = _scripted("torch"), _scripted("jax")
    assert got == want
    fired, count, codes, kinds = got
    assert codes == [200, 503]
    assert count == len(fired)
    assert {"loss_spike", "nan_inf", "scaler_thrash",
            "throughput_regression", "serving_admission_stall",
            "slo_violation", "pool_stall"} <= set(kinds)
    assert ("nan_inf", 27) in fired


def test_engine_feeds_queue_and_slo_detectors():
    """The serving engine's own call sites feed the bank: a tight SLO
    fails every request and fires once per class."""
    from apex_tpu_torch.models.config import gpt_tiny
    from apex_tpu_torch.models.transformer_lm import init_gpt_params
    from apex_tpu_torch.serving import ServingEngine

    cfg = gpt_tiny(num_layers=1, hidden_size=32, num_attention_heads=2,
                   vocab_size=64, max_position_embeddings=32)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reg = tobs.configure()
    try:
        eng = ServingEngine(params, cfg, max_slots=2, max_len=32,
                            slo_targets={"interactive": (1e-6, 1e-6)},
                            device="cpu")
        eng.run([dict(prompt=[1, 2, 3], max_new_tokens=3,
                      slo_class="interactive") for _ in range(10)])
        kinds = [a.kind for a in reg.detectors.anomalies]
        assert kinds.count("slo_violation") == 1
        assert reg.counter("serving.goodput.missed",
                           {"slo_class": "interactive"}).value == 10
    finally:
        tobs.shutdown()


def _mlp_params(seed=7):
    r = np.random.RandomState(seed)
    return {"w1": torch.from_numpy(r.randn(8, 16) * 0.3).float(),
            "b1": torch.zeros(16),
            "w2": torch.from_numpy(r.randn(16, 4) * 0.3).float()}


def _mlp_loss(p, x, y):
    h = torch.tanh(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype))
    return torch.mean((h @ p["w2"].to(x.dtype) - y) ** 2)


def _batch(i, b=16):
    r = np.random.RandomState(50_000 + i)
    return (torch.from_numpy(r.randn(b, 8)).float(),
            torch.from_numpy(r.randn(b, 4)).float())


def test_recovery_rolls_back_on_the_detector_alone(tmp_path):
    """The port's RecoveryManager sees the NaN only through the detector
    bank: the loop records the step metrics, and hands after_step a dict
    without the loss.  It rolls back to the last committed checkpoint,
    records the rollback through the bank (re-arming the NaN latch), and
    a second NaN later rolls back again."""
    from apex_tpu_torch.amp.frontend import make_train_step
    from apex_tpu_torch.checkpoint import RecoveryManager
    from apex_tpu_torch.optimizers import fused_adam

    reg = tobs.configure()
    try:
        init, step = make_train_step(_mlp_loss, fused_adam(lr=1e-2), "O2",
                                     device="cpu")
        mgr = RecoveryManager(str(tmp_path), save_every=2, keep=3)
        state = init(_mlp_params())
        rolled = []
        for i in range(1, 15):
            x, y = _batch(i)
            if i in (7, 12):
                x = x * float("nan")
            state, m = step(state, x, y)
            tobs.record_step_metrics(m)
            seen = {k: v for k, v in m.items() if k != "loss"}
            state, r = mgr.after_step(state, seen)
            if r:
                rolled.append((i, mgr.last_rollback_step))
        mgr.saver.close()
        assert rolled == [(7, 6), (12, 10)]
        kinds = [a.kind for a in reg.detectors.anomalies]
        assert kinds.count("nan_inf") == 2 and kinds.count("rollback") == 2
        assert reg.counter("checkpoint.rollbacks").value == 2
        assert np.isfinite(float(m["loss"]))
    finally:
        tobs.shutdown()
