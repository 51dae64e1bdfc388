"""Norm telemetry and the scaler's host-side telemetry of the port
(apex_tpu_torch.optimizers._common norm_metrics / with_norm_telemetry /
latest_norms / record_opt_norms, amp.scaler.record_scaler_step,
make_train_step(norm_telemetry=True)) against the JAX package's on the
CPU: the cases of tests/test_observability.py (the no-op entry points,
the scale-change event and counters, the wrapped optimizers' norms, the
smoke loop) and the GPT O2 step's norms in lockstep with JAX's.

The optimizers' norms are fp32 on both sides, sums in another order:
1e-5 relative.  The GPT step computes in bf16, which rounds at other
places in the two frameworks: its norms within 2e-2 relative, the
tolerance of the port's other O2 step tests (tests/torch_train_cases.py),
its scaler decisions identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import observability as jobs
from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.amp.scaler import record_scaler_step as j_record_scaler_step
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu.optimizers import fused_lamb as j_lamb
from apex_tpu.optimizers._common import latest_norms as j_latest
from apex_tpu_torch.amp import make_train_step, record_scaler_step
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import train_state_from_jax
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.observability import metrics as tobs
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.optimizers._common import (
    NormTelemetryState, latest_norms, norm_metrics, record_opt_norms)
from torch_train_cases import GEOM

NORM_KEYS = ("grad_norm", "update_norm", "param_norm",
             "update_to_param_ratio")
STEP_NORM_RTOL = 2e-2


@pytest.fixture
def registry():
    reg = tobs.configure()
    yield reg
    tobs.shutdown()


def test_instrumentation_entry_points_are_noops():
    tobs.shutdown()
    record_scaler_step({"loss_scale": 1.0, "overflow": False})
    record_opt_norms(opt_state=None)
    assert not tobs.enabled()


def test_tight_loop_unconfigured_shares_one_noop():
    """With telemetry off, a tight loop of the entry points returns None
    and materializes no registry."""
    tobs.shutdown()
    for i in range(1000):
        assert record_scaler_step({"loss_scale": 1.0, "overflow": False,
                                   "step": i}) is None
        assert record_opt_norms(None) is None
    assert tobs.registry() is None


_SCALER_SEQ = ((65536.0, False), (32768.0, True), (32768.0, False),
               (65536.0, False))


def test_scale_change_event_and_counters(registry, tmp_path):
    """The port's record_scaler_step against JAX's on one sequence of
    step metrics: the same counters, gauge and loss-scale-change events
    (an overflow's halving and a window's doubling, not the unchanged
    step)."""
    import json

    path = tmp_path / "t.jsonl"
    jreg = jobs.configure(jsonl_path=str(path), detectors=False)
    try:
        for scale, overflow in _SCALER_SEQ:
            j_record_scaler_step({"loss_scale": jnp.asarray(scale),
                                  "overflow": jnp.asarray(overflow)})
            record_scaler_step({"loss_scale": torch.tensor(scale),
                                "overflow": torch.tensor(overflow)})
        for name in ("amp.overflow_count", "amp.skipped_steps"):
            assert registry.counter(name).value == jreg.counter(name).value
        assert registry.counter("amp.overflow_count").value == 1
        assert (registry.gauge("amp.loss_scale").value
                == jreg.gauge("amp.loss_scale").value == 65536.0)
    finally:
        jobs.shutdown()
    want = [r["data"] for r in map(json.loads, open(path))
            if r.get("type") == "event"
            and r.get("name") == "amp.loss_scale_change"]
    got = [e["data"] for e in registry.events
           if e["name"] == "amp.loss_scale_change"]
    assert len(got) == 2 and got == want
    assert got[0] == {"old": 65536.0, "new": 32768.0, "overflow": True}


@pytest.mark.parametrize("make", ["adam", "lamb"])
def test_wrapped_optimizer_state_carries_jax_norms(registry, make):
    """fused_adam / fused_lamb(norm_telemetry=True): the state carries the
    last update's four norms, equal to JAX's; record_opt_norms records
    them as gauges."""
    jtx = (j_adam if make == "adam" else j_lamb)(lr=1e-3,
                                                 norm_telemetry=True)
    ttx = (fused_adam if make == "adam" else fused_lamb)(
        lr=1e-3, norm_telemetry=True)
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(4, 3).astype(np.float32),
         "b": np.ones(3, np.float32)}
    g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                       jtx.init(jp), jp)
    ts = ttx.init(tp)
    assert isinstance(ts, NormTelemetryState)
    _, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                       tp)
    want, got = j_latest(js), latest_norms(ts)
    assert sorted(got) == sorted(want) == sorted(NORM_KEYS)
    for k in NORM_KEYS:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    record_opt_norms(ts)
    assert registry.gauge("optim.grad_norm").value == pytest.approx(
        got["grad_norm"])
    assert latest_norms(ts.inner) is None


def test_fused_adam_norm_values():
    """tests/test_observability.py's hand values: |g| = sqrt(4·2²) = 4,
    |p| = 2, the ratio their quotient."""
    tx = fused_adam(lr=1e-3, norm_telemetry=True)
    params = {"w": torch.ones(4)}
    _, state = tx.update({"w": torch.full((4,), 2.0)}, tx.init(params),
                         params)
    norms = latest_norms(state)
    assert norms["grad_norm"] == pytest.approx(4.0)
    assert norms["param_norm"] == pytest.approx(2.0)
    assert norms["update_norm"] > 0
    assert norms["update_to_param_ratio"] == pytest.approx(
        norms["update_norm"] / norms["param_norm"], rel=1e-5)
    only_grads = norm_metrics({"w": torch.full((4,), 2.0)})
    assert list(only_grads) == ["grad_norm"]


def _gpt_lockstep(norm_telemetry):
    kw = dict(GEOM, fused_head_ce=True, head_ce_chunk=24)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), "O2",
                            norm_telemetry=norm_telemetry)
    j_step = jax.jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 15), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, fused_adam(lr=1e-3), "O2", device="cpu",
                       norm_telemetry=norm_telemetry)
    rng = np.random.RandomState(0)
    out = {"j": [], "t": []}
    for _ in range(3):
        tok = rng.randint(0, GEOM["vocab_size"], (2, 32)).astype(np.int32)
        lab = rng.randint(0, GEOM["vocab_size"], (2, 32)).astype(np.int32)
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab))
        out["j"].append({k: float(v) for k, v in jm.items()})
        out["t"].append({k: float(v) for k, v in tm.items()})
    return out


def test_gpt_o2_step_norms_track_jax():
    """make_gpt_train_step(norm_telemetry=True): the metrics carry the four
    norms, each within STEP_NORM_RTOL of JAX's on every step, and the
    loss and scaler decisions are those of the step without telemetry."""
    on, off = _gpt_lockstep(True), _gpt_lockstep(False)
    for jm, tm, tm_off in zip(on["j"], on["t"], off["t"]):
        assert (tm["overflow"], tm["loss_scale"]) == (jm["overflow"],
                                                      jm["loss_scale"])
        assert tm["loss"] == tm_off["loss"]
        assert not tm["overflow"]
        for k in NORM_KEYS:
            assert abs(tm[k] - jm[k]) <= STEP_NORM_RTOL * abs(jm[k]), k
        assert tm["param_norm"] == pytest.approx(jm["param_norm"], rel=1e-5)


def test_smoke_loop_records_scaler_and_norms(registry):
    """A tiny O2 loop with norm_telemetry: every step's metrics carry the
    norms, record_scaler_step records the scale gauge each step."""
    rng = np.random.RandomState(0)
    params = {"emb": torch.from_numpy((rng.randn(64, 16) * 0.02)
                                      .astype(np.float32)),
              "w": torch.from_numpy((rng.randn(16, 64) * 0.02)
                                    .astype(np.float32))}
    tokens = torch.from_numpy(rng.randint(0, 64, (4, 8)))

    def loss_fn(p, toks):
        logits = (p["emb"][toks] @ p["w"]).float()
        tgt = torch.roll(toks, -1, dims=-1)
        return torch.nn.functional.cross_entropy(logits.reshape(-1, 64),
                                                 tgt.reshape(-1))

    init, step = make_train_step(loss_fn, fused_adam(lr=1e-3), "O2",
                                 norm_telemetry=True, device="cpu")
    state = init(params)
    for _ in range(3):
        state, metrics = step(state, tokens)
        assert all(k in metrics for k in NORM_KEYS)
        assert all(np.isfinite(float(metrics[k])) for k in NORM_KEYS)
        record_scaler_step(metrics)
    assert registry.gauge("amp.loss_scale").value == float(
        metrics["loss_scale"])
