"""The engine's host-side helpers against the JAX package's on the CPU:
bucketing and the lane pool (``serving/batching.py``), the SLO class
table (``serving/slo.py``), the log-bucket SLO sketch
(``observability/sketches.py``), and the telemetry the port's engine
emits into its registry."""

import numpy as np
import pytest
import torch

from apex_tpu.observability.sketches import LogBucketSketch as JSketch
from apex_tpu.serving import batching as jb
from apex_tpu.serving import slo as jslo
from apex_tpu_torch import observability as tobs
from apex_tpu_torch.models.config import gpt_tiny
from apex_tpu_torch.models.transformer_lm import init_gpt_params
from apex_tpu_torch.observability.sketches import LogBucketSketch as TSketch
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.serving import batching as tb
from apex_tpu_torch.serving import slo as tslo


@pytest.mark.parametrize("max_len, n", [(32, 1), (1024, 768), (100, 65),
                                        (48, 48)])
def test_buckets_and_padding_match(max_len, n):
    assert tb.default_buckets(max_len) == jb.default_buckets(max_len)
    buckets = tb.default_buckets(max_len)
    assert tb.pick_bucket(n, buckets) == jb.pick_bucket(n, buckets)
    prompt = np.arange(n, dtype=np.int32) + 7
    bucket = tb.pick_bucket(n, buckets)
    np.testing.assert_array_equal(tb.pad_prompt(prompt, bucket),
                                  jb.pad_prompt(prompt, bucket))
    with pytest.raises(ValueError):
        tb.pick_bucket(max_len + 1, buckets)


def test_slot_pool_script_matches():
    rng = np.random.RandomState(0)
    tp, jp = tb.SlotPool(5), jb.SlotPool(5)
    for _ in range(60):
        if rng.rand() < 0.55:
            assert tp.claim() == jp.claim()
        elif jp.active:
            slot = int(rng.choice(jp.active))
            tp.release(slot)
            jp.release(slot)
        assert (tp.active, tp.n_active, tp.n_free) == \
            (jp.active, jp.n_active, jp.n_free)


def test_slo_table_and_judge_match():
    over = {"interactive": (100.0, 20.0), "gold": {"ttft_ms": 50.0},
            "batch": None}
    t, j = tslo.resolve_slo_targets(over), jslo.resolve_slo_targets(over)
    assert {k: (v.ttft_ms, v.tpot_ms) for k, v in t.items()} == \
        {k: (v.ttft_ms, v.tpot_ms) for k, v in j.items()}
    for cls in t:
        for ttft, tpot in [(10.0, 5.0), (120.0, 5.0), (10.0, 30.0),
                           (60.0, None)]:
            assert tslo.judge(t[cls], ttft, tpot) == \
                jslo.judge(j[cls], ttft, tpot)
    assert tslo.tpot_ms(1.0, 1.5, 6) == jslo.tpot_ms(1.0, 1.5, 6)
    assert tslo.tpot_ms(1.0, 1.5, 1) is None
    with pytest.raises(ValueError):
        tslo.resolve_slo_targets({"x": {"p99": 1.0}})


def test_sketch_quantiles_and_merge_match():
    rng = np.random.RandomState(3)
    vals = rng.lognormal(2.0, 1.5, 500)
    ts, js = TSketch(), JSketch()
    for v in vals:
        ts.observe(float(v))
        js.observe(float(v))
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ts.quantile(q) == js.quantile(q)
    assert ts.to_dict() == js.to_dict()
    half = TSketch()
    for v in vals[:250]:
        half.observe(float(v))
    rest = TSketch()
    for v in vals[250:]:
        rest.observe(float(v))
    merged, whole = half.merge(rest).to_dict(), ts.to_dict()
    # the running total sums in another order
    assert merged.pop("total") == pytest.approx(whole.pop("total"))
    assert merged == whole


def test_engine_telemetry_counts_and_sketches():
    cfg = gpt_tiny(num_layers=1, init_method_std=0.2)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(params, cfg, max_slots=2, max_len=32,
                        cache_layout="paged", block_size=4, device="cpu",
                        slo_targets={"interactive": (1e6, 1e6)})
    reg = tobs.configure()
    try:
        out = eng.run([dict(prompt=[1, 2, 3], max_new_tokens=4,
                            slo_class="interactive"),
                       dict(prompt=[4, 5, 6, 7, 8], max_new_tokens=3)])
        s = reg.summary()
    finally:
        tobs.shutdown()
    st = eng.stats()
    c = s["counters"]
    assert c["serving.requests"] == 2
    assert c["serving.prefill_calls"] == st["prefill_calls"] == 2
    assert c["serving.decode_steps"] == st["decode_steps"]
    assert c["serving.tokens_generated"] == sum(r.tokens.size for r in out)
    assert c["serving.goodput.met{slo_class=interactive}"] == 1
    assert s["sketches"]["serving.ttft_ms{slo_class=interactive}"][
        "count"] == 1
    assert s["gauges"]["serving.blocks_in_use"] == 0
    assert not tobs.enabled()
