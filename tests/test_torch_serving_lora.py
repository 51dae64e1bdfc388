"""The port's multi-tenant LoRA ServingEngine against the JAX engine on the
CPU at a tiny fp32 GPT: 16 tenants through a 4-slot AdapterPool, on both
cache layouts.  Stepped in lockstep on the same requests, the two engines
complete the same requests with the same greedy tokens, finish reasons
and decode steps, and after every step their block ledgers and their
pools' hits, misses, evictions and census agree.  Each stream also equals
the port's own merged-weights oracle (``merge_lora`` + ``generate``), and
a pool pinned full makes admission wait, then progress.  Everything
compared is exact.  (The int8 pool and the starved pool:
tests/test_torch_serving_lora_pool.py.)
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.models.generate import generate as t_generate
from apex_tpu_torch.serving import ServingEngine as TEngine
from torch_serving_lora_cases import (
    ENGINE, TCFG, _engines, _lockstep, _model, _oracle, _requests)
from torch_train_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lora_engine_matches_jax_and_the_merged_oracle(layout):
    je, te, jpool, tpool = _engines(layout)
    reqs = _requests()
    done, _ = _lockstep(je, te, jpool, tpool, reqs)
    assert tpool.stats()["evictions"] >= 1       # 16 tenants, 4 slots
    if layout == "paged":
        assert te.stats()["blocks_in_use"] == 0
    _oracle(reqs, done)
    # the adapters change the streams: a tenant's tokens differ from the
    # base model's on the same prompt
    _, tp = _model(False)
    differ = 0
    for i, r in enumerate(reqs):
        if r["adapter_id"]:
            base = t_generate(tp, torch.as_tensor(r["prompt"][None]), TCFG,
                              max_new_tokens=r["max_new_tokens"],
                              device="cpu")[0, r["prompt"].size:].numpy()
            differ += int(not np.array_equal(base, done[i].tokens))
    assert differ >= 4


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_admission_waits_on_a_pinned_full_pool_then_progresses(layout):
    """3 lanes, 2 pool slots, 3 tenants: the third tenant's admission
    waits while both slots are pinned (a lane stays free), in lockstep
    with JAX, and completes once a request unpins."""
    je, te, jpool, tpool = _engines(layout, slots=2, tenants=3,
                                    max_slots=3)
    rng = np.random.RandomState(6)
    reqs = [dict(prompt=rng.randint(0, 128, (6,)), max_new_tokens=4 + aid,
                 adapter_id=aid) for aid in (1, 2, 3)]
    done, blocked = _lockstep(je, te, jpool, tpool, reqs)
    assert blocked >= 1
    assert sorted(done) == [0, 1, 2]
    _oracle(reqs, done)


def test_submit_validates_adapters():
    je, te, _, _ = _engines("paged", tenants=2)
    with pytest.raises(ValueError, match="not registered"):
        te.submit([1, 2], adapter_id=5)
    with pytest.raises(ValueError, match="no adapter_pool"):
        TEngine(_model(False)[1], TCFG, device="cpu", **ENGINE).submit(
            [1, 2], adapter_id=1)
    with pytest.raises(ValueError):
        te.submit([1, 2], adapter_id=-1)
    with pytest.raises(ValueError):
        je.submit([1, 2], adapter_id=-1)
    with pytest.raises(ValueError, match="token_masks=True"):
        te.submit([1, 2], token_mask_fn=lambda v: [1])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_adapter_prefill_logits_give_the_admitted_first_token(layout):
    """An idle engine's ``adapter_prefill_logits`` is its admission's own
    verify call: the argmax is each adapter request's greedy first token,
    and the lane, blocks and adapter pin it claims come back."""
    _, te, _, tpool = _engines(layout)
    reqs = _requests()
    done = {r.request_id: r for r in te.run(reqs)}
    before = te.stats()
    for i, r in enumerate(reqs):
        if not r["adapter_id"]:
            continue
        logits = te.adapter_prefill_logits(r["prompt"], r["adapter_id"])
        assert logits.shape == (TCFG.vocab_size,)
        assert int(logits.argmax()) == int(done[i].tokens[0]), i
    after = te.stats()
    assert te.idle
    assert {k: after.get(k) for k in ("blocks_in_use", "free_slots")} == \
        {k: before.get(k) for k in ("blocks_in_use", "free_slots")}
    assert tpool.stats()["pinned_refs"] == 0
    assert tpool.census()["pinned"] == 0
    with pytest.raises(RuntimeError):
        te.adapter_prefill_logits(reqs[0]["prompt"], 0)
