"""Shared cases of the LoRA serving lockstep tests
(tests/test_torch_serving_lora.py, tests/test_torch_serving_lora_pool.py):
a tiny fp32 GPT (scaled init, so greedy streams vary), 16 tenants made
with numpy from a seed, the JAX and the port's engine over 4-slot pools,
the lockstep runner and the port's merged-weights oracle."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.quantized import quantize_params as j_quantize
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving.adapter_pool import AdapterPool as JPool
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.generate import generate as t_generate
from apex_tpu_torch.models.lora import merge_lora as t_merge
from apex_tpu_torch.models.quantized import quantize_params as t_quantize
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving.adapter_pool import AdapterPool as TPool
from torch_port_cases import lora_pair

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64,
           init_method_std=0.2)
JCFG = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
TCFG = TConfig(compute_dtype=torch.float32, **CFG)
TENANTS, SLOTS = 16, 4
ENGINE = dict(max_slots=4, max_len=32, prompt_buckets=(8, 16),
              block_size=4)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "free_slots")
POOL = ("slots", "resident", "resident_ids", "pinned_refs", "hits",
        "misses", "evictions")


@functools.lru_cache(maxsize=None)
def _model(quant):
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if quant:
        jp, tp = j_quantize(jp), t_quantize(tp)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _suite():
    return lora_pair(JCFG, TENANTS, rank=4, alpha=8.0)


def _requests(seed=3, n=16):
    """One request per tenant in turn, every fifth on the base model."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        aid = 0 if i % 5 == 4 else 1 + (i % TENANTS)
        reqs.append(dict(prompt=rng.randint(0, 128, (rng.randint(3, 15),)),
                         max_new_tokens=int(rng.randint(3, 8)),
                         adapter_id=aid))
    return reqs


def _engines(layout, wire=None, quant=False, slots=SLOTS, tenants=TENANTS,
             **kw):
    jp, tp = _model(quant)
    ja, ta = _suite()
    jpool, tpool = JPool(JCFG, slots=slots), TPool(TCFG, slots=slots)
    for aid in range(1, tenants + 1):
        jpool.register(aid, ja[aid - 1])
        tpool.register(aid, ta[aid - 1])
    geom = dict(ENGINE, cache_layout=layout, cache_wire=wire)
    if layout == "paged":
        geom.update(num_blocks=40, reserve_blocks=0)
    geom.update(kw)
    je = JEngine(jp, JCFG, adapter_pool=jpool, **geom)
    te = TEngine(tp, TCFG, adapter_pool=tpool, device="cpu", **geom)
    return je, te, jpool, tpool


def _lockstep(je, te, jpool, tpool, reqs):
    for r in reqs:
        assert je.submit(**r) == te.submit(**r)
    done, steps, blocked = {}, 0, 0
    while not je.idle:
        jr, tr = je.step(), te.step()
        steps += 1
        assert [r.request_id for r in jr] == [r.request_id for r in tr]
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert (a.finish_reason, a.decode_steps, a.preemptions) == (
                b.finish_reason, b.decode_steps, b.preemptions)
            done[a.request_id] = b
        js, ts = je.stats(), te.stats()
        assert {k: js.get(k) for k in LEDGER} == \
            {k: ts.get(k) for k in LEDGER}, steps
        assert {k: js["adapter_pool"][k] for k in POOL} == \
            {k: ts["adapter_pool"][k] for k in POOL}, steps
        assert tpool.census() == jpool.census()
        blocked += int(ts["queued"] > 0 and ts["free_slots"] > 0)
        assert steps < 300
    assert te.idle and len(done) == len(reqs)
    st = tpool.stats()
    assert st["pinned_refs"] == 0 and tpool.census()["pinned"] == 0
    return done, blocked


def _oracle(reqs, done):
    """Each float stream equals the port's merged-weights generate."""
    _, tp = _model(False)
    _, ta = _suite()
    for i, r in enumerate(reqs):
        aid = r["adapter_id"]
        params = tp if aid == 0 else t_merge(tp, TCFG, ta[aid - 1])
        want = t_generate(params, torch.as_tensor(r["prompt"][None]), TCFG,
                          max_new_tokens=r["max_new_tokens"], device="cpu")
        np.testing.assert_array_equal(
            done[i].tokens, want[0, r["prompt"].size:].numpy(),
            err_msg=f"request {i} adapter {aid}")
