"""A pool whose dtype differs from the compute dtype (``cache_dtype=``)
in the port against the JAX package on the CPU: an fp32-compute model
over a bf16 (or fp16) pool, the configuration ``cache_dtype`` exists
for.  Greedy ``generate`` equals JAX's on both layouts, and the
``ServingEngine`` steps in lockstep with the JAX engine (tokens, finish
reasons, block ledger, cache bytes), plain, under ``spec=`` and with the
host tier.  On the card rows 6 and 7 read such a pool as it is
(``tests/test_torch_kernels.py -k foreign``); here their plain versions
run, which cast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.speculative import SpecConfig as JSpec
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu_torch.models import generate as tgen
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.speculative import SpecConfig as TSpec
from apex_tpu_torch.serving import ServingEngine as TEngine
from torch_port_cases import jgen

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64, init_method_std=0.2)
ENGINE = dict(max_slots=2, max_len=32, prompt_buckets=(8, 16), block_size=4)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "cache_bytes", "free_slots")
POOLS = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}
_M = {}


def _model():
    if not _M:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
        tcfg = TConfig(compute_dtype=torch.float32, **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _M.update(m=(jcfg, jp, tcfg, tp))
    return _M["m"]


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_generate_over_a_foreign_pool_matches_jax(pool, layout):
    jcfg, jp, tcfg, tp = _model()
    jd, td = POOLS[pool]
    rng = np.random.RandomState(2)
    lens = np.asarray([5, 12, 9], np.int32)
    prompt = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        prompt[i, :n] = rng.randint(0, 128, (n,))
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=12,
                         prompt_lens=jnp.asarray(lens), cache_dtype=jd,
                         cache_layout=layout, block_size=4)
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg,
                        max_new_tokens=12, prompt_lens=torch.from_numpy(lens),
                        cache_dtype=td, cache_layout=layout, block_size=4,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _requests():
    rng = np.random.RandomState(4)
    return [dict(prompt=rng.randint(0, 128, (int(rng.randint(3, 15)),)),
                 max_new_tokens=int(rng.randint(4, 12))) for _ in range(5)]


@pytest.mark.parametrize("layout, extra", [
    ("contiguous", {}), ("paged", {}), ("paged", dict(num_blocks=7,
                                                      reserve_blocks=0)),
    ("paged", dict(spec=3)), ("paged", dict(num_blocks=7, reserve_blocks=0,
                                            host_tier_bytes=1 << 22))])
def test_engine_over_a_bf16_pool_matches_jax(layout, extra):
    """fp32 compute over a bf16 pool: the engines agree step by step,
    through a starved pool's preempt → resume, under spec, and with the
    host tier parking bf16 pages."""
    jcfg, jp, tcfg, tp = _model()
    extra = dict(extra)
    k = extra.pop("spec", None)
    jkw = dict(extra, **({} if k is None else dict(spec=JSpec(k=k))))
    tkw = dict(extra, **({} if k is None else dict(spec=TSpec(k=k))))
    je = JEngine(jp, jcfg, cache_layout=layout, cache_dtype=jnp.bfloat16,
                 **jkw, **ENGINE)
    te = TEngine(tp, tcfg, cache_layout=layout, cache_dtype=torch.bfloat16,
                 device="cpu", **tkw, **ENGINE)
    assert te.cache["k"].dtype == torch.bfloat16
    for r in _requests():
        assert je.submit(**r) == te.submit(**r)
    steps = 0
    while not je.idle:
        jr, tr = je.step(), te.step()
        steps += 1
        assert [r.request_id for r in jr] == [r.request_id for r in tr]
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert (a.finish_reason, a.decode_steps, a.preemptions) == (
                b.finish_reason, b.decode_steps, b.preemptions)
        js, ts = je.stats(), te.stats()
        assert {k: js.get(k) for k in LEDGER} == \
            {k: ts.get(k) for k in LEDGER}, steps
        assert steps < 200
    assert te.idle
    if "num_blocks" in extra:
        assert te.stats()["preemptions"] >= 1
