"""Constrained decoding in the port's ServingEngine against the JAX engine
on the CPU at fp32: ``ServingEngine(token_masks=True)`` with
``submit(token_mask_fn=)`` stepped in lockstep with the JAX engine on
greedy requests (a seeded half of the vocabulary, a single token, a list
of ids, no mask), both layouts and the int8 pool, chunked prefill on
and off; and the mask validation errors JAX raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.serving import ServingEngine as TEngine

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64, init_method_std=0.2)
ENGINE = dict(max_slots=2, max_len=32, prompt_buckets=(8, 16), block_size=4,
              token_masks=True)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "prefilling")
_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
        tcfg = TConfig(compute_dtype=torch.float32, **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL.update(j=(jcfg, jp), t=(tcfg, tp))
    return _MODEL


def _requests():
    rng = np.random.RandomState(4)
    half = rng.permutation(128)[:64]
    allowed = np.zeros(128, bool)
    allowed[half] = True
    return [
        dict(prompt=rng.randint(0, 128, (9,)), max_new_tokens=7,
             token_mask_fn=lambda v: allowed),
        dict(prompt=rng.randint(0, 128, (5,)), max_new_tokens=6,
             token_mask_fn=lambda v: [17]),
        dict(prompt=rng.randint(0, 128, (14,)), max_new_tokens=8),
        dict(prompt=rng.randint(0, 128, (3,)), max_new_tokens=9,
             token_mask_fn=lambda v: np.arange(5, 40, 3)),
    ], allowed


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("layout, wire", [("contiguous", None),
                                          ("paged", None),
                                          ("paged", "int8")])
def test_masked_engine_matches_jax(layout, wire, chunk):
    m = _model()
    je = JEngine(m["j"][1], m["j"][0], cache_layout=layout, cache_wire=wire,
                 chunk_tokens=chunk, **ENGINE)
    te = TEngine(m["t"][1], m["t"][0], cache_layout=layout, cache_wire=wire,
                 chunk_tokens=chunk, device="cpu", **ENGINE)
    reqs, allowed = _requests()
    for r in reqs:
        assert je.submit(**r) == te.submit(**r)
    done, steps = {}, 0
    while not je.idle:
        jr, tr = je.step(), te.step()
        steps += 1
        assert [r.request_id for r in jr] == [r.request_id for r in tr]
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert a.finish_reason == b.finish_reason
            done[b.request_id] = b
        js, ts = je.stats(), te.stats()
        assert {k: js.get(k) for k in LEDGER} == \
            {k: ts.get(k) for k in LEDGER}, steps
        assert steps < 100
    assert te.idle and len(done) == 4
    assert allowed[done[0].tokens].all()
    assert (done[1].tokens == 17).all()
    assert set(done[3].tokens.tolist()) <= set(range(5, 40, 3))


def test_sampled_masked_lanes_stay_allowed():
    """Sampled lanes draw only allowed tokens (the JAX draws differ, so
    only the support is held)."""
    m = _model()
    te = TEngine(m["t"][1], m["t"][0], cache_layout="paged", device="cpu",
                 top_k=20, top_p=0.9, **ENGINE)
    reqs, allowed = _requests()
    reqs = [dict(r, temperature=0.9) for r in reqs]
    out = {r.request_id: r for r in te.run(reqs)}
    assert allowed[out[0].tokens].all()
    assert (out[1].tokens == 17).all()
    assert set(out[3].tokens.tolist()) <= set(range(5, 40, 3))


def _raises(engines, fn, match):
    for eng in engines:
        with pytest.raises(ValueError, match=match):
            eng.submit([1, 2, 3], max_new_tokens=4, token_mask_fn=fn)


def test_mask_validation_matches_jax():
    m = _model()
    kw = dict(ENGINE, token_masks=False)
    plain = (JEngine(m["j"][1], m["j"][0], **kw),
             TEngine(m["t"][1], m["t"][0], device="cpu", **kw))
    _raises(plain, lambda v: [1], "token_masks=True")
    masked = (JEngine(m["j"][1], m["j"][0], **ENGINE),
              TEngine(m["t"][1], m["t"][0], device="cpu", **ENGINE))
    _raises(masked, lambda v: np.ones(v + 1, bool), "expected")
    _raises(masked, lambda v: np.zeros(v, bool), "allows no tokens")
    _raises(masked, lambda v: [], "allows no tokens")
    for eng in masked:
        assert eng.submit([1, 2, 3], max_new_tokens=4,
                          token_mask_fn=lambda v: [3, 4]) == 0
