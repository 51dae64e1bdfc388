"""The port's ServingEngine against the JAX ServingEngine on the CPU, at a
tiny fp32 GPT: both cache layouts, native and int8 pools, float and
``quantize_params`` weights.  The two engines are stepped in lockstep on
the same request stream: every step they complete the same requests
with the same greedy tokens, finish reasons and decode steps, and their
block ledgers (in use, shared by prefix, preemptions) agree after every
step, including a starved pool that forces preempt→resume and two
identical prompts that share blocks.

The model's init is scaled (``init_method_std=0.2``) so the greedy
streams vary; at the default 0.02 a random tiny model repeats one token
per request, which would prove little.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.quantized import quantize_params as j_quantize
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.quantized import param_bytes
from apex_tpu_torch.models.quantized import quantize_params as t_quantize
from apex_tpu_torch.serving import ServingEngine as TEngine

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64,
           init_method_std=0.2)
ENGINE = dict(max_slots=2, max_len=32, prompt_buckets=(8, 16),
              block_size=4)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "num_blocks",
          "cache_bytes", "free_slots")

_MODELS = {}


def _model(quant):
    if quant not in _MODELS:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
        tcfg = TConfig(compute_dtype=torch.float32, **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        if quant:
            jp, tp = j_quantize(jp), t_quantize(tp)
        _MODELS[quant] = (jcfg, jp, tcfg, tp)
    return _MODELS[quant]


def _requests(seed):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 128, (9,))
    reqs = [dict(prompt=shared, max_new_tokens=7),
            dict(prompt=rng.randint(0, 128, (5,)), max_new_tokens=9),
            dict(prompt=shared, max_new_tokens=5),       # prefix sharing
            dict(prompt=rng.randint(0, 128, (14,)), max_new_tokens=6,
                 eos_token_id=int(rng.randint(0, 128))),
            dict(prompt=rng.randint(0, 128, (3,)), max_new_tokens=11)]
    return reqs


def _lockstep(layout, wire, quant, **kw):
    jcfg, jp, tcfg, tp = _model(quant)
    je = JEngine(jp, jcfg, cache_layout=layout, cache_wire=wire,
                 **dict(ENGINE, **kw))
    te = TEngine(tp, tcfg, cache_layout=layout, cache_wire=wire,
                 device="cpu", **dict(ENGINE, **kw))
    for r in _requests(3):
        assert je.submit(**r) == te.submit(**r)
    done = {}
    steps = 0
    while not je.idle:
        jr, tr = je.step(), te.step()
        steps += 1
        assert [r.request_id for r in jr] == [r.request_id for r in tr]
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert (a.finish_reason, a.decode_steps, a.preemptions) == (
                b.finish_reason, b.decode_steps, b.preemptions)
            done[a.request_id] = a
        js, ts = je.stats(), te.stats()
        assert {k: js.get(k) for k in LEDGER} == \
            {k: ts.get(k) for k in LEDGER}, steps
        assert steps < 200
    assert te.idle and len(done) == 5
    return je, te, done


CASES = [("contiguous", None, False), ("contiguous", None, True),
         ("paged", None, False), ("paged", None, True),
         ("paged", "int8", False), ("paged", "int8", True)]


@pytest.mark.parametrize("layout, wire, quant", CASES)
def test_engine_matches_jax(layout, wire, quant):
    je, te, done = _lockstep(layout, wire, quant)
    assert te.stats()["cache_bytes"] == je.stats()["cache_bytes"]
    if layout == "paged":
        assert te.stats()["blocks_in_use"] == 0
        assert te.stats()["blocks_high_water"] >= 1
    # the streams vary (a scaled init), so identity is a real check
    assert len({int(t) for r in done.values() for t in r.tokens}) > 5


@pytest.mark.parametrize("wire, quant", [(None, False), ("int8", True)])
def test_starved_pool_preempts_and_resumes_like_jax(wire, quant):
    je, te, done = _lockstep("paged", wire, quant, num_blocks=7,
                             reserve_blocks=0)
    assert te.stats()["preemptions"] >= 1
    assert sum(r.preemptions for r in done.values()) >= 1
    assert te.stats()["blocks_in_use"] == 0


def test_prefix_blocks_are_shared():
    _, _, tcfg, tp = _model(False)
    te = TEngine(tp, tcfg, cache_layout="paged", device="cpu", **ENGINE)
    prompt = np.arange(9) + 3
    te.submit(prompt, max_new_tokens=4)
    te.submit(prompt, max_new_tokens=4)
    te.step()
    # two full 4-token blocks of the 9-token prompt map, not allocate
    assert te.stats()["prefix_shared_blocks"] == 2
    out = te.run()
    assert te.stats()["blocks_in_use"] == 0
    assert len(out) == 2


def test_quantized_params_bytes_and_stats_keys():
    _, jp, _, tp = _model(True)
    j_bytes = sum(x.size * x.dtype.itemsize
                  for x in jax.tree_util.tree_leaves(jp))
    assert param_bytes(tp) == j_bytes


@pytest.mark.parametrize("kw", [dict(spec="ngram"),
                                dict(spec="ngram", chunk_tokens=8),
                                dict(host_tier_bytes=1 << 20),
                                dict(host_tier_wire="int8",
                                     token_masks=True)])
def test_unported_engine_options_raise(kw):
    """Every engine option serves KV handoffs as the JAX engine does: a
    request prefilled elsewhere (the JAX package's prefill, K/V over the
    raw wire) and injected through ``submit_prefilled`` decodes the same
    greedy tokens in both engines under the option, beside a local
    request; ``drain`` empties the engine.  (The name is kept from when
    the port raised here.)"""
    from apex_tpu.serving.cluster.handoff import encode_kv as j_encode
    from apex_tpu_torch.serving.cluster.handoff import decode_kv as t_decode

    jcfg, jp, tcfg, tp = _model(False)
    kw = dict(ENGINE, cache_layout="paged", **kw)
    te = TEngine(tp, tcfg, device="cpu", **kw)
    je = JEngine(jp, jcfg, **kw)
    prompt = np.arange(5) + 1
    k, v, first = _jax_remote_prefill(jp, jcfg, prompt, "paged")
    hdr, blobs = j_encode(k, v, wire_dtype="raw")
    tk, tv = t_decode(hdr, blobs)
    te.submit_prefilled(prompt, tk, tv, first, max_new_tokens=6,
                        prefill_ms=1.5)
    je.submit_prefilled(prompt, k, v, first, max_new_tokens=6,
                        prefill_ms=1.5)
    for e in (te, je):
        e.submit(np.arange(7) + 2, max_new_tokens=4)
    tout, jout = te.run(), je.run()
    assert [r.tokens.tolist() for r in tout] == \
        [r.tokens.tolist() for r in jout]
    assert tout[0].tokens[0] == first and tout[0].prefill_ms == 1.5
    assert te.stats()["prefill_calls"] == 1     # the local request only
    te.submit(np.arange(5) + 1, max_new_tokens=4)
    live, requeue = te.drain()
    assert te.idle and not live and len(requeue) == 1


def _jax_remote_prefill(params, cfg, prompt, scratch_layout,
                        cache_dtype=jnp.float32):
    """The JAX package's prefill of one prompt into a bucket scratch
    cache → (per-token K/V, greedy first token), as its cluster prefill
    worker computes them."""
    from apex_tpu.models.generate import extract_kv, init_kv_cache, prefill
    from apex_tpu.serving.batching import default_buckets, pad_prompt
    from apex_tpu.serving.batching import pick_bucket

    n = len(prompt)
    bucket = pick_bucket(n, default_buckets(32))
    padded = jnp.asarray(pad_prompt(np.asarray(prompt, np.int32),
                                    bucket)[None])
    lens = jnp.asarray([n], jnp.int32)
    if scratch_layout == "paged":
        scratch = init_kv_cache(cfg, 1, bucket, cache_dtype=cache_dtype,
                                cache_layout="paged", block_size=4)
        logits, cache = prefill(params, padded, cfg, prompt_lens=lens,
                                cache=scratch)
    else:
        logits, cache = prefill(params, padded, cfg, prompt_lens=lens,
                                max_len=bucket, cache_dtype=cache_dtype)
    k, v = extract_kv(cache, n)
    return np.asarray(k), np.asarray(v), int(jnp.argmax(logits[0]))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_submit_prefilled_raw_wire_token_identical(layout, cache_dtype):
    """The JAX package's ``test_raw_wire_token_identical`` on the port:
    extract (the JAX prefill, cross-layout) → raw wire → the port's
    ``submit_prefilled``, then decode: the greedy outputs equal a port
    engine that prefilled locally and the JAX engine fed the same
    handoffs."""
    from apex_tpu.serving.cluster.handoff import encode_kv as j_encode
    from apex_tpu_torch.serving.cluster.handoff import decode_kv as t_decode

    jcfg, jp, tcfg, tp = _model(False)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 128, (n,)) for n in (5, 9)]
    kw = dict(max_slots=2, max_len=32, cache_layout=layout, block_size=4)
    tdt, jdt = getattr(torch, cache_dtype), getattr(jnp, cache_dtype)
    ref_eng = TEngine(tp, tcfg, cache_dtype=tdt, device="cpu", **kw)
    ref = {tuple(r.prompt.tolist()): r.tokens.tolist()
           for r in ref_eng.run([dict(prompt=p, max_new_tokens=5)
                                 for p in prompts])}
    te = TEngine(tp, tcfg, cache_dtype=tdt, device="cpu", **kw)
    je = JEngine(jp, jcfg, cache_dtype=jdt, **kw)
    for p in prompts:
        k, v, first = _jax_remote_prefill(
            jp, jcfg, p, "paged" if layout == "contiguous" else "contiguous",
            cache_dtype=jdt)
        hdr, blobs = j_encode(k, v, wire_dtype="raw")
        tk, tv = t_decode(hdr, blobs)
        assert tk.dtype == tdt
        te.submit_prefilled(p, tk, tv, first, max_new_tokens=5)
        je.submit_prefilled(p, k, v, first, max_new_tokens=5)
    out = {tuple(r.prompt.tolist()): r.tokens.tolist() for r in te.run()}
    jout = {tuple(r.prompt.tolist()): r.tokens.tolist() for r in je.run()}
    assert out == ref == jout
    assert te.stats()["prefill_calls"] == 0


def test_submit_prefilled_refusals():
    """A foreign geometry, an unknown adapter and an over-long request
    are refused as the JAX engine refuses them."""
    _, _, tcfg, tp = _model(False)
    te = TEngine(tp, tcfg, device="cpu", **ENGINE)
    k = torch.zeros(2, 3, 4, 16)
    with pytest.raises(ValueError, match="geometry"):
        te.submit_prefilled([1, 2, 3, 4], k, k, 1, max_new_tokens=4)
    with pytest.raises(ValueError, match="adapter_pool"):
        te.submit_prefilled([1, 2, 3], k, k, 1, adapter_id=2)
    with pytest.raises(ValueError, match="max_len"):
        te.submit_prefilled([1, 2, 3], k, k, 1, max_new_tokens=40)
    assert te.idle


def test_sampled_lanes_are_seeded_and_in_vocab():
    _, _, tcfg, tp = _model(False)
    reqs = [dict(prompt=np.arange(5) + 1, max_new_tokens=8,
                 temperature=0.8) for _ in range(3)]

    def run(seed):
        te = TEngine(tp, tcfg, cache_layout="paged", device="cpu",
                     top_k=20, top_p=0.9, vocab_limit=100,
                     generator=torch.Generator().manual_seed(seed),
                     **ENGINE)
        return [r.tokens for r in te.run(reqs)]

    a, b = run(5), run(5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert int(x.max()) < 100
