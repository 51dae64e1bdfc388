"""``ServingEngine(spec=)`` in the port against the JAX engine on the CPU
at fp32: the two engines are stepped in lockstep on one greedy request
stream and every step they complete the same requests with the same
tokens, finish reasons, decode polls and preemptions; their block
ledgers agree after every step, and so do the
``generate.spec.{draft_tokens,accepted_tokens,verify_calls}`` counters
at the end.  Covered: both cache layouts, native and int8 pools, float
and quantized weights, a starved pool that forces preempt → resume (the
write horizon of k+1 cells in the block budget), ``chunk_tokens=``,
``token_masks=``, LoRA adapters, and the spec engine's greedy tokens
against the spec-off engine's.

The init is scaled (``init_method_std=0.2``) so the greedy streams vary
and drafts are partly rejected; prompts repeat a motif, so the drafter
finds matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.quantized import quantize_params as j_quantize
from apex_tpu.models.speculative import SpecConfig as JSpec
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.observability import metrics as jtel
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.quantized import quantize_params as t_quantize
from apex_tpu_torch.models.speculative import SpecConfig as TSpec
from apex_tpu_torch.observability import metrics as ttel
from apex_tpu_torch.serving import ServingEngine as TEngine
from torch_train_cases import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64,
           init_method_std=0.2)
ENGINE = dict(max_slots=3, max_len=40, prompt_buckets=(8, 16),
              block_size=4)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "num_blocks", "free_slots",
          "spec_k", "prefilling")
SPEC_COUNTERS = ("draft_tokens", "accepted_tokens", "verify_calls")
K = 3
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


def _requests(seed, long_prompt=False):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(6):
        n = int(rng.randint(3, 15))
        motif = rng.randint(0, 128, (int(rng.randint(2, 5)),))
        prompt = np.resize(motif, n) if i % 2 == 0 else rng.randint(
            0, 128, (n,))
        reqs.append(dict(prompt=prompt, max_new_tokens=int(
            rng.randint(4, 14))))
    reqs[3]["eos_token_id"] = int(rng.randint(0, 128))
    if long_prompt:
        reqs.append(dict(prompt=np.resize(rng.randint(0, 128, (5,)), 22),
                         max_new_tokens=9))
    return reqs


def _lockstep(je, te, reqs, **submit_kw):
    for r in reqs:
        assert je.submit(**r, **submit_kw) == te.submit(**r, **submit_kw)
    done, steps = {}, 0
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
        assert steps < 300
    assert te.idle and len(done) == len(reqs)
    if te.cache_layout == "paged":
        assert te.stats()["blocks_in_use"] == 0
    return done


def _run(quant=False, reqs=None, submit_kw=None, **kw):
    """Both engines under ``spec`` over ``reqs``; → (responses, the port's
    spec counters, JAX's)."""
    jcfg, jp, tcfg, tp = _model(quant)
    jreg, treg = jtel.configure(), ttel.configure()
    try:
        je = JEngine(jp, jcfg, spec=JSpec(k=K), **dict(ENGINE, **kw))
        te = TEngine(tp, tcfg, spec=TSpec(k=K), device="cpu",
                     **dict(ENGINE, **kw))
        done = _lockstep(je, te, reqs or _requests(3), **(submit_kw or {}))
        tc = {n: treg.counter(f"generate.spec.{n}").value
              for n in SPEC_COUNTERS}
        jc = {n: jreg.counter(f"generate.spec.{n}").value
              for n in SPEC_COUNTERS}
    finally:
        jtel.shutdown()
        ttel.shutdown()
    assert te.stats()["spec_k"] == K
    return done, tc, jc


CASES = [("contiguous", None, False), ("paged", None, False),
         ("paged", "int8", False), ("paged", None, True),
         ("paged", "int8", True)]


@pytest.mark.parametrize("layout, wire, quant", CASES)
def test_spec_engine_matches_jax(layout, wire, quant):
    done, tc, jc = _run(quant, cache_layout=layout, cache_wire=wire)
    assert tc == jc
    assert 0 < tc["accepted_tokens"] < tc["draft_tokens"]
    # several tokens a poll: fewer polls than tokens after the first
    assert sum(r.decode_steps for r in done.values()) < sum(
        r.tokens.size - 1 for r in done.values())


def test_spec_engine_greedy_equals_spec_off():
    """The spec engine's greedy tokens are the spec-off engine's."""
    _, _, tcfg, tp = _model(False)
    reqs = _requests(4)
    on = TEngine(tp, tcfg, spec=TSpec(k=K), cache_layout="paged",
                 device="cpu", **ENGINE).run(reqs)
    off = TEngine(tp, tcfg, cache_layout="paged", device="cpu",
                  **ENGINE).run(reqs)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.finish_reason == b.finish_reason


@pytest.mark.parametrize("wire", [None, "int8"])
def test_spec_starved_pool_preempts_and_resumes_like_jax(wire):
    """10 blocks of 4 for three lanes whose write horizons reach k+1 cells
    past their lengths: preemptions happen, in the same steps as JAX's,
    and the drafting history survives preempt → resume."""
    done, tc, jc = _run(cache_layout="paged", cache_wire=wire,
                        num_blocks=10, reserve_blocks=0)
    assert tc == jc
    assert sum(r.preemptions for r in done.values()) >= 1


def test_spec_chunked_prefill_like_jax():
    """A 22-token prompt in chunks of 8 joins the spec batch once its last
    chunk lands."""
    done, tc, jc = _run(cache_layout="paged", chunk_tokens=8,
                        prompt_buckets=(8, 16, 32),
                        reqs=_requests(5, long_prompt=True))
    assert max(r.prompt.size for r in done.values()) == 22
    assert tc == jc


def test_spec_token_masks_like_jax():
    """Every request under a seeded half-vocabulary mask (one under a
    single token): drafts outside the mask are rejected outright, and
    every delivered token is allowed."""
    allowed = np.random.RandomState(6).rand(128) < 0.5
    done, tc, jc = _run(cache_layout="paged", token_masks=True,
                        submit_kw=dict(token_mask_fn=lambda v: allowed))
    assert tc == jc
    for r in done.values():
        assert allowed[r.tokens].all()


def test_spec_lora_engine_like_jax():
    """Adapters through a 4-slot pool: the spec round passes each lane's
    slab slot to the verify forward (``spec_round(lora=)``)."""
    from apex_tpu.serving.adapter_pool import AdapterPool as JPool
    from apex_tpu_torch.serving.adapter_pool import AdapterPool as TPool
    from torch_serving_lora_cases import (
        ENGINE as LORA_ENGINE, JCFG, TCFG, TENANTS, _model as lora_model,
        _requests as lora_requests, _suite)

    jp, tp = lora_model(False)
    ja, ta = _suite()
    jpool, tpool = JPool(JCFG, slots=4), TPool(TCFG, slots=4)
    for aid in range(1, TENANTS + 1):
        jpool.register(aid, ja[aid - 1])
        tpool.register(aid, ta[aid - 1])
    geom = dict(LORA_ENGINE, cache_layout="paged", num_blocks=40,
                reserve_blocks=0)
    je = JEngine(jp, JCFG, adapter_pool=jpool, spec=JSpec(k=K), **geom)
    te = TEngine(tp, TCFG, adapter_pool=tpool, spec=TSpec(k=K),
                 device="cpu", **geom)
    done = _lockstep(je, te, lora_requests(3, n=8))
    assert tpool.stats()["pinned_refs"] == 0
    assert len(done) == 8


def test_spec_engine_validation():
    _, _, tcfg, tp = _model(False)
    with pytest.raises(ValueError, match="spec"):
        TEngine(tp, tcfg, spec="tree", device="cpu", **ENGINE)
    te = TEngine(tp, tcfg, spec="ngram", cache_layout="paged", device="cpu",
                 **ENGINE)
    assert te.stats()["spec_k"] == 8


def test_spec_engine_through_the_ladder(tmp_path):
    """With ``compile_cache_dir=`` the spec round is the ``decode`` entry
    (eager here, a captured graph on the card, ``tests/test_torch_graphs.py``):
    the same tokens as the engine without a directory; ``warmup_ladder``
    names the JAX ladder's entries but ``sample`` (first tokens are drawn
    eagerly and the round draws its own), and its key carries k and the
    n-gram sizes."""
    from apex_tpu_torch.serving.compile_cache import warmup_ladder

    _, _, tcfg, tp = _model(False)
    reqs = _requests(8)
    geom = dict(ENGINE, cache_layout="paged", chunk_tokens=8,
                prompt_buckets=(8, 16, 32))
    want = TEngine(tp, tcfg, spec=TSpec(k=K), device="cpu", **geom).run(reqs)
    eng = TEngine(tp, tcfg, spec=TSpec(k=K), device="cpu",
                  compile_cache_dir=str(tmp_path), **geom)
    out = warmup_ladder(eng)
    assert out["labels"] == [f"{n}[{b}]" for b in eng.buckets
                             for n in ("prefill", "insert")] + ["decode",
                                                                "chunk"]
    assert [label for label, _ in out["skipped"]] == ["sample"]
    got = eng.run(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert eng._cc_parts()["spec"] == (K, 3, 1, None)
    other = TEngine(tp, tcfg, spec=TSpec(k=K + 1), device="cpu",
                    compile_cache_dir=str(tmp_path), **geom)
    assert warmup_ladder(other)["misses"] >= 1
