"""Chunked prefill in the port against the JAX package on the CPU at fp32:
``prefill_chunked`` (logits and caches, both layouts and the int8 pool),
``extract_kv``/``inject_kv`` round trips across layouts, and
``ServingEngine(chunk_tokens=)`` stepped in lockstep with the JAX engine
(completions, tokens, finish reasons, the block ledger and the chunk
``stats()`` keys after every step).

The engine geometry is ``bench.py``'s ``bench_chunked_starvation`` (2
layers, h 128, 4 heads, vocab 256, 4 lanes, max_len 576, blocks of 16,
chunks of 64, a 448-token prompt admitted among 16-token ones after two
steps), plus a second copy of the long prompt that shares its leading
chunks.  The init is scaled (``init_method_std=0.2``) so the greedy
streams vary.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu_torch.models import generate as tgen
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving.paged_cache import dequantize_kv
from torch_port_cases import LENS, LOGIT_TOL, _cfgs, _params, _prompt, jgen

LAYOUTS = [("contiguous", None), ("paged", None), ("paged", "int8")]


def _kv(cache, side):
    if "k_scale" in cache:
        return dequantize_kv(cache[side], cache[f"{side}_scale"]).numpy()
    return cache[side].numpy()


def _jkv(cache, side):
    w = np.asarray(cache[side], np.float32)
    if "k_scale" in cache:
        return w * np.asarray(cache[f"{side}_scale"])[..., None]
    return w


def _kv_tol(jc, wire):
    """Two int8 steps of the largest scale on a quantized pool."""
    return LOGIT_TOL if wire is None else 2 * float(
        np.abs(np.asarray(jc["k_scale"])).max())


def _fresh(name, layout, wire, total):
    jcfg, tcfg = _cfgs(name)
    jc = jgen.init_kv_cache(jcfg, len(LENS), total, cache_layout=layout,
                            block_size=4, cache_wire=wire)
    tc = tgen.init_kv_cache(tcfg, len(LENS), total, cache_layout=layout,
                            block_size=4, cache_wire=wire, device="cpu")
    return jcfg, tcfg, jc, tc


@pytest.mark.parametrize("name, chunk", [("learned_mha_gelu", 4),
                                         ("rope_gqa_swiglu", 5)])
@pytest.mark.parametrize("layout, wire", LAYOUTS)
def test_prefill_chunked_matches_jax(name, chunk, layout, wire):
    """Ragged prompts (lengths 5, 11, 8) in chunks of 4 (or 5, which no
    block size divides): the last real token's logits and the written
    caches agree with JAX's."""
    jcfg, tcfg, jc, tc = _fresh(name, layout, wire, 16)
    jp, _, tp = _params(name)
    prompt = _prompt(jcfg.vocab_size, LENS)
    lens = np.asarray(LENS, np.int32)
    jlog, jc = jgen.prefill_chunked(jp, jnp.asarray(prompt), jcfg,
                                    chunk_tokens=chunk,
                                    prompt_lens=jnp.asarray(lens), cache=jc)
    tlog, tc = tgen.prefill_chunked(tp, torch.from_numpy(prompt), tcfg,
                                    chunk_tokens=chunk,
                                    prompt_lens=torch.from_numpy(lens),
                                    cache=tc, device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), lens)
    tol = _kv_tol(jc, wire)
    for side in ("k", "v"):
        np.testing.assert_allclose(_kv(tc, side), _jkv(jc, side), atol=tol,
                                   rtol=0)


def test_prefill_chunked_greedy_equals_prefill():
    """The chunked cache decodes greedily as the monolithic one does."""
    name = "learned_mha_gelu"
    _, tcfg = _cfgs(name)
    tp = _params(name)[2]
    prompt = torch.from_numpy(_prompt(tcfg.vocab_size, LENS))
    lens = torch.tensor(LENS, dtype=torch.int32)
    out = []
    for chunked in (False, True):
        cache = tgen.init_kv_cache(tcfg, len(LENS), 24, cache_layout="paged",
                                   block_size=4, device="cpu")
        if chunked:
            lg, cache = tgen.prefill_chunked(tp, prompt, tcfg, chunk_tokens=3,
                                             prompt_lens=lens, cache=cache,
                                             device="cpu")
        else:
            lg, cache = tgen.prefill(tp, prompt, tcfg, prompt_lens=lens,
                                     cache=cache, device="cpu")
        toks = []
        for _ in range(6):
            nxt = lg.argmax(-1)
            toks.append(nxt)
            lg, cache = tgen.decode_step(tp, nxt, cache, tcfg, device="cpu")
        out.append(torch.stack(toks, 1))
    assert torch.equal(out[0], out[1])


# (source layout, wire) -> (destination layout, wire)
HANDOFFS = [(("contiguous", None), ("paged", None)),
            (("paged", None), ("contiguous", None)),
            (("paged", "int8"), ("paged", None)),
            (("paged", None), ("paged", "int8"))]


@pytest.mark.parametrize("src, dst", HANDOFFS)
def test_extract_inject_round_trip_matches_jax(src, dst):
    """Row 1's prompt K/V extracted from a prefilled cache equals JAX's;
    injected into row 0 of a fresh cache of the other form it sets the
    same position and cells, and the next decode step's logits agree
    with JAX's."""
    name = "learned_mha_gelu"
    jcfg, tcfg, jc, tc = _fresh(name, *src, 16)
    jp, _, tp = _params(name)
    prompt = _prompt(jcfg.vocab_size, LENS)
    lens = np.asarray(LENS, np.int32)
    _, jc = jgen.prefill(jp, jnp.asarray(prompt), jcfg,
                         prompt_lens=jnp.asarray(lens), cache=jc)
    _, tc = tgen.prefill(tp, torch.from_numpy(prompt), tcfg,
                         prompt_lens=torch.from_numpy(lens), cache=tc,
                         device="cpu")
    n = LENS[1]
    jk, jv = jgen.extract_kv(jc, n, row=1)
    tk, tv = tgen.extract_kv(tc, n, row=1)
    assert tuple(tk.shape) == (jcfg.num_layers, n, jcfg.kv_groups,
                               jcfg.kv_channels)
    tol = _kv_tol(jc, src[1])
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=tol, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=tol, rtol=0)
    _, _, jd, td = _fresh(name, *dst, 16)
    jd = jgen.inject_kv(jd, jk, jv, row=0)
    td = tgen.inject_kv(td, tk, tv, row=0)
    assert int(td["pos"][0]) == int(jd["pos"][0]) == n
    rk, rv = tgen.extract_kv(td, n, row=0)
    dtol = max(tol, _kv_tol(jd, dst[1]))
    np.testing.assert_allclose(rk.numpy(), tk.numpy(), atol=dtol, rtol=0)
    np.testing.assert_allclose(rv.numpy(), tv.numpy(), atol=dtol, rtol=0)
    tok = np.asarray([prompt[1, n - 1], 3, 3], np.int32)
    step = jax.jit(functools.partial(jgen.decode_step, cfg=jcfg))
    jlog, _ = step(jp, jnp.asarray(tok), jd)
    tlog, _ = tgen.decode_step(tp, torch.from_numpy(tok), td, tcfg,
                               device="cpu")
    np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0],
                               atol=LOGIT_TOL, rtol=0)


def test_extract_inject_refuse_unmapped_blocks():
    name = "learned_mha_gelu"
    _, tcfg, _, tc = _fresh(name, "paged", None, 16)
    tc["block_tables"][1, 1:] = tc["k"].shape[1]       # sentinel
    with pytest.raises(ValueError, match="unmapped"):
        tgen.extract_kv(tc, 9, row=1)
    k = torch.zeros(tcfg.num_layers, 9, tcfg.kv_groups, tcfg.kv_channels)
    with pytest.raises(ValueError, match="unmapped"):
        tgen.inject_kv(tc, k, k, row=1)
    with pytest.raises(ValueError, match="length"):
        tgen.extract_kv(tc, 0)


# -- the engine, in lockstep with the JAX one ---------------------------

BENCH = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
             vocab_size=256, max_position_embeddings=640,
             init_method_std=0.2)
ENGINE = dict(max_slots=4, max_len=576, block_size=16, chunk_tokens=64)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "num_blocks",
          "free_slots", "chunk_tokens", "prefilling")
_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **BENCH)
        tcfg = TConfig(compute_dtype=torch.float32, **BENCH)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL.update(j=(jcfg, jp), t=(tcfg, tp))
    return _MODEL


def _bench_requests():
    rng = np.random.RandomState(11)
    shorts = [dict(prompt=rng.randint(0, 256, (16,)), max_new_tokens=24,
                   slo_class="standard") for _ in range(3)]
    long_req = dict(prompt=rng.randint(0, 256, (448,)), max_new_tokens=4,
                    slo_class="batch")
    return shorts, long_req


def _stats_keys(st):
    out = {k: st.get(k) for k in LEDGER}
    if "digest_inventory" in st:
        out["inventory_chunk_tokens"] = st["digest_inventory"]["chunk_tokens"]
    return out


@pytest.mark.parametrize("layout, wire", LAYOUTS)
def test_chunked_engine_matches_jax(layout, wire):
    """Three short requests decoding, the long prompt admitted after two
    steps and streamed in 64-token chunks, then the same long prompt again
    (paged: its leading chunks map the published blocks)."""
    m = _model()
    je = JEngine(m["j"][1], m["j"][0], cache_layout=layout, cache_wire=wire,
                 **ENGINE)
    te = TEngine(m["t"][1], m["t"][0], cache_layout=layout, cache_wire=wire,
                 device="cpu", **ENGINE)
    shorts, long_req = _bench_requests()
    for r in shorts:
        assert je.submit(**r) == te.submit(**r)
    done, steps, max_prefilling = {}, 0, 0

    def step():
        nonlocal steps, max_prefilling
        jr, tr = je.step(), te.step()
        steps += 1
        assert [r.request_id for r in jr] == [r.request_id for r in tr]
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert (a.finish_reason, a.decode_steps) == (b.finish_reason,
                                                         b.decode_steps)
            done[a.request_id] = b
        assert _stats_keys(je.stats()) == _stats_keys(te.stats()), steps
        max_prefilling = max(max_prefilling, te.stats()["prefilling"])
        assert steps < 200

    for _ in range(2):
        step()
    for _ in range(2):
        assert je.submit(**long_req) == te.submit(**long_req)
    while not je.idle:
        step()
    assert te.idle and len(done) == 5
    assert max_prefilling == 1
    if layout == "paged":
        assert te.stats()["blocks_in_use"] == 0
    assert len({int(t) for r in done.values() for t in r.tokens}) > 5


def test_chunked_engine_shares_leading_chunks():
    """A copy of the long prompt admitted while the first is decoding maps
    the first's published chunk blocks (all but the last chunk's) and
    emits the same tokens."""
    m = _model()
    te = TEngine(m["t"][1], m["t"][0], cache_layout="paged", device="cpu",
                 **dict(ENGINE, max_slots=2))
    _, long_req = _bench_requests()
    te.submit(**dict(long_req, max_new_tokens=12))
    while te.stats()["prefilling"] or not te.stats()["active"]:
        te.step()
    te.submit(**long_req)
    te.step()
    # 448 tokens = 7 chunks of 4 blocks; the last chunk always runs
    assert te.stats()["prefix_shared_blocks"] == 24
    out = {r.request_id: r for r in te.run()}
    np.testing.assert_array_equal(out[1].tokens, out[0].tokens[:4])
    assert te.stats()["blocks_in_use"] == 0


def test_chunk_tokens_validation():
    m = _model()
    with pytest.raises(ValueError, match="chunk_tokens"):
        TEngine(m["t"][1], m["t"][0], device="cpu",
                **dict(ENGINE, chunk_tokens=0))
    st = TEngine(m["t"][1], m["t"][0], device="cpu", cache_layout="paged",
                 **ENGINE).stats()
    assert (st["chunk_tokens"], st["prefilling"]) == (64, 0)
    assert st["digest_inventory"]["chunk_tokens"] == 64
