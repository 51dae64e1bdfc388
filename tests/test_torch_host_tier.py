"""The host-DRAM KV tier in the port against the JAX package on the CPU.

- ``comm/quantize``: ``quantize_blocks``/``dequantize_blocks`` bit for
  bit the JAX codec's (round-half-to-even, ``amax / 127``, zero blocks
  at scale 1, tails padded to the block);
- ``serving/cluster/handoff``: ``encode_kv`` gives the JAX codec's
  header and bytes on the raw, bf16 and int8 wires for fp32, fp16 and
  bf16 caches, each side decodes the other's blobs to the same values,
  and a torn handoff is refused;
- ``HostTier``: one scripted sequence of parks, takes, peeks, drops,
  prefetches, an eviction and a refusal against the JAX ``HostTier``:
  the same return values, decoded pages and ``stats()`` after every
  call;
- the engine with ``host_tier_bytes=`` stepped in lockstep with the JAX
  engine: a starved pool that preempts (resume by page-in, raw and int8
  wires, native and int8 pools, with spec), and cold prefixes that page
  back in by digest (monolithic and chunked admissions): the same
  tokens, finish reasons, block ledger and tier ``stats()`` after every
  step, and the same ``serving.host_tier.{page_ins,resumes,replays}``
  counters.  On the raw wire the resumed greedy tokens equal the
  tier-off engine's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.comm import quantize as jq
from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.speculative import SpecConfig as JSpec
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.observability import metrics as jtel
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving import host_tier as jht
from apex_tpu.serving.cluster import handoff as jh
from apex_tpu_torch.comm import quantize as tq
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.models.speculative import SpecConfig as TSpec
from apex_tpu_torch.observability import metrics as ttel
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import host_tier as tht
from apex_tpu_torch.serving.cluster import handoff as th

DTYPES = [(np.float32, torch.float32), (np.float16, torch.float16),
          (ml_dtypes.bfloat16, torch.bfloat16)]


def _kv(seed, n=7, dt=(np.float32, torch.float32), shape=(2, None, 3, 8)):
    rng = np.random.RandomState(seed)
    full = (2, n, 3, 8)
    k = (rng.randn(*full) * 3).astype(np.float32)
    v = rng.randn(*full).astype(np.float32)
    k[0, 0] = 0.0                               # an all-zero block edge
    nk, nv = k.astype(dt[0]), v.astype(dt[0])
    return (nk, nv), (torch.from_numpy(k).to(dt[1]),
                      torch.from_numpy(v).to(dt[1]))


# ---- the codec --------------------------------------------------------------


@pytest.mark.parametrize("n, block", [(1000, 256), (512, 256), (7, 4),
                                      (300, 128)])
def test_quantize_blocks_bit_for_bit(n, block):
    rng = np.random.RandomState(n)
    x = (rng.randn(3, n) * rng.rand(3, 1) * 10).astype(np.float32)
    x[1, :block] = 0.0                          # a zero block: scale 1
    x[2, 5] = 0.5 * 127 / 127                   # ties round to even
    jw, js = jq.quantize_blocks(jnp.asarray(x), "int8", block)
    tw, ts_ = tq.quantize_blocks(torch.from_numpy(x), "int8", block)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))
    jd = jq.dequantize_blocks(jw, js, block, n)
    td = tq.dequantize_blocks(tw, ts_, block, n)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jb, _ = jq.quantize_blocks(jnp.asarray(x), "bf16", block)
    tb, none = tq.quantize_blocks(torch.from_numpy(x), "bf16", block)
    assert none is None
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb, np.float32))
    for w in ("fp32", "bf16", "int8"):
        assert tq.wire_itemsize(w) == jq.wire_itemsize(w)


@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("wire", th.WIRE_DTYPES)
@pytest.mark.parametrize("n", [7, 64])
def test_encode_kv_byte_identical_and_cross_decodes(dt, wire, n):
    (nk, nv), (tk, tv) = _kv(n, n, dt)
    jhd, jb = jh.encode_kv(nk, nv, wire_dtype=wire)
    thd, tb = th.encode_kv(tk, tv, wire_dtype=wire)
    assert thd == jhd
    assert tb == jb
    assert th.wire_bytes(tb) == jh.wire_bytes(jb)
    # the port decodes JAX's blobs, and JAX decodes the port's
    pk, pv = th.decode_kv(jhd, jb)
    jk, jv = jh.decode_kv(thd, tb)
    assert pk.dtype == tk.dtype and tuple(pk.shape) == nk.shape
    for p, j in ((pk, jk), (pv, jv)):
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(j, np.float32))
    if wire == "raw":
        assert torch.equal(pk, tk) and torch.equal(pv, tv)


def test_decode_kv_refuses_torn_handoffs():
    _, (tk, tv) = _kv(1)
    hd, blobs = th.encode_kv(tk, tv, wire_dtype="int8")
    with pytest.raises(ValueError, match="4 blobs"):
        th.decode_kv(hd, blobs[:3])
    with pytest.raises(ValueError, match="int8 blobs"):
        th.decode_kv(hd, [blobs[0][:-1]] + blobs[1:])
    hd, blobs = th.encode_kv(tk, tv)
    with pytest.raises(ValueError, match="bytes"):
        th.decode_kv(hd, [blobs[0] + b"x", blobs[1]])
    with pytest.raises(ValueError, match="malformed"):
        th.decode_kv(dict(hd, cache_dtype="int3"), blobs)
    with pytest.raises(ValueError, match="wire_dtype"):
        th.encode_kv(tk, tv, wire_dtype="fp8")
    with pytest.raises(ValueError, match="matching"):
        th.encode_kv(tk, tv[:, :2])


# ---- the store --------------------------------------------------------------


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))


@pytest.mark.parametrize("wire", tht.HOST_TIER_WIRES)
def test_host_tier_script_equals_jax(wire):
    """Parks, takes, peeks, drops and prefetches, a put over a full store
    that evicts the least recently used entry, and a page set larger than
    the whole budget (refused): after every call the same result and
    ``stats()``, and the same newest digests."""
    (nk, nv), (tk, tv) = _kv(5, 4)
    one = len(b"".join(th.encode_kv(tk, tv, wire_dtype=wire)[1]))
    jt = jht.HostTier(int(one * 2.5), wire=wire, block_size=4)
    tt = tht.HostTier(int(one * 2.5), wire=wire, block_size=4)
    big_n, big_t = _kv(6, 40)
    script = [
        ("put_request", (1, 4), True), ("put_block", (b"a" * 32,), True),
        ("has_request", (1, 4), False), ("peek_block", (b"a" * 32,), False),
        ("put_request", (2, 4), True),            # evicts request 1
        ("has_request", (1, 4), False), ("take_request", (1, 4), False),
        ("prefetch_request", (2, 4), False), ("prefetch_request", (2, 4),
                                               False),
        ("take_request", (2, 4), False), ("put_request", (3, 4), True),
        ("drop_request", (3, 4), False), ("has_block", (b"a" * 32,), False),
        ("put_block", (b"b" * 32,), True), ("put_request", (9, 40), "big"),
        ("peek_block", (b"z" * 32,), False)]
    for name, args, kv in script:
        if kv == "big":
            jr = getattr(jt, name)(*args, *big_n)
            tr = getattr(tt, name)(*args, *big_t)
        elif kv:
            jr = getattr(jt, name)(*args, nk, nv)
            tr = getattr(tt, name)(*args, tk, tv)
        else:
            jr = getattr(jt, name)(*args)
            tr = getattr(tt, name)(*args)
        if isinstance(jr, tuple) or isinstance(tr, tuple) or (
                jr is None and name in ("take_request", "peek_block")):
            _same(tr, jr)
        else:
            assert tr == jr, name
        assert tt.stats() == jt.stats(), name
        assert tt.newest_digests() == jt.newest_digests(), name
    st = tt.stats()
    assert st["evictions"] >= 1 and st["misses"] >= 1 and st["hits"] >= 1


def test_host_tier_knobs():
    for v in (None, "off", "0"):
        assert tht.resolve_host_tier_bytes(v) is None
    assert tht.resolve_host_tier_bytes("256m") == 256 << 20
    assert tht.resolve_host_tier_bytes(4096) == 4096
    assert tht.resolve_host_tier_wire(None) == "raw"
    with pytest.raises(ValueError):
        tht.resolve_host_tier_bytes(0)
    with pytest.raises(ValueError):
        tht.resolve_host_tier_wire("bf16")
    assert tht.DIGEST_INVENTORY_N == jht.DIGEST_INVENTORY_N


# ---- the engine -------------------------------------------------------------

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64, init_method_std=0.2)
LEDGER = ("active", "queued", "blocks_in_use", "blocks_free",
          "prefix_shared_blocks", "preemptions", "free_slots", "prefilling",
          "host_tier")
TIER_COUNTERS = ("page_ins", "resumes", "replays", "hits", "misses",
                 "evictions", "prefetches")
_MODELS = {}


def _model(compute="float32"):
    if compute not in _MODELS:
        jcfg = JConfig(compute_dtype=jnp.dtype(compute), remat=False, **CFG)
        tcfg = TConfig(compute_dtype=getattr(torch, compute), **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[compute] = (jcfg, jp, tcfg, tp)
    return _MODELS[compute]


def _preempting(**kw):
    """6 blocks of 4 and 6-token prompts decoding 10 (the JAX tier tests'
    geometry): both admit, both outgrow the pool, the youngest is
    preempted."""
    geom = dict(max_slots=2, max_len=32, prompt_buckets=(8,),
                cache_layout="paged", block_size=4, num_blocks=6,
                reserve_blocks=0)
    geom.update(kw)
    return geom


def _lockstep(geom, reqs, spec_k=None):
    jcfg, jp, tcfg, tp = _model()
    jreg, treg = jtel.configure(), ttel.configure()
    try:
        jkw = {} if spec_k is None else dict(spec=JSpec(k=spec_k))
        tkw = {} if spec_k is None else dict(spec=TSpec(k=spec_k))
        je = JEngine(jp, jcfg, **jkw, **geom)
        te = TEngine(tp, tcfg, device="cpu", **tkw, **geom)
        out = []
        for batch in reqs:
            for r in batch:
                assert je.submit(**r) == te.submit(**r)
            steps = 0
            while not je.idle:
                jr, tr = je.step(), te.step()
                steps += 1
                assert [r.request_id for r in jr] == \
                    [r.request_id for r in tr]
                for a, b in zip(jr, tr):
                    np.testing.assert_array_equal(a.tokens, b.tokens)
                    assert (a.finish_reason, a.decode_steps,
                            a.preemptions) == (b.finish_reason,
                                               b.decode_steps, b.preemptions)
                    out.append(b)
                js, ts = je.stats(), te.stats()
                assert {k: js.get(k) for k in LEDGER} == \
                    {k: ts.get(k) for k in LEDGER}, steps
                assert js["digest_inventory"] == ts["digest_inventory"]
                assert steps < 200
        counts = [{n: reg.counter(f"serving.host_tier.{n}").value
                   for n in TIER_COUNTERS} for reg in (treg, jreg)]
    finally:
        jtel.shutdown()
        ttel.shutdown()
    assert counts[0] == counts[1]
    assert te.stats()["blocks_in_use"] == 0
    return sorted(out, key=lambda r: r.request_id), counts[0], te


def _pair(seed, n=6, new=10):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 128, (n,)), max_new_tokens=new)
            for _ in range(2)]


@pytest.mark.parametrize("wire, pool, spec_k", [
    ("raw", None, None), ("raw", "int8", None), ("int8", None, None),
    ("raw", None, 3)])
def test_preempted_resume_pages_in_like_jax(wire, pool, spec_k):
    """Resume by page-in, not replay, in lockstep with JAX; on the raw
    wire the greedy tokens equal the tier-off engine's."""
    reqs = _pair(7)
    geom = _preempting(host_tier_bytes=1 << 24, host_tier_wire=wire,
                       cache_wire=pool)
    out, counts, te = _lockstep(geom, [reqs], spec_k=spec_k)
    assert te.stats()["preemptions"] >= 1
    assert counts["resumes"] >= 1 and counts["replays"] == 0
    assert not [key for key in te._host._lru if key[0] == "req"]
    if wire == "raw":
        _, _, tcfg, tp = _model()
        kw = {} if spec_k is None else dict(spec=TSpec(k=spec_k))
        base = TEngine(tp, tcfg, device="cpu", **kw,
                       **_preempting(cache_wire=pool)).run(reqs)
        for a, b in zip(out, base):
            np.testing.assert_array_equal(a.tokens, b.tokens)


def test_evicted_parking_replays_like_jax():
    """A tier too small for a parked page set refuses it: the resume
    replays the prefill (counted), in lockstep with JAX."""
    geom = _preempting(host_tier_bytes=512)
    _out, counts, te = _lockstep(geom, [_pair(9)])
    assert counts["replays"] >= 1 and counts["resumes"] == 0
    assert te.stats()["host_tier"]["evictions"] >= 1


@pytest.mark.parametrize("chunk", [None, 8])
def test_cold_prefix_pages_in_by_digest_like_jax(chunk):
    """A completed request's published blocks park by digest when their
    last HBM reference drops; the same prompt later pages them back in
    and republishes them instead of rewriting them (monolithic prefill,
    or chunked with the leading whole chunks paged in)."""
    prompt = np.random.RandomState(23).randint(0, 128, (20,))
    geom = dict(max_slots=2, max_len=40, prompt_buckets=(8, 24),
                cache_layout="paged", block_size=4, chunk_tokens=chunk,
                host_tier_bytes=1 << 24)
    req = dict(prompt=prompt, max_new_tokens=6)
    out, counts, te = _lockstep(geom, [[req], [req]])
    assert counts["page_ins"] >= 4
    np.testing.assert_array_equal(out[0].tokens, out[1].tokens)
    st = te.stats()
    assert st["host_tier"]["pages"] >= 4 and st["digest_inventory"]["host"]
    with pytest.raises(ValueError, match="paged"):
        TEngine(te.params, te.cfg, device="cpu", max_len=40,
                host_tier_bytes=1 << 20)
