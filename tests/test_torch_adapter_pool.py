"""The port's AdapterPool against the JAX package's on the CPU: a scripted
register / acquire / release churn (hits, misses, LRU evictions, a
pinned-full pool that refuses) gives the same return value, ``stats()``
and ``census()`` after every call on both pools, and the same slab
contents; plus the byte knob's parsing and its environment override.
Everything compared is exact."""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu.models import lora as jl
from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.serving import adapter_pool as jpool
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.serving import adapter_pool as tpool
from torch_port_cases import lora_pair

CFG = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=32)
JCFG = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
TCFG = TConfig(**CFG)
RANK = 2


@functools.lru_cache(maxsize=None)
def _adapter(aid, rank=RANK):
    ja, ta = lora_pair(JCFG, 1, rank=rank, alpha=3.0, seed=aid)
    return ja[0], ta[0]


def _pools(n, **kw):
    jp, tp = jpool.AdapterPool(JCFG, **kw), tpool.AdapterPool(TCFG, **kw)
    for aid in range(1, n + 1):
        ja, ta = _adapter(aid)
        jp.register(aid, ja)
        tp.register(aid, ta)
    return jp, tp


def _same(jp, tp):
    assert tp.stats() == jp.stats()
    assert tp.census() == jp.census()


# (op, adapter id): 3 slots, 6 tenants
SCRIPT = [("acquire", 1), ("acquire", 2), ("acquire", 1), ("acquire", 3),
          ("acquire", 4),                       # every slot pinned: None
          ("release", 2), ("acquire", 4),       # evicts 2
          ("acquire", 0), ("release", 0),       # the base id is free
          ("release", 1), ("release", 1), ("release", 3),
          ("acquire", 5), ("acquire", 2),       # two evictions
          ("acquire", 3),                       # pinned full again: None
          ("release", 4), ("acquire", 6), ("acquire", 4),
          ("release", 5), ("release", 2), ("release", 6),
          ("acquire", 3), ("acquire", 1), ("release", 1), ("release", 3)]


def test_scripted_churn_matches_jax():
    jp, tp = _pools(6, slots=3)
    _same(jp, tp)                               # unbuilt: 0 slots
    for op, aid in SCRIPT:
        got = getattr(tp, op)(aid)
        want = getattr(jp, op)(aid)
        assert got == want, (op, aid)
        _same(jp, tp)
    st = tp.stats()
    assert st["evictions"] >= 3 and st["pinned_refs"] == 0
    js, ts = jp.slabs(), tp.slabs()
    for t in jl.TARGETS:
        for f in ("a", "b"):
            np.testing.assert_array_equal(ts[t][f].numpy(),
                                          np.asarray(js[t][f]))
    assert tp.resident_ids() == jp.resident_ids()


def test_ledger_errors_match_jax():
    jp, tp = _pools(2, slots=2)
    for pool in (jp, tp):
        with pytest.raises(ValueError):
            pool.register(0, _adapter(1)[0 if pool is jp else 1])
        with pytest.raises(KeyError):
            pool.acquire(9)
        pool.acquire(1)
        with pytest.raises(ValueError, match="resident"):
            pool.register(1, _adapter(1)[0 if pool is jp else 1])
        with pytest.raises(RuntimeError, match="corrupt"):
            pool.release(2)
    odd_j, odd_t = _adapter(7, rank=3)
    with pytest.raises(ValueError, match="uniform"):
        jp.register(3, odd_j)
    with pytest.raises(ValueError, match="uniform"):
        tp.register(3, odd_t)
    with pytest.raises(RuntimeError):
        tpool.AdapterPool(TCFG).slabs()
    with pytest.raises(ValueError):
        tpool.AdapterPool(TCFG, slots=0)


@pytest.mark.parametrize("pool_bytes", [None, 1 << 16, "64k", 5 * 4096])
def test_slot_count_from_the_byte_bound_matches_jax(pool_bytes):
    jp, tp = _pools(2, pool_bytes=pool_bytes)
    jp.acquire(1)
    tp.acquire(1)
    _same(jp, tp)


@pytest.mark.parametrize("env", [None, "256m", "2g", "3000", "off", "0",
                                 "12q", "-5"])
@pytest.mark.parametrize("value", [None, 4096, "1k", "off"])
def test_resolve_adapter_pool_bytes_matches_jax(monkeypatch, env, value):
    if env is None:
        monkeypatch.delenv("APEX_TPU_ADAPTER_POOL_BYTES", raising=False)
    else:
        monkeypatch.setenv("APEX_TPU_ADAPTER_POOL_BYTES", env)

    def outcome(fn):
        try:
            with pytest.warns(UserWarning) if env in ("12q", "-5") else \
                    contextlib.nullcontext():
                return fn(value)
        except ValueError as e:
            return type(e)

    assert outcome(tpool.resolve_adapter_pool_bytes) == outcome(
        jpool.resolve_adapter_pool_bytes)


def test_parse_bytes_matches_jax():
    from apex_tpu.serving.host_tier import _parse_bytes as j_parse

    for text in ("1", "64k", "256M", " 2g ", "4096"):
        assert tpool._parse_bytes(text) == j_parse(text)
    for text in ("0", "-1k", "x", ""):
        with pytest.raises(ValueError):
            tpool._parse_bytes(text)
