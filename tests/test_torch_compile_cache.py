"""The port's compiled ladder (``apex_tpu_torch/serving/compile_cache.py``)
on the CPU: the counterparts of ``tests/test_compile_cache.py``'s unit
tests, held to the documented contract (a record written by one cache is
a hit for the next over the same directory; a stale code digest, a torn
record, a torn library or a torn manifest is a miss that never raises),
plus the engine: tokens identical to the JAX engine's and to the port's
engine without a directory, a second engine on the directory hits every
entry, ``warmup_ladder`` names the JAX ladder's entries, and a fresh
process on a primed directory hits every entry and computes the same
logits bit for bit.  (The JAX round-trip and fresh-process tests fail in
this repository's reference run, so the port is held to the contract,
not to their results.)  On the CPU an entry runs eagerly: the CUDA-graph
capture and replay are held by ``tests/test_torch_graphs.py`` on the
card."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu.serving import ServingEngine as JEngine
from apex_tpu.serving.compile_cache import warmup_ladder as j_warmup
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.serving import ServingEngine as TEngine
from apex_tpu_torch.serving import compile_cache as cc_mod
from apex_tpu_torch.serving.compile_cache import (
    CompileCache, code_version, warmup_ladder)

CFG = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64)
ENGINE = dict(max_slots=2, max_len=32, prompt_buckets=(8, 16),
              cache_layout="paged", block_size=4, num_blocks=24)
_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **CFG)
        tcfg = TConfig(compute_dtype=torch.float32, **CFG)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL.update(j=(jcfg, jp), t=(tcfg, tp))
    return _MODEL


def _double(x):
    return x * 2.0


def _entry(cc, x, name="double"):
    """Look the entry up and call it once (a miss is recorded at its
    first call)."""
    fn = cc.load_or_compile(name, _double, (x,))
    out = fn(x)
    torch.testing.assert_close(out, x * 2)
    return fn


class TestCompileCacheUnit:
    def test_round_trip_same_dir_is_hit(self, tmp_path):
        x = torch.arange(8, dtype=torch.float32)
        a = CompileCache(tmp_path, device="cpu")
        _entry(a, x)
        assert (a.hits, a.misses) == (0, 1)
        b = CompileCache(tmp_path, device="cpu")    # a fresh process's view
        _entry(b, x)
        assert (b.hits, b.misses) == (1, 0)
        assert b.stats()["entries"] == 1

    def test_memo_short_circuits_counters(self, tmp_path):
        x = torch.ones(4)
        cc = CompileCache(tmp_path, device="cpu")
        f1 = _entry(cc, x)
        f2 = _entry(cc, x)
        assert f1 is f2
        assert (cc.hits, cc.misses) == (0, 1)

    def test_meta_and_concrete_share_a_key(self, tmp_path):
        x = torch.ones(4)
        cc = CompileCache(tmp_path, device="cpu")
        assert (cc.key_for("double", (torch.empty(4, device="meta"),))
                == cc.key_for("double", (x,)))

    def test_key_covers_shapes_bound_state_and_parts(self, tmp_path):
        cc = CompileCache(tmp_path, device="cpu")
        a = torch.ones(4)
        k = cc.key_for("f", (a,))
        assert cc.key_for("f", (torch.ones(8),)) != k
        assert cc.key_for("f", (a.to(torch.bfloat16),)) != k
        assert cc.key_for("g", (a,)) != k
        assert cc.key_for("f", (a,), key_parts={"bucket": 8}) != k
        assert cc.key_for("f", (a,), {"w": torch.ones(3)}) != \
            cc.key_for("f", (a,), {"w": torch.ones(4)})

    def test_stale_code_version_invalidates(self, tmp_path, monkeypatch):
        x = torch.ones(4)
        a = CompileCache(tmp_path, device="cpu")
        _entry(a, x)
        # the sources "changed": same directory, a new digest, so the old
        # record is orphaned and never hit
        monkeypatch.setattr(cc_mod, "code_version", lambda: "stale!")
        b = CompileCache(tmp_path, device="cpu")
        _entry(b, x)
        assert (b.hits, b.misses) == (0, 1)

    def test_torn_entry_is_miss_not_crash(self, tmp_path):
        x = torch.ones(4)
        a = CompileCache(tmp_path, device="cpu")
        key = a.key_for("double", (x,))
        _entry(a, x)
        (tmp_path / f"{key}.json").write_bytes(b"\x00torn bytes, not json")
        b = CompileCache(tmp_path, device="cpu")
        _entry(b, x)
        assert (b.hits, b.misses) == (0, 1)
        # the miss rewrote the record: the next reader hits
        c = CompileCache(tmp_path, device="cpu")
        _entry(c, x)
        assert c.hits == 1

    def test_foreign_record_is_miss(self, tmp_path):
        """A well-formed record of the wrong shape (another version's)
        also degrades to a miss."""
        x = torch.ones(4)
        a = CompileCache(tmp_path, device="cpu")
        key = a.key_for("double", (x,))
        (tmp_path / f"{key}.json").write_text(json.dumps({"not": "ours"}))
        _entry(a, x)
        assert a.misses == 1

    def test_torn_library_is_miss(self, tmp_path):
        """A record whose kernel library is missing or torn is a miss: a
        hit must load every library with no nvcc run."""
        x = torch.ones(4)
        a = CompileCache(tmp_path, device="cpu")
        key = a.key_for("double", (x,))
        rec = {"key": key, "libraries": ["softmax.cu"]}
        (tmp_path / f"{key}.json").write_text(json.dumps(rec))
        missing = CompileCache(tmp_path, device="cpu")
        missing.load_or_compile("double", _double, (x,))
        assert (missing.hits, missing.misses) == (0, 1)
        lib = ku.lib_path("softmax.cu", a.kernel_dir)
        lib.parent.mkdir(parents=True)
        lib.write_bytes(b"not a shared library")
        b = CompileCache(tmp_path, device="cpu")
        _entry(b, x)
        assert (b.hits, b.misses) == (0, 1)
        # the CPU route launches no kernel: the rewritten record needs no
        # library, and the next reader hits
        c = CompileCache(tmp_path, device="cpu")
        _entry(c, x)
        assert c.hits == 1

    def test_torn_manifest_degrades_to_empty(self, tmp_path):
        (tmp_path / "manifest.json").write_text("{torn json")
        cc = CompileCache(tmp_path, device="cpu")
        assert cc.stats()["entries"] == 0
        _entry(cc, torch.ones(4))
        # the record re-indexes: the manifest heals
        assert len(json.loads((tmp_path / "manifest.json").read_text())) == 1

    def test_device_defaults_to_the_card(self, tmp_path):
        """No device is the card, as for every entry point: without one
        the cache refuses rather than run the entries eagerly."""
        if torch.cuda.is_available():
            assert CompileCache(tmp_path).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                CompileCache(tmp_path)

    def test_bound_state_on_another_device_raises(self, tmp_path):
        cc = CompileCache(tmp_path, device="cpu")
        with pytest.raises(ValueError, match="bound state on meta"):
            cc.load_or_compile("f", _double, (torch.ones(2),),
                               {"w": [torch.empty(2, device="meta")]})
        assert cc.stats()["entries"] == 0

    def test_code_version_is_stable_in_process(self):
        assert code_version() == code_version()
        assert len(code_version()) == 16


def _engine(d, **kw):
    m = _model()
    return TEngine(m["t"][1], m["t"][0], device="cpu",
                   compile_cache_dir=None if d is None else str(d),
                   **dict(ENGINE, **kw))


def _reqs(n=3):
    rng = np.random.RandomState(3)
    return [dict(prompt=rng.randint(0, 128, (5 + 4 * i,)).astype(np.int32),
                 max_new_tokens=6) for i in range(n)]


class TestEngine:
    def test_tokens_match_jax_and_eager_and_second_engine_hits(self,
                                                               tmp_path):
        m = _model()
        je = JEngine(m["j"][1], m["j"][0], **ENGINE)
        want = [r.tokens for r in je.run(_reqs())]
        eager = [r.tokens for r in _engine(None).run(_reqs())]
        cold = _engine(tmp_path)
        got = [r.tokens for r in cold.run(_reqs())]
        for g, e, w in zip(got, eager, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, e)
        st = cold.stats()["compile_cache"]
        assert st["misses"] > 0 and st["hits"] == 0
        warm = _engine(tmp_path)
        got2 = [r.tokens for r in warm.run(_reqs())]
        for g, w in zip(got2, want):
            np.testing.assert_array_equal(g, w)
        st2 = warm.stats()["compile_cache"]
        assert st2["hits"] == st["misses"] and st2["misses"] == 0

    def test_engine_calls_its_entries_without_a_lookup(self, tmp_path,
                                                       monkeypatch):
        """After the ladder, a step calls the entries the engine kept: the
        cache is never asked again (its lookup hashes the bound state)."""
        eng = _engine(tmp_path)
        out = warmup_ladder(eng)
        assert len(eng._entries) == out["entries"]

        def refuse(*a, **k):
            raise AssertionError("a step looked an entry up again")

        monkeypatch.setattr(eng._compile_cache, "load_or_compile", refuse)
        got = [r.tokens for r in eng.run(_reqs())]
        for g, w in zip(got, [r.tokens for r in _engine(None).run(_reqs())]):
            np.testing.assert_array_equal(g, w)
        assert len(eng._entries) == out["entries"]

    def test_no_cache_dir_stats_none(self):
        assert _engine(None).stats()["compile_cache"] is None

    def test_warmup_ladder_names_the_jax_ladder(self, tmp_path):
        m = _model()
        je = JEngine(m["j"][1], m["j"][0], chunk_tokens=8,
                     compile_cache_dir=str(tmp_path / "jax"), **ENGINE)
        jout = j_warmup(je)
        eng = _engine(tmp_path / "port", chunk_tokens=8)
        assert eng.buckets == je.buckets
        out = warmup_ladder(eng)
        want = [f"{n}[{b}]" for b in je.buckets
                for n in ("prefill", "insert")] + ["decode", "sample",
                                                   "chunk"]
        assert out["labels"] == want
        assert out["entries"] == jout["entries"] == len(want)
        assert out["skipped"] == jout["skipped"] == []
        assert (out["hits"], out["misses"]) == (0, out["entries"])
        warm = _engine(tmp_path / "port", chunk_tokens=8)
        out2 = warmup_ladder(warm)
        assert (out2["hits"], out2["misses"]) == (out["entries"], 0)
        got = [r.tokens for r in warm.run(_reqs())]
        assert warm.stats()["compile_cache"]["misses"] == 0
        want_tokens = [r.tokens for r in _engine(
            None, chunk_tokens=8).run(_reqs())]
        for g, w in zip(got, want_tokens):
            np.testing.assert_array_equal(g, w)

    def test_warmup_without_cache_and_while_busy(self, tmp_path):
        out = warmup_ladder(_engine(None))
        assert out["entries"] == 0
        assert out["skipped"] == [("*", "no compile_cache_dir")]
        eng = _engine(tmp_path)
        eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="idle"):
            warmup_ladder(eng)

    def test_warmup_changes_nothing_an_idle_engine_holds(self, tmp_path):
        for layout in ("contiguous", "paged"):
            eng = _engine(tmp_path / layout, cache_layout=layout,
                          chunk_tokens=8)
            before = {k: v.clone() for k, v in eng.cache.items()}
            ledger = eng.stats()
            warmup_ladder(eng)
            assert torch.equal(eng.cache["pos"], before["pos"])
            if layout == "paged":
                for k in ("k", "v"):
                    assert torch.equal(eng.cache[k], before[k])
            st = eng.stats()
            for k in ("blocks_free", "blocks_in_use", "active", "queued"):
                assert st.get(k) == ledger.get(k)


_FRESH = r"""
import hashlib, json, sys
import numpy as np, torch
from apex_tpu_torch.models.config import TransformerConfig
from apex_tpu_torch.models.transformer_lm import init_gpt_params
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.serving import ServingEngine, warmup_ladder

cfg = TransformerConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                        vocab_size=128, max_position_embeddings=64,
                        compute_dtype=torch.float32)
params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
eng = ServingEngine(params, cfg, max_slots=2, max_len=32,
                    prompt_buckets=(8, 16), cache_layout="paged",
                    block_size=4, num_blocks=24, chunk_tokens=8,
                    compile_cache_dir=sys.argv[1], device="cpu")
w = warmup_ladder(eng)
eng.submit(np.arange(1, 6), max_new_tokens=4)
eng.step()
st = eng.stats()["compile_cache"]
print(json.dumps({
    "digest": hashlib.sha256(
        eng.last_logits.numpy().tobytes()).hexdigest(),
    "entries": w["entries"], "warm_hits": w["hits"],
    "warm_misses": w["misses"], "hits": st["hits"], "misses": st["misses"],
    "nvcc": len(ku.NVCC_RUNS)}))
"""


def test_fresh_process_on_a_primed_dir_hits_and_logits_are_bitwise(tmp_path):
    """Process A primes the directory; process B (no shared memo) hits
    every entry, runs no nvcc, and its first decode step's logits are
    byte for byte A's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _FRESH, str(tmp_path)],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd=root)
        assert out.returncode == 0, out.stderr[-2000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert (cold["warm_hits"], cold["warm_misses"]) == (0, cold["entries"])
    assert (warm["warm_hits"], warm["warm_misses"]) == (warm["entries"], 0)
    assert (warm["hits"], warm["misses"]) == (warm["entries"], 0)
    assert warm["nvcc"] == 0
    assert warm["digest"] == cold["digest"]


def test_dropped_engine_frees_without_the_cyclic_collector(tmp_path):
    """An entry holds no reference back to its cache: dropping an engine
    frees its cache and entries (on the card, its graphs) at once, never
    later in the cyclic collector, which could run inside another
    engine's capture, where freeing a graph ends the capture."""
    import gc
    import weakref

    eng = _engine(tmp_path)
    eng.run(_reqs(1))
    refs = [weakref.ref(eng._compile_cache)]
    refs += [weakref.ref(e) for e in eng._compile_cache._memo.values()]
    assert len(refs) > 1
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
