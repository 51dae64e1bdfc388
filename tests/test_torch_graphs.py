"""The serving engine's compiled ladder on the card: every entry
(``prefill[b]``, ``insert[b]``, ``decode``, ``sample``, ``chunk``)
captured as a CUDA graph by ``ServingEngine(compile_cache_dir=)`` and
replayed.  A replay must give what the eager call gives, bit for bit
(the same kernels in the same order), and must add exactly the launches
the eager call makes.  Marked ``cuda``: they skip where there is no
CUDA device.  This file imports no JAX, so on a GPU machine without JAX
it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.models.config import gpt_tiny
from apex_tpu_torch.models.quantized import quantize_params
from apex_tpu_torch.models.transformer_lm import init_gpt_params
from apex_tpu_torch.ops import _kernel_utils as ku
from apex_tpu_torch.serving import ServingEngine
from apex_tpu_torch.serving.compile_cache import warmup_ladder

pytestmark = pytest.mark.cuda

CFG = dict(num_layers=2, hidden_size=256, num_attention_heads=4,
           vocab_size=512, max_position_embeddings=128, init_method_std=0.2)
ENGINE = dict(max_slots=4, max_len=96, prompt_buckets=(16, 32, 96),
              block_size=16, top_k=20, top_p=0.9, chunk_tokens=32,
              token_masks=True)
# (layout, wire, quantized weights)
CASES = [("contiguous", None, False), ("paged", None, False),
         ("paged", "int8", True)]
_MODELS = {}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the card)")
    return torch.device("cuda")


def _params(quant, dev):
    if (quant, dev) not in _MODELS:
        p = init_gpt_params(gpt_tiny(**CFG), torch.Generator().manual_seed(0),
                            dev)
        _MODELS[quant, dev] = quantize_params(p) if quant else p
    return _MODELS[quant, dev]


def _engine(dev, layout, wire, quant, d=None, **kw):
    return ServingEngine(_params(quant, dev), gpt_tiny(**CFG),
                         cache_layout=layout, cache_wire=wire,
                         compile_cache_dir=d, device=dev,
                         generator=torch.Generator().manual_seed(7),
                         **dict(ENGINE, **kw))


def _requests():
    """A 70-token prompt (chunked), short greedy and sampled ones, one
    restricted to the even ids."""
    rng = np.random.RandomState(5)
    reqs = [dict(prompt=rng.randint(0, 512, (70,)), max_new_tokens=6)]
    reqs += [dict(prompt=rng.randint(0, 512, (5 + 4 * i,)),
                  max_new_tokens=9, temperature=0.8 if i % 2 else 0.0)
             for i in range(5)]
    reqs[3]["token_mask_fn"] = lambda v: np.arange(0, v, 2)
    return reqs


def _run(eng):
    ku.reset_launch_counts()
    out = eng.run(_requests())
    torch.cuda.synchronize(eng.device)
    return ({r.request_id: (r.tokens.tolist(), r.finish_reason)
             for r in out}, ku.launch_counts())


@pytest.mark.parametrize("layout, wire, quant", CASES)
def test_graph_engine_is_the_eager_engine(dev, tmp_path, layout, wire, quant):
    """Tokens, finish reasons and every kernel's launches of the graph
    engine equal the eager engine's; the entries replayed."""
    want, want_counts = _run(_engine(dev, layout, wire, quant))
    eng = _engine(dev, layout, wire, quant, tmp_path)
    got, got_counts = _run(eng)
    assert got == want
    assert got_counts == want_counts
    st = eng.stats()
    assert st["compile_cache"]["replays"] > 0
    assert st.get("blocks_in_use", 0) == 0
    assert all(t % 2 == 0 for t in got[3][0])


@pytest.mark.parametrize("layout, wire, quant", CASES)
def test_warm_engine_replays_every_entry(dev, tmp_path, layout, wire, quant):
    """After warmup_ladder every entry is captured; a second engine on the
    directory hits every entry with no nvcc run, and serves the same
    tokens with the same launches."""
    want, want_counts = _run(_engine(dev, layout, wire, quant))
    cold = _engine(dev, layout, wire, quant, tmp_path)
    w = warmup_ladder(cold)
    assert w["skipped"] == [] and w["misses"] == w["entries"]
    assert cold.stats()["compile_cache"]["captured"] == w["entries"]
    runs = len(ku.NVCC_RUNS)
    warm = _engine(dev, layout, wire, quant, tmp_path)
    w2 = warmup_ladder(warm)
    assert (w2["hits"], w2["misses"]) == (w["entries"], 0)
    got, got_counts = _run(warm)
    assert len(ku.NVCC_RUNS) == runs
    assert warm.stats()["compile_cache"]["misses"] == 0
    assert got == want and got_counts == want_counts


def test_prefill_and_sample_replays_equal_eager(dev, tmp_path):
    """``prefill[b]`` replayed on new prompts and ``sample`` on new key
    words and temperatures give the eager calls' outputs bit for bit,
    one launch set a call."""
    eager = _engine(dev, "paged", None, False)
    graph = _engine(dev, "paged", None, False, tmp_path)
    rng = np.random.RandomState(0)
    for n in (3, 16, 9, 30, 1):
        toks = rng.randint(0, 512, (n,)).astype(np.int32)
        bucket = 16 if n <= 16 else 32
        ku.reset_launch_counts()
        a = eager._prefill_call(toks, n, bucket)
        ca = ku.launch_counts()
        ku.reset_launch_counts()
        b = graph._prefill_call(toks, n, bucket)
        torch.cuda.synchronize(dev)
        assert ku.launch_counts() == ca
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    from apex_tpu_torch.serving.engine import _sample_entry
    logits = torch.randn(4, 512, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1)) * 3
    for words in ((1, 2), (0xDEADBEEF, 7), (5, 5)):
        temps = torch.tensor([0.0, 0.7, 1.3, 0.9])
        w = torch.tensor(words, dtype=torch.int64)
        a = eager._cc("sample", _sample_entry, (logits, temps, w),
                      eager._sample_bound)
        b = graph._cc("sample", _sample_entry, (logits, temps, w),
                      graph._sample_bound)
        assert torch.equal(a, b)


def test_lora_graph_engine_is_the_eager_engine(dev, tmp_path):
    """Row 9 inside the decode graph: three tenants through two slab slots
    (the pool pages adapters in between steps, in place) beside base
    lanes; tokens and launches equal the eager engine's."""
    from apex_tpu_torch.models.lora import init_lora_adapter
    from apex_tpu_torch.serving import AdapterPool

    def run(d):
        cfg = gpt_tiny(**CFG)
        pool = AdapterPool(cfg, slots=2)
        for aid in (1, 2, 3):
            pool.register(aid, init_lora_adapter(
                torch.Generator().manual_seed(aid), cfg, rank=4, b_std=0.05,
                device=dev))
        reqs = _requests()
        for i, r in enumerate(reqs):
            r["adapter_id"] = i % 4
        eng = _engine(dev, "paged", None, False, d, adapter_pool=pool)
        ku.reset_launch_counts()
        out = eng.run(reqs)
        torch.cuda.synchronize(dev)
        assert pool.stats()["pinned_refs"] == 0
        return ({r.request_id: r.tokens.tolist() for r in out},
                ku.launch_counts(), eng)

    want, want_counts, _ = run(None)
    got, got_counts, eng = run(tmp_path)
    assert got == want and got_counts == want_counts
    assert got_counts["grouped_matmul"] > 0
    assert eng.stats()["compile_cache"]["replays"] > 0


@pytest.mark.parametrize("layout, wire, quant", CASES)
def test_spec_graph_engine_is_the_eager_engine(dev, tmp_path, layout, wire,
                                               quant):
    """Under ``spec=`` the ``decode`` entry is one speculative round,
    captured and replayed with new key words each step: tokens, finish
    reasons and launches equal the eager spec engine's, and the greedy
    streams equal the spec-off engine's."""
    from apex_tpu_torch.models.speculative import SpecConfig

    spec = SpecConfig(k=4)
    want, want_counts = _run(_engine(dev, layout, wire, quant, spec=spec))
    eng = _engine(dev, layout, wire, quant, tmp_path, spec=spec)
    got, got_counts = _run(eng)
    assert got == want and got_counts == want_counts
    st = eng.stats()
    assert st["compile_cache"]["replays"] > 0 and st["spec_k"] == 4
    assert st.get("blocks_in_use", 0) == 0
    w = warmup_ladder(_engine(dev, layout, wire, quant, tmp_path, spec=spec))
    assert [label for label, _ in w["skipped"]] == ["sample"]
