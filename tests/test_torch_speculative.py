"""Speculative decoding in the port (``apex_tpu_torch/models/
speculative.py``) against the JAX package on the CPU.

- ``ngram_draft`` equals the JAX drafter exactly (integer arithmetic) on
  seeded histories over a small vocabulary, where matches are common,
  and on the edge cases: no match, a match at the very end, lengths
  shorter than the n-gram, one token;
- ``_spec_probs`` within 1e-6 of JAX's, greedy, sampled and mixed
  temperatures, with and without token masks, top-k/top-p and a vocab
  limit;
- greedy ``generate(spec=)`` token-identical to JAX's ``spec_generate``
  and to the port's spec-off greedy ``generate``, on both cache layouts
  and both pool wires, with the three ``generate.spec.*`` counters
  equal to JAX's.  The model's init is scaled (``init_method_std=0.2``)
  so the greedy streams vary and drafts are partly rejected;
- sampled spec is held to the distribution contract (JAX's threefry
  draws cannot be reproduced): over 16 tokens, the token each emission
  column delivers follows the target distribution (a chi-square test at
  p = 1e-4, a fixed seed), for the point-mass n-gram proposal and for a
  draft model's proposal; and one seed gives the same tokens twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from apex_tpu.models import speculative as js
from apex_tpu.models.config import TransformerConfig as JConfig
from apex_tpu.models.transformer_lm import init_gpt_params as j_init
from apex_tpu_torch.models import generate as tgen
from apex_tpu_torch.models import speculative as ts
from apex_tpu_torch.models.config import TransformerConfig as TConfig
from apex_tpu_torch.models.convert import params_from_numpy
from apex_tpu_torch.observability import metrics as ttel

CFG = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
           vocab_size=256, max_position_embeddings=96,
           init_method_std=0.2)
VARIANTS = {"learned": {},
            "rope_gqa": dict(position_embedding_type="rope",
                             num_query_groups=2)}
LENS = [5, 11, 8]
_MODELS = {}


def _model(name):
    if name not in _MODELS:
        kw = dict(CFG, **VARIANTS[name])
        jcfg = JConfig(compute_dtype=jnp.float32, remat=False, **kw)
        tcfg = TConfig(compute_dtype=torch.float32, **kw)
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[name] = (jcfg, jp, tcfg, tp)
    return _MODELS[name]


def _prompts(vocab, seed):
    """Ragged prompts with a repeated motif, so the drafter finds
    matches."""
    rng = np.random.RandomState(seed)
    out = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, n in enumerate(LENS):
        motif = rng.randint(0, vocab, (3,))
        out[i, :n] = np.resize(motif, n) if i % 2 else rng.randint(0, vocab,
                                                                   (n,))
    return out


# ---- the drafter --------------------------------------------------------


@pytest.mark.parametrize("k, max_ngram, min_ngram", [(4, 3, 1), (8, 3, 2),
                                                     (2, 1, 1), (5, 4, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_equals_jax(k, max_ngram, min_ngram, seed):
    rng = np.random.RandomState(seed)
    b, T = 16, 40
    tokens = rng.randint(0, 4, (b, T)).astype(np.int32)
    lens = rng.randint(0, T + 1, (b,)).astype(np.int32)
    want = js.ngram_draft(jnp.asarray(tokens), jnp.asarray(lens), k=k,
                          max_ngram=max_ngram, min_ngram=min_ngram)
    got = ts.ngram_draft(torch.from_numpy(tokens), torch.from_numpy(lens),
                         k=k, max_ngram=max_ngram, min_ngram=min_ngram)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ngram_draft_edge_cases():
    """No match (all distinct), the suffix's only match at the very end
    (the clamped continuation), lengths 0, 1 and shorter than the n-gram,
    a longer n-gram winning over a more recent shorter one."""
    T = 12
    rows = [list(range(10, 22)),                        # no match
            [1, 2, 3, 9, 9, 1, 2, 3, 0, 0, 0, 0],         # match, len 8
            [5, 6, 7, 5, 6, 7, 0, 0, 0, 0, 0, 0],         # match near end
            [4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],         # one token
            [4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],         # lens < 3
            [1, 2, 3, 5, 2, 3, 1, 2, 3, 0, 0, 0],         # 3-gram vs 2-gram
            [0] * T]                                    # empty
    lens = [12, 8, 6, 1, 2, 9, 0]
    tokens = np.asarray(rows, np.int32)
    lens = np.asarray(lens, np.int32)
    for k, mx in ((4, 3), (6, 2), (1, 1)):
        want = js.ngram_draft(jnp.asarray(tokens), jnp.asarray(lens), k=k,
                              max_ngram=mx)
        got = ts.ngram_draft(torch.from_numpy(tokens),
                             torch.from_numpy(lens), k=k, max_ngram=mx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ts.ngram_draft(torch.from_numpy(tokens), torch.from_numpy(lens),
                         k=3).numpy()
    assert got[0].tolist() == [21, 21, 21]      # no match: repeat the last
    assert got[1].tolist() == [9, 9, 1]         # after the earlier 1 2 3


def test_spec_config_and_resolve():
    assert ts.resolve_spec(None) is None and ts.resolve_spec("off") is None
    assert ts.resolve_spec("ngram") == ts.SpecConfig()
    cfg = ts.SpecConfig(k=3, max_ngram=2)
    assert ts.resolve_spec(cfg) is cfg
    for bad in (dict(k=0), dict(min_ngram=0), dict(min_ngram=3, max_ngram=2)):
        with pytest.raises(ValueError):
            ts.SpecConfig(**bad)
    with pytest.raises(ValueError):
        ts.resolve_spec("tree")


# ---- the target distributions --------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.7, "mixed"])
@pytest.mark.parametrize("filters", [dict(), dict(top_k=5),
                                     dict(top_p=0.8),
                                     dict(top_k=7, top_p=0.9,
                                          vocab_limit=50)])
@pytest.mark.parametrize("mask", [None, "shared", "per_row"])
def test_spec_probs_matches_jax(temperature, filters, mask):
    rng = np.random.RandomState(3)
    b, m, v = 3, 4, 64
    logits = (rng.randn(b, m, v) * 2).astype(np.float32)
    temps = np.asarray([0.0, 0.9, 1.3], np.float32)
    if temperature == "mixed":
        jt, tt = jnp.asarray(temps), torch.from_numpy(temps)
    else:
        jt = tt = temperature
    jm = tm = None
    if mask is not None:
        shape = (v,) if mask == "shared" else (b, v)
        mk = rng.rand(*shape) < 0.6
        mk[..., 0] = True
        jm, tm = jnp.asarray(mk), torch.from_numpy(mk)
    kw = dict(top_k=filters.get("top_k"), top_p=filters.get("top_p"),
              vocab_limit=filters.get("vocab_limit"))
    want = js._spec_probs(jnp.asarray(logits), jt, token_mask=jm, **kw)
    got = ts._spec_probs(torch.from_numpy(logits), tt, token_mask=tm, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---- greedy generate --------------------------------------------------------


def _counters(fn):
    reg = ttel.configure()
    try:
        out = fn()
        names = ("draft_tokens", "accepted_tokens", "verify_calls")
        return out, {n: reg.counter(f"generate.spec.{n}").value
                     for n in names}
    finally:
        ttel.shutdown()


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("layout, wire, k, eos", [
    ("contiguous", None, 3, None), ("paged", None, 5, 7),
    ("paged", "int8", 4, 7), ("contiguous", None, 6, 7)])
def test_greedy_spec_generate_matches_jax(name, layout, wire, k, eos):
    """Greedy ``generate(spec=)`` equals JAX's ``spec_generate`` token for
    token and counter for counter, and the port's spec-off ``generate``
    (ragged prompts, blocks of 4, an EOS id in the second case)."""
    jcfg, jp, tcfg, tp = _model(name)
    prompt = _prompts(jcfg.vocab_size, 5)
    lens = np.asarray(LENS, np.int32)
    kw = dict(max_new_tokens=20, cache_layout=layout, block_size=4,
              cache_wire=wire, eos_token_id=eos)
    jt, jst = js.spec_generate(jp, jnp.asarray(prompt), jcfg,
                               spec=js.SpecConfig(k=k),
                               prompt_lens=jnp.asarray(lens), **kw)
    got, counts = _counters(lambda: tgen.generate(
        tp, torch.from_numpy(prompt), tcfg, spec=ts.SpecConfig(k=k),
        prompt_lens=torch.from_numpy(lens), device="cpu", **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt))
    assert counts == jst
    # drafts are partly rejected: the identity is a real check
    assert 0 < jst["accepted_tokens"] < jst["draft_tokens"]
    off = tgen.generate(tp, torch.from_numpy(prompt), tcfg,
                        prompt_lens=torch.from_numpy(lens), device="cpu",
                        **kw)
    assert torch.equal(got, off)


def test_spec_headroom_and_layout_refusals():
    _, _, tcfg, tp = _model("learned")
    with pytest.raises(ValueError, match="speculative verify headroom"):
        tgen.generate(tp, torch.zeros(1, 80, dtype=torch.long), tcfg,
                      max_new_tokens=10, spec="ngram", device="cpu")
    with pytest.raises(ValueError, match="cache_layout"):
        ts.spec_generate(tp, torch.zeros(1, 3, dtype=torch.long), tcfg,
                         cache_layout="ring", device="cpu")
    with pytest.raises(ValueError, match="enabled spec"):
        ts.spec_generate(tp, torch.zeros(1, 3, dtype=torch.long), tcfg,
                         spec="off", device="cpu")


# ---- sampled spec: the distribution contract --------------------------------

V16 = 16
N_ROWS = 40000
P_CRIT = 1e-4


def _chi2_ok(tokens, p):
    counts = np.bincount(tokens, minlength=len(p)).astype(np.float64)
    n = counts.sum()
    live = p > 0
    assert counts[~live].sum() == 0, "a token of zero mass was emitted"
    stat = float((((counts - n * p) ** 2)[live] / (n * p[live])).sum())
    return stat, float(chi2.ppf(1 - P_CRIT, int(live.sum()) - 1))


@pytest.mark.parametrize("proposal", ["point_mass", "draft_model"])
def test_sampled_accept_emits_the_target_marginal(proposal):
    """``_accept`` over one verify block of k = 3 on 16 tokens, 40000 rows
    sharing each position's target ``p_j`` (one with a zero): the token
    delivered at column 0, and at column 1 among the rows that reach it,
    follows ``p_0`` and ``p_1``."""
    rng = np.random.RandomState(11)
    k = 3
    p = rng.dirichlet(np.ones(V16) * 0.7, size=k + 1)
    p[:, 3] = 0.0
    p /= p.sum(-1, keepdims=True)
    probs = torch.from_numpy(np.broadcast_to(
        p, (N_ROWS, k + 1, V16)).astype(np.float32).copy())
    if proposal == "point_mass":
        # a fixed draft, one of the likelier tokens at each position
        d = np.argsort(-p[:k], axis=-1)[:, 2]
        draft = np.broadcast_to(d, (N_ROWS, k)).copy()
        q = None
    else:
        qp = rng.dirichlet(np.ones(V16), size=k)
        draft = np.stack([rng.choice(V16, N_ROWS, p=qp[j])
                          for j in range(k)], 1)
        q = torch.from_numpy(np.broadcast_to(
            qp, (N_ROWS, k, V16)).astype(np.float32).copy())
    draft_t = torch.from_numpy(draft.astype(np.int32))
    n_acc, y = ts._accept(draft_t, probs, q,
                          torch.tensor([12345, 678], dtype=torch.int64))
    n_acc, y = n_acc.numpy(), y.numpy()
    col0 = np.where(n_acc >= 1, draft[:, 0], y)
    stat, crit = _chi2_ok(col0, p[0])
    assert stat < crit, (stat, crit)
    reach1 = n_acc >= 1
    col1 = np.where(n_acc[reach1] >= 2, draft[reach1, 1], y[reach1])
    stat, crit = _chi2_ok(col1, p[1])
    assert stat < crit, (stat, crit)
    # greedy rows: one-hot targets accept exactly the argmax drafts
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(np.argmax(p, -1)), V16).float()
    n_g, y_g = ts._accept(draft_t[:4], onehot.expand(4, k + 1, V16), None,
                          torch.tensor([1, 2]))
    want = np.argmax(p, -1)
    hits = np.cumprod(draft[:4] == want[:k], axis=1).sum(1)
    np.testing.assert_array_equal(n_g.numpy(), hits)
    np.testing.assert_array_equal(y_g.numpy(), want[hits])


def test_sampled_spec_generate_is_seeded_and_in_vocab():
    _, _, tcfg, tp = _model("learned")
    prompt = torch.from_numpy(_prompts(tcfg.vocab_size, 6))
    kw = dict(max_new_tokens=16, temperature=1.0, top_k=40, top_p=0.95,
              vocab_limit=200, prompt_lens=torch.tensor(LENS),
              cache_layout="paged", block_size=4, spec=ts.SpecConfig(k=4),
              device="cpu")
    a = tgen.generate(tp, prompt, tcfg, seed=7, **kw)
    b = tgen.generate(tp, prompt, tcfg, seed=7, **kw)
    c = tgen.generate(tp, prompt, tcfg, seed=8, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    for i, n in enumerate(LENS):
        assert int(a[i, n:n + 16].max()) < 200
