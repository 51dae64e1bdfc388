"""Dropout in the port's train steps (apex_tpu_torch.models: the GPT AMP-O2
step with FusedAdam, the MoE step, the BERT O2 step with FusedLAMB) on
the CPU; the GPT and MoE steps in lockstep with JAX here (the MoE step
under capacity and ragged routing, top-k 1 and 2, routing flips allowed
only at near-ties as in tests/test_torch_gpt_moe.py); the BERT lockstep against JAX, under both attention backends, is
tests/test_torch_bert_dropout.py, which shares this file's helpers.

Against the JAX package: the hidden-dropout and drop-path masks are drawn
by jax.random.bernoulli there, and by the flash kernels' counter hash in
the port, so the test points apex_tpu.models.transformer_lm's _dropout
and _drop_path at the same hash (monkeypatch, for the test's duration;
nothing under apex_tpu/ is edited).  Attention dropout is the flash
kernels' hash on both sides already.  Each step's key is split as the JAX
backbone splits it (one key a layer, five a layer), and the port gets
those keys' data words, [L, 5, 2].  Both packages then step 3 times from
one converted JAX state: losses within 3e-2, the gradient norm of every
step that did not overflow within 2e-2 relative, identical scaler
decisions (the tolerances of tests/torch_train_cases.py and of the train
checks on the card: bf16 rounds at other places in the two frameworks).

The port's own masks, unpatched: keep rates within 5 binomial sigma of
1 - p, kept values scaled by exactly 1/(1-p), the same words giving the
same step, and the five sites of a layer drawing different masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models import transformer_lm as jtlm
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.ops.flash_attention import _seed_from_rng
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu.optimizers._common import global_norm as j_global_norm
from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models import transformer_lm as ttlm
from apex_tpu_torch.models.config import bert_large as t_bert_large
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import train_state_from_jax
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.optimizers import fused_adam as t_adam
from apex_tpu_torch.optimizers import fused_lamb as t_lamb
from apex_tpu_torch.optimizers import global_norm as t_global_norm
from apex_tpu_torch.ops import flash_attention as tfa
from test_torch_bert import make_batch
from torch_train_cases import one_torch_thread, oracle_jit  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 3
LOSS_TOL, NORM_RTOL = 3e-2, 2e-2
GPT_GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                vocab_size=256, max_position_embeddings=32)
BERT_GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                 vocab_size=128, max_position_embeddings=64)


def _j_keep(shape, rate, rng):
    """The port's mask (flash_attention.dropout_keep) in jnp: the flash kernels'
    counter hash over the tensor viewed as [B, R, C]."""
    seed = _seed_from_rng(rng)[0].astype(jnp.uint32)
    c = shape[-1] if len(shape) >= 1 else 1
    r = shape[-2] if len(shape) >= 2 else 1
    lead = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    u32 = jnp.uint32
    bh = jnp.arange(lead, dtype=u32)[:, None, None]
    row = jnp.arange(r, dtype=u32)[None, :, None]
    col = jnp.arange(c, dtype=u32)[None, None, :]
    h = seed + bh * u32(0x9E3779B1)
    h = h ^ (row * u32(0x85EBCA77))
    h = h ^ (h >> 16)
    h = h * u32(0x7FEB352D)
    h = h ^ (col * u32(0xC2B2AE3D))
    h = h ^ (h >> 16)
    h = h * u32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * u32(0xC2B2AE35)
    h = h ^ (h >> 16)
    thr = min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)
    return (h < u32(thr)).reshape(shape)


def _j_dropout(x, rate, rng):
    if rate == 0.0 or rng is None:
        return x
    keep = _j_keep(x.shape, rate, rng)
    return jnp.where(keep, x / (1.0 - rate), 0).astype(x.dtype)


def _j_drop_path(x, rate, rng):
    if rate == 0.0 or rng is None:
        return x
    keep = _j_keep((x.shape[0],) + (1,) * (x.ndim - 1), rate, rng)
    return jnp.where(keep, x / (1.0 - rate), 0).astype(x.dtype)


@pytest.fixture
def hashed_jax(monkeypatch):
    monkeypatch.setattr(jtlm, "_dropout", _j_dropout)
    monkeypatch.setattr(jtlm, "_drop_path", _j_drop_path)


def layer_words(key, num_layers):
    """[L, 5, 2] int64: the data words of the JAX backbone's keys (one
    split per layer, five per layer)."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.key_data(jax.random.split(k, 5)))
        for k in jax.random.split(key, num_layers)]).astype(np.int64))


def _norm_hooks():
    j_norms, t_norms = [], []

    def j_post(grads):
        jax.debug.callback(lambda n: j_norms.append(float(n)),
                           j_global_norm(grads))
        return grads

    def t_post(grads):
        t_norms.append(float(t_global_norm(grads)))
        return grads

    return j_norms, t_norms, j_post, t_post


def _lockstep(j_step, t_step, jstate, tstate, batches, num_layers):
    seq = {"j": [], "t": []}
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = j_step(jstate, *(jnp.asarray(a) for a in batch), key)
        tstate, tm = t_step(tstate, *(torch.from_numpy(a) for a in batch),
                            layer_words(key, num_layers))
        for name, m in (("j", jm), ("t", tm)):
            seq[name].append((float(m["loss"]), bool(m["overflow"]),
                              float(m["loss_scale"])))
    return seq


def _check(seq, j_norms, t_norms):
    jl = np.array([s[0] for s in seq["j"]])
    tl = np.array([s[0] for s in seq["t"]])
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    assert len(j_norms) == len(t_norms) == STEPS
    live = [i for i, s in enumerate(seq["t"]) if not s[1]]
    assert live, "every step overflowed"
    for i in live:
        assert abs(t_norms[i] - j_norms[i]) <= NORM_RTOL * j_norms[i]


def _gpt_batches(vocab):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        tok = rng.randint(0, vocab, (2, 32)).astype(np.int32)
        lab = rng.randint(0, vocab, (2, 32)).astype(np.int32)
        lab[0, :5] = -1
        out.append((tok, lab))
    return out


@pytest.mark.parametrize("rates", [
    dict(hidden_dropout=0.1, attention_dropout=0.1),
    dict(hidden_dropout=0.1, attention_dropout=0.1, drop_path_rate=0.2)],
    ids=["hidden_attention", "with_drop_path"])
def test_gpt_o2_dropout_step_tracks_jax(hashed_jax, rates):
    kw = dict(GPT_GEOM, fused_head_ce=True, head_ce_chunk=24, **rates)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    j_norms, t_norms, j_post, t_post = _norm_hooks()
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), "O2",
                            grad_postprocess=j_post)
    j_step = oracle_jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 15), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), "O2", device="cpu",
                       grad_postprocess=t_post)
    seq = _lockstep(j_step, t_step, jstate, tstate,
                    _gpt_batches(GPT_GEOM["vocab_size"]),
                    GPT_GEOM["num_layers"])
    _check(seq, j_norms, t_norms)


MOE_GEOM = dict(GPT_GEOM, num_experts=4)
MOE_RATES = dict(hidden_dropout=0.1, attention_dropout=0.1,
                 drop_path_rate=0.1)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("routing", ["capacity", "ragged"])
def test_moe_o2_dropout_step_tracks_jax(hashed_jax, routing, top_k):
    """The GPT-MoE O2 step with every dropout site on, in lockstep with
    JAX's for 3 steps at the GPT test's tolerances.  After each step a
    dropout-free probe forward of both states holds every token's top-k
    expert set to JAX's except at a routing near-tie (the rule of
    tests/test_torch_gpt_moe.py: in the layer where the sets first
    differ, JAX's k-th minus (k+1)-th probability below NEAR_TIE)."""
    from test_torch_gpt_moe import (
        NEAR_TIE, _kth_gap, _probe_jax, _probe_torch, _topk_sets)

    kw = dict(MOE_GEOM, moe_routing=routing, moe_top_k=top_k, **MOE_RATES)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    j_norms, t_norms, j_post, t_post = _norm_hooks()
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), "O2",
                            grad_postprocess=j_post)
    j_step = oracle_jit(j_step)
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 15), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), "O2", device="cpu",
                       grad_postprocess=t_post)
    probe_cfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False,
                       **dict(MOE_GEOM, moe_routing=routing,
                              moe_top_k=top_k))
    t_probe_cfg = t_tiny(compute_dtype=torch.bfloat16,
                         **dict(MOE_GEOM, moe_routing=routing,
                                moe_top_k=top_k))
    probe = _probe_jax(probe_cfg)
    seq = {"j": [], "t": []}
    for i, (tok, lab) in enumerate(_gpt_batches(GPT_GEOM["vocab_size"])):
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab), key)
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab),
                            layer_words(key, GPT_GEOM["num_layers"]))
        for name, m in (("j", jm), ("t", tm)):
            seq[name].append((float(m["loss"]), bool(m["overflow"]),
                              float(m["loss_scale"])))
        jp = probe(jstate.params, jnp.asarray(tok))
        tp = _probe_torch(tstate.params, tok, t_probe_cfg)
        diverged = np.zeros(tok.size, bool)
        for (_, _, jpr), (_, _, tpr) in zip(jp, tp):
            jpr = np.asarray(jpr)
            flip = (_topk_sets(jpr, top_k) != _topk_sets(tpr, top_k)).any(-1)
            first = flip & ~diverged
            assert (_kth_gap(jpr, top_k)[first] < NEAR_TIE).all()
            diverged |= flip
    _check(seq, j_norms, t_norms)


def test_moe_dropout_loss_matches_jax_fp32(hashed_jax):
    """One fp32 MoE forward (ragged, top-2) with every site dropping: the
    loss within 1e-5 of JAX's."""
    from apex_tpu.models.transformer_lm import (
        gpt_loss as j_loss, init_gpt_params as j_init_params)
    from apex_tpu_torch.models.convert import params_from_numpy

    kw = dict(MOE_GEOM, moe_routing="ragged", moe_top_k=2, **MOE_RATES)
    jcfg = j_tiny(compute_dtype=jnp.float32, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.float32, **kw)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tok, lab = _gpt_batches(GPT_GEOM["vocab_size"])[0]
    key = jax.random.PRNGKey(7)
    want = float(oracle_jit(lambda p, t, lb, k: j_loss(
        p, t, lb, jcfg, dropout_rng=k))(jp, jnp.asarray(tok),
                                        jnp.asarray(lab), key))
    got = float(ttlm.gpt_loss(tp, torch.from_numpy(tok).long(),
                              torch.from_numpy(lab).long(), tcfg,
                              dropout_rng=layer_words(key, 2)))
    base = float(ttlm.gpt_loss(tp, torch.from_numpy(tok).long(),
                               torch.from_numpy(lab).long(), tcfg))
    assert abs(got - want) <= 1e-5 and abs(got - base) > 1e-3


@pytest.mark.parametrize("drop_path", [0.0, 0.2])
def test_gpt_dropout_loss_matches_jax_fp32(hashed_jax, drop_path):
    """One fp32 forward with every site dropping: the loss within 1e-5 of
    JAX's (a mask that differs in one site moves it far more)."""
    from apex_tpu.models.transformer_lm import (
        gpt_loss as j_loss, init_gpt_params as j_init_params)
    from apex_tpu_torch.models.convert import params_from_numpy

    kw = dict(GPT_GEOM, hidden_dropout=0.1, attention_dropout=0.1,
              drop_path_rate=drop_path)
    jcfg = j_tiny(compute_dtype=jnp.float32, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.float32, **kw)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tok, lab = _gpt_batches(GPT_GEOM["vocab_size"])[0]
    key = jax.random.PRNGKey(7)
    want = float(oracle_jit(lambda p, t, lb, k: j_loss(
        p, t, lb, jcfg, dropout_rng=k))(jp, jnp.asarray(tok),
                                        jnp.asarray(lab), key))
    got = float(ttlm.gpt_loss(tp, torch.from_numpy(tok).long(),
                              torch.from_numpy(lab).long(), tcfg,
                              dropout_rng=layer_words(key, 2)))
    base = float(ttlm.gpt_loss(tp, torch.from_numpy(tok).long(),
                               torch.from_numpy(lab).long(), tcfg))
    assert abs(got - want) <= 1e-5 and abs(got - base) > 1e-3


# ---------------------------------------------------------------------------
# the port's own masks
# ---------------------------------------------------------------------------


def _sigma(p, n):
    return 5 * (p * (1 - p) / n) ** 0.5


def test_hidden_dropout_keep_rate_and_scale():
    p = 0.1
    words = ttlm.dropout_keys(t_tiny(**GPT_GEOM), torch.Generator()
                              .manual_seed(0), "cpu")
    x = torch.ones(4, 64, 256)
    y = ttlm._dropout(x, p, words[0, 1])
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) <= _sigma(p, x.numel())
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - p)))
    # bf16 keeps the dtype and the same mask
    yb = ttlm._dropout(x.bfloat16(), p, words[0, 1])
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)


def test_drop_path_takes_whole_samples():
    p = 0.3
    x = torch.ones(2048, 3, 5)
    y = ttlm._drop_path(x, p, torch.tensor([7, 9]))
    per = (y != 0).reshape(2048, -1)
    assert torch.equal(per.all(1), per.any(1))        # all or nothing
    keep = per[:, 0].float().mean().item()
    assert abs(keep - (1 - p)) <= _sigma(p, 2048)
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0],
                                                  1.0 / (1.0 - p)))


def test_five_sites_draw_different_masks(monkeypatch):
    """The layer's attention, two hidden-dropout and two drop-path sites
    each take their own words, and their masks differ."""
    cfg = t_tiny(hidden_dropout=0.1, attention_dropout=0.1,
                 drop_path_rate=0.1, **GPT_GEOM)
    seen = {"dropout": [], "drop_path": [], "attention": []}
    real_dropout, real_drop_path = ttlm._dropout, ttlm._drop_path
    real_flash = ttlm.flash_attention

    def dropout(x, rate, words):
        seen["dropout"].append(words.clone())
        return real_dropout(x, rate, words)

    def drop_path(x, rate, words):
        seen["drop_path"].append(words.clone())
        return real_drop_path(x, rate, words)

    def flash(*a, **kw):
        seen["attention"].append(kw["dropout_rng"].clone())
        return real_flash(*a, **kw)

    monkeypatch.setattr(ttlm, "_dropout", dropout)
    monkeypatch.setattr(ttlm, "_drop_path", drop_path)
    monkeypatch.setattr(ttlm, "flash_attention", flash)
    params = ttlm.init_gpt_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    words = ttlm.dropout_keys(cfg, torch.Generator().manual_seed(1), "cpu")
    tok = torch.randint(0, 256, (2, 32), generator=torch.Generator()
                        .manual_seed(2))
    ttlm.gpt_forward(params, tok, cfg, dropout_rng=words)
    L = cfg.num_layers
    assert len(seen["attention"]) == L
    assert len(seen["dropout"]) == len(seen["drop_path"]) == 2 * L
    for i in range(L):
        sites = [seen["attention"][i], seen["dropout"][2 * i],
                 seen["dropout"][2 * i + 1], seen["drop_path"][2 * i],
                 seen["drop_path"][2 * i + 1]]
        assert all(torch.equal(w, words[i, j]) for j, w in
                   enumerate((sites[0], sites[1], sites[2], sites[3],
                              sites[4])))
        masks = [tfa.dropout_keep((2, 32, 64), tfa.seed_from_key(w), 0.5,
                                   "cpu") for w in sites]
        assert all(not torch.equal(masks[a], masks[c])
                   for a in range(5) for c in range(a + 1, 5))


@pytest.mark.parametrize("kind", ["gpt", "moe", "bert"])
def test_dropout_steps_are_deterministic_in_their_words(kind):
    """The same words give the same losses bit for bit, other words
    another first loss; a dropout step without its words raises."""
    def run(seed_words):
        if kind == "bert":
            cfg = t_bert_large(attention_dropout=0.1, hidden_dropout=0.1,
                               **BERT_GEOM)
            init, step = tbert.make_bert_train_step(cfg, t_lamb(), "O2",
                                                    device="cpu")
            batch = [torch.from_numpy(a) for a in make_batch(
                BERT_GEOM["vocab_size"], 2, 32, seed=3)]
        else:
            extra = (dict(num_experts=4, moe_routing="ragged", moe_top_k=2)
                     if kind == "moe" else {})
            cfg = t_tiny(hidden_dropout=0.1, attention_dropout=0.1,
                         drop_path_rate=0.1, **GPT_GEOM, **extra)
            init, step = t_make(cfg, t_adam(lr=1e-3), "O2", device="cpu")
            gen = torch.Generator().manual_seed(3)
            batch = [torch.randint(0, 256, (2, 32), generator=gen)
                     for _ in range(2)]
        state = init(torch.Generator().manual_seed(0))
        words = ttlm.dropout_keys(cfg, torch.Generator().manual_seed(
            seed_words), "cpu")
        with pytest.raises(TypeError, match="dropout"):
            step(state, *batch)
        losses = []
        for _ in range(2):
            state, m = step(state, *batch, words)
            losses.append(float(m["loss"]))
        return losses

    a, b, c = run(1), run(1), run(2)
    assert a == b and np.isfinite(a).all()
    assert a[0] != c[0]
