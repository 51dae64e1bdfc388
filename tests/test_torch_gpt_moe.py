"""The port's GPT-MoE AMP-O2 train step (``make_gpt_train_step`` on an MoE
config, FusedAdam) in lockstep with ``apex_tpu.models.gpt.
make_gpt_train_step`` for 12 steps from one converted JAX ``TrainState``:
a two-layer GPT with 4 experts, capacity and ragged routing, top-k 1 and
2.  The start scale 2**24 overflows in fp16, so the first steps are
skipped: the scaler decisions must be identical, not close.  Losses
within tests/test_torch_train_step_o2.py's 3e-2 (bf16 compute).  After
every step a probe forward of the current parameters records each
layer's aux loss and expert load in both packages: aux losses within the
same 3e-2, and each token's top-k expert set equal in both packages
except at a routing near-tie: a token whose k-th and (k+1)-th best router
probabilities (JAX's) differ by less than NEAR_TIE, where bf16 rounding
of the hidden state may flip its expert.  Only the layer where a token's
set first differs is held to that (a token routed elsewhere in an earlier
layer carries a different hidden state on), and the layers with such
flips are counted and bounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaleState as JLossScaleState
from apex_tpu.models import transformer_lm as jlm
from apex_tpu.models.config import gpt_tiny as j_tiny
from apex_tpu.models.gpt import make_gpt_train_step as j_make
from apex_tpu.optimizers import fused_adam as j_adam
from apex_tpu.transformer import moe as jmoe
from apex_tpu_torch.models import transformer_lm as tlm
from apex_tpu_torch.models.config import gpt_tiny as t_tiny
from apex_tpu_torch.models.convert import train_state_from_jax
from apex_tpu_torch.models.gpt import make_gpt_train_step as t_make
from apex_tpu_torch.optimizers import fused_adam as t_adam
from apex_tpu_torch.transformer import moe as tmoe

GEOM = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=16, num_experts=4)
B, S, STEPS = 2, 16, 12
LOSS_TOL = 3e-2          # tests/torch_train_cases.py LOSS_TOL["O2"]
NEAR_TIE = 2e-2          # bf16 hidden states: the router's input rounds
MAX_TIE_LAYERS = 4       # of STEPS x 2 probed layers


def _topk_sets(probs, top_k):
    """Each token's sorted top-k expert set: iterative argmax, first-index
    ties (``_topk_routing`` in both packages)."""
    remaining = np.array(probs, dtype=np.float32).reshape(-1,
                                                          probs.shape[-1])
    picks = []
    for _ in range(top_k):
        c = remaining.argmax(-1)
        picks.append(c)
        remaining[np.arange(len(c)), c] = -1.0
    return np.sort(np.stack(picks, -1), -1)


def _kth_gap(probs, top_k):
    """Per token: the k-th minus the (k+1)-th best router probability."""
    top = -np.sort(-np.asarray(probs, np.float32).reshape(
        -1, probs.shape[-1]), -1)
    return top[:, top_k - 1] - top[:, top_k]


def _probe_jax(cfg):
    """A jitted probe forward: each layer's (aux, load, router probs)."""
    def probe(params, tok):
        outs, probs_seen = [], []
        real_moe, real_probs = jmoe.switch_moe_mlp, jmoe._router_probs

        def moe(*a, **kw):
            outs.append(real_moe(*a, **kw))
            return outs[-1]

        def probs(*a):
            probs_seen.append(real_probs(*a))
            return probs_seen[-1]
        jmoe.switch_moe_mlp, jmoe._router_probs = moe, probs
        try:
            jlm.gpt_forward(params, tok, cfg)
        finally:
            jmoe.switch_moe_mlp, jmoe._router_probs = real_moe, real_probs
        return [(o.aux_loss, o.expert_load, p)
                for o, p in zip(outs, probs_seen)]
    return jax.jit(probe)


def _probe_torch(params, tok, cfg):
    sink, probs_seen = [], []
    real, real_probs = tmoe.switch_moe_mlp, tmoe._router_probs

    def moe(*a, **kw):
        sink.append(real(*a, **kw))
        return sink[-1]

    def probs(*a):
        probs_seen.append(real_probs(*a))
        return probs_seen[-1]
    tmoe.switch_moe_mlp, tmoe._router_probs = moe, probs
    try:
        with torch.no_grad():
            tlm.gpt_forward(params, torch.from_numpy(tok).long(), cfg)
    finally:
        tmoe.switch_moe_mlp, tmoe._router_probs = real, real_probs
    return [(float(o.aux_loss), o.expert_load.numpy(), p.numpy())
            for o, p in zip(sink, probs_seen)]


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("routing", ["capacity", "ragged"])
def test_moe_train_step_tracks_jax(routing, top_k):
    kw = dict(GEOM, moe_routing=routing, moe_top_k=top_k)
    jcfg = j_tiny(compute_dtype=jnp.bfloat16, scan_layers=False, **kw)
    tcfg = t_tiny(compute_dtype=torch.bfloat16, **kw)
    j_init, j_step = j_make(jcfg, j_adam(lr=1e-3), "O2")
    jstate = j_init(jax.random.PRNGKey(0))
    jstate = jstate._replace(loss_scale_state=JLossScaleState(
        jnp.float32(2.0 ** 24), jnp.int32(0)))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    _, t_step = t_make(tcfg, t_adam(lr=1e-3), "O2", device="cpu")
    probe = _probe_jax(jcfg)
    rng = np.random.RandomState(0)
    seq, ties = {"j": [], "t": []}, 0
    for _ in range(STEPS):
        tok = rng.randint(0, GEOM["vocab_size"], (B, S)).astype(np.int32)
        lab = rng.randint(0, GEOM["vocab_size"], (B, S)).astype(np.int32)
        jstate, jm = j_step(jstate, jnp.asarray(tok), jnp.asarray(lab))
        tstate, tm = t_step(tstate, torch.from_numpy(tok),
                            torch.from_numpy(lab))
        for name, m in (("j", jm), ("t", tm)):
            seq[name].append((float(m["loss"]), bool(m["overflow"]),
                              float(m["loss_scale"]), int(m["step"])))
        jp = probe(jstate.params, jnp.asarray(tok))
        tp = _probe_torch(tstate.params, tok, tcfg)
        assert len(jp) == len(tp) == GEOM["num_layers"]
        diverged = np.zeros(B * S, bool)
        for layer, ((ja, jl, jpr), (ta, tl, tpr)) in enumerate(zip(jp, tp)):
            jl, jpr = np.asarray(jl), np.asarray(jpr)
            assert abs(float(ja) - ta) <= LOSS_TOL
            assert tl.sum() == jl.sum() == B * S * top_k
            flip = (_topk_sets(jpr, top_k) != _topk_sets(tpr, top_k)).any(-1)
            if not flip.any():
                assert np.array_equal(jl, tl), (layer, jl, tl)
                continue
            first = flip & ~diverged
            gap = _kth_gap(jpr, top_k)[first]
            assert (gap < NEAR_TIE).all(), (layer, jl, tl, gap)
            diverged |= flip
            ties += 1
    jl = np.array([s[0] for s in seq["j"]])
    tl = np.array([s[0] for s in seq["t"]])
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    assert [s[1:] for s in seq["t"]] == [s[1:] for s in seq["j"]]
    assert seq["t"][0][1], "the 2**24 start scale must overflow"
    assert not seq["t"][-1][1]
    assert ties <= MAX_TIE_LAYERS, ties
